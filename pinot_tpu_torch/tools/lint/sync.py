"""Device-sync taint: implicit host syncs in convoy positions.

A torch tensor on a CUDA device reaches the host through *implicit*
syncs: ``.item()``, ``.tolist()``, ``.cpu()``, ``int()`` / ``float()`` /
``bool()`` of it, ``np.asarray()`` / ``np.array()`` of it, and
``torch.cuda.synchronize()`` itself. Each blocks the calling thread until
the card has run everything queued before it. Three call contexts turn
that stall into a systemic hazard:

- **while a lock is held**: every other thread queuing on that lock now
  waits on the card too (the lock-held set flows through the lock graph:
  lexical ``with self.<lock>`` regions, the ``*_locked`` caller-holds
  convention, and functions name-resolved from call sites under a lock,
  two levels deep);
- **on the launcher's dispatcher thread**: one dispatcher a device (or a
  mesh) serializes every batch launch in the process; a sync there stalls
  all queries, not one. Dispatcher reachability starts at
  ``threading.Thread(target=...)`` call sites in launcher modules and
  closes over name-resolved calls. (Worker-pool threads are deliberately
  NOT roots: a query's own decode copy is the design, not a hazard.)
- **inside a metrics/telemetry gauge callback**: callables registered via
  ``MetricsRegistry.gauge`` / ``Telemetry.track_gauge`` run on scrape and
  sampler threads; a sink there stalls every scrape on the card. Both
  lambda registrations (checked against the registering function's taint
  set) and named-function registrations are gated.

Taint sources: the results of ``torch.*`` calls (minus host-metadata
entry points like ``torch.cuda.device_count()`` and host constructors
like ``torch.from_numpy()``), the outputs of the kernel wrappers
(``KERNEL_WRAPPERS``), plus calls to in-package functions summarized as
returning device values (fixpoint over the scan set). Taint propagates
through arithmetic, subscripts, attribute chains and method calls (host
metadata like ``.shape`` / ``.dtype`` / ``.device`` / ``.numel()``
strips it: reading it never syncs), and conservatively through
unresolved calls fed tainted arguments. Sink results are host values and
untainted.

The per-function sink pass runs the taint as a forward dataflow over the
:mod:`dataflow` CFG (union join, no kills), so a sink is only flagged
with the taint that can actually reach it.
"""

from __future__ import annotations

import ast
import os

from typing import Any, Dict, FrozenSet, List, Optional, Set, Tuple

from pinot_tpu_torch.tools.lint.core import (
    Finding,
    LintContext,
    Module,
    attr_base_name,
    register,
)
from pinot_tpu_torch.tools.lint.dataflow import (
    ForwardAnalysis,
    build_cfg,
    stmt_scan,
    walk_no_nested,
)
from pinot_tpu_torch.tools.lint.locks import (
    AMBIG_CAP,
    CONTAINER_METHODS,
    _CallGraph,
    _with_locks,
    collect_classes,
)
from pinot_tpu_torch.tools.lint.pairing import _functions
from pinot_tpu_torch.tools.lint.tracer import _enclosing_scope, shared_index

# attribute reads and methods that never sync (host-side metadata of a
# tensor on the card)
METADATA_ATTRS = {"nbytes", "shape", "dtype", "ndim", "size", "itemsize",
                  "bits", "vals_per_word", "device", "numel",
                  "element_size", "is_cuda", "data_ptr", "stride", "dim",
                  "requires_grad", "layout", "is_contiguous"}

# torch entry points that return HOST values or metadata, not tensors on
# the card
NONDEVICE_TORCH = {"device", "dtype", "is_tensor", "is_available",
                   "device_count", "get_device_name", "current_device",
                   "memory_allocated", "max_memory_allocated",
                   "memory_reserved", "memory_stats", "get_device_properties",
                   "reset_peak_memory_stats", "from_numpy", "iinfo", "finfo",
                   "manual_seed", "no_grad", "inference_mode",
                   "set_grad_enabled", "Event", "Stream", "current_stream",
                   "stream", "empty_cache", "get_default_dtype",
                   "synchronize", "Size", "Generator", "mem_get_info"}

# methods whose result is a tensor on the card whatever the receiver
_DEVICE_METHODS = {"to", "cuda"}

# the kernel wrappers: their outputs live on the card
KERNEL_WRAPPERS = {"fused_scan", "fused_scan_probe", "counted_scan",
                   "counted_scan_many", "fused_scan_many",
                   "sharded_fused_scan", "sharded_fused_scan_probe",
                   "sharded_fused_scan_many",
                   "sharded_fused_scan_probe_many"}

_CAST_SINKS = {"float", "int", "bool"}
_METHOD_SINKS = {"item", "tolist", "cpu"}
_NP_SINKS = {"asarray", "array"}


def _is_cuda_synchronize(call: ast.Call) -> bool:
    """``torch.cuda.synchronize(...)``, or ``.synchronize()`` of a CUDA
    stream or event: a sink whatever its argument."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "synchronize"):
        return False
    if isinstance(f.value, ast.Attribute) and f.value.attr == "cuda" \
            and isinstance(f.value.value, ast.Name) \
            and f.value.value.id == "torch":
        return True
    # torch.cuda.current_stream(d).synchronize(), event.synchronize()
    recv = f.value
    return not (isinstance(recv, ast.Name) and recv.id == "self")


class _TaintEngine:
    def __init__(self, ctx: LintContext):
        self.ctx = ctx
        self.idx = shared_index(ctx)
        classes, _ = collect_classes(ctx)
        self.classes = classes
        self.graph = _CallGraph(ctx, classes)
        self.ret_dev: Set[int] = set()

    # -- resolution ---------------------------------------------------------
    def resolve_targets(self, call: ast.Call, mod: Module,
                        scope) -> List[ast.AST]:
        hits: List[ast.AST] = []
        try:
            hit = self.idx.resolve_callable(call.func, mod, scope)
        except Exception:
            hit = None
        if hit is not None:
            hits.append(hit[1])
            return hits
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr not in CONTAINER_METHODS:
            cands = self.graph.methods_by_name.get(f.attr, [])
            if 0 < len(cands) <= AMBIG_CAP:
                hits.extend(fn for _ci, fn in cands)
        return hits

    # -- sources ------------------------------------------------------------
    def is_device_call(self, call: ast.Call, mod: Module) -> bool:
        f = call.func
        if isinstance(f, ast.Attribute):
            if f.attr in _DEVICE_METHODS:
                return True
            if f.attr in NONDEVICE_TORCH:
                return False
            if f.attr in KERNEL_WRAPPERS:
                return True
            base = attr_base_name(f)
            imps = self.idx.imports.get(mod.relpath, {})
            target = imps.get(base or "")
            if target is not None and target.split(".")[0] == "torch":
                return True
            fi = self.idx.from_imports.get(mod.relpath, {}).get(base or "")
            if fi is not None and fi[0].split(".")[0] == "torch":
                return True
            return False
        if isinstance(f, ast.Name):
            if f.id in KERNEL_WRAPPERS:
                return True
            fi = self.idx.from_imports.get(mod.relpath, {}).get(f.id)
            return fi is not None and fi[0].split(".")[0] == "torch" \
                and f.id not in NONDEVICE_TORCH
        return False

    # -- sinks --------------------------------------------------------------
    def sink_kind(self, call: ast.Call, S: FrozenSet[str],
                  mod: Module, scope) -> Optional[str]:
        f = call.func
        if _is_cuda_synchronize(call):
            return "torch.cuda.synchronize()"
        if isinstance(f, ast.Name) and f.id in _CAST_SINKS \
                and len(call.args) == 1 \
                and self.tainted(call.args[0], S, mod, scope):
            return f"{f.id}()"
        if isinstance(f, ast.Attribute):
            if f.attr in _METHOD_SINKS \
                    and self.tainted(f.value, S, mod, scope):
                return f".{f.attr}()"
            if f.attr in _NP_SINKS and call.args:
                base = attr_base_name(f)
                imps = self.idx.imports.get(mod.relpath, {})
                if imps.get(base or "") == "numpy" \
                        and self.tainted(call.args[0], S, mod, scope):
                    return f"np.{f.attr}()"
        return None

    # -- taint of one expression -------------------------------------------
    def tainted(self, e: ast.expr, S: FrozenSet[str],
                mod: Module, scope) -> bool:
        if isinstance(e, ast.Name):
            return e.id in S
        if isinstance(e, ast.Attribute):
            if e.attr in METADATA_ATTRS:
                return False
            return self.tainted(e.value, S, mod, scope)
        if isinstance(e, ast.Subscript):
            return self.tainted(e.value, S, mod, scope)
        if isinstance(e, ast.BinOp):
            return self.tainted(e.left, S, mod, scope) \
                or self.tainted(e.right, S, mod, scope)
        if isinstance(e, ast.UnaryOp):
            return self.tainted(e.operand, S, mod, scope)
        if isinstance(e, ast.BoolOp):
            return any(self.tainted(v, S, mod, scope) for v in e.values)
        if isinstance(e, ast.Compare):
            return self.tainted(e.left, S, mod, scope) \
                or any(self.tainted(c, S, mod, scope)
                       for c in e.comparators)
        if isinstance(e, ast.IfExp):
            return self.tainted(e.body, S, mod, scope) \
                or self.tainted(e.orelse, S, mod, scope)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tainted(x, S, mod, scope) for x in e.elts)
        if isinstance(e, ast.Starred):
            return self.tainted(e.value, S, mod, scope)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            # comprehension scope: coarse subtree scan
            for sub in ast.walk(e):
                if isinstance(sub, ast.Name) and sub.id in S:
                    return True
                if isinstance(sub, ast.Call) \
                        and self.is_device_call(sub, mod):
                    return True
            return False
        if isinstance(e, ast.Call):
            if self.sink_kind(e, S, mod, scope) is not None:
                return False  # sink results are host values
            if self.is_device_call(e, mod):
                return True
            f = e.func
            if isinstance(f, ast.Attribute) \
                    and f.attr not in METADATA_ATTRS \
                    and self.tainted(f.value, S, mod, scope):
                return True
            for t in self.resolve_targets(e, mod, scope):
                if id(t) in self.ret_dev:
                    return True
            return any(self.tainted(a, S, mod, scope) for a in e.args)
        return False

    # -- per-function taint ------------------------------------------------
    def _add_target(self, t: ast.expr, S: Set[str]) -> None:
        if isinstance(t, ast.Name):
            S.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for x in t.elts:
                self._add_target(x, S)
        elif isinstance(t, ast.Starred):
            self._add_target(t.value, S)
        elif isinstance(t, (ast.Subscript, ast.Attribute)):
            base = t
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if isinstance(base, ast.Name) and base.id not in ("self", "cls"):
                S.add(base.id)

    def _stmt_additions(self, st: ast.AST, S: FrozenSet[str],
                        mod: Module, scope) -> Set[str]:
        add: Set[str] = set()
        if isinstance(st, ast.Assign):
            if self.tainted(st.value, S, mod, scope):
                for t in st.targets:
                    self._add_target(t, add)
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            if self.tainted(st.value, S, mod, scope):
                self._add_target(st.target, add)
        elif isinstance(st, ast.AugAssign):
            if self.tainted(st.value, S, mod, scope) \
                    or self.tainted(st.target, S, mod, scope):
                self._add_target(st.target, add)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            if self.tainted(st.iter, S, mod, scope):
                self._add_target(st.target, add)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                if item.optional_vars is not None \
                        and self.tainted(item.context_expr, S, mod, scope):
                    self._add_target(item.optional_vars, add)
        elif isinstance(st, ast.Expr):
            # container mutation with tainted payload: x.append(dev)
            v = st.value
            if isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)\
                    and v.func.attr in ("append", "extend", "insert") \
                    and isinstance(v.func.value, ast.Name) \
                    and any(self.tainted(a, S, mod, scope) for a in v.args):
                add.add(v.func.value.id)
        return add

    def flow_insensitive_taint(self, fn: ast.AST, mod: Module,
                               scope) -> Set[str]:
        S: Set[str] = set()
        body = getattr(fn, "body", [])
        stmts = [n for n in walk_no_nested(fn) if isinstance(n, ast.stmt)]
        for _ in range(4):
            before = len(S)
            for st in stmts:
                S |= self._stmt_additions(st, frozenset(S), mod, scope)
            if len(S) == before:
                break
        return S

    def returns_device(self, fn: ast.AST, mod: Module, scope) -> bool:
        S = frozenset(self.flow_insensitive_taint(fn, mod, scope))
        for node in walk_no_nested(fn):
            if isinstance(node, ast.Return) and node.value is not None \
                    and self.tainted(node.value, S, mod, scope):
                return True
        return False

    def compute_summaries(self, funcs) -> None:
        for _ in range(5):
            changed = False
            for mod, _qual, fn in funcs:
                if id(fn) in self.ret_dev or isinstance(fn, ast.Lambda):
                    continue
                scope = self.idx.scope_of.get(id(fn))
                if self.returns_device(fn, mod, scope):
                    self.ret_dev.add(id(fn))
                    changed = True
            if not changed:
                break


# -- contexts ---------------------------------------------------------------


def _lock_held_functions(eng: _TaintEngine) -> Dict[int, str]:
    """id(fn) -> witness for functions that may execute with a lock held:
    name-resolved from call sites inside ``with self.<lock>`` blocks (and
    from ``*_locked`` methods), closed one more level (depth 2)."""
    out: Dict[int, str] = {}
    owner: Dict[int, Tuple[Any, str]] = {}  # id(fn) -> (ci, relpath)
    for ci in eng.classes:
        for method in ci.methods.values():
            owner[id(method)] = (ci, ci.module.relpath)

    def visit(node, ci, relpath, held):
        if isinstance(node, ast.With):
            new = held | _with_locks(node, ci) if ci is not None else held
            for item in node.items:
                visit(item.context_expr, ci, relpath, held)
            for st in node.body:
                visit(st, ci, relpath, new)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # closures run later; they are their own functions
        if isinstance(node, ast.Call) and held:
            for ci2, fn2 in eng.graph.resolve(node, ci, relpath):
                rp2 = ci2.module.relpath if ci2 is not None else relpath
                out.setdefault(
                    id(fn2),
                    f"called while {ci.name}.{sorted(held)[0]} is held "
                    f"({relpath}:{node.lineno})")
                owner.setdefault(id(fn2), (ci2, rp2))
        for child in ast.iter_child_nodes(node):
            visit(child, ci, relpath, held)

    for ci in eng.classes:
        for name, method in ci.methods.items():
            if name.endswith("_locked"):
                out.setdefault(
                    id(method),
                    f"{ci.name}.{name} runs under the caller's lock "
                    f"(*_locked convention)")
            for st in method.body:
                visit(st, ci, ci.module.relpath, set())

    # one expansion level: callees of lock-held functions
    frontier = list(out.items())
    for fid, witness in frontier:
        info = owner.get(fid)
        if info is None:
            continue
        ci, relpath = info
        fn = next((m for c in eng.classes for m in c.methods.values()
                   if id(m) == fid), None)
        if fn is None:
            continue
        for node in walk_no_nested(fn):
            if isinstance(node, ast.Call):
                for ci2, fn2 in eng.graph.resolve(node, ci, relpath):
                    out.setdefault(id(fn2), witness + " -> transitive")
    return out


def _dispatcher_functions(eng: _TaintEngine) -> Dict[int, str]:
    """id(fn) -> witness for functions reachable from a launcher module's
    ``threading.Thread(target=...)`` dispatcher loop."""
    out: Dict[int, str] = {}
    roots: List[Tuple[Module, ast.AST, str]] = []
    for mod in eng.ctx.modules:
        if "launcher" not in os.path.basename(mod.relpath):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.id if isinstance(f, ast.Name) else \
                (f.attr if isinstance(f, ast.Attribute) else None)
            if name != "Thread":
                continue
            target = next((k.value for k in node.keywords
                           if k.arg == "target"), None)
            if target is None:
                continue
            scope = _enclosing_scope(eng.idx, mod, node)
            try:
                hit = eng.idx.resolve_callable(target, mod, scope)
            except Exception:
                hit = None
            if hit is not None:
                roots.append((hit[0], hit[1],
                              f"dispatcher thread rooted at "
                              f"{mod.relpath}:{node.lineno}"))
    frontier = list(roots)
    while frontier:
        mod, fn, witness = frontier.pop()
        if id(fn) in out:
            continue
        out[id(fn)] = witness
        scope = eng.idx.scope_of.get(id(fn))
        for node in walk_no_nested(fn):
            if isinstance(node, ast.Call):
                for t in eng.resolve_targets(node, mod, scope):
                    if id(t) not in out:
                        tm = eng.idx.mod_of.get(id(t), mod)
                        frontier.append((tm, t, witness))
    return out


_GAUGE_REGISTRARS = {"gauge", "track_gauge"}


def _gauge_call_arg(node: ast.AST) -> Optional[ast.expr]:
    """The callback argument of a ``<registry>.gauge(name, fn)`` /
    ``track_gauge(name, fn)`` registration, else None."""
    if not isinstance(node, ast.Call) or len(node.args) < 2:
        return None
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else \
        (f.id if isinstance(f, ast.Name) else None)
    if name not in _GAUGE_REGISTRARS:
        return None
    return node.args[1]


def _gauge_functions(eng: _TaintEngine) -> Dict[int, str]:
    """id(fn) -> witness for NAMED functions registered as gauge/telemetry
    callbacks — they run on scrape/sampler threads, where a device sink
    stalls every scrape."""
    out: Dict[int, str] = {}
    for mod in eng.ctx.modules:
        for node in ast.walk(mod.tree):
            fnarg = _gauge_call_arg(node)
            if fnarg is None or isinstance(fnarg, ast.Lambda):
                continue
            scope = _enclosing_scope(eng.idx, mod, node)
            try:
                hit = eng.idx.resolve_callable(fnarg, mod, scope)
            except Exception:
                hit = None
            targets: List[ast.AST] = [hit[1]] if hit is not None else []
            if not targets and isinstance(fnarg, ast.Attribute):
                cands = eng.graph.methods_by_name.get(fnarg.attr, [])
                if 0 < len(cands) <= AMBIG_CAP:
                    targets = [fn for _ci, fn in cands]
            for t in targets:
                out.setdefault(
                    id(t),
                    f"registered as a metrics gauge callback "
                    f"({mod.relpath}:{node.lineno}) — runs on scrape "
                    f"threads")
    return out


def _gauge_lambda_findings(eng: _TaintEngine, funcs) -> List[Finding]:
    """Sinks inside gauge-registered LAMBDAS, checked against the
    registering function's flow-insensitive taint set (a lambda closing
    over a device value and materializing it syncs at every scrape)."""
    findings: List[Finding] = []
    seen: Set[str] = set()
    for mod, qual, fn in funcs:
        if isinstance(fn, ast.Lambda):
            continue
        scope = eng.idx.scope_of.get(id(fn))
        lams: List[Tuple[ast.Call, ast.Lambda]] = []
        for node in walk_no_nested(fn):
            fnarg = _gauge_call_arg(node)
            if fnarg is not None and isinstance(fnarg, ast.Lambda):
                lams.append((node, fnarg))
        if not lams:
            continue
        S = frozenset(eng.flow_insensitive_taint(fn, mod, scope))
        for call_node, lam in lams:
            for sub in ast.walk(lam.body):
                if not isinstance(sub, ast.Call):
                    continue
                kind = eng.sink_kind(sub, S, mod, scope)
                if kind is None:
                    continue
                sym = f"{qual}:gauge-lambda:{kind}"
                key = f"{mod.relpath}:{sym}"
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    "sync", mod.relpath, sub.lineno, sym,
                    f"gauge callback registered in {qual}() materializes "
                    f"a device value via {kind} — the sink runs at SCRAPE "
                    f"time, silently stalling every /metrics pull and "
                    f"telemetry sampler tick on device execution"))
    return findings


def _held_map(fn: ast.AST, ci) -> Dict[int, FrozenSet[str]]:
    """ast-node-id -> lock names lexically held there (nested defs reset)."""
    held_at: Dict[int, FrozenSet[str]] = {}

    def visit(node, held: FrozenSet[str]):
        held_at[id(node)] = held
        if isinstance(node, ast.With) and ci is not None:
            inner = held | frozenset(_with_locks(node, ci))
            for item in node.items:
                visit(item.context_expr, held)
            for st in node.body:
                visit(st, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            return  # closure bodies do not inherit the with
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    visit(fn, frozenset())
    return held_at


# -- the checker ------------------------------------------------------------


@register("sync")
def check_sync(ctx: LintContext) -> List[Finding]:
    eng = _TaintEngine(ctx)
    funcs: List[Tuple[Module, str, ast.AST]] = []
    for mod in ctx.modules:
        for qual, fn in _functions(mod.tree):
            funcs.append((mod, qual, fn))
    eng.compute_summaries(funcs)
    lock_ctx = _lock_held_functions(eng)
    thread_ctx = _dispatcher_functions(eng)
    gauge_ctx = _gauge_functions(eng)

    class_of: Dict[int, Any] = {}
    for ci in eng.classes:
        for m in ci.methods.values():
            class_of[id(m)] = ci

    findings: List[Finding] = list(_gauge_lambda_findings(eng, funcs))
    seen: Set[str] = set()
    for mod, qual, fn in funcs:
        ci = class_of.get(id(fn))
        fname = getattr(fn, "name", qual)
        contexts: List[str] = []
        if fname.endswith("_locked"):
            contexts.append("runs under the caller's lock "
                            "(*_locked convention)")
        if id(fn) in lock_ctx:
            contexts.append(lock_ctx[id(fn)])
        if id(fn) in thread_ctx:
            contexts.append(thread_ctx[id(fn)])
        if id(fn) in gauge_ctx:
            contexts.append(gauge_ctx[id(fn)])
        has_with_lock = ci is not None and any(
            isinstance(n, ast.With) and _with_locks(n, ci)
            for n in walk_no_nested(fn))
        if not contexts and not has_with_lock:
            continue

        scope = eng.idx.scope_of.get(id(fn))
        cfg = build_cfg(fn)
        fa = ForwardAnalysis(
            cfg, frozenset(),
            transfer=lambda S, st, nid: (
                S if st is None
                else S | eng._stmt_additions(st, S, mod, scope)),
            join=lambda a, b: a | b)
        inn = fa.run()
        held_at = _held_map(fn, ci)

        for nid, st in enumerate(cfg.stmts):
            if st is None or not isinstance(st, ast.stmt):
                continue
            S = inn.get(nid)
            if S is None:
                continue
            for call in stmt_scan(st):
                if not isinstance(call, ast.Call):
                    continue
                kind = eng.sink_kind(call, S, mod, scope)
                if kind is None:
                    continue
                held = held_at.get(id(call), frozenset())
                why = list(contexts)
                if held:
                    why.insert(0, f"inside `with self.{sorted(held)[0]}`")
                if not why:
                    continue
                sym = f"{qual}:{kind}"
                key = f"{mod.relpath}:{sym}"
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    "sync", mod.relpath, call.lineno, sym,
                    f"{fname}() materializes a device value via {kind} "
                    f"— implicit device sync {why[0]}; the stall convoys "
                    f"every thread behind this position"))
    return findings
