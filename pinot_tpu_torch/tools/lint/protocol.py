"""Kernel param-protocol verification: plan.py's pack order vs every
``pc.take()`` consumer.

The positional static-param protocol between ``engine/plan.py`` (which
appends runtime arrays to a flat ``params`` list while compiling the spec)
and the cursor consumers (``engine/kernels.py`` ``_emit_filter`` /
``_emit_value`` / the general rung's group epilogue, and
``engine/fused_scan.py`` ``extract_plan``'s nested ``walk`` /
``compile_vexpr``) has no type system: drift produces silently wrong
query results, not a crash. The declared protocol lives in two dict
literals in plan.py — ``_FILTER_PARAMS`` and ``_VALUE_PARAMS`` (params
consumed per spec op) — and this family proves, per op, that both sides
agree with it:

- **pack side** (``protocol`` / append counts): every function that
  appends to a ``params`` list and returns spec tuples is path-executed;
  at each ``return ("<op>", ...)`` the number of ``params.append`` calls
  on that path must equal the table's count for the op.
- **consume side** (take counts): every dispatch-shaped function with
  ``pc.take()`` calls (``op = spec[0]; if op == "eq": ...``) is executed
  once per table op with the op pinned; the takes on surviving paths must
  equal the table count. Paths that ``raise`` decline the op (the fused
  scan extractor's ``_Ineligible``) and are exempt; ``_emit_filter`` and
  ``_emit_value`` are *total* consumers — an op they fail to handle, or a
  branch they handle for an op missing from the table, is drift.
- **group epilogue order**: the pack side's ordered
  ``params.append(strides)`` / ``params.append(...bases...)`` sequence
  must match, in order, every consumer's stride/base-named
  ``... = pc.take()`` assignments (swapping the two takes is the
  classic silent-wrong-results drift).
- **int32 range safety**: narrowing a ``_bases`` element with
  ``.astype(int32)`` *before* the key subtraction wraps i64 graw/gexpr
  offsets — only the ``strat == "gdict"`` branch (dictIds are i32 by
  construction) may cast the base directly.
- **pow2-padding consistency**: every ``_next_pow2`` definition in the
  package must be structurally identical, and a ``_vmapped`` batch cache
  must key on a ``_next_pow2``-padded size (unbounded batch sizes would
  mint unbounded compile variants). The port's launcher has no such
  cache: its query axis is one compiled kernel for any batch size.
- **cursor tails**: a function that builds a ``_ParamCursor`` and takes
  from it must either call ``.finish()`` (the runtime mirror asserting
  full consumption) or hand the cursor to another function.

Built on :mod:`pinot_tpu_torch.tools.lint.dataflow` (DispatchExecutor +
SummaryTable) and :mod:`tracer`'s resolution index. All checks discover
their anchors structurally (by table/function shape, not hardcoded
paths), so fixtures and scratch copies lint the same way the package
does.
"""

from __future__ import annotations

import ast

from typing import Dict, List, Optional, Set, Tuple

from pinot_tpu_torch.tools.lint.core import (
    Finding,
    LintContext,
    Module,
    register,
)
from pinot_tpu_torch.tools.lint.dataflow import (
    DispatchExecutor,
    SummaryTable,
    eval_expr,
    walk_no_nested,
)
from pinot_tpu_torch.tools.lint.pairing import _functions
from pinot_tpu_torch.tools.lint.tracer import shared_index

# ops the spec tree uses structurally (children carry the params)
_STRUCTURAL = {"and", "or", "not"}
# consumers that must handle EVERY op of their table (by function name)
_TOTAL_CONSUMERS = {"_emit_filter": "filter", "_emit_value": "value"}


def _is_take(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "take" and not node.args)


def _param_tables(ctx: LintContext):
    """-> (merged op->count table, filter table, value table, module)."""
    filt: Dict[str, int] = {}
    val: Dict[str, int] = {}
    home: Optional[Module] = None
    for mod in ctx.modules:
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t = node.targets[0]
            if not isinstance(t, ast.Name) \
                    or t.id not in ("_FILTER_PARAMS", "_VALUE_PARAMS") \
                    or not isinstance(node.value, ast.Dict):
                continue
            d: Dict[str, int] = {}
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                        and isinstance(v, ast.Constant) \
                        and isinstance(v.value, int):
                    d[k.value] = v.value
            if t.id == "_FILTER_PARAMS":
                filt.update(d)
                home = home or mod
            else:
                val.update(d)
                home = home or mod
    merged = dict(filt)
    merged.update(val)
    return merged, filt, val, home


class _Resolver:
    """Shared call resolution + take/append summaries over the scan set."""

    def __init__(self, ctx: LintContext):
        self.idx = shared_index(ctx)
        self.take_sums = SummaryTable(self._take_counter_for)

    def _ctx_of(self, fn: ast.AST):
        mod = self.idx.mod_of.get(id(fn))
        scope = self.idx.scope_of.get(id(fn))
        return mod, scope

    def resolve(self, func_expr, mod, scope):
        if mod is None:
            return None
        try:
            return self.idx.resolve_callable(func_expr, mod, scope)
        except Exception:
            return None

    def _take_counter_for(self, fn: ast.AST):
        mod, scope = self._ctx_of(fn)
        cursors = cursor_names(fn)
        return self.take_counter(mod, scope, cursors)

    def take_counter(self, mod, scope, cursors: Set[str]):
        def count(node, env):
            n, unk = 0, False
            for sub in walk_no_nested(node):
                if not isinstance(sub, ast.Call):
                    continue
                if _is_take(sub):
                    n += 1
                    continue
                hit = self.resolve(sub.func, mod, scope)
                if hit is not None:
                    s = self.take_sums.summary(hit[1])
                    if s is None:
                        unk = True
                    else:
                        n += s
                elif any(isinstance(a, ast.Name) and a.id in cursors
                         for a in sub.args):
                    unk = True  # cursor escapes to unresolved code
            return n, unk
        return count

    def append_counter(self, mod, scope):
        def count(node, env):
            n, unk = 0, False
            for sub in walk_no_nested(node):
                if not isinstance(sub, ast.Call):
                    continue
                f = sub.func
                if isinstance(f, ast.Attribute) \
                        and f.attr in ("append", "insert") \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id == "params":
                    n += 1
                    continue
                if any(isinstance(a, ast.Name) and a.id == "params"
                       for a in sub.args):
                    # forwarding the pack list is fine when the callee is
                    # in-package (its own returns are checked); opaque
                    # forwarding makes this path unverifiable
                    if self.resolve(sub.func, mod, scope) is None:
                        unk = True
            return n, unk
        return count


def cursor_names(fn: ast.AST) -> Set[str]:
    """Names that hold a param cursor in ``fn``: receivers of ``.take()``
    and targets of ``_ParamCursor(...)`` assignments."""
    out: Set[str] = set()
    for node in walk_no_nested(fn):
        if _is_take(node) and isinstance(node.func.value, ast.Name):
            out.add(node.func.value.id)
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            f = node.value.func
            name = f.id if isinstance(f, ast.Name) else \
                (f.attr if isinstance(f, ast.Attribute) else None)
            if name == "_ParamCursor":
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _dispatch_param(fn: ast.AST) -> Optional[str]:
    """The parameter P whose ``P[0]`` drives the op dispatch, if any."""
    args = getattr(fn, "args", None)
    if args is None:
        return None
    params = {a.arg for a in list(args.posonlyargs) + list(args.args)}
    for node in walk_no_nested(fn):
        if isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in params \
                and isinstance(node.slice, ast.Constant) \
                and node.slice.value == 0:
            return node.value.id
    return None


def _group_label(name: str) -> Optional[str]:
    n = name.lower()
    if "stride" in n:
        return "strides"
    if "base" in n:
        return "bases"
    return None


def _first_label(expr: ast.expr) -> Optional[str]:
    for node in ast.walk(expr):
        if isinstance(node, ast.Name):
            lbl = _group_label(node.id)
            if lbl:
                return lbl
    return None


@register("protocol")
def check_protocol(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    table, filt, val, home = _param_tables(ctx)
    res = _Resolver(ctx)

    funcs: List[Tuple[Module, str, ast.AST]] = []
    for mod in ctx.modules:
        for qual, fn in _functions(mod.tree):
            funcs.append((mod, qual, fn))

    if table:
        _check_consumers(funcs, table, filt, val, res, findings)
        _check_pack_side(funcs, table, res, findings)
    _check_group_order(funcs, findings)
    _check_bases_narrowing(funcs, findings)
    _check_pow2(ctx, findings)
    _check_cursor_finish(funcs, findings)
    return findings


# -- consume side -----------------------------------------------------------

def _own_stmts(fn: ast.AST) -> List[ast.stmt]:
    return list(getattr(fn, "body", []))


def _check_consumers(funcs, table, filt, val, res: _Resolver, findings):
    for mod, qual, fn in funcs:
        has_take = any(_is_take(n) for n in walk_no_nested(fn))
        if not has_take:
            continue
        p = _dispatch_param(fn)
        if p is None:
            continue
        scope = res.idx.scope_of.get(id(fn))
        counter = res.take_counter(mod, scope, cursor_names(fn))
        name = getattr(fn, "name", "<lambda>")
        total_table = (filt if _TOTAL_CONSUMERS.get(name) == "filter"
                       else val if _TOTAL_CONSUMERS.get(name) == "value"
                       else None)
        for op, expected in sorted(table.items()):
            env: Dict = {("idx0", p): frozenset([op])}
            ex = DispatchExecutor(counter)
            outs = ex.run(_own_stmts(fn), env)
            live = [o for o in outs if o.kind in ("return", "fall")]
            if not live:
                if total_table is not None and op in total_table:
                    findings.append(Finding(
                        "protocol", mod.relpath, fn.lineno,
                        f"{qual}:{op}:unhandled",
                        f"{name}() has no consuming branch for spec op "
                        f"{op!r} declared in the param table — specs "
                        f"carrying it fail or misconsume the cursor"))
                continue
            counts = {o.count for o in live if not o.unknown}
            if counts and counts != {expected}:
                got = "/".join(str(c) for c in sorted(counts))
                findings.append(Finding(
                    "protocol", mod.relpath, fn.lineno,
                    f"{qual}:{op}",
                    f"{name}() consumes {got} param(s) for spec op "
                    f"{op!r}; the declared protocol packs {expected} — "
                    f"pack/unpack drift silently corrupts results"))
        if total_table is not None:
            _check_coverage(mod, qual, fn, p, table, findings)


def _check_coverage(mod, qual, fn, p, table, findings):
    """Ops a total consumer dispatches on must exist in the table (a new
    branch without a table entry breaks the pack-side walkers)."""
    opvars = {("sub", p)}
    names: Set[str] = set()
    for node in walk_no_nested(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Subscript) \
                and isinstance(node.value.value, ast.Name) \
                and node.value.value.id == p \
                and isinstance(node.value.slice, ast.Constant) \
                and node.value.slice.value == 0:
            names.add(node.targets[0].id)
    allowed = set(table) | _STRUCTURAL
    seen: Set[str] = set()
    for node in walk_no_nested(fn):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1 \
                or not isinstance(node.ops[0], (ast.Eq, ast.In)):
            continue
        left = node.left
        is_op = (isinstance(left, ast.Name) and left.id in names) or (
            isinstance(left, ast.Subscript)
            and isinstance(left.value, ast.Name) and left.value.id == p
            and isinstance(left.slice, ast.Constant)
            and left.slice.value == 0)
        if not is_op:
            continue
        comp = node.comparators[0]
        consts = []
        if isinstance(comp, ast.Constant) and isinstance(comp.value, str):
            consts = [comp.value]
        elif isinstance(comp, (ast.Tuple, ast.Set, ast.List)):
            consts = [e.value for e in comp.elts
                      if isinstance(e, ast.Constant)
                      and isinstance(e.value, str)]
        for c in consts:
            if c not in allowed and c not in seen:
                seen.add(c)
                findings.append(Finding(
                    "protocol", mod.relpath, node.lineno,
                    f"{qual}:{c}:untabled",
                    f"{getattr(fn, 'name', qual)}() handles spec op {c!r} "
                    f"that is missing from the param-count table — the "
                    f"pack-side walkers will misindex params for it"))


# -- pack side --------------------------------------------------------------

def _return_tuples(value: ast.expr) -> List[ast.Tuple]:
    if isinstance(value, ast.Tuple):
        return [value]
    if isinstance(value, ast.IfExp):
        return _return_tuples(value.body) + _return_tuples(value.orelse)
    return []


def _check_pack_side(funcs, table, res: _Resolver, findings):
    for mod, qual, fn in funcs:
        has_append = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr in ("append", "insert")
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == "params"
            for n in walk_no_nested(fn))
        if not has_append:
            continue
        returns_specs = any(
            isinstance(n, ast.Return) and n.value is not None
            and _return_tuples(n.value)
            for n in walk_no_nested(fn))
        if not returns_specs:
            continue
        scope = res.idx.scope_of.get(id(fn))
        counter = res.append_counter(mod, scope)
        ex = DispatchExecutor(counter)
        outs = ex.run(_own_stmts(fn), {})
        reported: Set[str] = set()
        for o in outs:
            if o.kind != "return" or o.unknown or o.node is None \
                    or o.node.value is None:
                continue
            for tup in _return_tuples(o.node.value):
                if not tup.elts:
                    continue
                ops = eval_expr(tup.elts[0], o.env)
                if ops is None:
                    continue
                for op in ops:
                    if not isinstance(op, str) or op not in table \
                            or op in reported:
                        continue
                    if o.count != table[op]:
                        reported.add(op)
                        findings.append(Finding(
                            "protocol", mod.relpath, o.node.lineno,
                            f"{qual}:pack:{op}",
                            f"{getattr(fn, 'name', qual)}() appends "
                            f"{o.count} param(s) on a path returning spec "
                            f"op {op!r}; the declared protocol says "
                            f"{table[op]} — consumers will misalign the "
                            f"cursor"))


# -- group epilogue order ---------------------------------------------------

def _pack_group_seq(fn: ast.AST) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for node in walk_no_nested(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)\
                and node.func.attr in ("append", "insert") \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "params" and node.args:
            arg = node.args[-1]
            lbl = _first_label(arg)
            if lbl:
                out.append((lbl, node.lineno))
    return out


def _consume_group_seq(fn: ast.AST) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for node in walk_no_nested(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and any(_is_take(s) for s in ast.walk(node.value)):
            lbl = _group_label(node.targets[0].id)
            if lbl:
                out.append((lbl, node.lineno))
    return out


def _check_group_order(funcs, findings):
    packs = []
    for mod, qual, fn in funcs:
        seq = _pack_group_seq(fn)
        if len({lbl for lbl, _ in seq}) >= 2:
            packs.append((mod, qual, fn, seq))
    if not packs:
        return
    canon = [lbl for lbl, _ in packs[0][3]]
    for mod, qual, fn, seq in packs[1:]:
        if [lbl for lbl, _ in seq] != canon:
            findings.append(Finding(
                "protocol", mod.relpath, seq[0][1],
                f"{qual}:group-pack-order",
                f"{qual}() packs group params as "
                f"{[lbl for lbl, _ in seq]} but {packs[0][1]}() packs "
                f"{canon} — one of them is wrong"))
    for mod, qual, fn in funcs:
        seq = _consume_group_seq(fn)
        if not seq:
            continue
        got = [lbl for lbl, _ in seq]
        if got != canon:
            findings.append(Finding(
                "protocol", mod.relpath, seq[0][1],
                f"{qual}:group-order",
                f"{qual}() consumes group static params as {got} but the "
                f"pack side writes {canon} — reordered/missing pc.take() "
                f"silently mis-keys every grouped result"))


# -- int32 range safety of _bases ------------------------------------------

def _check_bases_narrowing(funcs, findings):
    for mod, qual, fn in funcs:
        bases_vars = {t for t, _ in
                      ((n.targets[0].id, n) for n in walk_no_nested(fn)
                       if isinstance(n, ast.Assign) and len(n.targets) == 1
                       and isinstance(n.targets[0], ast.Name)
                       and any(_is_take(s) for s in ast.walk(n.value)))
                      if _group_label(t) == "bases"}
        if not bases_vars:
            continue

        def scan(node, in_gdict: bool):
            if isinstance(node, ast.If):
                test = node.test
                is_gdict = (isinstance(test, ast.Compare)
                            and len(test.ops) == 1
                            and isinstance(test.ops[0], ast.Eq)
                            and isinstance(test.comparators[0], ast.Constant)
                            and test.comparators[0].value == "gdict")
                for st in node.body:
                    scan(st, in_gdict or is_gdict)
                for st in node.orelse:
                    scan(st, in_gdict)
                return
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "astype" \
                    and isinstance(node.func.value, ast.Subscript) \
                    and isinstance(node.func.value.value, ast.Name) \
                    and node.func.value.value.id in bases_vars \
                    and not in_gdict:
                findings.append(Finding(
                    "protocol", mod.relpath, node.lineno,
                    f"{qual}:bases-narrowing",
                    f"{qual}() narrows a _bases offset with .astype() "
                    f"before the key subtraction outside the gdict "
                    f"branch — i64 graw/gexpr offsets would wrap in "
                    f"int32"))
                return
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef, ast.Lambda)):
                    scan(child, in_gdict)

        for st in getattr(fn, "body", []):
            scan(st, False)


# -- pow2-padding consistency -----------------------------------------------

def _check_pow2(ctx: LintContext, findings):
    defs: List[Tuple[Module, ast.FunctionDef, str]] = []
    for mod in ctx.modules:
        for node in mod.tree.body:
            if isinstance(node, ast.FunctionDef) \
                    and node.name == "_next_pow2":
                dump = ast.dump(ast.Module(body=node.body, type_ignores=[]))
                defs.append((mod, node, dump))
    if len({d for _, _, d in defs}) > 1:
        first = defs[0][2]
        for mod, node, dump in defs[1:]:
            if dump != first:
                findings.append(Finding(
                    "protocol", mod.relpath, node.lineno,
                    "_next_pow2:drift",
                    f"_next_pow2 in {mod.relpath} differs from "
                    f"{defs[0][0].relpath} — plan padding and launcher "
                    f"batch padding must round identically or vmapped "
                    f"coalescing misaligns"))
    # the vmapped kernel cache must key on pow2-padded sizes
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            touches = any(
                (isinstance(s, ast.Subscript)
                 and isinstance(s.value, ast.Attribute)
                 and s.value.attr == "_vmapped")
                or (isinstance(s, ast.Call)
                    and isinstance(s.func, ast.Attribute)
                    and s.func.attr in ("get", "setdefault")
                    and isinstance(s.func.value, ast.Attribute)
                    and s.func.value.attr == "_vmapped")
                for s in ast.walk(node))
            if not touches:
                continue
            calls_pow2 = any(
                isinstance(s, ast.Call) and (
                    (isinstance(s.func, ast.Name)
                     and s.func.id == "_next_pow2")
                    or (isinstance(s.func, ast.Attribute)
                        and s.func.attr == "_next_pow2"))
                for s in ast.walk(node))
            if not calls_pow2:
                findings.append(Finding(
                    "protocol", mod.relpath, node.lineno,
                    f"{node.name}:vmapped-pow2",
                    f"{node.name}() keys the _vmapped batch cache without "
                    f"_next_pow2 padding — unpadded sizes mint unbounded "
                    f"compile variants"))


# -- cursor tails -----------------------------------------------------------

def _check_cursor_finish(funcs, findings):
    for mod, qual, fn in funcs:
        makes_cursor = False
        cursor_vars: Set[str] = set()
        for node in walk_no_nested(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                f = node.value.func
                name = f.id if isinstance(f, ast.Name) else \
                    (f.attr if isinstance(f, ast.Attribute) else None)
                if name == "_ParamCursor":
                    makes_cursor = True
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            cursor_vars.add(t.id)
        if not makes_cursor:
            continue
        has_take = any(_is_take(n) for n in walk_no_nested(fn))
        if not has_take:
            continue
        finished = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "finish"
            for n in walk_no_nested(fn))
        escapes = any(
            isinstance(n, ast.Call) and not _is_take(n)
            and any(isinstance(a, ast.Name) and a.id in cursor_vars
                    for a in n.args)
            for n in walk_no_nested(fn))
        if not finished and not escapes:
            findings.append(Finding(
                "protocol", mod.relpath, fn.lineno,
                f"{qual}:unfinished-cursor",
                f"{qual}() builds a _ParamCursor and takes from it but "
                f"never asserts full consumption (.finish()) — an "
                f"unconsumed tail means pack/unpack drift goes unnoticed"))
