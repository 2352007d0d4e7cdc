"""Whole-program thread-topology race analysis.

The serving tier is a fixed cast of long-lived thread *roles*:

- ``request``    — scheduler query workers, pool ``submit()`` tasks, the
                   REST / mock-S3 front ends (``rest-api``, ``mock-s3``),
                   the gRPC servicer (grpc's own pool calls its public
                   methods), and every public API method (callers run it
                   on their own thread);
- ``dispatcher`` — the launcher's loop, one a device or a mesh
                   (``parallel/launcher.py``; serializes every batch
                   launch);
- ``prefetch``   — the residency HBM prefetcher;
- ``sampler``    — the telemetry sampler, heartbeats, controller
                   periodics (time-driven daemons);
- ``seal``       — realtime consumer loops (``consumer-<segment>``) and
                   the seal / commit path;
- ``scrape``     — metrics gauge callbacks (run at /metrics pull and
                   sampler ticks);
- ``writer``     — ingest/replication daemons (kafka sim, stream broker,
                   minion workers, state-replica poller).

The family proves, per ``self.X`` field of every scanned class, that one
of these holds — anything else is a finding:

1. **annotated-guarded** — the field carries ``# guarded-by:`` /
   ``# guarded-by-writes:``; the lock-guard family enforces the lock, so
   this family only certifies the annotation exists;
2. **role-confined** — every (reachable) access runs under one role;
3. **immutable-after-publish** — every non-``__init__`` write lexically
   precedes every thread spawn in its function (``q = Queue()`` then
   ``Thread(target=...).start()``: the spawn is the happens-before
   edge), or the field is never written outside ``__init__``;
4. **lock-consistent** — some one lock is lexically held (``with
   self.<lock>:`` or the ``*_locked`` caller-holds convention) at every
   access;
5. **waived** — the declaration line carries ``# race-ok: <reason>``
   with a reason registered in ``tracing.RACE_OK_REASONS`` (conformance-
   tested like decline codes). A waiver on a field that rules 1-4
   already cover is a *dead annotation* — its own finding — so waivers
   cannot rot in place when the field later gains a lock.

Roles come from the **spawn graph**: every ``threading.Thread(target=
...)`` site (role from the thread's ``name=`` literal prefix, falling
back to the spawning module), every pool/scheduler ``submit()`` whose
first argument resolves to an in-package callable (``request``), and
every ``gauge``/``track_gauge`` registration (``scrape``). Public
methods and module functions seed ``request``. Roles close over the
name-resolved call graph (the ``_Index`` + lock-graph resolution);
functions no role reaches contribute no accesses (dead code cannot
race). A spawn site whose role cannot be mapped is itself a finding —
the role table is total over the package by construction, the same
conformance discipline the decline registry uses.

True positives are fixed in-code with a deterministic regression test,
never baselined; the whole-package gate stays zero-finding on an empty
baseline.
"""

from __future__ import annotations

import ast
import os
import re

from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from pinot_tpu_torch.tools.lint.core import (
    Finding,
    LintContext,
    Module,
    is_self_attr,
    register,
)
from pinot_tpu_torch.tools.lint.dataflow import walk_no_nested
from pinot_tpu_torch.tools.lint.locks import (
    CONTAINER_METHODS,
    ClassInfo,
    _CallGraph,
    _collect_writes,
    _with_locks,
    collect_classes,
    held_helpers,
)
from pinot_tpu_torch.tools.lint.sync import _gauge_call_arg
from pinot_tpu_torch.tools.lint.tracer import _enclosing_scope, shared_index

RACE_OK_RE = re.compile(r"race-ok:\s*(?P<reason>[a-z0-9_]+)")

ROLES = ("request", "dispatcher", "prefetch", "sampler", "seal",
         "scrape", "writer")

# thread-name literal prefix -> role (the ``name=`` kwarg of the Thread
# ctor; f-string names contribute their leading literal). First match
# wins; order longest-prefix-first where prefixes overlap.
THREAD_NAME_ROLES: Tuple[Tuple[str, str], ...] = (
    ("combine-launch", "dispatcher"),
    ("hbm-prefetch", "prefetch"),
    ("telemetry-sampler", "sampler"),
    ("heartbeat", "sampler"),
    ("controller-periodic", "sampler"),
    ("state-replica-poller", "writer"),
    ("consumer-", "seal"),
    ("minion-", "writer"),
    ("kafka-sim", "writer"),
    ("stream-broker", "writer"),
    ("mock-s3", "request"),
    ("rest-api", "request"),
    ("prio-query", "request"),
    ("sewf-query", "request"),
)

# methods of torch tensors, CUDA events and streams whose names a package
# method also has (``event.query()``, ``t.view()``, ``t.tolist()``): on a
# receiver other than ``self`` the bare-name fallback does not resolve
# them, since the receiver is as likely a torch object as the one package
# class that defines the name
TORCH_OBJECT_METHODS = frozenset({
    "add", "any", "cpu", "index", "item", "mean", "nbytes", "put",
    "quantile", "query", "record", "reshape", "select", "size",
    "synchronize", "take", "to", "tolist", "values", "view", "wait",
})

# spawning-module basename substring -> role, for spawn sites whose
# ``name=`` is not a literal (the launcher names its loop self._name;
# scheduler workers are f"{name}-{i}")
MODULE_ROLES: Tuple[Tuple[str, str], ...] = (
    ("launcher", "dispatcher"),
    ("scheduler", "request"),
)

_TRACING_PATH = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    os.pardir, os.pardir, "common", "tracing.py"))


def _registered_race_reasons(ctx: LintContext) -> FrozenSet[str]:
    """``RACE_OK_REASONS`` parsed from common/tracing.py (ast, never
    imported — the lint runs without torch): the scanned
    copy when the run includes one, the installed file otherwise."""
    tree: Optional[ast.AST] = None
    for mod in ctx.modules:
        if mod.relpath.replace(os.sep, "/").endswith("common/tracing.py"):
            tree = mod.tree
            break
    if tree is None:
        try:
            with open(_TRACING_PATH, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=_TRACING_PATH)
        except (OSError, SyntaxError):
            return frozenset()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "RACE_OK_REASONS"
                   for t in node.targets):
            continue
        v = node.value
        if isinstance(v, ast.Call) and v.args:
            v = v.args[0]
        if isinstance(v, (ast.Set, ast.List, ast.Tuple)):
            return frozenset(e.value for e in v.elts
                             if isinstance(e, ast.Constant)
                             and isinstance(e.value, str))
    return frozenset()


def _thread_name_literal(call: ast.Call) -> Optional[str]:
    for kw in call.keywords:
        if kw.arg != "name":
            continue
        v = kw.value
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            return v.value
        if isinstance(v, ast.JoinedStr) and v.values \
                and isinstance(v.values[0], ast.Constant) \
                and isinstance(v.values[0].value, str):
            return v.values[0].value
    return None


def _spawn_role(call: ast.Call, mod: Module) -> Optional[str]:
    name = _thread_name_literal(call)
    if name is not None:
        for prefix, role in THREAD_NAME_ROLES:
            if name.startswith(prefix):
                return role
    base = os.path.basename(mod.relpath)
    for needle, role in MODULE_ROLES:
        if needle in base:
            return role
    return None


class _Access:
    __slots__ = ("qual", "kind", "roles", "held", "line", "exempt",
                 "pre_spawn")

    def __init__(self, qual: str, kind: str, roles: FrozenSet[str],
                 held: FrozenSet[str], line: int, exempt: bool,
                 pre_spawn: bool):
        self.qual = qual
        self.kind = kind
        self.roles = roles
        self.held = held
        self.line = line
        self.exempt = exempt
        self.pre_spawn = pre_spawn


class _Topology:
    """Spawn graph -> per-function role sets -> per-field verdicts."""

    def __init__(self, ctx: LintContext):
        self.ctx = ctx
        self.idx = shared_index(ctx)
        classes, _ = collect_classes(ctx)
        self.classes = classes
        self.graph = _CallGraph(ctx, classes)
        self.roles: Dict[int, Set[str]] = {}       # id(fn) -> role set
        self.spawn_lines: Dict[int, List[int]] = {}  # id(enclosing fn)
        self.findings: List[Finding] = []
        self._callee_memo: Dict[int, List[Tuple[Module, ast.AST]]] = {}
        self._import_memo: Dict[str, FrozenSet[str]] = {}
        self._method_class: Optional[Dict[int, ClassInfo]] = None

    # -- call resolution ----------------------------------------------------
    def _resolve(self, expr: ast.expr, mod: Module,
                 scope) -> Optional[Tuple[Module, ast.AST]]:
        try:
            return self.idx.resolve_callable(expr, mod, scope)
        except Exception:
            return None

    def _callees(self, mod: Module,
                 fn: ast.AST) -> List[Tuple[Module, ast.AST]]:
        got = self._callee_memo.get(id(fn))
        if got is not None:
            return got
        scope = self.idx.scope_of.get(id(fn))
        if scope is None and not isinstance(fn, ast.Lambda):
            scope = _enclosing_scope(self.idx, mod, fn)
        out: List[Tuple[Module, ast.AST]] = []
        for node in walk_no_nested(fn):
            if not isinstance(node, ast.Call):
                continue
            hit = self._resolve(node.func, mod, scope)
            if hit is not None:
                out.append(hit)
                continue
            f = node.func
            # a receiver whose type the source states resolves in that
            # class alone (``self.cluster.query()``)
            rci = self._typed_receiver(f, fn)
            if rci is not None:
                target = self.graph._self_method(rci, f.attr)
                if target is not None:
                    out.append((target[0].module, target[1]))
                continue
            # bare-name fallback only when the method name is UNIQUE in
            # the package: roles are a union, and the lock-graph's
            # AMBIG_CAP=8 smear (fine for may-acquire sets) would stamp
            # a daemon's role onto every class sharing a `merge`/`init`
            if isinstance(f, ast.Attribute) \
                    and f.attr not in CONTAINER_METHODS \
                    and not (f.attr in TORCH_OBJECT_METHODS
                             and not is_self_attr(f)) \
                    and not (isinstance(f.value, ast.Name)
                             and f.value.id in self._imports(mod)):
                cands = self.graph.methods_by_name.get(f.attr, [])
                if len(cands) == 1:
                    out.extend((ci.module, m) for ci, m in cands)
        self._callee_memo[id(fn)] = out
        return out

    def _typed_receiver(self, f: ast.expr, fn: ast.AST
                        ) -> Optional[ClassInfo]:
        """The class of ``f``'s receiver where it is a typed ``self.a.b``
        chain inside a method, else None."""
        if not (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Attribute)):
            return None
        if self._method_class is None:
            self._method_class = {id(m): ci for ci in self.classes
                                  for m in ci.methods.values()}
        ci = self._method_class.get(id(fn))
        if ci is None:
            return None
        t = self.graph.receiver_type(f.value, ci)
        return self.graph.by_class_name.get(t) if t else None

    def _imports(self, mod: Module) -> FrozenSet[str]:
        """Names an ``import x`` / ``import x as y`` binds in ``mod``: a
        call on one (``np.array(...)``) is a module function, never a
        method of a package class."""
        got = self._import_memo.get(mod.relpath)
        if got is None:
            got = frozenset(
                (a.asname or a.name.split(".")[0])
                for node in ast.walk(mod.tree) if isinstance(node, ast.Import)
                for a in node.names)
            self._import_memo[mod.relpath] = got
        return got

    # -- spawn graph --------------------------------------------------------
    def _spawn_qual(self, scope, mod: Module) -> str:
        node = getattr(scope, "node", None)
        return getattr(node, "name", None) or "<module>"

    def collect_roots(self) -> List[Tuple[Module, ast.AST, str]]:
        roots: List[Tuple[Module, ast.AST, str]] = []
        for mod in self.ctx.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                cname = f.id if isinstance(f, ast.Name) else (
                    f.attr if isinstance(f, ast.Attribute) else None)
                if cname == "Thread":
                    target = next((k.value for k in node.keywords
                                   if k.arg == "target"), None)
                    if target is None:
                        continue
                    scope = _enclosing_scope(self.idx, mod, node)
                    qual = self._spawn_qual(scope, mod)
                    role = _spawn_role(node, mod)
                    if role is None:
                        self.findings.append(Finding(
                            "threads", mod.relpath, node.lineno,
                            f"spawn:{qual}:role",
                            f"thread spawned in {qual}() has no role "
                            f"mapping — name its Thread with a prefix "
                            f"from THREAD_NAME_ROLES (or extend the "
                            f"table) so the race analysis knows which "
                            f"role runs the target"))
                        continue
                    hit = self._resolve(target, mod, scope)
                    if hit is None and isinstance(target, ast.Attribute) \
                            and target.attr == "serve_forever":
                        # stdlib HTTP server loop: its in-package
                        # handlers are public do_* methods, which seed
                        # the request role on their own
                        continue
                    if hit is None:
                        self.findings.append(Finding(
                            "threads", mod.relpath, node.lineno,
                            f"spawn:{qual}:target",
                            f"Thread target in {qual}() does not "
                            f"resolve to an in-package function — the "
                            f"{role} role cannot be propagated; use a "
                            f"direct method/def reference"))
                        continue
                    roots.append((hit[0], hit[1], role))
                    if scope is not None:
                        self.spawn_lines.setdefault(
                            id(scope.node), []).append(node.lineno)
                elif cname == "submit" and node.args:
                    scope = _enclosing_scope(self.idx, mod, node)
                    hit = self._resolve(node.args[0], mod, scope)
                    if hit is not None:
                        roots.append((hit[0], hit[1], "request"))
                        if scope is not None:
                            self.spawn_lines.setdefault(
                                id(scope.node), []).append(node.lineno)
                else:
                    fnarg = _gauge_call_arg(node)
                    if fnarg is None:
                        continue
                    scope = _enclosing_scope(self.idx, mod, node)
                    hit = self._resolve(fnarg, mod, scope)
                    if hit is not None:
                        roots.append((hit[0], hit[1], "scrape"))
        return roots

    # -- role propagation ---------------------------------------------------
    def compute_roles(self) -> None:
        pending: List[Tuple[Module, ast.AST]] = []

        def add(mod: Module, fn: ast.AST, roles: Set[str]) -> None:
            cur = self.roles.setdefault(id(fn), set())
            if not roles <= cur:
                cur |= roles
                pending.append((mod, fn))

        for mod in self.ctx.modules:
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and not node.name.startswith("_"):
                    add(mod, node, {"request"})
        for ci in self.classes:
            for name, fn in ci.methods.items():
                if not name.startswith("_") or (
                        name.startswith("__") and name.endswith("__")):
                    add(ci.module, fn, {"request"})
        for mod, fn, role in self.collect_roots():
            add(mod, fn, {role})
        while pending:
            mod, fn = pending.pop()
            roles = set(self.roles[id(fn)])
            for tmod, t in self._callees(mod, fn):
                add(tmod, t, roles)

    # -- access map ---------------------------------------------------------
    def _pre_spawn(self, fn_node: ast.AST, line: int) -> bool:
        spawns = self.spawn_lines.get(id(fn_node))
        return bool(spawns) and line <= min(spawns)

    def _scan_class(self, ci: ClassInfo) -> Tuple[
            Dict[str, List[_Access]], Dict[str, Tuple[str, int]]]:
        accesses: Dict[str, List[_Access]] = {}
        race_ok: Dict[str, Tuple[str, int]] = {}
        for sub in ast.walk(ci.node):
            targets: List[ast.expr] = []
            if isinstance(sub, ast.Assign):
                targets = sub.targets
            elif isinstance(sub, ast.AnnAssign):
                targets = [sub.target]
            else:
                continue
            for t in targets:
                if not is_self_attr(t):
                    continue
                m = ci.module.comment_in_range(
                    sub.lineno, sub.end_lineno or sub.lineno, RACE_OK_RE)
                if m is not None and t.attr not in race_ok:
                    race_ok[t.attr] = (m.group("reason"), sub.lineno)
        # class-body declarations (``x: T = default`` directly under the
        # class) are the other legal waiver site — the analogue of the
        # reference's ``volatile`` on the field declaration itself
        for sub in ci.node.body:
            targets = []
            if isinstance(sub, ast.Assign):
                targets = sub.targets
            elif isinstance(sub, ast.AnnAssign):
                targets = [sub.target]
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                m = ci.module.comment_in_range(
                    sub.lineno, sub.end_lineno or sub.lineno, RACE_OK_RE)
                if m is not None and t.id not in race_ok:
                    race_ok[t.id] = (m.group("reason"), sub.lineno)

        helpers = held_helpers(ci)
        for name, method in ci.methods.items():
            writes = _collect_writes(method)
            exempt0 = name in ("__init__", "__del__")
            roles0 = frozenset(self.roles.get(id(method), ()))
            held0 = frozenset(ci.lock_attrs) \
                if name.endswith("_locked") \
                else helpers.get(name, frozenset())

            def visit(node: ast.AST, fn_node: ast.AST,
                      roles: FrozenSet[str], held: FrozenSet[str],
                      exempt: bool, qual: str) -> None:
                if isinstance(node, ast.With):
                    inner = held | frozenset(_with_locks(node, ci))
                    for item in node.items:
                        visit(item.context_expr, fn_node, roles, held,
                              exempt, qual)
                    for st in node.body:
                        visit(st, fn_node, roles, inner, exempt, qual)
                    return
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    # closures escape the with-block and may run on a
                    # spawned role: reset held locks, switch to the
                    # nested function's own role set when it is rooted
                    nname = getattr(node, "name", "<lambda>")
                    own = self.roles.get(id(node))
                    nroles = frozenset(own) if own else roles
                    nexempt = exempt and not own
                    nheld = frozenset(ci.lock_attrs) \
                        if nname.endswith("_locked") else frozenset()
                    body = node.body if isinstance(node.body, list) \
                        else [node.body]
                    for st in body:
                        visit(st, node, nroles, nheld, nexempt,
                              f"{qual}.{nname}")
                    return
                if isinstance(node, ast.Attribute) and is_self_attr(node):
                    f = node.attr
                    if roles and f not in ci.lock_attrs \
                            and f not in ci.methods:
                        accesses.setdefault(f, []).append(_Access(
                            qual=qual,
                            kind="write" if id(node) in writes
                            else "read",
                            roles=roles, held=held, line=node.lineno,
                            exempt=exempt,
                            pre_spawn=self._pre_spawn(
                                fn_node, node.lineno)))
                for child in ast.iter_child_nodes(node):
                    visit(child, fn_node, roles, held, exempt, qual)

            for stmt in method.body:
                visit(stmt, method, roles0, held0, exempt0,
                      f"{ci.name}.{name}")
        return accesses, race_ok

    # -- verdicts -----------------------------------------------------------
    def _verdict(self, ci: ClassInfo, field: str, accs: List[_Access],
                 race_ok: Dict[str, Tuple[str, int]],
                 registered: FrozenSet[str]) -> None:
        ro = race_ok.get(field)

        def dead(why: str) -> None:
            self.findings.append(Finding(
                "threads", ci.module.relpath, ro[1],
                f"{ci.name}.{field}:race-ok-dead",
                f"stale `# race-ok: {ro[0]}` on {ci.name}.{field}: "
                f"{why} — drop the waiver so it cannot mask a future "
                f"regression"))

        if field in ci.guarded:
            if ro is not None:
                dead("the field is `# guarded-by:` annotated; the lock, "
                     "not the waiver, is the invariant")
            return
        live = [a for a in accs if not a.exempt]
        all_roles: Set[str] = set()
        for a in live:
            all_roles |= a.roles
        if len(all_roles) <= 1:
            if ro is not None:
                only = next(iter(sorted(all_roles)), "no live role")
                dead(f"every access is confined to one role ({only})")
            return
        writes = [a for a in live if a.kind == "write"]
        if all(a.pre_spawn for a in writes):
            if ro is not None:
                dead("immutable after publish — every write precedes "
                     "every spawn in its function (or lives in "
                     "__init__)")
            return
        common: Optional[Set[str]] = None
        for a in live:
            common = set(a.held) if common is None else common & a.held
        if common:
            if ro is not None:
                dead(f"every access already holds "
                     f"self.{sorted(common)[0]}")
            return
        if ro is not None:
            if ro[0] in registered:
                return
            self.findings.append(Finding(
                "threads", ci.module.relpath, ro[1],
                f"{ci.name}.{field}:race-ok-reason",
                f"`# race-ok: {ro[0]}` on {ci.name}.{field} is not a "
                f"registered reason — add it to "
                f"tracing.RACE_OK_REASONS (conformance-tested) or use "
                f"a registered one"))
            return
        w = writes[0] if writes else live[0]
        self.findings.append(Finding(
            "threads", ci.module.relpath, w.line,
            f"{ci.name}.{field}",
            f"{ci.name}.{field} is touched by roles "
            f"{{{', '.join(sorted(all_roles))}}} with no consistent "
            f"lock (witness {w.kind} in {w.qual}(), line {w.line}) — "
            f"guard it, confine it to one role, publish it before "
            f"spawn, or waive it with a registered `# race-ok:` "
            f"reason"))

    # -- run ----------------------------------------------------------------
    def run(self) -> List[Finding]:
        self.compute_roles()
        registered = _registered_race_reasons(self.ctx)
        for ci in self.classes:
            accesses, race_ok = self._scan_class(ci)
            for field in sorted(set(accesses) | set(race_ok)):
                self._verdict(ci, field, accesses.get(field, []),
                              race_ok, registered)
        return self.findings


@register("threads", whole_program=True)
def check_threads(ctx: LintContext) -> List[Finding]:
    return _Topology(ctx).run()
