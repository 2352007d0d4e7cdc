"""Lock discipline: ``# guarded-by:`` fields + the lock-order graph.

Convention (documented in README "Invariants & lint"):

- A field whose every access must hold a lock is annotated on its
  ``__init__`` assignment line::

      self._entries = OrderedDict()   # guarded-by: _lock

  ``# guarded-by-writes: _lock`` guards mutations only (for fields whose
  reads are deliberately lock-free — atomic dict gets under the GIL).
- The named lock must be a ``threading.Lock/RLock/Condition/Semaphore``
  attribute of the same class; accesses count as guarded inside a
  ``with self.<lock>:`` block in the same method.
- Methods named ``*_locked`` assert "caller holds the lock" and are exempt
  (the call-site discipline covers them); ``__init__``/``__del__`` are
  exempt (no concurrent access during construction/teardown).
- A private helper (``_name``, not a dunder) that the class only ever
  calls as ``self._name(...)``, and always while holding a lock (inside
  ``with self.<lock>:``, from a ``*_locked`` method, or from another such
  helper), holds that lock for its whole body: the port's idiom for the
  caller-holds convention without the ``_locked`` suffix. One call
  outside the lock, or any other reference (a callback), drops it.
- Nested ``def``/``lambda`` bodies do NOT inherit the enclosing ``with``:
  closures escape (metric gauge lambdas run on scrape threads).

The lock-order pass builds a cross-module acquisition graph: while holding
lock A, any reachable acquisition of lock B (direct nesting, or through a
name-resolved call chain up to depth 2) adds edge A->B. Only *inversions*
(both A->B and B->A present) are findings — edges themselves are the
design.

Calls resolve through the receiver's type where the source states it: a
``self.<attr>`` chain whose attributes are typed by an annotation
(``self.x: T``, a class-body ``x: T``, a ``@property`` returning ``T``),
by an annotated ``__init__`` parameter assigned to them, or by a
constructor call (``self.x = T(...)``). ``self.segment.metadata.column()``
then reaches ``SegmentMetadata.column`` only, not every class with a
``column`` method. A receiver of unknown type falls back to the bare
method name.
"""

from __future__ import annotations

import ast
import re

from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from pinot_tpu_torch.tools.lint.core import (
    Finding,
    LintContext,
    Module,
    is_self_attr,
    register,
)

GUARD_RE = re.compile(
    r"guarded-by(?P<writes>-writes)?:\s*(?P<lock>[A-Za-z_][A-Za-z0-9_]*)")

LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore"}

# dict/list/set/deque methods that mutate their receiver in place:
# ``self.field.pop(...)`` is a WRITE to the guarded structure
MUTATORS = {"append", "appendleft", "add", "clear", "discard", "extend",
            "extendleft", "insert", "move_to_end", "pop", "popitem",
            "popleft", "remove", "reverse", "setdefault", "sort", "update"}

# resolving ``obj.m(...)`` by bare method name across the package: names
# defined in more classes than this are too ambiguous to chase (noise)
AMBIG_CAP = 8

# never bare-name-resolve these: they are overwhelmingly builtin container
# operations (``self._cache.clear()`` must not resolve to SomeClass.clear)
CONTAINER_METHODS = MUTATORS | {"get", "keys", "values", "items", "copy",
                                "join", "put", "wait", "notify",
                                "notify_all", "acquire", "release_lock",
                                "set", "count", "index"}

CALL_DEPTH = 2


class ClassInfo:
    def __init__(self, module: Module, node: ast.ClassDef):
        self.module = module
        self.node = node
        self.name = node.name
        self.lock_attrs: Set[str] = set()
        # field -> (lock attr, writes_only, decl line)
        self.guarded: Dict[str, Tuple[str, bool, int]] = {}
        self.methods: Dict[str, ast.FunctionDef] = {
            n.name: n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.base_names = [b.id for b in node.bases
                           if isinstance(b, ast.Name)]


def _is_lock_factory(value: ast.expr) -> bool:
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    name = f.attr if isinstance(f, ast.Attribute) else \
        (f.id if isinstance(f, ast.Name) else None)
    return name in LOCK_FACTORIES


def collect_classes(ctx: LintContext) -> Tuple[List[ClassInfo], List[Finding]]:
    cached = ctx.memo.get("lint.classes")
    if cached is not None:
        classes, findings = cached
        return classes, list(findings)
    classes: List[ClassInfo] = []
    findings: List[Finding] = []
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            ci = ClassInfo(mod, node)
            for sub in ast.walk(node):
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
                    if _is_lock_factory(getattr(sub, "value", None)):
                        ci.lock_attrs.add(t.attr)
                    m = mod.comment_in_range(
                        sub.lineno, sub.end_lineno or sub.lineno, GUARD_RE)
                    if m is not None:
                        ci.guarded[t.attr] = (m.group("lock"),
                                              bool(m.group("writes")),
                                              sub.lineno)
            if ci.lock_attrs or ci.guarded:
                classes.append(ci)
            elif ci.methods:
                classes.append(ci)  # still needed for call resolution
    _inherit_lock_attrs(classes)
    for ci in classes:
        for field, (lock, _w, line) in ci.guarded.items():
            if lock not in ci.lock_attrs:
                findings.append(Finding(
                    "lock-guard", ci.module.relpath, line,
                    f"{ci.name}.{field}:annotation",
                    f"guarded-by names {lock!r}, which is not a "
                    f"threading lock attribute of {ci.name}"))
    # memoized per context: four+ families build this same table; the
    # findings are stored immutably (callers extend the returned list)
    ctx.memo["lint.classes"] = (classes, tuple(findings))
    return classes, findings


def _inherit_lock_attrs(classes: List[ClassInfo]) -> None:
    """A subclass guards fields with locks its base's ``__init__`` created
    (``super().__init__()`` runs first); union lock_attrs down the
    name-resolved base chain (fixpoint over the scanned set)."""
    by_name = {c.name: c for c in classes}
    changed = True
    while changed:
        changed = False
        for ci in classes:
            for b in ci.base_names:
                base = by_name.get(b)
                if base is not None and not base.lock_attrs <= ci.lock_attrs:
                    ci.lock_attrs |= base.lock_attrs
                    changed = True


# -- write detection --------------------------------------------------------

def _base_self_attr(node: ast.expr) -> Optional[ast.Attribute]:
    """The ``self.X`` at the bottom of a subscript/attribute chain."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and is_self_attr(node):
        return node
    return None


def _collect_writes(func: ast.AST) -> Set[int]:
    """ids of ``self.X`` Attribute nodes that are writes: direct stores,
    subscript stores/deletes bottoming at the field, mutator-method calls."""
    writes: Set[int] = set()

    def mark_target(t: ast.expr) -> None:
        if is_self_attr(t):
            writes.add(id(t))
            return
        base = _base_self_attr(t)
        if base is not None:
            writes.add(id(base))
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                mark_target(e)

    for node in ast.walk(func):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                mark_target(t)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            mark_target(node.target)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                mark_target(t)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in MUTATORS:
            base = node.func.value
            if is_self_attr(base):
                writes.add(id(base))
            else:
                b = _base_self_attr(base)
                if b is not None:
                    writes.add(id(b))
    return writes


# -- guard traversal --------------------------------------------------------

def _with_locks(node: ast.With, ci: ClassInfo) -> Set[str]:
    got: Set[str] = set()
    for item in node.items:
        e = item.context_expr
        if is_self_attr(e) and e.attr in ci.lock_attrs:
            got.add(e.attr)
    return got


def held_helpers(ci: ClassInfo) -> Dict[str, FrozenSet[str]]:
    """Private helper -> the locks every one of its in-class call sites
    holds (see the module doc); helpers with no such lock are absent.
    A fixpoint: a call from a helper counts with the helper's own locks."""
    cands = {n for n in ci.methods
             if n.startswith("_") and not n.startswith("__")
             and not n.endswith("_locked")}
    if not cands or not ci.lock_attrs:
        return {}
    # every reference self.<helper>, with the locks held at it
    sites: Dict[str, List[Tuple[str, FrozenSet[str]]]] = {
        n: [] for n in cands}
    escaped: Set[str] = set()
    for mname, method in ci.methods.items():
        base = frozenset(ci.lock_attrs) if mname.endswith("_locked") \
            else frozenset()

        def visit(node: ast.AST, held: FrozenSet[str],
                  parent: Optional[ast.AST]) -> None:
            if isinstance(node, ast.With):
                inner = held | frozenset(_with_locks(node, ci))
                for item in node.items:
                    visit(item.context_expr, held, node)
                for st in node.body:
                    visit(st, inner, node)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                body = node.body if isinstance(node.body, list) \
                    else [node.body]
                for st in body:
                    visit(st, frozenset(), node)
                return
            if isinstance(node, ast.Attribute) and is_self_attr(node) \
                    and node.attr in cands:
                if isinstance(parent, ast.Call) and parent.func is node:
                    sites[node.attr].append((mname, held))
                else:
                    escaped.add(node.attr)
            for child in ast.iter_child_nodes(node):
                visit(child, held, node)

        for st in method.body:
            visit(st, base, method)
    out: Dict[str, FrozenSet[str]] = {}
    changed = True
    while changed:
        changed = False
        for n in cands - escaped:
            if not sites[n]:
                continue
            common: Optional[FrozenSet[str]] = None
            for caller, held in sites[n]:
                h = held | out.get(caller, frozenset())
                common = h if common is None else common & h
            if common and out.get(n) != common:
                out[n] = common
                changed = True
    return out


def _check_method(ci: ClassInfo, method: ast.FunctionDef,
                  findings: List[Finding],
                  held0: FrozenSet[str] = frozenset()) -> None:
    writes = _collect_writes(method)
    seen: Set[Tuple[str, str]] = set()  # (field, kind) dedup per method

    def visit(node: ast.AST, held: Set[str]) -> None:
        if isinstance(node, ast.With):
            inner = held | _with_locks(node, ci)
            for item in node.items:
                visit(item.context_expr, held)
            for stmt in node.body:
                visit(stmt, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # closures escape the with-block; nothing is held at call time
            name = getattr(node, "name", "<lambda>")
            inner: Set[str] = set(ci.lock_attrs) \
                if name.endswith("_locked") else set()
            body = node.body if isinstance(node.body, list) else [node.body]
            for stmt in body:
                visit(stmt, inner)
            return
        if isinstance(node, ast.Attribute) and is_self_attr(node) \
                and node.attr in ci.guarded:
            lock, writes_only, _ = ci.guarded[node.attr]
            is_write = id(node) in writes
            if (is_write or not writes_only) and lock not in held:
                kind = "write" if is_write else "read"
                if (node.attr, kind) not in seen:
                    seen.add((node.attr, kind))
                    findings.append(Finding(
                        "lock-guard", ci.module.relpath, node.lineno,
                        f"{ci.name}.{node.attr}:{method.name}",
                        f"{kind} of {ci.name}.{node.attr} outside "
                        f"`with self.{lock}` in {method.name}()"))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in method.body:
        visit(stmt, set(held0))


@register("lock-guard")
def check_lock_guard(ctx: LintContext) -> List[Finding]:
    classes, findings = collect_classes(ctx)
    for ci in classes:
        if not ci.guarded:
            continue
        helpers = held_helpers(ci)
        for name, method in ci.methods.items():
            if name in ("__init__", "__del__") or name.endswith("_locked"):
                continue
            _check_method(ci, method, findings,
                          helpers.get(name, frozenset()))
    return findings


# -- lock-order graph -------------------------------------------------------

class _CallGraph:
    """Name-based, conservative call resolution across the scanned files."""

    def __init__(self, ctx: LintContext, classes: List[ClassInfo]):
        self.classes = classes
        self.by_class_name: Dict[str, ClassInfo] = {c.name: c
                                                    for c in classes}
        self.methods_by_name: Dict[str, List[Tuple[ClassInfo,
                                                   ast.FunctionDef]]] = {}
        for ci in classes:
            for name, fn in ci.methods.items():
                self.methods_by_name.setdefault(name, []).append((ci, fn))
        self.module_funcs: Dict[Tuple[str, str], ast.FunctionDef] = {}
        for mod in ctx.modules:
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.module_funcs[(mod.relpath, node.name)] = node
        self._acq_memo: Dict[Tuple[int, int], Set[str]] = {}
        self.class_names: Set[str] = {
            n.name for mod in ctx.modules for n in ast.walk(mod.tree)
            if isinstance(n, ast.ClassDef)}
        self.attr_types: Dict[Tuple[str, str], Optional[str]] = {}
        for ci in classes:
            self._collect_attr_types(ci)

    # -- receiver types ----------------------------------------------------
    def _type_name(self, ann: Optional[ast.expr]) -> Optional[str]:
        """The scanned class an annotation names (``T``, ``m.T``,
        ``Optional[T]``, ``"T"``), else None."""
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            name = ann.value.rsplit(".", 1)[-1]
        elif isinstance(ann, ast.Name):
            name = ann.id
        elif isinstance(ann, ast.Attribute):
            name = ann.attr
        elif isinstance(ann, ast.Subscript) \
                and isinstance(ann.value, ast.Name) \
                and ann.value.id == "Optional":
            return self._type_name(ann.slice)
        else:
            return None
        return name if name in self.class_names else None

    def _note_type(self, cls: str, attr: str, t: Optional[str]) -> None:
        key = (cls, attr)
        if t is None:
            return
        if key in self.attr_types and self.attr_types[key] != t:
            self.attr_types[key] = None     # conflicting: unknown
        else:
            self.attr_types[key] = t

    def _collect_attr_types(self, ci: ClassInfo) -> None:
        for sub in ci.node.body:
            if isinstance(sub, ast.AnnAssign) \
                    and isinstance(sub.target, ast.Name):
                self._note_type(ci.name, sub.target.id,
                                self._type_name(sub.annotation))
        for name, fn in ci.methods.items():
            if any(isinstance(d, ast.Name) and d.id == "property"
                   for d in fn.decorator_list):
                self._note_type(ci.name, name, self._type_name(fn.returns))
                continue
            params = {a.arg: self._type_name(a.annotation)
                      for a in fn.args.args + fn.args.kwonlyargs}
            for node in ast.walk(fn):
                if isinstance(node, ast.AnnAssign) \
                        and is_self_attr(node.target):
                    self._note_type(ci.name, node.target.attr,
                                    self._type_name(node.annotation))
                elif isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and is_self_attr(node.targets[0]):
                    v = node.value
                    t = None
                    if isinstance(v, ast.Name):
                        t = params.get(v.id)
                    elif isinstance(v, ast.Call) \
                            and isinstance(v.func, ast.Name) \
                            and v.func.id in self.class_names:
                        t = v.func.id
                    self._note_type(ci.name, node.targets[0].attr, t)

    def _attr_type(self, ci: ClassInfo, attr: str) -> Optional[str]:
        seen = set()
        cur: Optional[ClassInfo] = ci
        while cur is not None and cur.name not in seen:
            seen.add(cur.name)
            t = self.attr_types.get((cur.name, attr))
            if t is not None:
                return t
            cur = next((self.by_class_name[b] for b in cur.base_names
                        if b in self.by_class_name), None)
        return None

    def receiver_type(self, expr: ast.expr,
                      ci: Optional[ClassInfo]) -> Optional[str]:
        """The class name a ``self.a.b`` receiver is typed as, else None."""
        if isinstance(expr, ast.Name) and expr.id == "self" \
                and ci is not None:
            return ci.name
        if isinstance(expr, ast.Attribute):
            base = self.receiver_type(expr.value, ci)
            bci = self.by_class_name.get(base) if base else None
            if bci is not None:
                return self._attr_type(bci, expr.attr)
        return None

    def resolve(self, call: ast.Call, ci: Optional[ClassInfo],
                relpath: str) -> List[Tuple[Optional[ClassInfo], ast.AST]]:
        f = call.func
        out: List[Tuple[Optional[ClassInfo], ast.AST]] = []
        if isinstance(f, ast.Name):
            fn = self.module_funcs.get((relpath, f.id))
            if fn is not None:
                out.append((None, fn))
            return out
        if not isinstance(f, ast.Attribute):
            return out
        if isinstance(f.value, ast.Name) and f.value.id == "self" \
                and ci is not None:
            target = self._self_method(ci, f.attr)
            if target is not None:
                out.append(target)
                return out
        rtype = self.receiver_type(f.value, ci) \
            if isinstance(f.value, ast.Attribute) else None
        if rtype is not None:
            rci = self.by_class_name.get(rtype)
            target = self._self_method(rci, f.attr) if rci else None
            if target is not None:
                out.append(target)
            return out
        if f.attr in CONTAINER_METHODS:
            return out
        cands = self.methods_by_name.get(f.attr, [])
        if 0 < len(cands) <= AMBIG_CAP:
            out.extend(cands)
        fn = self.module_funcs.get((relpath, f.attr))
        if fn is not None:
            out.append((None, fn))
        return out

    def _self_method(self, ci: ClassInfo, name: str
                     ) -> Optional[Tuple[ClassInfo, ast.AST]]:
        seen = set()
        cur: Optional[ClassInfo] = ci
        while cur is not None and cur.name not in seen:
            seen.add(cur.name)
            if name in cur.methods:
                return (cur, cur.methods[name])
            cur = next((self.by_class_name[b] for b in cur.base_names
                        if b in self.by_class_name), None)
        return None

    def acquired(self, ci: Optional[ClassInfo], fn: ast.AST,
                 depth: int, relpath: str) -> Set[str]:
        """Locks (``Class.attr``) this function may acquire, following
        name-resolved calls up to ``depth`` levels."""
        memo_key = (id(fn), depth)
        got = self._acq_memo.get(memo_key)
        if got is not None:
            return got
        self._acq_memo[memo_key] = set()  # cycle guard
        out: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.With) and ci is not None:
                for a in _with_locks(node, ci):
                    out.add(f"{ci.name}.{a}")
            if depth > 0 and isinstance(node, ast.Call):
                for ci2, fn2 in self.resolve(node, ci, relpath):
                    rp2 = ci2.module.relpath if ci2 is not None else relpath
                    out |= self.acquired(ci2, fn2, depth - 1, rp2)
        self._acq_memo[memo_key] = out
        return out


@register("lock-order")
def check_lock_order(ctx: LintContext) -> List[Finding]:
    classes, _ = collect_classes(ctx)
    graph = _CallGraph(ctx, classes)
    # (A, B) -> first witness "path:line"
    edges: Dict[Tuple[str, str], str] = {}

    def walk(node: ast.AST, ci: Optional[ClassInfo], relpath: str,
             held: Set[str]) -> None:
        if isinstance(node, ast.With):
            new = {f"{ci.name}.{a}" for a in _with_locks(node, ci)} \
                if ci is not None else set()
            for L in held:
                for M in new:
                    if L != M:
                        edges.setdefault((L, M), f"{relpath}:{node.lineno}")
            for item in node.items:
                walk(item.context_expr, ci, relpath, held)
            for stmt in node.body:
                walk(stmt, ci, relpath, held | new)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            body = node.body if isinstance(node.body, list) else [node.body]
            for stmt in body:
                walk(stmt, ci, relpath, set())
            return
        if isinstance(node, ast.Call) and held:
            for ci2, fn2 in graph.resolve(node, ci, relpath):
                rp2 = ci2.module.relpath if ci2 is not None else relpath
                for M in graph.acquired(ci2, fn2, CALL_DEPTH, rp2):
                    for L in held:
                        if L != M:
                            edges.setdefault(
                                (L, M), f"{relpath}:{node.lineno}")
        for child in ast.iter_child_nodes(node):
            walk(child, ci, relpath, held)

    for ci in classes:
        for method in ci.methods.values():
            for stmt in method.body:
                walk(stmt, ci, ci.module.relpath, set())
    for (rel, name), fn in graph.module_funcs.items():
        for stmt in fn.body:
            walk(stmt, None, rel, set())

    findings: List[Finding] = []
    reported: Set[Tuple[str, str]] = set()
    for (a, b), w1 in sorted(edges.items()):
        if (b, a) in edges and (b, a) not in reported:
            reported.add((a, b))
            w2 = edges[(b, a)]
            path, line = w1.rsplit(":", 1)
            findings.append(Finding(
                "lock-order", path, int(line),
                "<->".join(sorted((a, b))),
                f"lock-order inversion: {a} -> {b} at {w1} but "
                f"{b} -> {a} at {w2} (potential deadlock)"))
    return findings
