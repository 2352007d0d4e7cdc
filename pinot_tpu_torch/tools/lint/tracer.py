"""Tracer safety: code that torch compiles or captures must stay pure.

A function that ``torch.compile`` or ``torch.jit.script`` compiles, or
the work a ``torch.cuda.graph`` captures, runs its Python once per
compile (or capture); host effects inside it either bake stale values
into the compiled program or replay (``time.*``, ``random.*``, global
reads) or break under concurrent compiles (``threading.*``, global-dict
mutation), and a ``.item()`` forces a graph break or fails inside a
capture.

Roots: the first argument of ``torch.compile`` / ``torch.jit.script`` /
``torch.jit.trace`` calls, defs decorated with ``@torch.compile`` /
``@torch.jit.script``, and the body of every ``with torch.cuda.graph(...)``
block (its calls are roots too). The port uses none of them today, so
over the package the family has no roots; its fixtures show that it
catches a violation. Reachability is a conservative intra-package call
graph: names resolve through enclosing scopes, module globals, ``self.``
methods of the same class, and ``from <package module> import name`` —
unresolved calls (third-party, callbacks) are not followed.

Flagged inside reachable functions:

- calls into the ``time`` / ``threading`` / ``random`` / ``socket`` /
  ``subprocess`` modules (resolved through the module's imports);
- ``open()`` / ``input()``;
- ``.item()`` — a host sync that breaks the graph;
- ``float()/int()/bool()`` directly on a ROOT function's parameter
  (parameters of a compiled root are symbolic by definition);
- mutation of a module-level global (subscript store or mutating method).
"""

from __future__ import annotations

import ast

from typing import Dict, List, Optional, Set, Tuple

from pinot_tpu_torch.tools.lint.core import (
    Finding,
    LintContext,
    Module,
    attr_base_name,
    register,
)

DENY_MODULES = {"time", "threading", "random", "socket", "subprocess"}
DENY_BUILTINS = {"open", "input"}
CAST_BUILTINS = {"float", "int", "bool"}
MUTATORS = {"append", "add", "clear", "pop", "popitem", "update", "extend",
            "remove", "discard", "insert", "setdefault"}

# torch entry points that compile their first argument: the dotted path
# under ``torch``
TRACE_ENTRY_PATHS = {("compile",), ("jit", "script"), ("jit", "trace")}
# context managers whose block torch captures
CAPTURE_PATHS = {("cuda", "graph")}


class _Scope:
    """One function's environment: parent scope + local defs."""

    def __init__(self, mod: Module, node: ast.AST,
                 parent: Optional["_Scope"], cls: Optional[ast.ClassDef]):
        self.mod = mod
        self.node = node
        self.parent = parent
        self.cls = cls
        self.defs: Dict[str, ast.AST] = {}

    def lookup(self, name: str) -> Optional[Tuple[Module, ast.AST,
                                                  "_Scope"]]:
        s: Optional[_Scope] = self
        while s is not None:
            fn = s.defs.get(name)
            if fn is not None:
                return (s.mod, fn, s)
            s = s.parent
        return None


class _Index:
    """Per-module: imports, module-level globals, every function's scope."""

    def __init__(self, ctx: LintContext):
        self.ctx = ctx
        # module alias -> module name ('np' -> 'numpy'), per file
        self.imports: Dict[str, Dict[str, str]] = {}
        # 'from mod import name' -> (module relpath?, source module name)
        self.from_imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self.globals: Dict[str, Set[str]] = {}
        self.scope_of: Dict[int, _Scope] = {}   # id(fn node) -> scope
        self.root_scopes: Dict[str, _Scope] = {}  # relpath -> module scope
        self.mod_of: Dict[int, Module] = {}
        # package-module name ('pinot_tpu_torch.engine.kernels') -> Module
        self.pkg_modules: Dict[str, Module] = {}
        for mod in ctx.modules:
            dotted = mod.relpath[:-3].replace("/", ".").replace("\\", ".")
            self.pkg_modules[dotted] = mod
            if dotted.endswith(".__init__"):
                self.pkg_modules[dotted[:-9]] = mod
        for mod in ctx.modules:
            self._index_module(mod)

    def _index_module(self, mod: Module) -> None:
        imps: Dict[str, str] = {}
        fimps: Dict[str, Tuple[str, str]] = {}
        gnames: Set[str] = set()
        for node in mod.tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    imps[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    fimps[a.asname or a.name] = (node.module, a.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        gnames.add(t.id)
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                gnames.add(node.target.id)
        self.imports[mod.relpath] = imps
        self.from_imports[mod.relpath] = fimps
        self.globals[mod.relpath] = gnames

        root = _Scope(mod, mod.tree, None, None)
        self.root_scopes[mod.relpath] = root
        self._build_scopes(mod, mod.tree, root, None)

    def _build_scopes(self, mod: Module, node: ast.AST, scope: _Scope,
                      cls: Optional[ast.ClassDef]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope.defs[child.name] = child
                sub = _Scope(mod, child, scope, cls)
                self.scope_of[id(child)] = sub
                self.mod_of[id(child)] = mod
                self._build_scopes(mod, child, sub, cls)
            elif isinstance(child, ast.ClassDef):
                csub = _Scope(mod, child, scope, child)
                self._build_scopes(mod, child, csub, child)
            else:
                self._build_scopes(mod, child, scope, cls)

    # -- resolution ---------------------------------------------------------
    def resolve_callable(self, expr: ast.expr, mod: Module,
                         scope: Optional[_Scope]
                         ) -> Optional[Tuple[Module, ast.AST]]:
        if isinstance(expr, ast.Lambda):
            return (mod, expr)
        if isinstance(expr, ast.Name):
            if scope is not None:
                hit = scope.lookup(expr.id)
                if hit is not None:
                    return (hit[0], hit[1])
            src = self.from_imports[mod.relpath].get(expr.id)
            if src is not None:
                smod = self.pkg_modules.get(src[0])
                if smod is not None:
                    for n in smod.tree.body:
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)) \
                                and n.name == src[1]:
                            return (smod, n)
            return None
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                    and scope is not None and scope.cls is not None:
                for n in scope.cls.body:
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) \
                            and n.name == expr.attr:
                        return (mod, n)
        return None

    def torch_path(self, expr: ast.expr, mod: Module
                   ) -> Optional[Tuple[str, ...]]:
        """``torch.jit.script`` -> ("jit", "script") where the chain's root
        names the ``torch`` module (``import torch``, ``from torch import
        jit``), else None."""
        parts: List[str] = []
        while isinstance(expr, ast.Attribute):
            parts.append(expr.attr)
            expr = expr.value
        if not isinstance(expr, ast.Name):
            return None
        parts.reverse()
        target = self.imports[mod.relpath].get(expr.id)
        if target is not None:
            root = target.split(".")
        else:
            fi = self.from_imports[mod.relpath].get(expr.id)
            if fi is None:
                return None
            root = fi[0].split(".") + [fi[1]]
        if root[0] != "torch":
            return None
        return tuple(root[1:] + parts)

    def is_trace_entry(self, call: ast.Call, mod: Module) -> bool:
        return self.torch_path(call.func, mod) in TRACE_ENTRY_PATHS

    def is_capture(self, call: ast.Call, mod: Module) -> bool:
        return self.torch_path(call.func, mod) in CAPTURE_PATHS


def shared_index(ctx: LintContext) -> _Index:
    """The per-run shared import/scope index: building it walks every
    module's AST, and four families need the same one — memoized on the
    context (read-only after construction)."""
    idx = ctx.memo.get("lint.index")
    if idx is None:
        idx = _Index(ctx)
        ctx.memo["lint.index"] = idx
    return idx


def _jit_decorated(fn: ast.AST, mod: Module, idx: _Index) -> bool:
    """``@torch.compile`` / ``@torch.jit.script`` (called or bare)."""
    for dec in getattr(fn, "decorator_list", []):
        d = dec.func if isinstance(dec, ast.Call) else dec
        if idx.torch_path(d, mod) in TRACE_ENTRY_PATHS:
            return True
    return False


@register("tracer")
def check_tracer(ctx: LintContext) -> List[Finding]:
    idx = shared_index(ctx)
    findings: List[Finding] = []

    # -- roots --------------------------------------------------------------
    roots: List[Tuple[Module, ast.AST]] = []
    seen_roots: Set[int] = set()

    def add_root(mod: Module, fn: ast.AST) -> None:
        if id(fn) not in seen_roots:
            seen_roots.add(id(fn))
            roots.append((mod, fn))

    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and _jit_decorated(node, mod, idx):
                add_root(mod, node)
            if isinstance(node, ast.Call) \
                    and idx.is_trace_entry(node, mod) and node.args:
                scope = _enclosing_scope(idx, mod, node)
                hit = idx.resolve_callable(node.args[0], mod, scope)
                if hit is not None:
                    add_root(*hit)
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(it.context_expr, ast.Call)
                    and idx.is_capture(it.context_expr, mod)
                    for it in node.items):
                # the captured block is a root of its own
                block = ast.FunctionDef(
                    name="<cuda graph capture>", args=ast.arguments(
                        posonlyargs=[], args=[], kwonlyargs=[],
                        kw_defaults=[], defaults=[]),
                    body=node.body, decorator_list=[], returns=None,
                    lineno=node.lineno, col_offset=node.col_offset)
                idx.scope_of[id(block)] = _enclosing_scope(idx, mod, node)
                add_root(mod, block)

    # -- reachability -------------------------------------------------------
    reach: List[Tuple[Module, ast.AST]] = []
    visited: Set[int] = set()
    frontier = list(roots)
    while frontier:
        mod, fn = frontier.pop()
        if id(fn) in visited:
            continue
        visited.add(id(fn))
        reach.append((mod, fn))
        scope = idx.scope_of.get(id(fn))
        if scope is None and not isinstance(fn, ast.Lambda):
            scope = _enclosing_scope(idx, mod, fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                hit = idx.resolve_callable(node.func, mod, scope)
                if hit is not None and id(hit[1]) not in visited:
                    frontier.append(hit)

    root_ids = {id(fn) for _m, fn in roots}

    # -- denylist scan ------------------------------------------------------
    for mod, fn in reach:
        name = getattr(fn, "name", "<lambda>")
        params: Set[str] = set()
        args = getattr(fn, "args", None)
        if args is not None:
            params = {a.arg for a in
                      list(args.posonlyargs) + list(args.args)
                      + list(args.kwonlyargs)} - {"self"}
        imps = idx.imports[mod.relpath]
        fimps = idx.from_imports[mod.relpath]
        gnames = idx.globals[mod.relpath]
        for node in ast.walk(fn):
            if not isinstance(node, (ast.Call, ast.Assign, ast.AugAssign,
                                     ast.Delete)):
                continue
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute):
                    base = attr_base_name(f)
                    target = imps.get(base or "", None)
                    if target in DENY_MODULES:
                        findings.append(Finding(
                            "tracer", mod.relpath, node.lineno,
                            f"{name}:{target}.{f.attr}",
                            f"traced function {name}() calls "
                            f"{target}.{f.attr}() — host effect inside a "
                            f"compiled or captured region"))
                    elif f.attr == "item" and not node.args:
                        findings.append(Finding(
                            "tracer", mod.relpath, node.lineno,
                            f"{name}:item",
                            f"traced function {name}() calls .item() — "
                            f"a host sync that breaks the compiled graph"))
                elif isinstance(f, ast.Name):
                    fi = fimps.get(f.id)
                    src_mod = fi[0] if fi else None
                    if f.id in DENY_BUILTINS and f.id not in fimps:
                        findings.append(Finding(
                            "tracer", mod.relpath, node.lineno,
                            f"{name}:{f.id}",
                            f"traced function {name}() calls {f.id}() — "
                            f"I/O inside a compiled or captured region"))
                    elif src_mod in DENY_MODULES or (
                            fi and fi[0].split(".")[0] in DENY_MODULES):
                        findings.append(Finding(
                            "tracer", mod.relpath, node.lineno,
                            f"{name}:{f.id}",
                            f"traced function {name}() calls {f.id}() "
                            f"(from {src_mod}) — host effect inside a "
                            f"traced region"))
                    elif f.id in CAST_BUILTINS and id(fn) in root_ids \
                            and len(node.args) == 1 \
                            and isinstance(node.args[0], ast.Name) \
                            and node.args[0].id in params:
                        findings.append(Finding(
                            "tracer", mod.relpath, node.lineno,
                            f"{name}:{f.id}({node.args[0].id})",
                            f"compiled root {name}() calls {f.id}() on "
                            f"parameter {node.args[0].id!r} — "
                            f"concretizes a symbolic value"))
                # global mutation via method call
                if isinstance(f, ast.Attribute) and f.attr in MUTATORS:
                    base = f.value
                    if isinstance(base, ast.Name) and base.id in gnames:
                        findings.append(Finding(
                            "tracer", mod.relpath, node.lineno,
                            f"{name}:mutate:{base.id}",
                            f"traced function {name}() mutates module "
                            f"global {base.id!r} — unsafe under "
                            f"concurrent tracing"))
            else:  # Assign / AugAssign / Delete: global subscript stores
                targets = node.targets if isinstance(
                    node, (ast.Assign, ast.Delete)) else [node.target]
                for t in targets:
                    tt = t
                    while isinstance(tt, ast.Subscript):
                        tt = tt.value
                    if isinstance(tt, ast.Name) and tt.id in gnames \
                            and isinstance(t, ast.Subscript):
                        findings.append(Finding(
                            "tracer", mod.relpath, node.lineno,
                            f"{name}:mutate:{tt.id}",
                            f"traced function {name}() writes into module "
                            f"global {tt.id!r} — unsafe under concurrent "
                            f"tracing"))
    return findings


def _enclosing_scope(idx: _Index, mod: Module,
                     node: ast.AST) -> Optional[_Scope]:
    """Innermost function scope whose span contains ``node`` (line-based);
    module-level call sites resolve against the module's root scope."""
    best: Optional[_Scope] = None
    best_span = None
    ln = getattr(node, "lineno", None)
    if ln is None:
        return idx.root_scopes.get(mod.relpath)
    for fid, scope in idx.scope_of.items():
        fn = scope.node
        if idx.mod_of.get(fid) is not mod:
            continue
        lo = fn.lineno
        hi = fn.end_lineno or fn.lineno
        if lo <= ln <= hi:
            span = hi - lo
            if best_span is None or span < best_span:
                best, best_span = scope, span
    return best if best is not None else idx.root_scopes.get(mod.relpath)
