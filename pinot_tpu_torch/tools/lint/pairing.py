"""Resource pairing: acquire-like calls must release on ALL paths.

Pairs checked (the lease/refcount protocols of the residency manager and
the table data managers):

- ``begin_query`` / ``end_query``       (HBM residency QueryLease)
- ``_begin_lease`` / ``end_query``      (executor wrapper for the above)
- ``acquire_segments`` / ``release_segments``  (segment refcounts)
- ``acquire`` / ``release``             (bare refcount style)
- ``admit`` / ``release``               (admission-gate tickets)

For each function that calls the acquire half:

- if the acquired resource *escapes* (returned, yielded, stored on
  ``self``, or stashed into a container that is itself the function's
  product), local analysis cannot conclude — skipped; the function is a
  resource constructor and its callers are checked instead;
- otherwise a matching release call must exist in the ``finally`` of a
  ``try`` that either encloses the acquire or follows it in the same
  block (``with`` context managers on the resource also count);
- a release that exists but is NOT exception-safe (reachable only on the
  fall-through path) is the classic 8-thread-hang shape and is flagged.

An acquire appended straight to a local list (``tickets.append(
gate.admit(t))``) makes the list the resource: a ``finally`` that loops
over the list and releases each element pairs it (the port's broker
admits every physical table of a hybrid query this way).

Bare ``acquire``/``release`` is checked only when the receiver is a plain
local name — ``self.quota.acquire(table)`` styles (long-lived token
managers with no release half) and threading primitives are excluded.
"""

from __future__ import annotations

import ast

from typing import List, Optional, Set, Tuple

from pinot_tpu_torch.tools.lint.core import (
    Finding,
    LintContext,
    call_name,
    register,
)
from pinot_tpu_torch.tools.lint.locks import collect_classes

PAIRS = [
    ("begin_query", "end_query"),
    ("_begin_lease", "end_query"),
    ("acquire_segments", "release_segments"),
    ("acquire", "release"),
    # admission-gate tickets (server/admission.py): a rejected/errored
    # query must free its slot on every path or the gate convoys shut
    ("admit", "release"),
]
BARE_PAIRS = {"acquire"}  # resource = the receiver, not the return value


def _functions(tree: ast.AST):
    """Every function in the module, with its qualname."""
    out: List[Tuple[str, ast.FunctionDef]] = []

    def rec(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((prefix + child.name, child))
                rec(child, prefix + child.name + ".")
            elif isinstance(child, ast.ClassDef):
                rec(child, prefix + child.name + ".")
            else:
                rec(child, prefix)

    rec(tree, "")
    return out


def _blocks_after(func: ast.AST, target: ast.AST) -> List[ast.Try]:
    """Try statements that can cover ``target``: ancestors whose body holds
    it, plus later siblings in every enclosing statement list."""
    trys: List[ast.Try] = []

    def rec(node: ast.AST) -> bool:
        """True when ``target`` is in this subtree."""
        found = False
        body_lists = [getattr(node, f) for f in ("body", "orelse",
                                                 "finalbody", "handlers")
                      if getattr(node, f, None)]
        flat: List[List[ast.AST]] = []
        for bl in body_lists:
            items = []
            for st in bl:
                items.append(st)
            flat.append(items)
        for stmts in flat:
            hit_idx = None
            for i, st in enumerate(stmts):
                if st is target or rec(st):
                    hit_idx = i
                    found = True
                    break
            if hit_idx is not None:
                for later in stmts[hit_idx:]:
                    if isinstance(later, ast.Try):
                        trys.append(later)
        if found and isinstance(node, ast.Try):
            trys.append(node)
        return found or any(
            target is c for c in ast.walk(node) if c is target)

    rec(func)
    return trys


def _contains_target(node: ast.AST, target: ast.AST) -> bool:
    return any(c is target for c in ast.walk(node))


def _release_in(nodes: List[ast.AST], release: str,
                resource: Optional[str], via_list: bool = False) -> bool:
    if via_list:
        # each element of the list, released by a loop over it
        return any(
            isinstance(sub, ast.For) and isinstance(sub.iter, ast.Name)
            and sub.iter.id == resource and isinstance(sub.target, ast.Name)
            and _release_in(sub.body, release, sub.target.id)
            for n in nodes for sub in ast.walk(n))
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Call) and call_name(sub) == release:
                if resource is None:
                    return True
                names = {a.id for a in ast.walk(sub)
                         if isinstance(a, ast.Name)}
                if resource in names:
                    return True
    return False


def _escapes(func: ast.AST, name: str, release: str) -> bool:
    """Does local ``name`` escape this function (so pairing is the
    caller's job)? Returned/yielded, stored onto an attribute/subscript,
    stashed via a container method, or passed to any call that is not the
    release half."""
    for node in ast.walk(func):
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            v = getattr(node, "value", None)
            if v is not None and any(isinstance(x, ast.Name) and x.id == name
                                     for x in ast.walk(v)):
                return True
        if isinstance(node, ast.Assign):
            if any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in node.targets) \
                    and any(isinstance(x, ast.Name) and x.id == name
                            for x in ast.walk(node.value)):
                return True
        if isinstance(node, ast.Call) and call_name(node) != release:
            for a in node.args:
                if isinstance(a, ast.Name) and a.id == name:
                    return True
            f = node.func  # container stash: out.append(sdm)
            if isinstance(f, ast.Attribute) \
                    and any(isinstance(x, ast.Name) and x.id == name
                            for arg in node.args for x in ast.walk(arg)):
                return True
    return False


@register("pairing")
def check_pairing(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    # threading-primitive attribute names across the scanned classes:
    # their acquire/release is flow control, not a refcount protocol
    classes, _ = collect_classes(ctx)
    lock_attr_names: Set[str] = set()
    for ci in classes:
        lock_attr_names |= ci.lock_attrs

    for mod in ctx.modules:
        for qualname, func in _functions(mod.tree):
            for acquire, release in PAIRS:
                _check_one(mod, qualname, func, acquire, release,
                           lock_attr_names, findings)
    return findings


def _check_one(mod, qualname: str, func: ast.AST, acquire: str,
               release: str, lock_attr_names: Set[str],
               findings: List[Finding]) -> None:
    own_body_funcs = {id(n) for sub in ast.walk(func)
                      if isinstance(sub, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                      and sub is not func
                      for n in ast.walk(sub)}
    for stmt in ast.walk(func):
        if id(stmt) in own_body_funcs:
            continue  # nested defs are their own checked functions
        if not isinstance(stmt, ast.Call) or call_name(stmt) != acquire:
            continue
        via_list = False
        if stmt.func is not None and isinstance(stmt.func, ast.Attribute):
            recv = stmt.func.value
        else:
            recv = None
        if acquire in BARE_PAIRS:
            # only plain-local receivers are checkable refcount handles
            if not isinstance(recv, ast.Name) \
                    or recv.id in lock_attr_names:
                continue
            resource = recv.id
            if _escapes(func, resource, release):
                continue
        else:
            # resource = assignment target of the acquire call, or the
            # local list it is appended to
            resource = _assign_target(func, stmt)
            via_list = False
            if resource is None:
                resource = _appended_to(func, stmt)
                via_list = resource is not None
            if resource is None:
                # bare acquire with a discarded result: nothing can ever
                # release it
                findings.append(Finding(
                    "pairing", mod.relpath, stmt.lineno,
                    f"{qualname}:{acquire}",
                    f"{acquire}() result is discarded — the matching "
                    f"{release}() can never run"))
                continue
            if not via_list and _escapes(func, resource, release):
                continue

        trys = _blocks_after(func, stmt)
        safe = any(_release_in(t.finalbody, release, resource, via_list)
                   for t in trys)
        if not safe and not via_list and _with_manages(func, resource):
            safe = True
        if safe:
            continue
        anywhere = _release_in([func], release, resource, via_list)
        if anywhere:
            findings.append(Finding(
                "pairing", mod.relpath, stmt.lineno,
                f"{qualname}:{acquire}",
                f"{release}({resource}) is not in a `finally` reachable "
                f"from {acquire}() — an exception leaks the resource"))
        else:
            findings.append(Finding(
                "pairing", mod.relpath, stmt.lineno,
                f"{qualname}:{acquire}",
                f"{acquire}() has no matching {release}() on any path "
                f"in {qualname}()"))


def _assign_target(func: ast.AST, call: ast.Call) -> Optional[str]:
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and node.value is call:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                return t.id
        if isinstance(node, ast.withitem) and node.context_expr is call:
            if isinstance(node.optional_vars, ast.Name):
                return node.optional_vars.id
    return None


def _appended_to(func: ast.AST, call: ast.Call) -> Optional[str]:
    """The local list ``call``'s result is appended to (``xs.append(
    call)``, the call its only argument), else None."""
    for node in ast.walk(func):
        if isinstance(node, ast.Call) and call_name(node) == "append" \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and len(node.args) == 1 and node.args[0] is call:
            return node.func.value.id
    return None


def _with_manages(func: ast.AST, resource: str) -> bool:
    for node in ast.walk(func):
        if isinstance(node, ast.With):
            for item in node.items:
                e = item.context_expr
                if isinstance(e, ast.Name) and e.id == resource:
                    return True
                if isinstance(item.optional_vars, ast.Name) \
                        and item.optional_vars.id == resource:
                    return True
    return False
