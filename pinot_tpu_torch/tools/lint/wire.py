"""Schema/config consistency: string-level drift catchers.

``wire``: every public field of the ``QueryStats`` dataclass must

- be referenced (``self.<field>``) in ``QueryStats.to_dict`` — the wire
  serialization both framings share,
- be referenced (``other.<field>``) in ``QueryStats.merge`` — the
  cross-segment/shard/server combine,
- appear as a keyword in ``DataTable._stats_from_dict`` — the decode side,

so "added a stat, forgot the wire" fails lint instead of silently dropping
the stat at the first broker hop. The port's forms count: a loop over a
tuple of field-name literals, or over a module-level table of
``(field, wire key)`` pairs (``WIRE_COUNTERS``), that reads or sets each
field with ``getattr`` / ``setattr`` references every name it lists; a
``self.<method>()`` call from ``to_dict`` / ``merge`` brings that method's
references in; and ``QueryStats.from_dict`` (keywords of ``cls(...)`` and
the table loops) is a decode side like ``_stats_from_dict``. The launcher's ``LAUNCH_MAX_KEYS``
(merge-by-max stat keys) must each appear as a literal inside
``QueryStats.merge`` — the two modules encode the same semantics — unless
``merge`` (or a function of its module it calls) reads
``LAUNCH_MAX_KEYS`` itself, so that the two cannot disagree.

``config``: every ``pinot.server.*`` / ``pinot.broker.*`` string literal
anywhere in the scanned tree must be a declared constant value in
``CommonConstants`` (spi/config.py) — undeclared keys are typo'd or
undocumented knobs.

``wire`` also carries the COLUMN-KIND dispatch obligation: the DataTable
wire (common/datatable.py) assigns one ``_COL_<KIND> = <int>`` ordinal
per column kind, and

- ``_encode_column`` and ``_decode_column`` must each reference EVERY
  kind (a new kind must update both sides of the wire),
- any function/method anywhere in the scanned tree that dispatches on
  kinds (references two or more ``_COL_*`` int constants — the
  ``columns()`` consumers' dispatch shape) must reference ALL of them,
  so a new kind cannot silently fall through a partial dispatch.

Non-int ``_COL_*`` assignments (tuples like ``_COL_NUMERIC``) are kind
GROUPS, not kinds — helpers built on them don't count as dispatchers.

All passes no-op when the anchor class/function isn't in the scanned
file set (fixture runs), so they stay usable on arbitrary paths.
"""

from __future__ import annotations

import ast
import re

from typing import Dict, List, Optional, Set, Tuple

from pinot_tpu_torch.tools.lint.core import (
    Finding,
    LintContext,
    Module,
    register,
)

CONFIG_KEY_RE = re.compile(r"^pinot\.(server|broker)\.")


def _find_class(ctx: LintContext, name: str
                ) -> Optional[Tuple[Module, ast.ClassDef]]:
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name == name:
                return (mod, node)
    return None


def _method(cls: ast.ClassDef, name: str) -> Optional[ast.FunctionDef]:
    for n in cls.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and n.name == name:
            return n
    return None


def _attr_refs(fn: ast.AST, base: str) -> Set[str]:
    """Attribute names read off ``base`` (e.g. 'self' or 'other')."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == base:
            out.add(node.attr)
    return out


def _name_tables(mod: Module) -> Dict[str, List[str]]:
    """Module-level tables of field names: ``T = (("f", "wireKey"), ...)``
    -> {"T": ["f", ...]}."""
    out: Dict[str, List[str]] = {}
    for node in mod.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, (ast.Tuple, ast.List))):
            continue
        names = []
        for e in node.value.elts:
            if isinstance(e, ast.Tuple) and e.elts \
                    and isinstance(e.elts[0], ast.Constant) \
                    and isinstance(e.elts[0].value, str):
                names.append(e.elts[0].value)
            else:
                names = []
                break
        if names:
            out[node.targets[0].id] = names
    return out


def _loop_refs(fn: ast.AST, bases: Set[str],
               tables: Dict[str, List[str]]) -> Set[str]:
    """Field names a ``for`` loop over name literals or a name table reads
    or sets on one of ``bases`` through ``getattr`` / ``setattr``."""
    out: Set[str] = set()
    loops: List[Tuple[ast.AST, ast.expr, ast.expr]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.For):
            loops.append((node, node.iter, node.target))
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            loops.extend((node, g.iter, g.target) for g in node.generators)
    for node, it, tgt in loops:
        if isinstance(it, (ast.Tuple, ast.List)) and it.elts and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in it.elts):
            names = [e.value for e in it.elts]
        elif isinstance(it, ast.Name) and it.id in tables:
            names = tables[it.id]
        else:
            continue
        if isinstance(tgt, ast.Tuple) and tgt.elts:
            tgt = tgt.elts[0]
        if not isinstance(tgt, ast.Name):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                    and sub.func.id in ("getattr", "setattr") \
                    and len(sub.args) >= 2 \
                    and isinstance(sub.args[0], ast.Name) \
                    and sub.args[0].id in bases \
                    and isinstance(sub.args[1], ast.Name) \
                    and sub.args[1].id == tgt.id:
                out.update(names)
                break
    return out


def _refs_with_helpers(cls: ast.ClassDef, fn: ast.AST, bases: Set[str],
                       tables: Dict[str, List[str]]) -> Set[str]:
    """Attribute and table-loop references of ``fn`` and of the class
    methods it calls on ``self`` (transitively)."""
    out: Set[str] = set()
    todo, seen = [fn], set()
    while todo:
        f = todo.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        for b in bases:
            out |= _attr_refs(f, b)
        out |= _loop_refs(f, bases | {"self", "other"}, tables)
        for node in ast.walk(f):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self":
                m = _method(cls, node.func.attr)
                if m is not None:
                    todo.append(m)
    return out


def _is_initvar(ann: ast.expr) -> bool:
    """``InitVar[T]``: a constructor parameter, not a field."""
    if isinstance(ann, ast.Subscript):
        ann = ann.value
    return (isinstance(ann, ast.Name) and ann.id == "InitVar") or (
        isinstance(ann, ast.Attribute) and ann.attr == "InitVar")


def _dataclass_fields(cls: ast.ClassDef) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for n in cls.body:
        if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name) \
                and not n.target.id.startswith("_") \
                and not _is_initvar(n.annotation):
            out.append((n.target.id, n.lineno))
    return out


@register("wire")
def check_wire(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = list(_check_column_kinds(ctx))
    hit = _find_class(ctx, "QueryStats")
    if hit is None:
        return findings
    mod, cls = hit
    fields = _dataclass_fields(cls)
    to_dict = _method(cls, "to_dict")
    merge = _method(cls, "merge")
    tables = _name_tables(mod)
    ser_refs = _refs_with_helpers(cls, to_dict, {"self"}, tables) \
        if to_dict else set()
    merge_refs = _refs_with_helpers(cls, merge, {"self", "other"}, tables) \
        if merge else set()

    decode_kwargs: Optional[Set[str]] = None
    decode_loc: Tuple[str, int] = (mod.relpath, cls.lineno)
    from_dict = _method(cls, "from_dict")
    decoders = [(m2, node) for m2 in ctx.modules
                for node in ast.walk(m2.tree)
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name == "_stats_from_dict"]
    if from_dict is not None:
        decoders.append((mod, from_dict))
    for m2, node in decoders:
        if decode_kwargs is None:
            decode_kwargs = set()
            decode_loc = (m2.relpath, node.lineno)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                fname = sub.func.id if isinstance(sub.func, ast.Name)\
                    else getattr(sub.func, "attr", None)
                if fname == "QueryStats" or (node is from_dict
                                             and fname == "cls"):
                    decode_kwargs |= {k.arg for k in sub.keywords
                                      if k.arg}
        outs = {t.id for sub in ast.walk(node)
                if isinstance(sub, ast.Assign) for t in sub.targets
                if isinstance(t, ast.Name)}
        decode_kwargs |= _loop_refs(node, outs, _name_tables(m2))

    for field, line in fields:
        if to_dict is not None and field not in ser_refs:
            findings.append(Finding(
                "wire", mod.relpath, line, f"QueryStats.{field}:to_dict",
                f"QueryStats.{field} is not serialized in to_dict() — "
                f"the stat never reaches the DataTable wire"))
        if merge is not None and field not in merge_refs:
            findings.append(Finding(
                "wire", mod.relpath, line, f"QueryStats.{field}:merge",
                f"QueryStats.{field} is not combined in merge() — "
                f"the stat is dropped at segment/shard/server merge"))
        if decode_kwargs is not None and field not in decode_kwargs:
            findings.append(Finding(
                "wire", decode_loc[0], decode_loc[1],
                f"QueryStats.{field}:_stats_from_dict",
                f"QueryStats.{field} is not decoded in "
                f"_stats_from_dict() — the stat is lost on receive"))

    # LAUNCH_MAX_KEYS <-> merge() literal agreement (launcher vs results)
    if merge is not None:
        for m2 in ctx.modules:
            for node in m2.tree.body:
                if isinstance(node, ast.Assign) \
                        and any(isinstance(t, ast.Name)
                                and t.id == "LAUNCH_MAX_KEYS"
                                for t in node.targets) \
                        and isinstance(node.value, (ast.Tuple, ast.List)):
                    keys = [e.value for e in node.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)]
                    if _reads_name(merge, mod, "LAUNCH_MAX_KEYS"):
                        continue    # merge applies the table itself
                    merge_lits = {n.value for n in ast.walk(merge)
                                  if isinstance(n, ast.Constant)
                                  and isinstance(n.value, str)}
                    for k in keys:
                        if k not in merge_lits:
                            findings.append(Finding(
                                "wire", m2.relpath, node.lineno,
                                f"LAUNCH_MAX_KEYS.{k}",
                                f"LAUNCH_MAX_KEYS entry {k!r} is not a "
                                f"max-merged key in QueryStats.merge() — "
                                f"launcher and results disagree on merge "
                                f"semantics"))
    return findings


def _reads_name(fn: ast.AST, mod: Module, name: str) -> bool:
    """Does ``fn``, or a module-level function of ``mod`` it calls by
    name, read the global ``name``?"""
    funcs = {n.name: n for n in mod.tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    todo, seen = [fn], set()
    while todo:
        f = todo.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        for node in ast.walk(f):
            if isinstance(node, ast.Name) and node.id == name:
                return True
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id in funcs:
                todo.append(funcs[node.func.id])
    return False


COL_KIND_RE = re.compile(r"^_COL_[A-Z0-9]+$")


def _name_refs(fn: ast.AST, names: Set[str]) -> Set[str]:
    """Which of ``names`` are read (as bare Names) inside ``fn``."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id in names:
            out.add(node.id)
    return out


def _check_column_kinds(ctx: LintContext) -> List[Finding]:
    """Column-kind dispatch obligations (see module doc). Anchored on the
    module that defines ``_encode_column``; no-op when it's not scanned."""
    findings: List[Finding] = []
    anchor = None
    kinds: Set[str] = set()
    kind_line = 0
    for mod in ctx.modules:
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == "_encode_column":
                anchor = mod
    if anchor is None:
        return findings
    for node in anchor.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and COL_KIND_RE.match(node.targets[0].id) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int):
            kinds.add(node.targets[0].id)
            kind_line = max(kind_line, node.lineno)
    if not kinds:
        return findings

    required = {"_encode_column", "_decode_column"}
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            refs = _name_refs(node, kinds)
            is_required = node.name in required and mod is anchor
            if not is_required and len(refs) < 2:
                continue  # not a kind dispatcher (single-kind helpers ok)
            missing = sorted(kinds - refs)
            if missing:
                findings.append(Finding(
                    "wire", mod.relpath, node.lineno,
                    f"colkind.{node.name}",
                    f"{node.name} dispatches on column kinds but does not "
                    f"handle {', '.join(missing)} — a new wire column "
                    f"kind must update every encode/decode/accessor "
                    f"dispatch (DataTable columns() consumers included)"))
    return findings


@register("config")
def check_config(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    hit = _find_class(ctx, "CommonConstants")
    if hit is None:
        return findings
    _mod, cls = hit
    declared: Set[str] = set()
    for n in cls.body:
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant) \
                and isinstance(n.value.value, str):
            declared.add(n.value.value)

    seen: Set[str] = set()
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and CONFIG_KEY_RE.match(node.value) \
                    and node.value not in declared:
                if node.value in seen:
                    continue
                seen.add(node.value)
                findings.append(Finding(
                    "config", mod.relpath, node.lineno, node.value,
                    f"config key {node.value!r} is not declared in "
                    f"CommonConstants (spi/config.py) — undeclared keys "
                    f"are invisible to operators and prone to typos"))
    return findings
