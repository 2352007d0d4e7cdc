"""``configkeys`` family: ``pinot.*`` config-key conformance.

Pinot's reference implementation centralises every cluster config key in
``CommonConstants`` and validates query options against it; keys that
drift from the constants class become silently-ignored knobs. This
repo's analogue is ``spi/config.py``: every ``pinot.*`` key read through
``PinotConfiguration`` must resolve to a declared ``CommonConstants``
constant, every declared key must actually be read somewhere, and the
README's operator-facing config table must list every key with the code
default. Three rules:

1. **read resolution** (always runs, file-list and package scans): a
   ``get``/``get_int``/``get_float``/``get_bool``/``get_str`` call whose
   key argument is a ``pinot.*`` string literal not declared as a
   ``CommonConstants`` value — or an attribute ``*_KEY``/``*_PREFIX``
   name that ``CommonConstants`` does not define — is a finding. Keys
   are born in ``spi/config.py``, never inline.

2. **unread keys** (package scans only — needs the whole tree): a
   declared ``*_KEY``/``*_PREFIX`` string constant with no attribute
   access (any alias: ``CommonConstants.X`` or ``_CC.X``) and no equal
   string literal in any other scanned module is dead surface — a
   finding on the declaration.

3. **README table** (package scans with a README next to the tree): the
   block between ``<!-- torch-config-keys:begin -->`` and ``<!--
   torch-config-keys:end -->`` (the port's section) must contain a row for every declared key, and where a
   name-mapped ``DEFAULT_<base>`` constant exists its documented default
   must match the code default — stale docs are findings, auto-checked.

Rules 2-3 key off a scanned module whose relpath ends ``spi/config.py``.
The family registers ``whole_program=True``: a ``--changed`` run hands
it the full package (the key universe and the declaration module are
global facts) and scopes its findings to the changed set afterwards.
"""

from __future__ import annotations

import ast
import os
import re

from typing import Dict, List, Optional, Set, Tuple

from pinot_tpu_torch.tools.lint.core import (
    Finding,
    LintContext,
    Module,
    call_name,
    register,
)

_CONFIG_PATH = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    os.pardir, os.pardir, "spi", "config.py"))

_GETTERS = frozenset({"get", "get_int", "get_float", "get_bool", "get_str"})
_KEY_ATTR = re.compile(r".*(_KEY|_PREFIX)\Z")

# the port's own table in the README (the JAX package's table, between
# ``config-keys`` markers, lists the JAX defaults)
_TABLE_BEGIN = "<!-- torch-config-keys:begin -->"
_TABLE_END = "<!-- torch-config-keys:end -->"


def _constants_class(tree: ast.AST) -> Optional[ast.ClassDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "CommonConstants":
            return node
    return None


def _load_declared(ctx: LintContext) -> Tuple[
        Dict[str, str], Dict[str, object], Optional[Module]]:
    """(key-name -> key-value, default-name -> default-value, the scanned
    config module if the scan includes one). Prefers the scanned copy so
    fixture trees check against THEIR declarations."""
    tree = None
    cfg_mod: Optional[Module] = None
    for mod in ctx.modules:
        rel = mod.relpath.replace(os.sep, "/")
        if rel.endswith("spi/config.py") \
                and _constants_class(mod.tree) is not None:
            tree, cfg_mod = mod.tree, mod
            break
    if tree is None:
        with open(_CONFIG_PATH, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=_CONFIG_PATH)
    keys: Dict[str, str] = {}
    defaults: Dict[str, object] = {}
    cls = _constants_class(tree)
    if cls is None:
        return keys, defaults, cfg_mod
    for st in cls.body:
        if not (isinstance(st, ast.Assign) and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Name)
                and isinstance(st.value, ast.Constant)):
            continue
        name = st.targets[0].id
        if _KEY_ATTR.match(name) and isinstance(st.value.value, str):
            keys[name] = st.value.value
        elif name.startswith("DEFAULT_"):
            defaults[name] = st.value.value
    return keys, defaults, cfg_mod


def _key_arg(node: ast.Call) -> Optional[ast.expr]:
    if node.args:
        return node.args[0]
    for kw in node.keywords:
        if kw.arg == "key":
            return kw.value
    return None


def _cc_aliases(mod: Module) -> Set[str]:
    """Local names bound to CommonConstants (``CommonConstants`` itself
    or an import alias like executor.py's ``_CC``)."""
    aliases: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "CommonConstants":
                    aliases.add(a.asname or a.name)
    return aliases


def _check_reads(mod: Module, declared: Dict[str, str]) -> List[Finding]:
    findings: List[Finding] = []
    values = set(declared.values())
    names = set(declared)
    aliases = _cc_aliases(mod)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) \
                or call_name(node) not in _GETTERS:
            continue
        arg = _key_arg(node)
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                and arg.value.startswith("pinot."):
            if arg.value not in values:
                findings.append(Finding(
                    "configkeys", mod.relpath, node.lineno,
                    f"key:{arg.value}",
                    f"config key {arg.value!r} read inline is not "
                    f"declared in spi/config.py CommonConstants — keys "
                    f"are born there, never inline"))
        elif isinstance(arg, ast.Attribute) and _KEY_ATTR.match(arg.attr) \
                and isinstance(arg.value, ast.Name) \
                and arg.value.id in aliases:
            if arg.attr not in names:
                findings.append(Finding(
                    "configkeys", mod.relpath, node.lineno,
                    f"attr:{arg.attr}",
                    f"config read references CommonConstants.{arg.attr} "
                    f"which spi/config.py does not declare"))
    return findings


def _render_default(value: object) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    return str(value)


def _check_readme(cfg_mod: Module, declared: Dict[str, str],
                  defaults: Dict[str, object]) -> List[Finding]:
    findings: List[Finding] = []
    readme = os.path.normpath(os.path.join(
        os.path.dirname(os.path.abspath(cfg_mod.path)),
        os.pardir, os.pardir, "README.md"))
    if not os.path.exists(readme):
        return findings  # fixture trees without docs: nothing to check
    with open(readme, encoding="utf-8") as f:
        text = f.read()
    begin = text.find(_TABLE_BEGIN)
    end = text.find(_TABLE_END)
    if begin < 0 or end < 0:
        findings.append(Finding(
            "configkeys", cfg_mod.relpath, 1, "readme:table_missing",
            f"README.md has no {_TABLE_BEGIN} .. {_TABLE_END} config-key "
            f"table — the operator-facing key list must be auto-checked"))
        return findings
    block = text[begin:end]
    base_line = text[:begin].count("\n") + 1
    # row: | `pinot....` | `default` | prose |
    rows: Dict[str, Tuple[str, int]] = {}
    for i, line in enumerate(block.splitlines()):
        m = re.match(r"\|\s*`([^`]+)`\s*\|\s*([^|]*)\|", line)
        if m:
            rows[m.group(1)] = (m.group(2).strip().strip("`").strip(),
                                base_line + i)
    for name, value in sorted(declared.items()):
        if value not in rows:
            findings.append(Finding(
                "configkeys", cfg_mod.relpath, 1, f"readme:missing:{name}",
                f"declared key {value!r} ({name}) has no row in the "
                f"README config-key table"))
            continue
        base = name[:-len("_KEY")] if name.endswith("_KEY") else None
        if base is None or ("DEFAULT_" + base) not in defaults:
            continue
        doc_default, _line = rows[value]
        code_default = _render_default(defaults["DEFAULT_" + base])
        if doc_default != code_default:
            findings.append(Finding(
                "configkeys", cfg_mod.relpath, 1, f"readme:stale:{name}",
                f"README documents default {doc_default!r} for {value!r} "
                f"but the code default (DEFAULT_{base}) is "
                f"{code_default!r} — the table is auto-checked against "
                f"spi/config.py"))
    return findings


@register("configkeys", whole_program=True)
def check_configkeys(ctx: LintContext) -> List[Finding]:
    declared, defaults, cfg_mod = _load_declared(ctx)
    findings: List[Finding] = []
    for mod in ctx.modules:
        findings.extend(_check_reads(mod, declared))

    if cfg_mod is None:
        return findings  # file-list scan: global rules need the tree

    # unread declared keys: an attribute access (any import alias) or an
    # equal string literal in some OTHER scanned module
    read_attrs: Set[str] = set()
    read_literals: Set[str] = set()
    for mod in ctx.modules:
        if mod is cfg_mod:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute):
                read_attrs.add(node.attr)
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                read_literals.add(node.value)
    for name, value in sorted(declared.items()):
        if name in read_attrs or value in read_literals:
            continue
        line = 1
        for st in ast.walk(cfg_mod.tree):
            if isinstance(st, ast.Assign) and st.targets \
                    and isinstance(st.targets[0], ast.Name) \
                    and st.targets[0].id == name:
                line = st.lineno
                break
        findings.append(Finding(
            "configkeys", cfg_mod.relpath, line, f"unread:{name}",
            f"declared key {value!r} ({name}) is never read anywhere in "
            f"the scanned tree — dead config surface"))

    findings.extend(_check_readme(cfg_mod, declared, defaults))
    return findings
