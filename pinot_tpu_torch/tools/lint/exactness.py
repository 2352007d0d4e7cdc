"""``exactness`` family: numeric-exactness proof guards.

The engine's integer-sum and composite-key paths are exact only inside
proven bounds: i64 folds stay below ``2**62`` (headroom for one more
doubling), f64 carries integers exactly only below ``2**53``, and the
composite group-key space must fit under the i64 pad sentinel. Those
bounds live in ``common/bounds.py`` as named, derivation-commented
constants, not as raw ``1 << 62`` / ``float(1 << 53)`` literals scattered
across the kernel, reduce and broker tiers (one typo'd bit width away
from silent wrong sums); this family keeps them there:

1. **literal ban** — any ``1 << 62`` / ``1 << 53`` / ``2 ** 62`` /
   ``2 ** 53`` expression outside ``common/bounds.py`` is a finding.
   Wide-bound arithmetic must reference the named constant so the
   derivation comment travels with every use.

2. **dtype-evidence pairing** — a comparison against an i64-family
   bound (``I64_FOLD_BOUND``, ``I64_KEY_SPACE_BOUND``) inside a
   function with no integer-dtype evidence in scope (or an
   ``F64_EXACT_INT_BOUND`` comparison with no float64 evidence) is a
   finding: the guard proves nothing about a value of the wrong dtype.

3. **required guards** — the functions in ``REQUIRED_GUARDS`` are the
   known sum-reassembly sites; each must reference at least one bounds
   constant. Deleting the guard (the mutation this family exists to
   catch) is a finding even though no banned literal remains.
"""

from __future__ import annotations

import ast
import os
import re

from typing import Dict, List, Tuple

from pinot_tpu_torch.tools.lint.core import (
    Finding,
    LintContext,
    Module,
    register,
)

# the named bounds (common/bounds.py) and the dtype family each proves
BOUNDS_NAMES = frozenset({
    "I64_FOLD_BOUND", "F64_EXACT_INT_BOUND", "I64_KEY_SPACE_BOUND",
    "I64_PAD_SENTINEL",
})
_I64_BOUNDS = frozenset({"I64_FOLD_BOUND", "I64_KEY_SPACE_BOUND"})
_F64_BOUNDS = frozenset({"F64_EXACT_INT_BOUND"})

# evidence that the guarded value really is of the bound's dtype family
_I64_EVIDENCE = re.compile(
    r"int64|_i64|i64_|\bint\(|is_integral|kind == \"i\"")
_F64_EVIDENCE = re.compile(
    r"float64|_f64|f64_|\bfloat\(|kind == \"f\"")

# known sum-reassembly sites: module basename -> functions that MUST
# reference a named bound (guard-deletion tripwire)
REQUIRED_GUARDS: Dict[str, Tuple[str, ...]] = {
    "reduce.py": ("_finish_group_by",),
    "reduce_device.py": ("f64_sum_exact", "encode_composite_keys"),
    "fused_scan.py": ("extract_plan",),
}

_WIDE_SHIFTS = {62, 53}


def _is_banned_literal(node: ast.BinOp) -> bool:
    if not (isinstance(node.left, ast.Constant)
            and isinstance(node.right, ast.Constant)
            and isinstance(node.left.value, int)
            and isinstance(node.right.value, int)):
        return False
    if isinstance(node.op, ast.LShift):
        return node.left.value == 1 and node.right.value in _WIDE_SHIFTS
    if isinstance(node.op, ast.Pow):
        return node.left.value == 2 and node.right.value in _WIDE_SHIFTS
    return False


def _bound_names_in(node: ast.AST) -> set:
    names = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in BOUNDS_NAMES:
            names.add(n.id)
        elif isinstance(n, ast.Attribute) and n.attr in BOUNDS_NAMES:
            names.add(n.attr)
    return names


def _func_source(mod: Module, func: ast.AST) -> str:
    end = getattr(func, "end_lineno", func.lineno) or func.lineno
    return "\n".join(mod.lines[func.lineno - 1:end])


def _check_module(mod: Module) -> List[Finding]:
    findings: List[Finding] = []
    base = os.path.basename(mod.relpath)

    if base != "bounds.py":
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.BinOp) and _is_banned_literal(node):
                findings.append(Finding(
                    "exactness", mod.relpath, node.lineno,
                    f"L{node.lineno}:wide_literal",
                    "raw wide-bound literal (1 << 62 / 1 << 53 family) — "
                    "use the named constant from common/bounds.py so the "
                    "derivation travels with the guard"))

    # dtype-evidence pairing + required-guard presence, per function
    required = set(REQUIRED_GUARDS.get(base, ()))
    for func in ast.walk(mod.tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        used = _bound_names_in(func)
        src = _func_source(mod, func)
        if func.name in required:
            required.discard(func.name)
            if not used:
                findings.append(Finding(
                    "exactness", mod.relpath, func.lineno,
                    f"{func.name}:guard_missing",
                    f"{func.name} is a sum-reassembly site but references "
                    f"no common/bounds.py constant — the exactness guard "
                    f"has been removed"))
                continue
        if not used:
            continue
        # evidence source: the function name itself counts (f64_sum_exact)
        hay = func.name + "\n" + src
        if used & _I64_BOUNDS and not _I64_EVIDENCE.search(hay):
            findings.append(Finding(
                "exactness", mod.relpath, func.lineno,
                f"{func.name}:i64_evidence",
                f"{func.name} compares against an i64 bound "
                f"({sorted(used & _I64_BOUNDS)}) but shows no integer-"
                f"dtype evidence — the guard proves nothing about a "
                f"non-i64 value"))
        if used & _F64_BOUNDS and not _F64_EVIDENCE.search(hay):
            findings.append(Finding(
                "exactness", mod.relpath, func.lineno,
                f"{func.name}:f64_evidence",
                f"{func.name} compares against F64_EXACT_INT_BOUND but "
                f"shows no float64-dtype evidence — the guard proves "
                f"nothing about a non-f64 value"))
    for missing in sorted(required):
        findings.append(Finding(
            "exactness", mod.relpath, 1, f"{missing}:guard_site_missing",
            f"{base} must define sum-reassembly site {missing} with a "
            f"bounds-constant guard (REQUIRED_GUARDS)"))
    return findings


@register("exactness")
def check_exactness(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for mod in ctx.modules:
        findings.extend(_check_module(mod))
    return findings
