"""``decline`` family: fused-scan decline-reason drift check.

Every decline the fused-scan eligibility path records must resolve to a
code the ledger knows: ``engine/errors.py`` ``classify_decline``'s rule
table (``_DECLINE_RULES``) for ``_Ineligible("message")`` raises, the
``common/tracing.py`` ``DIRECT_DECLINE_CODES`` registry for
``decline("code")`` calls. A NEW decline site in ``engine/fused_scan.py``
whose string neither matches a classifier needle nor names a registered
direct code is flagged before it can reach the ledger (the sanitized
digit-stripped fallback would otherwise mint an unregistered code).

Scope: modules named ``fused_scan.py`` (the port's module, the JAX
package's ``pallas_kernels.py`` counterpart, and test fixtures alike).
Non-constant arguments (``raise _Ineligible(op)``) are exempt: the
classifier's fallback keeps them non-``unknown``.

The tables are read with ``ast``, never imported (the lint is
stdlib-only): the scanned copies when the run holds them, else the
package's files."""

from __future__ import annotations

import ast
import os

from typing import List, Optional, Set, Tuple

from pinot_tpu_torch.tools.lint.core import Finding, LintContext, register

_PKG = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir))
_TABLE_FILES = (os.path.join("common", "tracing.py"),
                os.path.join("engine", "errors.py"))

# the module whose eligibility path the family checks
SCOPE_MODULE = "fused_scan.py"


def _load_tables(ctx: LintContext) -> Tuple[List[str], Set[str]]:
    """(classifier needles, known direct codes) from engine/errors.py and
    common/tracing.py: the copies in the lint context when the scan
    includes them (so a scan of a modified tree checks against ITS
    tables), the package's files otherwise (fixture scans of standalone
    files)."""
    trees = []
    for rel in _TABLE_FILES:
        want = rel.replace(os.sep, "/")
        hit = next((m.tree for m in ctx.modules
                    if m.relpath.replace(os.sep, "/").endswith(want)), None)
        if hit is None:
            path = os.path.join(_PKG, rel)
            with open(path, encoding="utf-8") as f:
                hit = ast.parse(f.read(), filename=path)
        trees.append(hit)
    needles: List[str] = []
    codes: Set[str] = set()
    for node in (n for t in trees for n in ast.walk(t)):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            tgt = node.target
        else:
            continue
        name = tgt.id if isinstance(tgt, ast.Name) else None
        if name == "_DECLINE_RULES" and isinstance(node.value, ast.Tuple):
            for elt in node.value.elts:
                if (isinstance(elt, ast.Tuple) and len(elt.elts) == 2
                        and all(isinstance(e, ast.Constant)
                                and isinstance(e.value, str)
                                for e in elt.elts)):
                    needles.append(elt.elts[0].value)
                    codes.add(elt.elts[1].value)
        elif name == "DIRECT_DECLINE_CODES":
            call = node.value
            args = call.args if isinstance(call, ast.Call) else []
            for a in args:
                if isinstance(a, (ast.Set, ast.Tuple, ast.List)):
                    for e in a.elts:
                        if isinstance(e, ast.Constant) \
                                and isinstance(e.value, str):
                            codes.add(e.value)
    return needles, codes


def _const_prefix(node: ast.expr) -> Optional[str]:
    """The checkable constant text of a decline argument: full string for
    literals, the joined constant fragments for f-strings, None for
    anything dynamic."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = [v.value for v in node.values
                 if isinstance(v, ast.Constant) and isinstance(v.value, str)]
        return "".join(parts) if parts else None
    return None


@register("decline")
def check_declines(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    targets = [m for m in ctx.modules
               if os.path.basename(m.relpath) == SCOPE_MODULE]
    if not targets:
        return findings
    needles, codes = _load_tables(ctx)
    for mod in targets:
        func = "<module>"
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func = node.name
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            callee = f.id if isinstance(f, ast.Name) else \
                f.attr if isinstance(f, ast.Attribute) else None
            if callee == "_Ineligible" and node.args:
                msg = _const_prefix(node.args[0])
                if msg is None:
                    continue  # dynamic message: runtime namespacing covers
                if not any(n in msg for n in needles):
                    findings.append(Finding(
                        "decline", mod.relpath, node.lineno,
                        f"ineligible:{msg[:40]}",
                        f"_Ineligible message {msg!r} matches no "
                        f"classify_decline rule — it would classify "
                        f"through the sanitized fallback; add a rule to "
                        f"errors._DECLINE_RULES"))
            elif callee in ("decline", "on_decline") and node.args:
                code = _const_prefix(node.args[0])
                if code is None:
                    continue
                if code not in codes:
                    findings.append(Finding(
                        "decline", mod.relpath, node.lineno,
                        f"code:{code[:40]}",
                        f"decline code {code!r} is not registered — add "
                        f"it to tracing.DIRECT_DECLINE_CODES (or a "
                        f"_DECLINE_RULES row) so the ledger can never "
                        f"carry an unregistered reason"))
    return findings
