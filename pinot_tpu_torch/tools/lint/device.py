"""``device`` family: the fused scan's and the mesh's static obligations.

The JAX package's family checks its Pallas builders (``blockspec``,
``refs``, ``kernel-dtype``: BlockSpec lane alignment, value-ref sizing and
Mosaic's i64/f64 bans). The port has no BlockSpecs and no Mosaic: its
kernel is ``engine/csrc/fused_scan.cu``, and ``chip_smoke.py``'s test of
each kernel against its plain version does that work on the card. What
has a counterpart in the port is checked here:

- ``mesh-axis`` — the combine mesh's axes are ``SEG_AXIS`` / ``DOC_AXIS``
  (``parallel/mesh.py``): every string key of a mesh ``shape`` dict and
  every string subscript of a ``.shape[...]`` in the parallel modules
  names a declared axis, and every ``fold_partials`` op literal is a fold
  that ``fold_partials`` defines.
- ``pow2-narrow`` — ``narrow_plan_groups`` (``engine/plan.py``) keeps the
  spec's capacity slot and routes the narrowed group count through
  ``_next_pow2`` (a ``spec = (...)`` assignment or a ``SegmentPlan(spec=
  (...))`` keyword).
- ``idxcap`` — the star-tree device rung's padded index buffer
  (``engine/startree_device.py``) is sized by the plan spec's capacity
  slot.
- ``smem-cap`` — the fused scan's LUT run table rides the kernel's shared
  memory: ``engine/fused_scan.py``'s ``DEFAULT_LUT_RUN_CAP`` must not
  exceed the config default ``DEFAULT_PALLAS_LUT_MAX_RUNS``
  (``pinot.server.query.pallas.lut.max.runs``), and every ``_lut_runs``
  cap argument flows from the threaded ``lut_run_cap`` (or stays under
  the config value).

Like every lint family: pure stdlib ``ast``, scoped by module basename so
test fixtures (scratch copies of the real modules with one seeded
mutation) exercise each obligation. Cross-module constants (the mesh
axes, the config default) are read from the scanned tree when present,
the package's files otherwise — never imported.
"""

from __future__ import annotations

import ast
import os

from typing import Any, Dict, List, Optional, Set, Tuple

from pinot_tpu_torch.tools.lint.core import (
    Finding,
    LintContext,
    Module,
    register,
)

_PKG_ROOT = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir))

# the parallel modules whose mesh-axis uses are checked
_MESH_MODULES = {"mesh.py", "combine.py", "reduce_device.py", "batch.py",
                 "executor.py", "launcher.py"}


# -- cross-module constant loading (mirrors declines._load_tables) ----------

def _module_tree(ctx: LintContext, suffix: str,
                 fallback: str) -> Optional[ast.AST]:
    for mod in ctx.modules:
        if mod.relpath.replace(os.sep, "/").endswith(suffix):
            return mod.tree
    path = os.path.normpath(os.path.join(_PKG_ROOT, fallback))
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read(), filename=path)


def _int_consts(tree: Optional[ast.AST]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    if tree is None:
        return out
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int) \
                and not isinstance(node.value.value, bool):
            out[node.targets[0].id] = node.value.value
    return out


def _config_lut_cap(ctx: LintContext) -> Optional[int]:
    tree = _module_tree(ctx, "spi/config.py",
                        os.path.join("spi", "config.py"))
    return _int_consts(tree).get("DEFAULT_PALLAS_LUT_MAX_RUNS")


def _mesh_axes(ctx: LintContext) -> Dict[str, str]:
    """``*_AXIS`` name -> axis string, from parallel/mesh.py."""
    tree = _module_tree(ctx, "parallel/mesh.py",
                        os.path.join("parallel", "mesh.py"))
    out: Dict[str, str] = {}
    for node in ast.walk(tree) if tree is not None else ():
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.endswith("_AXIS") \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            out[node.targets[0].id] = node.value.value
    return out


def _fold_ops(ctx: LintContext) -> Set[str]:
    """The ops ``fold_partials`` compares its ``op`` against."""
    tree = _module_tree(ctx, "parallel/mesh.py",
                        os.path.join("parallel", "mesh.py"))
    fn = next((n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
               and n.name == "fold_partials"), None) \
        if tree is not None else None
    ops: Set[str] = set()
    for node in ast.walk(fn) if fn is not None else ():
        if isinstance(node, ast.Compare) and isinstance(node.left, ast.Name) \
                and node.left.id == "op":
            ops |= {c.value for c in node.comparators
                    if isinstance(c, ast.Constant)
                    and isinstance(c.value, str)}
    return ops


# -- tiny integer evaluator -------------------------------------------------

def _eval_int(expr: ast.expr, env: Dict[str, Any]) -> Optional[Any]:
    """-> int, or None (unknown)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, int) \
            and not isinstance(expr.value, bool):
        return expr.value
    if isinstance(expr, ast.Name):
        return env.get(expr.id)
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.USub):
        v = _eval_int(expr.operand, env)
        return -v if isinstance(v, int) else None
    if isinstance(expr, ast.BinOp):
        a = _eval_int(expr.left, env)
        b = _eval_int(expr.right, env)
        if isinstance(a, int) and isinstance(b, int):
            try:
                if isinstance(expr.op, ast.Add):
                    return a + b
                if isinstance(expr.op, ast.Sub):
                    return a - b
                if isinstance(expr.op, ast.Mult):
                    return a * b
                if isinstance(expr.op, ast.FloorDiv):
                    return a // b
                if isinstance(expr.op, ast.LShift):
                    return a << b
            except (ZeroDivisionError, ValueError):
                return None
    return None



# -- shared AST helpers ------------------------------------------------------

def _callee(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _kwarg(node: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


# -- LUT run cap against the config default (smem-cap) ----------------------

def _check_smem_cap(mod: Module, cfg_cap: Optional[int],
                    findings: List[Finding]) -> None:
    if cfg_cap is None:
        return
    env = _int_consts(mod.tree)
    cap = env.get("DEFAULT_LUT_RUN_CAP")
    if cap is not None and cap > cfg_cap:
        line = next((n.lineno for n in ast.walk(mod.tree)
                     if isinstance(n, ast.Assign)
                     and isinstance(n.targets[0], ast.Name)
                     and n.targets[0].id == "DEFAULT_LUT_RUN_CAP"), 0)
        findings.append(Finding(
            "device", mod.relpath, line, "smem-cap:DEFAULT_LUT_RUN_CAP",
            f"DEFAULT_LUT_RUN_CAP={cap} exceeds the config table's "
            f"DEFAULT_PALLAS_LUT_MAX_RUNS={cfg_cap} "
            f"(pinot.server.query.pallas.lut.max.runs) — the kernel's "
            f"shared-memory run table would outgrow the budget the "
            f"preflight verifies"))
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and _callee(node) == "_lut_runs"
                and len(node.args) >= 2):
            continue
        arg = node.args[1]
        names = {n.id for n in ast.walk(arg) if isinstance(n, ast.Name)}
        if "lut_run_cap" in names:
            continue
        v = _eval_int(arg, env)
        if isinstance(v, int) and v > cfg_cap:
            findings.append(Finding(
                "device", mod.relpath, node.lineno,
                f"smem-cap:lut_runs:{v}",
                f"_lut_runs cap {v} bypasses the configured "
                f"lut.max.runs bound ({cfg_cap})"))



# -- mesh axes (mesh-axis) ---------------------------------------------------

def _check_mesh_axes(mod: Module, axes: Dict[str, str], fold_ops: Set[str],
                     findings: List[Finding]) -> None:
    names, values = set(axes), set(axes.values())

    def bad_axis(key: ast.expr) -> Optional[str]:
        if isinstance(key, ast.Constant) and isinstance(key.value, str) \
                and key.value not in values:
            return repr(key.value)
        if isinstance(key, ast.Name) and key.id.endswith("_AXIS") \
                and key.id not in names:
            return key.id
        return None

    for node in ast.walk(mod.tree):
        keys: List[ast.expr] = []
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Attribute) and t.attr == "shape"
                        for t in node.targets):
            keys = [k for k in node.value.keys if k is not None]
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Attribute) \
                and node.value.attr == "shape":
            keys = [node.slice]
        for k in keys:
            why = bad_axis(k)
            if why is not None:
                findings.append(Finding(
                    "device", mod.relpath, node.lineno,
                    f"mesh-axis:{why[:30]}",
                    f"mesh axis {why} is not a declared axis "
                    f"{sorted(values)} (parallel/mesh.py)"))
        if fold_ops and isinstance(node, ast.Call) \
                and _callee(node) == "fold_partials":
            op = node.args[1] if len(node.args) > 1 else _kwarg(node, "op")
            if isinstance(op, ast.Constant) and isinstance(op.value, str) \
                    and op.value not in fold_ops:
                findings.append(Finding(
                    "device", mod.relpath, node.lineno,
                    f"mesh-axis:fold:{op.value[:20]}",
                    f"fold_partials op {op.value!r} is not a fold it "
                    f"defines {sorted(fold_ops)} — the cells' partials "
                    f"would not be combined"))


# -- narrow_plan_groups pow2 preservation (pow2-narrow) ---------------------

def _narrowed_specs(fn: ast.AST) -> List[Tuple[ast.AST, ast.Tuple]]:
    """(statement or call, 5-tuple) of every spec ``fn`` rebuilds: a
    ``spec = (...)`` assignment or a ``spec=(...)`` keyword."""
    out: List[Tuple[ast.AST, ast.Tuple]] = []
    for st in ast.walk(fn):
        if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                and isinstance(st.targets[0], ast.Name) \
                and st.targets[0].id == "spec" \
                and isinstance(st.value, ast.Tuple) \
                and len(st.value.elts) == 5:
            out.append((st, st.value))
        elif isinstance(st, ast.Call):
            v = _kwarg(st, "spec")
            if isinstance(v, ast.Tuple) and len(v.elts) == 5:
                out.append((st, v))
    return out


def _check_narrow(mod: Module, findings: List[Finding]) -> None:
    fn = next((n for n in ast.walk(mod.tree)
               if isinstance(n, ast.FunctionDef)
               and n.name == "narrow_plan_groups"), None)
    if fn is None:
        return
    # names unpacked from plan.spec (the capacity slot must come back)
    spec_names: Set[str] = set()
    assigns: Dict[str, ast.expr] = {}
    for st in ast.walk(fn):
        if isinstance(st, ast.Assign) and len(st.targets) == 1:
            t = st.targets[0]
            if isinstance(t, ast.Tuple) \
                    and isinstance(st.value, ast.Attribute) \
                    and st.value.attr == "spec":
                spec_names |= {e.id for e in t.elts
                               if isinstance(e, ast.Name)}
            elif isinstance(t, ast.Name):
                assigns[t.id] = st.value
    for st, spec in _narrowed_specs(fn):
        ng, cap = spec.elts[3], spec.elts[4]
        ng_src = assigns.get(ng.id) if isinstance(ng, ast.Name) else None
        if not (isinstance(ng_src, ast.Call)
                and _callee(ng_src) == "_next_pow2"):
            findings.append(Finding(
                "device", mod.relpath, st.lineno, "pow2-narrow:num_groups",
                "narrowed num_groups does not flow through _next_pow2 — "
                "the dense rung and the fused scan's group padding "
                "assume pow2 padding survives narrowing"))
        if not (isinstance(cap, ast.Name) and cap.id in spec_names):
            findings.append(Finding(
                "device", mod.relpath, st.lineno, "pow2-narrow:capacity",
                "narrowed spec does not preserve the original capacity "
                "slot — block/tile sizing would drift from the staged "
                "arrays"))



# -- star-tree idx pad sized by the spec capacity (idxcap) ------------------

def _check_idxcap(mod: Module, findings: List[Finding]) -> None:
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        assigns: Dict[str, ast.expr] = {}
        for st in ast.walk(fn):
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                assigns[st.targets[0].id] = st.value
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and _callee(node) == "zeros" and node.args):
                continue
            dt = _kwarg(node, "dtype")
            if not (isinstance(dt, ast.Attribute) and dt.attr == "int32"):
                continue
            size = node.args[0]
            src = assigns.get(size.id) if isinstance(size, ast.Name) \
                else size
            ok = (isinstance(src, ast.Subscript)
                  and isinstance(src.value, ast.Attribute)
                  and src.value.attr == "spec")
            if not ok:
                # symbol keyed on the size expr, not the enclosing def:
                # nested launch closures are walked by both scopes
                findings.append(Finding(
                    "device", mod.relpath, node.lineno,
                    f"idxcap:{ast.unparse(size)[:30]}",
                    "padded index buffer is not sized by the plan "
                    "spec's capacity slot — the kernel's block shapes "
                    "are derived from spec[-1], a drifting pad would "
                    "gather out of bounds"))



# -- family entry ------------------------------------------------------------

@register("device")
def check_device(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    axes: Optional[Dict[str, str]] = None
    fold_ops: Set[str] = set()
    for mod in ctx.modules:
        base = os.path.basename(mod.relpath)
        if base == "fused_scan.py":
            _check_smem_cap(mod, _config_lut_cap(ctx), findings)
        elif base == "plan.py":
            _check_narrow(mod, findings)
        elif base == "startree_device.py":
            _check_idxcap(mod, findings)
        if base in _MESH_MODULES:
            if axes is None:
                axes, fold_ops = _mesh_axes(ctx), _fold_ops(ctx)
            if axes:
                _check_mesh_axes(mod, axes, fold_ops, findings)
    # one finding per stable key (helpers shared by several call sites
    # would otherwise multiply one root cause)
    seen: Set[str] = set()
    out: List[Finding] = []
    for f in findings:
        if f.key not in seen:
            seen.add(f.key)
            out.append(f)
    return out
