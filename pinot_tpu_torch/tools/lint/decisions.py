"""``decisions`` family: decision-path totality over the ledger scope.

The system's credo since the decision ledger landed is "every fallback
explained": rung selection, reduce-path choice, routing prunes, hybrid
splits, and seal swaps all record WHY the declined alternative lost. The
``decline`` family and the reason-namespace conformance scan check that every reason *literal* is registered — this family
closes the other half: for every function in the declared scope registry
below, every path that returns into the declined alternative — including
paths through exception handlers — must REACH a recorder call
(``record_decision`` / an ``on_decline``-style hook) before it exits.

Built on the dataflow CFG tier: a must-analysis of one "recorded" bit over
:func:`dataflow.build_cfg`'s statement-level CFG (exception edges carry
the raising statement's pre-state, so a handler that swallows and
returns None must record on its own). Two scope modes:

- ``none`` — only explicit ``return None`` / bare ``return`` exits are
  decline exits (the scoped rung-probe shape: a non-None return means
  the rung SERVED, and ``return decline(...)`` / delegation returns
  record through their callee);
- ``all`` — every return and the implicit fall-through must be recorded
  (the scoped always-record shape: routing prunes, the hybrid split,
  the seal swap ledger every outcome).

Escaping raises are never findings — an exception that leaves the
function is loud by construction. Three discharges keep the zero
baseline honest without taint-widening:

- a ``not a decline`` / ``record(s|ed) its own reason`` comment on the
  exit's lines — the in-code annotation that an early None is a
  structural miss (no trees, no filter), not a silenced decline;
- ``x = f(..., on_decline=<hook>)`` followed by ``if x is None: return
  None`` — the callee records on every None it returns, so the caller's
  pass-through is covered (tracked per assigned name, killed on
  reassignment);
- branch edges testing the function's own ``on_decline`` hook against
  None: on the hook-is-None side recording is vacuous (recording IS the
  hook; without one there is nothing to drop).

The family also re-checks every literal reason argument at a recorder
call inside the scoped functions against the reason registry parsed
from ``common/tracing.py`` (ast, never imported) — non-literal reasons
(``e.reason_code``, f-strings) are the bench's runtime validation's
job, not lint's. The port keeps some tables beside the code that records
them (``broker/reduce.py`` ``REDUCE_DECISION_REASONS``, ``broker/
routing.py`` ``ROUTING_DECISION_REASONS``) and ``tracing.py`` imports
them into its registry: a ``*_REASONS`` / ``*_CODES`` name that
``tracing.py`` imports is read from the module it names.

True positives are fixed in-code, never baselined.
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
    call_name,
    register,
)
from pinot_tpu_torch.tools.lint.dataflow import ForwardAnalysis, build_cfg, \
    stmt_scan

_TRACING_PATH = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    os.pardir, os.pardir, "common", "tracing.py"))

# scope registry: module basename -> {function name: exit mode}. The
# basename keying lets test fixtures named like the real modules run the
# same rules (the declines-family convention); real-module collisions
# are resolved by the function-name lookup (parallel/executor.py defines
# none of engine/executor.py's scoped probes).
SCOPE: Dict[str, Dict[str, str]] = {
    "executor.py": {"_try_star_tree": "none", "_try_pallas": "none",
                    "_star_tree_pick": "none"},
    "startree_exec.py": {"pick_star_tree": "none",
                         "resolve_matches": "none"},
    "index_exec.py": {"try_index_rung": "none"},
    "fused_scan.py": {"extract_plan": "none",
                      "probe_narrowed_plan": "none"},
    "mutable_staging.py": {"_serve": "none", "_try_index_gather": "none"},
    "reduce.py": {"_fold_group_by": "none", "_fold_rows": "none",
                  "_finish_group_by": "none", "_device_group_by": "none"},
    "routing.py": {"_partition_prune": "all", "_time_prune": "all"},
    "broker.py": {"_split_hybrid": "all"},
    "data_manager.py": {"on_sealed": "all"},
}

# call names that record a decision (the ledger entrypoint plus every
# recorder closure/method convention in the scoped modules)
RECORDERS = frozenset({
    "record_decision", "on_decline", "decline", "declined", "note",
    "_decline", "_decline_rung", "_decline_device", "_chose",
    "_chose_rung", "_hybrid_route",
})

# the hook parameter name whose None-guard makes recording vacuous
HOOK_PARAM = "on_decline"

DISCHARGE_RE = re.compile(
    r"not a decline|record(?:s|ed)? (?:its|their) own reason")

_DYNAMIC_REASON = re.compile(r"tree\d+\Z")

_TABLE_NAME = re.compile(r"^[A-Z0-9_]+(?:_REASONS|_CODES)\Z")


def _load_registered_reasons(ctx: LintContext) -> FrozenSet[str]:
    """Every registered reason code, parsed from common/tracing.py — the
    scanned copy when the lint run includes one (so fixture trees check
    against THEIR table), the installed package's file otherwise."""
    tree = None
    tracing_path = _TRACING_PATH
    for mod in ctx.modules:
        if mod.relpath.replace(os.sep, "/").endswith("common/tracing.py"):
            tree = mod.tree
            tracing_path = os.path.abspath(mod.path)
            break
    if tree is None:
        with open(_TRACING_PATH, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=_TRACING_PATH)
    codes: Set[str] = set()
    trees = [tree] + [t for t, _names in
                      _imported_tables(ctx, tree, tracing_path)]
    wanted = {n for _t, names in _imported_tables(ctx, tree, tracing_path)
              for n in names}

    def strings_of(node: ast.expr) -> Set[str]:
        out: Set[str] = set()
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "frozenset":
            for a in node.args:
                out |= strings_of(a)
        elif isinstance(node, (ast.Set, ast.Tuple, ast.List)):
            for e in node.elts:
                out |= strings_of(e)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.add(node.value)
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
            out |= strings_of(node.left) | strings_of(node.right)
        elif isinstance(node, ast.GeneratorExp):
            pass  # computed namespace slices: covered by their source set
        return out

    for t in trees:
        for node in ast.walk(t):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            if _TABLE_NAME.match(name) and (t is tree or name in wanted):
                codes |= strings_of(node.value)
            elif name == "_DECLINE_RULES" \
                    and isinstance(node.value, ast.Tuple):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Tuple) and len(elt.elts) == 2 \
                            and isinstance(elt.elts[1], ast.Constant) \
                            and isinstance(elt.elts[1].value, str):
                        codes.add(elt.elts[1].value)
    return frozenset(codes)


def _imported_tables(ctx: LintContext, tree: ast.AST, tracing_path: str
                     ) -> List[Tuple[ast.AST, Set[str]]]:
    """(module tree, table names) for every ``from <pkg>.<mod> import
    <TABLE>`` in ``tracing.py`` whose names are reason tables; the module
    is the scanned copy beside ``tracing.py``'s package when the run holds
    it, else the file on disk."""
    key = ("decisions.tables", tracing_path)
    got = ctx.memo.get(key)
    if got is not None:
        return got
    root = os.path.dirname(os.path.dirname(tracing_path))
    scanned = {os.path.abspath(m.path): m for m in ctx.modules}
    out: List[Tuple[ast.AST, Set[str]]] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ImportFrom) and node.module
                and node.level == 0):
            continue
        names = {a.name for a in node.names
                 if _TABLE_NAME.match(a.name) or a.name == "_DECLINE_RULES"}
        if not names:
            continue
        path = os.path.join(root, *node.module.split(".")[1:]) + ".py"
        mod = scanned.get(os.path.abspath(path))
        if mod is not None:
            out.append((mod.tree, names))
        elif os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                out.append((ast.parse(f.read(), filename=path), names))
    ctx.memo[key] = out
    return out


# -- the "recorded" must-analysis -------------------------------------------

# state: (recorded, srvars) — recorded is the must-bit, srvars the names
# currently bound to a self-recording call's result
_State = Tuple[bool, FrozenSet[str]]


def _is_self_recording_call(node: ast.expr) -> bool:
    return (isinstance(node, ast.Call)
            and any(kw.arg == HOOK_PARAM
                    and not (isinstance(kw.value, ast.Constant)
                             and kw.value.value is None)
                    for kw in node.keywords))


def _records(st: ast.AST) -> bool:
    """Does this ONE CFG statement call a recorder (no nested defs)?"""
    for node in stmt_scan(st):
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name in RECORDERS:
                return True
    return False


def _is_name_none_test(test: ast.expr, names: FrozenSet[str],
                       want_is_none: bool) -> bool:
    """``<n> is None`` (want_is_none) / ``<n> is not None`` for n in
    ``names``."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.left, ast.Name)
            and test.left.id in names
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None):
        return False
    op = test.ops[0]
    return isinstance(op, ast.Is) if want_is_none \
        else isinstance(op, ast.IsNot)


def _analyze(mod: Module, func: ast.AST, mode: str,
             registered: FrozenSet[str]) -> List[Finding]:
    findings: List[Finding] = []
    cfg = build_cfg(func)
    hook_names = frozenset(
        a.arg for a in list(func.args.args) + list(func.args.kwonlyargs)
        if a.arg == HOOK_PARAM)

    def transfer(state: _State, st: Optional[ast.AST], _n: int) -> _State:
        if st is None:
            return state
        recorded, srvars = state
        if _records(st):
            recorded = True
        if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                and isinstance(st.targets[0], ast.Name):
            name = st.targets[0].id
            if _is_self_recording_call(st.value):
                srvars = srvars | {name}
            elif name in srvars:
                srvars = srvars - {name}
        elif isinstance(st, ast.Assign):
            killed = {t.id for tgt in st.targets
                      if isinstance(tgt, ast.Tuple)
                      for t in tgt.elts if isinstance(t, ast.Name)}
            killed |= {tgt.id for tgt in st.targets
                       if isinstance(tgt, ast.Name)}
            if killed & srvars:
                srvars = srvars - killed
        return (recorded, srvars)

    def join(a: _State, b: _State) -> _State:
        return (a[0] and b[0], a[1] & b[1])

    def refine(state: _State, test: Optional[ast.expr],
               is_true: bool) -> _State:
        if test is None:
            return state
        recorded, srvars = state
        vacuous_names = hook_names | srvars
        if is_true and _is_name_none_test(test, vacuous_names, True):
            return (True, srvars)
        if not is_true and _is_name_none_test(test, vacuous_names, False):
            return (True, srvars)
        return state

    analysis = ForwardAnalysis(cfg, (False, frozenset()), transfer, join,
                               refine=refine)
    inn = analysis.run()

    def discharged(st: ast.AST) -> bool:
        lo = st.lineno
        hi = getattr(st, "end_lineno", lo) or lo
        # annotations ride the exit statement or spill to the line after
        # (the codebase's continuation-comment idiom)
        return mod.comment_in_range(lo, hi + 1, DISCHARGE_RE) is not None

    returns = [n for n, st in enumerate(cfg.stmts)
               if isinstance(st, ast.Return)]
    checked: List[int] = []
    for n in returns:
        st = cfg.stmts[n]
        is_none_exit = st.value is None or (
            isinstance(st.value, ast.Constant) and st.value.value is None)
        if mode == "none" and not is_none_exit:
            continue
        checked.append(n)

    qual = func.name
    exit_ord = {n: i for i, n in enumerate(sorted(
        checked, key=lambda n: (cfg.stmts[n].lineno,
                                cfg.stmts[n].col_offset)))}
    for n in checked:
        state = inn.get(n)
        if state is None:
            continue  # unreachable
        out_recorded = transfer(state, cfg.stmts[n], n)[0]
        if out_recorded or discharged(cfg.stmts[n]):
            continue
        st = cfg.stmts[n]
        findings.append(Finding(
            "decisions", mod.relpath, st.lineno,
            f"{qual}:exit{exit_ord[n]}",
            f"{qual} can exit into the declined alternative at line "
            f"{st.lineno} without a ledger record — every fallback path "
            f"must reach record_decision/on_decline (or carry a "
            f"'not a decline' annotation)"))

    if mode == "all":
        # the implicit fall-through exit must be recorded too
        for n, _ in enumerate(cfg.stmts):
            st = cfg.stmts[n]
            if n == cfg.entry or isinstance(st, (ast.Return, ast.Raise)):
                continue
            for m, lbl in cfg.succ[n]:
                if m != cfg.exit or lbl == "exc":
                    continue
                state = inn.get(n)
                if state is None:
                    continue
                out = transfer(state, st, n)
                if isinstance(lbl, tuple):
                    out = refine(out, lbl[1], lbl[0] == "true")
                if out[0] or (st is not None and discharged(st)):
                    continue
                line = getattr(st, "lineno", func.lineno)
                findings.append(Finding(
                    "decisions", mod.relpath, line,
                    f"{qual}:fallthrough",
                    f"{qual} can fall through to its end without a "
                    f"ledger record — this decision point must record "
                    f"every outcome"))
                break
    return findings


# -- reason-literal conformance at scoped recorder calls --------------------

def _reason_literals(node: ast.Call) -> List[str]:
    """Checkable literal reason(s) of a recorder call: [] when the
    reason is dynamic (Name/attribute/f-string — runtime validation's
    job)."""
    name = call_name(node)
    if name == "record_decision":
        reason: Optional[ast.expr] = None
        if len(node.args) >= 5:
            reason = node.args[4]
        else:
            for kw in node.keywords:
                if kw.arg == "reason":
                    reason = kw.value
    else:
        reason = next(
            (a for a in node.args
             if isinstance(a, ast.Constant) and isinstance(a.value, str)
             or isinstance(a, ast.IfExp)),
            None)
    if isinstance(reason, ast.Constant) and isinstance(reason.value, str):
        return [reason.value]
    if isinstance(reason, ast.IfExp):
        return [b.value for b in (reason.body, reason.orelse)
                if isinstance(b, ast.Constant)
                and isinstance(b.value, str)]
    return []


def _check_reasons(mod: Module, func: ast.AST,
                   registered: FrozenSet[str]) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(func):
        if not isinstance(node, ast.Call) \
                or call_name(node) not in RECORDERS:
            continue
        for code in _reason_literals(node):
            if code in registered or _DYNAMIC_REASON.fullmatch(code):
                continue
            findings.append(Finding(
                "decisions", mod.relpath, node.lineno,
                f"{func.name}:reason:{code[:40]}",
                f"reason {code!r} recorded in {func.name} is not in any "
                f"registered namespace (tracing.reason_registry()) — "
                f"register it so the ledger never carries an unknown "
                f"code"))
    return findings


@register("decisions")
def check_decisions(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    targets = [(m, SCOPE[os.path.basename(m.relpath)])
               for m in ctx.modules
               if os.path.basename(m.relpath) in SCOPE]
    if not targets:
        return findings
    registered = _load_registered_reasons(ctx)
    for mod, scope in targets:
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            mode = scope.get(node.name)
            if mode is None:
                continue
            findings.extend(_analyze(mod, node, mode, registered))
            findings.extend(_check_reasons(mod, node, registered))
    return findings
