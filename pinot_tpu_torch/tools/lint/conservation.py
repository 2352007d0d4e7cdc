"""HBM accounting conservation: resident inserts/removals must balance.

The residency manager's contract (engine/residency.py) is a
conservation law: every resident that leaves the entries dict must have
its device arrays released exactly once (after the manager lock drops —
the lock-order family owns that half), and every resident that enters
must be re-measured against the byte budget. A removal whose resident is
neither released nor handed to the caller leaks HBM until GC; an insert
that skips accounting lets ``stagedBytes`` drift from reality until the
next unrelated refresh. Three paired-effect rules, run as a forward
obligation analysis over the :mod:`dataflow` CFG — **including exception
edges**, so a release that only lives on the fall-through of a ``try`` is
caught:

- **remove -> release** (classes that define ``_release_all``, on fields
  whose values carry the ``.resident`` protocol): ``pop``/``del``/
  ``clear`` creates an obligation on the variables holding the removed
  resident(s); the obligation is discharged by a ``*release*`` call
  mentioning a holder, or by *returning* a holder (the caller inherits
  the obligation — method summaries record which return positions carry
  it, and call sites of summarized methods re-create it on the caller's
  targets). ``if e is not None`` guards prune the nothing-was-removed
  branch. A bare ``self.F.pop(k)`` whose result is discarded can never be
  released and is flagged outright.
- **insert -> accounting**: an insert into the entries dict must reach,
  on every fall-through path, a method that (transitively) writes a
  ``*bytes*`` counter field. Exception paths are exempt — the query is
  dying and the next refresh re-measures.
- **host-tier removal -> accounting** (entries fields whose name contains
  ``host`` — the host-RAM spill tier): unlike the device tier, whose
  ``stagedBytes`` is re-derived by walking residents on every refresh,
  host-tier bytes are a running counter adjusted at each transition —
  so every demotion that inserts must account host bytes (the insert
  rule above) AND every promotion/drop that removes must reach a
  ``*bytes*`` write on all paths *including exception edges* (a pop
  whose accounting lives only on the try fall-through drifts the host
  budget forever). This is a second obligation on top of remove ->
  release.
- **cache-field parity** (classes defining both ``nbytes()`` and
  ``release()``): every field such a class populates outside ``__init__``
  must be read by ``nbytes()`` AND cleared by ``release()`` — a staged
  cache that accounting cannot see, or that eviction cannot drop, is the
  tiered-storage follow-up's landmine. The port's idioms count: a field
  is *counted* when every method that populates it also adds to a
  ``*bytes*`` counter that ``nbytes()`` returns (the running total kept
  beside each insert), and *cleared* when ``release()`` or a ``self``
  helper it calls (``_drop_locked``) clears it. Assigning ``None``, ``0``
  or an empty container is a clear, not a population. A scalar counter
  (set to a number in ``__init__`` and only ever added to or reset) and a
  field annotated in ``__init__`` as host scalars (``Dict[str, int]``,
  ``Set[int]``) hold no device bytes, so ``nbytes()`` need not read
  them; the second must still be cleared.
- **idxacct** (every function, package-wide): a ``.index_slice(...)``
  call pins a freshly-built device idx array on a staged resident, so it
  must reach a residency ``.account(...)`` call (or a direct ``*bytes*``
  counter write) on every fall-through path before exit — otherwise the
  pinned array inflates the resident's true footprint while the budget's
  running view predates it. Exception paths are exempt for the same
  reason as the insert rule: ``nbytes()`` walks the slice cache, so the
  next refresh re-measures.
- **spanpair** (every function, package-wide): a ``span_begin(...)`` call
  must reach a ``span_end`` mentioning its holder on ALL paths including
  exception edges (the hostacct machinery over the same CFG) — an open
  span that never closes corrupts the query's trace tree AND pins its
  attribute payload for the query lifetime. Discharges: a ``span_end``
  call naming the holder, returning the holder (the caller owns the
  close), storing it on an attribute (a teardown hook owns it), or a
  nested function that closes it (the done-callback shape). A bare
  ``span_begin`` whose result is discarded can never be closed and is
  flagged outright. ``with recorder.span(...)`` creates no obligation —
  the context manager self-closes.
"""

from __future__ import annotations

import ast

from typing import Any, Dict, FrozenSet, List, Optional, Set, Tuple

from pinot_tpu_torch.tools.lint.core import (
    Finding,
    LintContext,
    Module,
    is_self_attr,
    register,
)
from pinot_tpu_torch.tools.lint.dataflow import (
    ForwardAnalysis,
    build_cfg,
    stmt_scan,
    walk_no_nested,
)

# obligation id: (kind, lineno, col); kind in {"remove", "insert", "call"}
_State = Dict[Tuple, Tuple[bool, FrozenSet[str]]]


def _mentions(node: Optional[ast.AST], names: FrozenSet[str]) -> bool:
    if node is None or not names:
        return False
    return any(isinstance(n, ast.Name) and n.id in names
               for n in ast.walk(node))


def _self_field_call(node: ast.AST, field: str, attr: str
                     ) -> Optional[ast.Call]:
    """``self.<field>.<attr>(...)`` call, or None."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == attr \
            and is_self_attr(node.func.value, field):
        return node
    return None


class _ClassModel:
    """Everything the obligation analysis needs about one manager class."""

    def __init__(self, mod: Module, node: ast.ClassDef):
        self.mod = mod
        self.node = node
        self.name = node.name
        self.methods: Dict[str, ast.FunctionDef] = {
            n.name: n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.entries_fields = self._entries_fields()
        self.accounting = self._accounting_methods()
        # method name -> set of return positions carrying obligations
        # ("whole" for non-tuple returns); filled by the summary pass
        self.summaries: Dict[str, Set[Any]] = {}

    def _entry_vars(self, fn: ast.AST, field: str) -> Set[str]:
        """Locals bound from ``self.<field>`` lookups/pops/iteration."""
        out: Set[str] = set()
        for n in walk_no_nested(fn):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                v = n.value
                if isinstance(v, ast.Subscript) \
                        and is_self_attr(v.value, field):
                    out.add(n.targets[0].id)
                elif isinstance(v, ast.Call) \
                        and isinstance(v.func, ast.Attribute) \
                        and v.func.attr in ("get", "pop") \
                        and is_self_attr(v.func.value, field):
                    out.add(n.targets[0].id)
            if isinstance(n, (ast.For, ast.AsyncFor)) \
                    and _mentions_field(n.iter, field):
                t = n.target
                for x in ([t] if isinstance(t, ast.Name) else
                          getattr(t, "elts", [])):
                    if isinstance(x, ast.Name):
                        out.add(x.id)
        return out

    def _entries_fields(self) -> Set[str]:
        """Fields whose looked-up values have ``.resident`` accessed —
        the residents dict(s) this class manages."""
        fields: Set[str] = set()
        candidates: Set[str] = set()
        for fn in self.methods.values():
            for n in walk_no_nested(fn):
                if isinstance(n, ast.Attribute) and is_self_attr(n) \
                        and not isinstance(n.value, ast.Attribute):
                    candidates.add(n.attr)
        for field in candidates:
            for fn in self.methods.values():
                evars = self._entry_vars(fn, field)
                if not evars:
                    continue
                for n in walk_no_nested(fn):
                    if isinstance(n, ast.Attribute) \
                            and n.attr == "resident" \
                            and isinstance(n.value, ast.Name) \
                            and n.value.id in evars:
                        fields.add(field)
                        break
                if field in fields:
                    break
        return fields

    def _accounting_methods(self) -> Set[str]:
        """Methods that (transitively) write a ``*bytes*`` counter."""
        direct: Set[str] = set()
        for name, fn in self.methods.items():
            for n in walk_no_nested(fn):
                targets: List[ast.expr] = []
                if isinstance(n, ast.Assign):
                    targets = n.targets
                elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                    targets = [n.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and is_self_attr(t) \
                            and "bytes" in t.attr.lower():
                        direct.add(name)
        changed = True
        while changed:
            changed = False
            for name, fn in self.methods.items():
                if name in direct:
                    continue
                for n in walk_no_nested(fn):
                    if isinstance(n, ast.Call) \
                            and isinstance(n.func, ast.Attribute) \
                            and isinstance(n.func.value, ast.Name) \
                            and n.func.value.id == "self" \
                            and n.func.attr in direct:
                        direct.add(name)
                        changed = True
                        break
        return direct


def _mentions_field(node: ast.AST, field: str) -> bool:
    return any(isinstance(n, ast.Attribute) and is_self_attr(n, field)
               for n in ast.walk(node))


def _parse_none_test(test: ast.expr) -> Optional[Tuple[str, bool]]:
    """-> (var, none_when_true) for ``x is None`` / ``x is not None`` /
    ``x`` / ``not x`` tests; None otherwise."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.left, ast.Name) \
            and isinstance(test.comparators[0], ast.Constant) \
            and test.comparators[0].value is None:
        if isinstance(test.ops[0], ast.Is):
            return (test.left.id, True)
        if isinstance(test.ops[0], ast.IsNot):
            return (test.left.id, False)
    if isinstance(test, ast.Name):
        return (test.id, False)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
            and isinstance(test.operand, ast.Name):
        return (test.operand.id, True)
    return None


class _MethodAnalysis:
    def __init__(self, model: _ClassModel, mname: str,
                 fn: ast.FunctionDef, use_summaries: bool):
        self.model = model
        self.mname = mname
        self.fn = fn
        self.use_summaries = use_summaries
        self.entry_vars: Set[str] = set()
        for f in model.entries_fields:
            self.entry_vars |= model._entry_vars(fn, f)
        # captured resident lists (for .clear()): vars assigned from an
        # expression that both references the entries field and reads
        # ``.resident``
        self.captured: Set[str] = set()
        for n in walk_no_nested(fn):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                for f in model.entries_fields:
                    if _mentions_field(n.value, f) and any(
                            isinstance(s, ast.Attribute)
                            and s.attr == "resident"
                            for s in ast.walk(n.value)):
                        self.captured.add(n.targets[0].id)
        self.immediate: List[Tuple[int, str]] = []
        self.obligation_lines: Dict[Tuple, str] = {}

    # -- events in one statement -------------------------------------------
    def _stmt_targets(self, st: ast.AST) -> Set[str]:
        out: Set[str] = set()
        if isinstance(st, ast.Assign):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    out |= {x.id for x in t.elts if isinstance(x, ast.Name)}
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)) \
                and isinstance(st.target, ast.Name):
            out.add(st.target.id)
        for n in stmt_scan(st):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)\
                    and n.func.attr in ("append", "extend") \
                    and isinstance(n.func.value, ast.Name):
                out.add(n.func.value.id)
        return out

    def transfer(self, state: _State, st: Optional[ast.AST],
                 nid: int) -> _State:
        if st is None or not isinstance(st, (ast.stmt,)):
            return state
        out: _State = dict(state)
        all_holders = frozenset(
            h for (p, hs) in out.values() if p for h in hs)

        # (a) holder extension: x = <holder-expr> / x.append(holder.resident)
        ext: Set[str] = set()
        if isinstance(st, ast.Assign) and _mentions(st.value, all_holders):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    ext.add(t.id)
        if isinstance(st, ast.AugAssign) \
                and isinstance(st.target, ast.Name) \
                and _mentions(st.value, all_holders):
            ext.add(st.target.id)
        for n in stmt_scan(st):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)\
                    and n.func.attr in ("append", "extend") \
                    and isinstance(n.func.value, ast.Name) \
                    and any(_mentions(a, all_holders) for a in n.args):
                ext.add(n.func.value.id)
        if ext:
            for oid, (p, hs) in list(out.items()):
                if p and hs & all_holders:
                    out[oid] = (p, hs | frozenset(ext))

        # (b) satisfaction
        released: Set[str] = set()
        accounted = False
        for n in stmt_scan(st):
            if isinstance(n, ast.Call):
                fname = n.func.attr if isinstance(n.func, ast.Attribute) \
                    else (n.func.id if isinstance(n.func, ast.Name) else "")
                if "release" in fname:
                    for sub in ([n.func.value] if isinstance(
                            n.func, ast.Attribute) else []) + list(n.args):
                        for x in ast.walk(sub):
                            if isinstance(x, ast.Name):
                                released.add(x.id)
                if isinstance(n.func, ast.Attribute) \
                        and isinstance(n.func.value, ast.Name) \
                        and n.func.value.id == "self" \
                        and n.func.attr in self.model.accounting:
                    accounted = True
            targets = []
            if isinstance(n, ast.Assign):
                targets = n.targets
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            for t in targets:
                if isinstance(t, ast.Attribute) and is_self_attr(t) \
                        and "bytes" in t.attr.lower():
                    accounted = True
        for oid, (p, hs) in list(out.items()):
            if not p:
                continue
            if oid[0] in ("remove", "call") and hs & released:
                out[oid] = (False, hs)
            elif oid[0] in ("insert", "hostacct") and accounted:
                out[oid] = (False, hs)
        if isinstance(st, ast.Return) and st.value is not None:
            for oid, (p, hs) in list(out.items()):
                if p and oid[0] in ("remove", "call") \
                        and _mentions(st.value, hs):
                    out[oid] = (False, hs)
                    self._record_summary(st.value, hs)

        # (c) kills: plain rebind of a holder to something unrelated
        if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                and isinstance(st.targets[0], ast.Name) \
                and not _mentions(st.value, all_holders):
            dead = st.targets[0].id
            for oid, (p, hs) in list(out.items()):
                if dead in hs:
                    out[oid] = (p, hs - {dead})

        # (d) new obligations
        self._new_obligations(st, out)
        return out

    def _record_summary(self, value: ast.expr, hs: FrozenSet[str]) -> None:
        summ = self.model.summaries.setdefault(self.mname, set())
        if isinstance(value, ast.Tuple):
            for i, elt in enumerate(value.elts):
                if _mentions(elt, hs):
                    summ.add(i)
        else:
            summ.add("whole")

    def _host_obligation(self, f: str, node: ast.AST, out: _State,
                         what: str, holders: FrozenSet[str]) -> None:
        """Host-tier removal -> accounting: entries fields named ``*host*``
        keep a running byte counter, so every removal must reach a
        ``*bytes*`` write (exception edges included — see exc_filter,
        which exempts only inserts). ``holders`` carries the popped
        entry's variables so ``is None`` guards prune the
        nothing-was-removed branch, same as the remove rule."""
        if "host" not in f.lower():
            return
        oid = ("hostacct", node.lineno, node.col_offset)
        out.setdefault(oid, (True, holders))
        self.obligation_lines[oid] = (
            f"host-tier {what} on self.{f}")

    def _new_obligations(self, st: ast.stmt, out: _State) -> None:
        for f in self.model.entries_fields:
            for n in stmt_scan(st):
                pop = _self_field_call(n, f, "pop") \
                    or _self_field_call(n, f, "popitem")
                if pop is not None:
                    holders = frozenset(self._stmt_targets(st))
                    oid = ("remove", pop.lineno, pop.col_offset)
                    if holders:
                        out.setdefault(oid, (True, holders))
                        self.obligation_lines[oid] = (
                            f"resident popped from self.{f}")
                    else:
                        self.immediate.append((
                            pop.lineno,
                            f"self.{f}.pop() result is discarded — the "
                            f"removed resident can never be released"))
                    self._host_obligation(f, pop, out, "pop", holders)
                clr = _self_field_call(n, f, "clear")
                if clr is not None:
                    if self.captured:
                        oid = ("remove", clr.lineno, clr.col_offset)
                        out.setdefault(oid,
                                       (True, frozenset(self.captured)))
                        self.obligation_lines[oid] = (
                            f"residents cleared from self.{f}")
                    else:
                        self.immediate.append((
                            clr.lineno,
                            f"self.{f}.clear() drops every resident "
                            f"without capturing them for release"))
                    self._host_obligation(f, clr, out, "clear",
                                          frozenset(self.captured))
            if isinstance(st, ast.Delete):
                for t in st.targets:
                    if isinstance(t, ast.Subscript) \
                            and is_self_attr(t.value, f):
                        oid = ("remove", st.lineno, st.col_offset)
                        out.setdefault(
                            oid, (True, frozenset(self.entry_vars)))
                        self.obligation_lines[oid] = (
                            f"resident deleted from self.{f}")
                        self._host_obligation(f, st, out, "delete",
                                              frozenset(self.entry_vars))
            if isinstance(st, ast.Assign) and self.model.accounting:
                for t in st.targets:
                    if isinstance(t, ast.Subscript) \
                            and is_self_attr(t.value, f):
                        oid = ("insert", st.lineno, st.col_offset)
                        out.setdefault(oid, (True, frozenset()))
                        self.obligation_lines[oid] = (
                            f"resident inserted into self.{f}")
        # caller obligations from summarized self-calls
        if self.use_summaries and isinstance(
                st, (ast.Assign, ast.AugAssign)):
            call = st.value if isinstance(st.value, ast.Call) else None
            if call is not None and isinstance(call.func, ast.Attribute) \
                    and isinstance(call.func.value, ast.Name) \
                    and call.func.value.id == "self":
                summ = self.model.summaries.get(call.func.attr)
                if summ:
                    holders: Set[str] = set()
                    if isinstance(st, ast.AugAssign) \
                            and isinstance(st.target, ast.Name):
                        holders.add(st.target.id)
                    elif isinstance(st, ast.Assign):
                        for t in st.targets:
                            if isinstance(t, ast.Name):
                                holders.add(t.id)
                            elif isinstance(t, ast.Tuple):
                                for i, x in enumerate(t.elts):
                                    if (i in summ or "whole" in summ) \
                                            and isinstance(x, ast.Name):
                                        holders.add(x.id)
                    if holders:
                        oid = ("call", st.lineno, st.col_offset)
                        out.setdefault(oid, (True, frozenset(holders)))
                        self.obligation_lines[oid] = (
                            f"unreleased residents returned by "
                            f"self.{call.func.attr}()")

    # -- run ----------------------------------------------------------------
    def run(self) -> Dict[Tuple, str]:
        cfg = build_cfg(self.fn)

        def join(a: _State, b: _State) -> _State:
            out = dict(a)
            for oid, (p, h) in b.items():
                if oid in out:
                    p0, h0 = out[oid]
                    out[oid] = (p or p0, h0 | h)
                else:
                    out[oid] = (p, h)
            return out

        def refine(state: _State, test, is_true: bool) -> _State:
            if test is None:
                return state
            parsed = _parse_none_test(test)
            if parsed is None:
                return state
            var, none_when_true = parsed
            if none_when_true != is_true:
                return state
            out: _State = {}
            for oid, (p, h) in state.items():
                if p and var in h:
                    h2 = h - {var}
                    out[oid] = (p if h2 else False, h2)
                else:
                    out[oid] = (p, h)
            return out

        def exc_filter(state: _State) -> _State:
            # inserts are exempt on exception paths (the next refresh
            # re-measures); removals still must release
            return {oid: v for oid, v in state.items()
                    if oid[0] != "insert"}

        fa = ForwardAnalysis(cfg, {}, self.transfer, join,
                             refine=refine, exc_filter=exc_filter)
        inn = fa.run()
        exit_state = inn.get(cfg.exit, {})
        leaks: Dict[Tuple, str] = {}
        for oid, (p, _h) in exit_state.items():
            if p:
                leaks[oid] = self.obligation_lines.get(oid, "resident")
        return leaks


@register("conservation")
def check_conservation(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                methods = {n.name for n in node.body
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))}
                if "_release_all" in methods:
                    _check_manager(mod, node, findings)
                if "nbytes" in methods and "release" in methods:
                    _check_cache_parity(mod, node, findings)
                    _check_chunkacct(mod, node, findings)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_spanpair(mod, node, findings)
                _check_idxacct(mod, node, findings)
    return findings


# --------------------------------------------------------------------------
# idxacct: a pinned idx-array slice must reach byte accounting on every
# fall-through path — the index-rung residency obligation
# --------------------------------------------------------------------------

class _IdxAcctAnalysis:
    """Forward obligation analysis over one function: a ``.index_slice(...)``
    call grows a staged resident's device footprint (the docId gather array
    is pinned in the resident's slice cache), so every fall-through path to
    exit must pass a residency ``.account(...)`` call or a direct ``*bytes*``
    counter write. Exception edges are exempt — ``nbytes()`` walks the slice
    cache, so the next refresh re-measures (same rationale as the insert
    rule)."""

    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.obligation_lines: Dict[Tuple, int] = {}

    @staticmethod
    def _opens(st: ast.stmt) -> Optional[int]:
        for n in stmt_scan(st):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "index_slice":
                return n.lineno
        return None

    @staticmethod
    def _discharges(st: ast.stmt) -> bool:
        targets: List[ast.expr] = []
        if isinstance(st, ast.Assign):
            targets = st.targets
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            targets = [st.target]
        for t in targets:
            if isinstance(t, ast.Attribute) and is_self_attr(t) \
                    and "bytes" in t.attr.lower():
                return True
        for n in stmt_scan(st):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "account":
                return True
        return False

    def transfer(self, state: Dict[Tuple, bool], st: Optional[ast.AST],
                 nid: int) -> Dict[Tuple, bool]:
        if st is None or not isinstance(st, ast.stmt):
            return state
        out = dict(state)
        if self._discharges(st):
            out = {oid: False for oid in out}
        line = self._opens(st)
        if line is not None:
            oid = ("idx", st.lineno, getattr(st, "col_offset", 0))
            out[oid] = True
            self.obligation_lines[oid] = line
        return out

    def run(self) -> List[int]:
        cfg = build_cfg(self.fn)

        def join(a: Dict[Tuple, bool],
                 b: Dict[Tuple, bool]) -> Dict[Tuple, bool]:
            out = dict(a)
            for oid, p in b.items():
                out[oid] = out.get(oid, False) or p
            return out

        fa = ForwardAnalysis(cfg, {}, self.transfer, join,
                             exc_filter=lambda s: {})
        inn = fa.run()
        exit_state = inn.get(cfg.exit, {})
        return sorted(self.obligation_lines[oid]
                      for oid, p in exit_state.items() if p)


def _check_idxacct(mod: Module, fn: ast.AST,
                   findings: List[Finding]) -> None:
    if not any(isinstance(n, ast.Call)
               and isinstance(n.func, ast.Attribute)
               and n.func.attr == "index_slice"
               for n in walk_no_nested(fn)):
        return
    for line in _IdxAcctAnalysis(fn).run():
        findings.append(Finding(
            "conservation", mod.relpath, line,
            f"{fn.name}:idxacct",
            f"index_slice in {fn.name}() pins a device idx array on a "
            f"path that exits without reaching byte accounting — the "
            f"resident's budgeted footprint predates the pinned slice"))


# --------------------------------------------------------------------------
# spanpair: span_begin must reach span_end on all paths (exception edges
# included) — the trace-tree integrity obligation
# --------------------------------------------------------------------------

def _call_last_name(n: ast.Call) -> str:
    f = n.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _names_in(nodes) -> Set[str]:
    out: Set[str] = set()
    for node in nodes:
        for x in ast.walk(node):
            if isinstance(x, ast.Name):
                out.add(x.id)
    return out


class _SpanPairAnalysis:
    """Forward obligation analysis over one function: every span_begin
    assigned to a local must meet a span_end naming it on every path to
    exit — the same CFG/exception-edge machinery the hostacct obligation
    uses, scoped package-wide (spans open anywhere)."""

    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.immediate: List[int] = []
        self.obligation_lines: Dict[Tuple, int] = {}

    def transfer(self, state: _State, st: Optional[ast.AST],
                 nid: int) -> _State:
        if st is None or not isinstance(st, ast.stmt):
            return state
        out: _State = dict(state)
        all_holders = frozenset(
            h for (p, hs) in out.values() if p for h in hs)

        # discharges
        ended: Set[str] = set()
        for n in stmt_scan(st):
            if isinstance(n, ast.Call) \
                    and _call_last_name(n) == "span_end":
                ended |= _names_in(list(n.args)
                                   + [k.value for k in n.keywords])
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # done-callback shape: a nested function owning the close
            # discharges at its def (the closure pins the span until then)
            for n in ast.walk(st):
                if isinstance(n, ast.Call) \
                        and _call_last_name(n) == "span_end":
                    ended |= _names_in(list(n.args)
                                       + [k.value for k in n.keywords])
        returned: Set[str] = set()
        if isinstance(st, ast.Return) and st.value is not None:
            returned = _names_in([st.value])
        stored_names: Set[str] = set()
        if all_holders:
            for n in stmt_scan(st):
                if isinstance(n, ast.Assign) \
                        and any(isinstance(t, ast.Attribute)
                                for t in n.targets):
                    stored_names |= _names_in([n.value]) & all_holders
        for oid, (p, hs) in list(out.items()):
            if p and hs & (ended | returned | stored_names):
                out[oid] = (False, hs)

        # kills: rebinding a holder to something unrelated
        if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                and isinstance(st.targets[0], ast.Name) \
                and not _mentions(st.value, all_holders):
            dead = st.targets[0].id
            for oid, (p, hs) in list(out.items()):
                if dead in hs:
                    out[oid] = (p, hs - {dead})

        # new obligations
        for n in stmt_scan(st):
            if not (isinstance(n, ast.Call)
                    and _call_last_name(n) == "span_begin"):
                continue
            holders: Set[str] = set()
            if isinstance(st, ast.Assign):
                for t in st.targets:
                    if isinstance(t, ast.Name):
                        holders.add(t.id)
            elif isinstance(st, ast.AnnAssign) \
                    and isinstance(st.target, ast.Name):
                holders.add(st.target.id)
            elif isinstance(st, ast.Return):
                continue  # returned to the caller: it owns the close
            if holders:
                oid = ("span", n.lineno, n.col_offset)
                out.setdefault(oid, (True, frozenset(holders)))
                self.obligation_lines[oid] = n.lineno
            elif isinstance(st, ast.Expr):
                # bare call, result discarded: can never be closed
                self.immediate.append(n.lineno)
            # attribute-target assigns fall through obligation-free: the
            # span escaped to object state, a teardown hook owns it
        return out

    def run(self) -> List[int]:
        cfg = build_cfg(self.fn)

        def join(a: _State, b: _State) -> _State:
            out = dict(a)
            for oid, (p, h) in b.items():
                if oid in out:
                    p0, h0 = out[oid]
                    out[oid] = (p or p0, h0 | h)
                else:
                    out[oid] = (p, h)
            return out

        def refine(state: _State, test, is_true: bool) -> _State:
            if test is None:
                return state
            parsed = _parse_none_test(test)
            if parsed is None:
                return state
            var, none_when_true = parsed
            if none_when_true != is_true:
                return state
            out: _State = {}
            for oid, (p, h) in state.items():
                if p and var in h:
                    h2 = h - {var}
                    out[oid] = (p if h2 else False, h2)
                else:
                    out[oid] = (p, h)
            return out

        fa = ForwardAnalysis(cfg, {}, self.transfer, join, refine=refine,
                             exc_filter=lambda s: s)
        inn = fa.run()
        exit_state = inn.get(cfg.exit, {})
        return [self.obligation_lines[oid]
                for oid, (p, _h) in sorted(exit_state.items()) if p]


def _check_spanpair(mod: Module, fn: ast.AST,
                    findings: List[Finding]) -> None:
    if not any(isinstance(n, ast.Call)
               and _call_last_name(n) == "span_begin"
               for n in walk_no_nested(fn)):
        return
    sa = _SpanPairAnalysis(fn)
    for line in sa.run():
        findings.append(Finding(
            "conservation", mod.relpath, line,
            f"{fn.name}:spanpair",
            f"span_begin in {fn.name}() never reaches span_end on some "
            f"path (exception edges included) — the span tree is left "
            f"open and the query's trace is corrupted"))
    for line in sa.immediate:
        findings.append(Finding(
            "conservation", mod.relpath, line,
            f"{fn.name}:spanpair-discard",
            f"span_begin result discarded in {fn.name}() — the span can "
            f"never be closed"))


def _check_manager(mod: Module, node: ast.ClassDef,
                   findings: List[Finding]) -> None:
    model = _ClassModel(mod, node)
    if not model.entries_fields:
        return
    skip = {"__init__", "__del__", "_release_all"}
    # pass 1: build return-position summaries
    for mname, fn in model.methods.items():
        if mname in skip:
            continue
        _MethodAnalysis(model, mname, fn, use_summaries=False).run()
    # pass 2: full analysis with caller obligations
    for mname, fn in model.methods.items():
        if mname in skip:
            continue
        ma = _MethodAnalysis(model, mname, fn, use_summaries=True)
        leaks = ma.run()
        for (kind, line, _col), what in sorted(leaks.items()):
            if kind == "insert":
                findings.append(Finding(
                    "conservation", mod.relpath, line,
                    f"{model.name}.{mname}:insert",
                    f"{what} in {mname}() without re-running byte "
                    f"accounting on every fall-through path — "
                    f"stagedBytes drifts from the budget"))
            elif kind == "hostacct":
                findings.append(Finding(
                    "conservation", mod.relpath, line,
                    f"{model.name}.{mname}:hostacct",
                    f"{what} in {mname}() never reaches a byte-counter "
                    f"write on some path (exception edges included) — "
                    f"the host-tier running byte total drifts from "
                    f"reality"))
            else:
                findings.append(Finding(
                    "conservation", mod.relpath, line,
                    f"{model.name}.{mname}:{kind}",
                    f"{what} in {mname}() is neither released nor "
                    f"returned to the caller on some path (exception "
                    f"edges included) — HBM leaks until GC"))
        for line, msg in ma.immediate:
            findings.append(Finding(
                "conservation", mod.relpath, line,
                f"{model.name}.{mname}:discard",
                f"{msg} (in {mname}())"))


_HOST_SCALARS = frozenset({"int", "float", "bool", "str", "bytes"})
_HOST_CONTAINERS = frozenset({"Dict", "dict", "Set", "set", "FrozenSet",
                              "frozenset", "List", "list", "Tuple",
                              "tuple", "Optional"})


def _host_scalar_annotation(ann: Optional[ast.expr]) -> bool:
    """``int`` / ``Dict[str, int]`` / ``Set[int]`` ...: host values only."""
    if isinstance(ann, ast.Name):
        return ann.id in _HOST_SCALARS
    if isinstance(ann, ast.Constant) and ann.value is None:
        return True
    if isinstance(ann, ast.Subscript) and isinstance(ann.value, ast.Name) \
            and ann.value.id in _HOST_CONTAINERS:
        sl = ann.slice
        parts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        return all(_host_scalar_annotation(p) for p in parts)
    return False


def _is_clear_value(v: Optional[ast.expr]) -> bool:
    """``None``, a number, or an empty container: resetting, not caching."""
    if isinstance(v, ast.Constant):
        return v.value is None or isinstance(v.value, (int, float))
    if isinstance(v, (ast.Dict, ast.List, ast.Set, ast.Tuple)):
        return not (getattr(v, "keys", None) or getattr(v, "elts", None))
    if isinstance(v, ast.Call) and not v.args and not v.keywords:
        f = v.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        return name in ("dict", "list", "set", "OrderedDict", "deque")
    return False


def _self_callees(fn: ast.AST, methods: Dict[str, ast.AST]) -> List[ast.AST]:
    """``fn`` and the class methods it reaches through ``self.m(...)``."""
    out, todo, seen = [], [fn], set()
    while todo:
        f = todo.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        out.append(f)
        for n in ast.walk(f):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and isinstance(n.func.value, ast.Name) \
                    and n.func.value.id == "self" \
                    and n.func.attr in methods:
                todo.append(methods[n.func.attr])
    return out


def _check_cache_parity(mod: Module, node: ast.ClassDef,
                        findings: List[Finding]) -> None:
    methods = {n.name: n for n in node.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    nbytes_fn = methods["nbytes"]
    release_fn = methods["release"]
    # fields __init__ sets to a number, and fields it annotates as host
    # scalars
    numeric_init: Set[str] = set()
    host_typed: Set[str] = set()
    init = methods.get("__init__")
    for n in (walk_no_nested(init) if init is not None else ()):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant) \
                and isinstance(n.value.value, (int, float)) \
                and not isinstance(n.value.value, bool):
            numeric_init |= {t.attr for t in n.targets if is_self_attr(t)}
        elif isinstance(n, ast.AnnAssign) and is_self_attr(n.target):
            if _host_scalar_annotation(n.annotation):
                host_typed.add(n.target.attr)
            if isinstance(n.value, ast.Constant) \
                    and isinstance(n.value.value, (int, float)):
                numeric_init.add(n.target.attr)
    fields: Dict[str, Tuple[str, int]] = {}
    # field -> every method populating it; fields ever given a non-number
    populators: Dict[str, Set[str]] = {}
    not_scalar: Set[str] = set()
    # method -> the self.*bytes* counters it adds to
    bumps: Dict[str, Set[str]] = {}
    for mname, fn in methods.items():
        if mname in ("__init__", "release", "nbytes"):
            continue
        for n in walk_no_nested(fn):
            if isinstance(n, ast.AugAssign) and isinstance(n.op, ast.Add) \
                    and is_self_attr(n.target) \
                    and "bytes" in n.target.attr.lower():
                bumps.setdefault(mname, set()).add(n.target.attr)
            targets: List[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(n, ast.Assign):
                targets, value = n.targets, n.value
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets, value = [n.target], n.value
            for t in targets:
                base = t
                while isinstance(base, ast.Subscript):
                    base = base.value
                if not (isinstance(base, ast.Attribute)
                        and is_self_attr(base)):
                    continue
                if base is t and not isinstance(n, ast.AugAssign) \
                        and _is_clear_value(value):
                    continue    # a reset, not a population
                if base is not t or not isinstance(n, ast.AugAssign):
                    not_scalar.add(base.attr)
                fields.setdefault(base.attr, (mname, n.lineno))
                populators.setdefault(base.attr, set()).add(mname)
            # mutating-call population (``self.F.setdefault(k, arrays)``,
            # ``.update``, ``.append``): the star-tree node-array shape —
            # a cache filled without a plain subscript assignment must
            # still obey the nbytes()/release() parity contract
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("setdefault", "update", "append") \
                    and n.args:
                base = n.func.value
                while isinstance(base, ast.Subscript):
                    base = base.value
                if isinstance(base, ast.Attribute) and is_self_attr(base):
                    fields.setdefault(base.attr, (mname, n.lineno))
                    populators.setdefault(base.attr, set()).add(mname)
                    not_scalar.add(base.attr)
    read_in_nbytes = {n.attr for n in ast.walk(nbytes_fn)
                      if isinstance(n, ast.Attribute) and is_self_attr(n)}
    counters = {f for f in read_in_nbytes if "bytes" in f.lower()}
    for f, ms in populators.items():
        if f not in read_in_nbytes and counters and all(
                bumps.get(m, set()) & counters for m in ms):
            read_in_nbytes.add(f)   # kept in the running byte total
    for f in numeric_init - not_scalar:
        read_in_nbytes.add(f)       # a scalar counter holds no device bytes
    read_in_nbytes |= host_typed
    cleared: Set[str] = set(numeric_init - not_scalar)
    for n in (x for f in _self_callees(release_fn, methods)
              for x in ast.walk(f)):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Attribute) and is_self_attr(t):
                    cleared.add(t.attr)
        if isinstance(n, ast.Delete):
            for t in n.targets:
                if isinstance(t, ast.Attribute) and is_self_attr(t):
                    cleared.add(t.attr)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in ("clear", "pop", "popitem") \
                and isinstance(n.func.value, ast.Attribute) \
                and is_self_attr(n.func.value):
            cleared.add(n.func.value.attr)
    for field, (mname, line) in sorted(fields.items()):
        if field not in read_in_nbytes:
            findings.append(Finding(
                "conservation", mod.relpath, line,
                f"{node.name}.{field}:nbytes",
                f"{node.name}.{field} is populated in {mname}() but "
                f"never counted in nbytes() — resident bytes invisible "
                f"to the HBM budget"))
        if field not in cleared:
            findings.append(Finding(
                "conservation", mod.relpath, line,
                f"{node.name}.{field}:release",
                f"{node.name}.{field} is populated in {mname}() but "
                f"never cleared in release() — device arrays outlive "
                f"eviction"))


# --------------------------------------------------------------------------
# chunkacct: every chunk append must reach the running byte counter on all
# paths (exception edges included) — the mutable-staging watermark
# accounting obligation
# --------------------------------------------------------------------------

class _ChunkAcctAnalysis:
    """Forward obligation analysis over one method: a store into a
    ``self.*chunk*`` collection opens an obligation that only a ``*bytes*``
    counter write (direct, or via one of the class's accounting methods)
    discharges; any path reaching exit with the obligation pending has
    grown the device image without telling the HBM budget."""

    def __init__(self, fn: ast.AST, accounting: Set[str]):
        self.fn = fn
        self.accounting = accounting
        self.obligation_lines: Dict[Tuple, int] = {}

    @staticmethod
    def chunk_store_line(st: ast.stmt) -> Optional[int]:
        """Line of a subscript store into a self.*chunk* field, or None."""
        targets: List[ast.expr] = []
        if isinstance(st, ast.Assign):
            targets = st.targets
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            targets = [st.target]
        for t in targets:
            if not isinstance(t, ast.Subscript):
                continue
            base = t
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Attribute) and is_self_attr(base) \
                    and "chunk" in base.attr.lower():
                return st.lineno
        return None

    def _discharges(self, st: ast.stmt) -> bool:
        targets: List[ast.expr] = []
        if isinstance(st, ast.Assign):
            targets = st.targets
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            targets = [st.target]
        for t in targets:
            if isinstance(t, ast.Attribute) and is_self_attr(t) \
                    and "bytes" in t.attr.lower():
                return True
        for n in stmt_scan(st):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and isinstance(n.func.value, ast.Name) \
                    and n.func.value.id == "self" \
                    and n.func.attr in self.accounting:
                return True
        return False

    def transfer(self, state: Dict[Tuple, bool], st: Optional[ast.AST],
                 nid: int) -> Dict[Tuple, bool]:
        if st is None or not isinstance(st, ast.stmt):
            return state
        out = dict(state)
        if self._discharges(st):
            out = {oid: False for oid in out}
        line = self.chunk_store_line(st)
        if line is not None:
            oid = ("chunk", st.lineno, getattr(st, "col_offset", 0))
            out[oid] = True
            self.obligation_lines[oid] = line
        return out

    def run(self) -> List[int]:
        cfg = build_cfg(self.fn)

        def join(a: Dict[Tuple, bool],
                 b: Dict[Tuple, bool]) -> Dict[Tuple, bool]:
            out = dict(a)
            for oid, p in b.items():
                out[oid] = out.get(oid, False) or p
            return out

        fa = ForwardAnalysis(cfg, {}, self.transfer, join,
                             exc_filter=lambda s: s)
        inn = fa.run()
        exit_state = inn.get(cfg.exit, {})
        return sorted(self.obligation_lines[oid]
                      for oid, p in exit_state.items() if p)


def _check_chunkacct(mod: Module, node: ast.ClassDef,
                     findings: List[Finding]) -> None:
    """Dispatched for every nbytes()+release() resident class; only
    classes that append into ``self.*chunk*`` collections are analyzed.
    A chunk collection that ``nbytes()`` walks itself, and from which no
    method derives a ``*bytes*`` counter, needs no running counter: every
    store is measured at the next residency refresh."""
    model = _ClassModel(mod, node)
    nb = model.methods.get("nbytes")
    # fields nbytes() walks element by element (``self.F.values()``)
    walked = {n.func.value.attr for n in ast.walk(nb)
              if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Attribute)
              and n.func.attr in ("values", "items")
              and is_self_attr(n.func.value)
              and "chunk" in n.func.value.attr.lower()} \
        if nb is not None else set()
    for mname, fn in model.methods.items():
        if mname in ("nbytes", "release", "__init__"):
            continue
        writes_counter = any(
            isinstance(n, (ast.Assign, ast.AugAssign))
            and any(is_self_attr(t) and "bytes" in t.attr.lower()
                    for t in (n.targets if isinstance(n, ast.Assign)
                              else [n.target]))
            for n in ast.walk(fn))
        if writes_counter:
            walked -= {n.attr for n in ast.walk(fn)
                       if isinstance(n, ast.Attribute) and is_self_attr(n)}

    def unwalked_store(st: ast.stmt) -> Optional[int]:
        line = _ChunkAcctAnalysis.chunk_store_line(st)
        if line is None or not walked:
            return line
        targets = st.targets if isinstance(st, ast.Assign) else [
            getattr(st, "target", None)]
        for t in targets:
            while isinstance(t, ast.Subscript):
                t = t.value
            if isinstance(t, ast.Attribute) and t.attr in walked:
                return None
        return line

    for mname, fn in model.methods.items():
        if mname == "__init__":
            continue
        store_lines = [
            line for st in walk_no_nested(fn) if isinstance(st, ast.stmt)
            for line in [unwalked_store(st)]
            if line is not None]
        if not store_lines:
            continue
        if not model.accounting:
            for line in store_lines:
                findings.append(Finding(
                    "conservation", mod.relpath, line,
                    f"{node.name}.{mname}:chunkacct",
                    f"{node.name}.{mname}() appends a device chunk but the "
                    f"class has no byte-counter accounting method — staged "
                    f"bytes invisible to the HBM budget"))
            continue
        analysis = _ChunkAcctAnalysis(fn, model.accounting)
        for line in analysis.run():
            if line not in store_lines:
                continue    # a store into a chunk collection nbytes walks
            findings.append(Finding(
                "conservation", mod.relpath, line,
                f"{node.name}.{mname}:chunkacct",
                f"{node.name}.{mname}() appends a device chunk on a path "
                f"that exits without updating the byte counter — the HBM "
                f"budget drifts from the true staged footprint"))
