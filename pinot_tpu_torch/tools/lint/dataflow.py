"""Interprocedural dataflow engine for graftlint's dataflow families.

Three reusable pieces, all stdlib-``ast`` (importing this module must never
pull torch — the CLI runs where torch cannot be imported):

- :func:`build_cfg` — a per-function, statement-level control-flow graph.
  ``If``/``While``/``For`` statements become *test* nodes with labeled
  ``("true", test)`` / ``("false", test)`` out-edges; ``try`` statements
  contribute **exception edges** (every statement lexically inside a
  ``try`` body gets an ``"exc"`` edge to each handler entry and to the
  ``finally`` entry), ``return``/``raise`` route through enclosing
  ``finally`` blocks, and the ``finally`` frontier also reaches EXIT (the
  re-raise continuation). Statements *outside* any ``try`` are not assumed
  to raise — that keeps the path set honest enough for zero-baseline gating
  while still modeling the handler/finally shapes the conservation family
  must see.
- :class:`ForwardAnalysis` — a generic worklist forward abstract
  interpretation over a CFG: caller supplies ``init``/``transfer``/``join``
  plus optional ``refine`` (branch pruning on test edges) and
  ``exc_filter`` (state surgery on exception edges; ``"exc"`` edges
  propagate the raising node's PRE-state, since its effect may not have
  applied).
- :class:`DispatchExecutor` — a bounded micro-interpreter for the
  *dispatch-function* shape (``op = spec[0]; if op == "eq": ...``) that the
  kernel param protocol lives in. It tracks an environment of
  constant-string value sets (assignments, slices like ``op[3:]``,
  ``+``-concatenation, ``startswith``), prunes branches whose tests it can
  decide, counts protocol events (``pc.take()`` calls, ``params.append``)
  per path via a caller-supplied counter, and follows name-resolved calls
  through :func:`take_summary`-style **call summaries** (cycle-guarded:
  recursion or variable-count callees mark the path ``unknown`` instead of
  guessing). Paths end in ``return`` / ``raise`` / fall-through outcomes;
  checks skip ``unknown`` outcomes rather than report on them.

The dataflow checker families compose these: ``protocol`` uses the
executor + summaries, ``sync`` runs taint as a ForwardAnalysis and chases
the lock/thread call graphs, ``conservation`` runs paired-effect
obligations over the exception-edged CFG.
"""

from __future__ import annotations

import ast

from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

# -- CFG --------------------------------------------------------------------


class CFG:
    """Statement-level CFG: node 0 = ENTRY, 1 = EXIT; every other node
    carries one ast statement (compound statements are their own *test* /
    marker nodes; bodies hang off labeled edges). Edge labels:

    - ``None`` — unconditional fall-through;
    - ``("true", test)`` / ``("false", test)`` — branch edges out of an
      ``If``/``While`` test node (``For`` uses ``None`` tests);
    - ``"exc"`` — exception edge (carries the raising node's PRE-state).
    """

    def __init__(self, func: ast.AST):
        self.func = func
        self.stmts: List[Optional[ast.AST]] = []
        self.succ: List[List[Tuple[int, Any]]] = []
        self.entry = self.add(None)
        self.exit = self.add(None)

    def add(self, stmt: Optional[ast.AST]) -> int:
        self.stmts.append(stmt)
        self.succ.append([])
        return len(self.stmts) - 1

    def edge(self, a: int, b: int, label: Any = None) -> None:
        self.succ[a].append((b, label))


# id(func node) -> (func node, CFG): the shared-CFG cache (lint core).
# Several families build the CFG of the same function in one suite run —
# and parsed Modules are themselves cached across runs, so ast node
# identities persist. The entry pins the func node (strong ref) so its
# id cannot be recycled while the memo holds it; ForwardAnalysis keeps
# all per-run state on itself, never on the CFG, so sharing is safe.
_CFG_MEMO: Dict[int, Tuple[ast.AST, CFG]] = {}
_CFG_MEMO_CAP = 32768


def build_cfg(func: ast.AST) -> CFG:
    hit = _CFG_MEMO.get(id(func))
    if hit is not None and hit[0] is func:
        return hit[1]
    cfg = _build_cfg(func)
    if len(_CFG_MEMO) >= _CFG_MEMO_CAP:
        _CFG_MEMO.clear()
    _CFG_MEMO[id(func)] = (func, cfg)
    return cfg


def _build_cfg(func: ast.AST) -> CFG:
    cfg = CFG(func)
    loop_stack: List[Dict[str, Any]] = []
    finally_stack: List[int] = []
    exc_stack: List[List[int]] = []

    def attach(preds, n: int) -> None:
        for p, lbl in preds:
            cfg.edge(p, n, lbl)

    def simple(st, preds) -> int:
        n = cfg.add(st)
        attach(preds, n)
        if exc_stack:
            for t in exc_stack[-1]:
                cfg.edge(n, t, "exc")
        return n

    def seq(stmts, preds):
        for st in stmts:
            preds = do(st, preds)
            if not preds:
                break
        return preds

    def do(st, preds):
        if isinstance(st, ast.If):
            n = simple(st, preds)
            out = seq(st.body, [(n, ("true", st.test))])
            if st.orelse:
                out = out + seq(st.orelse, [(n, ("false", st.test))])
            else:
                out = out + [(n, ("false", st.test))]
            return out
        if isinstance(st, (ast.While, ast.For, ast.AsyncFor)):
            n = simple(st, preds)
            test = st.test if isinstance(st, ast.While) else None
            ctx: Dict[str, Any] = {"breaks": [], "test": n}
            loop_stack.append(ctx)
            body_out = seq(st.body, [(n, ("true", test))])
            loop_stack.pop()
            attach(body_out, n)  # back edge
            out = [(n, ("false", test))] + ctx["breaks"]
            if st.orelse:
                out = seq(st.orelse, out)
            return out
        if isinstance(st, ast.Break):
            n = simple(st, preds)
            if loop_stack:
                loop_stack[-1]["breaks"].append((n, None))
            return []
        if isinstance(st, ast.Continue):
            n = simple(st, preds)
            if loop_stack:
                cfg.edge(n, loop_stack[-1]["test"])
            return []
        if isinstance(st, ast.Return):
            n = simple(st, preds)
            cfg.edge(n, finally_stack[-1] if finally_stack else cfg.exit)
            return []
        if isinstance(st, ast.Raise):
            n = simple(st, preds)  # simple() wired the handler edges
            if not exc_stack:
                cfg.edge(n, finally_stack[-1] if finally_stack
                         else cfg.exit)
            return []
        if isinstance(st, ast.Try):
            hmarks = [cfg.add(h) for h in st.handlers]
            fmark = cfg.add(st) if st.finalbody else None
            targets = list(hmarks)
            if fmark is not None:
                targets.append(fmark)
            exc_stack.append(targets or [cfg.exit])
            if fmark is not None:
                finally_stack.append(fmark)
            body_out = seq(st.body, preds)
            if st.orelse:
                body_out = seq(st.orelse, body_out)
            exc_stack.pop()
            houts: List[Tuple[int, Any]] = []
            for h, m in zip(st.handlers, hmarks):
                houts += seq(h.body, [(m, None)])
            if fmark is not None:
                finally_stack.pop()
                attach(body_out + houts, fmark)
                fout = seq(st.finalbody, [(fmark, None)])
                for p, lbl in fout:
                    cfg.edge(p, cfg.exit, lbl)  # re-raise continuation
                return fout
            return body_out + houts
        if isinstance(st, (ast.With, ast.AsyncWith)):
            n = simple(st, preds)
            return seq(st.body, [(n, None)])
        n = simple(st, preds)
        return [(n, None)]

    out = seq(getattr(func, "body", []), [(cfg.entry, None)])
    attach(out, cfg.exit)
    return cfg


# -- forward analysis -------------------------------------------------------


class ForwardAnalysis:
    """Worklist forward dataflow over a :class:`CFG`.

    ``transfer(state, stmt, node_id) -> state`` must not mutate its input;
    ``join(a, b)`` merges; states must support ``==``. ``refine(state,
    test, is_true)`` optionally prunes along branch edges; ``exc_filter``
    optionally drops state components along ``"exc"`` edges.
    """

    def __init__(self, cfg: CFG, init: Any,
                 transfer: Callable[[Any, Optional[ast.AST], int], Any],
                 join: Callable[[Any, Any], Any],
                 refine: Optional[Callable] = None,
                 exc_filter: Optional[Callable] = None,
                 max_steps: int = 20000):
        self.cfg = cfg
        self.init = init
        self.transfer = transfer
        self.join = join
        self.refine = refine
        self.exc_filter = exc_filter
        self.max_steps = max_steps
        self.inn: Dict[int, Any] = {}

    def run(self) -> Dict[int, Any]:
        cfg = self.cfg
        self.inn = {cfg.entry: self.init}
        work = [cfg.entry]
        steps = 0
        while work and steps < self.max_steps:
            steps += 1
            n = work.pop()
            s = self.inn.get(n)
            if s is None:
                continue
            out = self.transfer(s, cfg.stmts[n], n)
            for m, lbl in cfg.succ[n]:
                if lbl == "exc":
                    v = s if self.exc_filter is None else self.exc_filter(s)
                elif isinstance(lbl, tuple) and self.refine is not None:
                    v = self.refine(out, lbl[1], lbl[0] == "true")
                else:
                    v = out
                cur = self.inn.get(m)
                nv = v if cur is None else self.join(cur, v)
                if nv != cur:
                    self.inn[m] = nv
                    work.append(m)
        return self.inn


# -- constant-set expression evaluation -------------------------------------

# env: var name (or ("idx0", param) for the dispatch subscript P[0]) ->
# frozenset of possible constant values. Sets stay tiny (cap below).
_SET_CAP = 8


def eval_expr(e: ast.expr, env: Dict[Any, FrozenSet]) -> Optional[FrozenSet]:
    """Possible constant values of ``e`` under ``env``, or None (unknown)."""
    if isinstance(e, ast.Constant):
        return frozenset([e.value])
    if isinstance(e, ast.Name):
        return env.get(e.id)
    if isinstance(e, ast.Subscript):
        idx = e.slice
        if isinstance(e.value, ast.Name) and isinstance(idx, ast.Constant) \
                and idx.value == 0:
            seed = env.get(("idx0", e.value.id))
            if seed is not None:
                return seed
        base = eval_expr(e.value, env)
        if base is None:
            return None
        out = set()
        for b in base:
            try:
                if isinstance(idx, ast.Constant):
                    out.add(b[idx.value])
                elif isinstance(idx, ast.Slice):
                    lo = idx.lower.value if isinstance(
                        idx.lower, ast.Constant) else None
                    hi = idx.upper.value if isinstance(
                        idx.upper, ast.Constant) else None
                    if idx.lower is not None and lo is None:
                        return None
                    if idx.upper is not None and hi is None:
                        return None
                    out.add(b[lo:hi])
                else:
                    return None
            except (TypeError, IndexError, KeyError):
                return None
        return frozenset(out) if len(out) <= _SET_CAP else None
    if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Add):
        a, b = eval_expr(e.left, env), eval_expr(e.right, env)
        if a is None or b is None:
            return None
        try:
            out = frozenset(x + y for x in a for y in b)
        except TypeError:
            return None
        return out if len(out) <= _SET_CAP else None
    if isinstance(e, ast.IfExp):
        t = truth(e.test, env)
        if t == "true":
            return eval_expr(e.body, env)
        if t == "false":
            return eval_expr(e.orelse, env)
        a, b = eval_expr(e.body, env), eval_expr(e.orelse, env)
        if a is None or b is None:
            return None
        out = a | b
        return out if len(out) <= _SET_CAP else None
    if isinstance(e, ast.Compare) and len(e.ops) == 1:
        left = eval_expr(e.left, env)
        right = eval_expr(e.comparators[0], env)
        if left is None or right is None:
            return None
        op = e.ops[0]
        out = set()
        for a in left:
            for b in right:
                try:
                    if isinstance(op, (ast.Eq, ast.Is)):
                        out.add(a == b)
                    elif isinstance(op, (ast.NotEq, ast.IsNot)):
                        out.add(a != b)
                    elif isinstance(op, ast.In):
                        out.add(a in b)
                    elif isinstance(op, ast.NotIn):
                        out.add(a not in b)
                    else:
                        return None
                except TypeError:
                    return None
        return frozenset(out)
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
            and e.func.attr == "startswith" and len(e.args) == 1:
        recv = eval_expr(e.func.value, env)
        arg = eval_expr(e.args[0], env)
        if recv is None or arg is None:
            return None
        try:
            return frozenset(r.startswith(a) for r in recv for a in arg)
        except (TypeError, AttributeError):
            return None
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Not):
        v = eval_expr(e.operand, env)
        return None if v is None else frozenset(not x for x in v)
    if isinstance(e, ast.BoolOp):
        vals = [truth(v, env) for v in e.values]
        want = "false" if isinstance(e.op, ast.And) else "true"
        if any(v == want for v in vals):
            return frozenset([want == "true"])
        if all(v == ("true" if want == "false" else "false") for v in vals):
            return frozenset([want != "true"])
        return None
    if isinstance(e, ast.Tuple):
        elts = [eval_expr(x, env) for x in e.elts]
        if any(v is None for v in elts):
            return None
        out = {()}
        for v in elts:
            out = {t + (x,) for t in out for x in v}
            if len(out) > _SET_CAP:
                return None
        return frozenset(out)
    return None


def truth(test: ast.expr, env: Dict[Any, FrozenSet]) -> str:
    """'true' | 'false' | 'both' — decidability of ``test`` under ``env``."""
    v = eval_expr(test, env)
    if v is None:
        return "both"
    bools = {bool(x) for x in v}
    if bools == {True}:
        return "true"
    if bools == {False}:
        return "false"
    return "both"


# -- dispatch executor ------------------------------------------------------


class Outcome:
    """One executed path: ``kind`` in {'return', 'raise', 'fall'},
    ``count`` = protocol events on the path, ``node`` = the terminating
    Return/Raise statement (None for fall-through), ``unknown`` = the
    count cannot be trusted (loop/recursion/unresolved cursor escape)."""

    __slots__ = ("kind", "count", "env", "node", "unknown")

    def __init__(self, kind, count, env, node, unknown):
        self.kind = kind
        self.count = count
        self.env = env
        self.node = node
        self.unknown = unknown


class DispatchExecutor:
    """Path-enumerating micro-interpreter for dispatch-shaped functions.

    ``count_stmt(node, env) -> (int, bool)`` counts protocol events in ONE
    statement/expression subtree (it must not descend into nested ``def``
    bodies) and reports whether the count is unreliable. Tests it can
    decide under the environment prune paths; loops containing events and
    try-blocks keep the analysis honest by flagging ``unknown``.
    """

    def __init__(self, count_stmt: Callable, budget: int = 600):
        self.count_stmt = count_stmt
        self.budget = budget

    def run(self, body: List[ast.stmt],
            env: Dict[Any, FrozenSet]) -> List[Outcome]:
        self._steps = 0
        falls, terms = self._block(body, [(0, dict(env), False)])
        for c, e, u in falls:
            terms.append(Outcome("fall", c, e, None, u))
        return terms

    # states: list of (count, env, unknown)
    def _block(self, stmts, states):
        terms: List[Outcome] = []
        for st in stmts:
            if not states:
                break
            states, t = self._stmt(st, states)
            terms += t
            states = self._dedup(states)
        return states, terms

    def _dedup(self, states):
        seen = set()
        out = []
        for c, e, u in states:
            key = (c, u, tuple(sorted(e.items(), key=repr)))
            if key not in seen:
                seen.add(key)
                out.append((c, e, u))
        if len(out) > 48:  # path blow-up: collapse to one unknown state
            return [(out[0][0], out[0][1], True)]
        return out

    def _events(self, node, env):
        n, unk = self.count_stmt(node, env)
        return n, unk

    def _stmt(self, st, states):
        self._steps += 1
        if self._steps > self.budget:
            return ([(c, e, True) for c, e, _ in states], [])
        terms: List[Outcome] = []

        if isinstance(st, ast.If):
            out_states = []
            for c, e, u in states:
                tn, tu = self._events(st.test, e)
                c2, u2 = c + tn, u or tu
                t = truth(st.test, e)
                if t in ("true", "both"):
                    s, tt = self._block(st.body, [(c2, dict(e), u2)])
                    out_states += s
                    terms += tt
                if t in ("false", "both"):
                    if st.orelse:
                        s, tt = self._block(st.orelse, [(c2, dict(e), u2)])
                        out_states += s
                        terms += tt
                    else:
                        out_states.append((c2, dict(e), u2))
            return out_states, terms

        if isinstance(st, ast.Return):
            for c, e, u in states:
                n, unk = (0, False) if st.value is None \
                    else self._events(st.value, e)
                terms.append(Outcome("return", c + n, e, st, u or unk))
            return [], terms

        if isinstance(st, ast.Raise):
            for c, e, u in states:
                terms.append(Outcome("raise", c, e, st, u))
            return [], terms

        if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
            n, unk = self._events(st, {})
            has_flow = any(isinstance(x, (ast.Return, ast.Raise))
                           for x in ast.walk(st))
            bad = unk or n > 0 or has_flow
            return ([(c, e, u or bad) for c, e, u in states], terms)

        if isinstance(st, ast.Try):
            out_states = []
            for c, e, u in states:
                body_s, tt = self._block(st.body, [(c, dict(e), u)])
                terms += tt
                hs = []
                for h in st.handlers:
                    s, tt = self._block(h.body, [(c, dict(e), True)])
                    hs += s
                    terms += tt
                merged = body_s + hs
                if st.finalbody:
                    merged, tt = self._block(st.finalbody, merged)
                    terms += tt
                out_states += merged
            return out_states, terms

        if isinstance(st, (ast.With, ast.AsyncWith)):
            out_states = []
            for c, e, u in states:
                n = 0
                unk = False
                for item in st.items:
                    dn, du = self._events(item.context_expr, e)
                    n += dn
                    unk = unk or du
                s, tt = self._block(st.body, [(c + n, dict(e), u or unk)])
                out_states += s
                terms += tt
            return out_states, terms

        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef, ast.Pass, ast.Global,
                           ast.Nonlocal, ast.Import, ast.ImportFrom)):
            return states, terms

        # simple statement: count events, update env on Name assignments
        out_states = []
        for c, e, u in states:
            n, unk = self._events(st, e)
            e2 = dict(e)
            if isinstance(st, ast.Assign) and len(st.targets) == 1:
                t = st.targets[0]
                if isinstance(t, ast.Name):
                    v = eval_expr(st.value, e)
                    if v is not None:
                        e2[t.id] = v
                    else:
                        e2.pop(t.id, None)
                elif isinstance(t, ast.Tuple):
                    for x in t.elts:
                        if isinstance(x, ast.Name):
                            e2.pop(x.id, None)
            elif isinstance(st, (ast.AugAssign, ast.AnnAssign)) \
                    and isinstance(st.target, ast.Name):
                e2.pop(st.target.id, None)
            out_states.append((c + n, e2, u or unk))
        return out_states, terms


def stmt_scan(st: ast.AST):
    """Nodes belonging to ONE CFG statement node. Compound statements
    contribute only their *header* (test / iter / with-items) — their
    bodies are separate CFG nodes, and scanning them here would apply
    body effects before the body's predecessors ran (and then again at
    the body nodes). Simple statements yield their full no-nested-def
    subtree."""
    if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.ClassDef)):
        return
    if isinstance(st, (ast.If, ast.While)):
        yield st
        yield from walk_no_nested(st.test)
        return
    if isinstance(st, (ast.For, ast.AsyncFor)):
        yield st
        yield from walk_no_nested(st.target)
        yield from walk_no_nested(st.iter)
        return
    if isinstance(st, (ast.With, ast.AsyncWith)):
        yield st
        for item in st.items:
            yield from walk_no_nested(item.context_expr)
            if item.optional_vars is not None:
                yield from walk_no_nested(item.optional_vars)
        return
    if isinstance(st, ast.Try):
        yield st  # the finally-marker node; body/handlers are their own
        return
    if isinstance(st, ast.ExceptHandler):
        yield st  # handler-entry marker
        if st.type is not None:
            yield from walk_no_nested(st.type)
        return
    yield from walk_no_nested(st)


def walk_no_nested(node: ast.AST):
    """Document-order (pre-order DFS) walk that does not descend into
    nested function/lambda bodies (their events belong to the nested
    function, not this path)."""
    stack = [node]
    first = True
    while stack:
        cur = stack.pop()
        if not first and isinstance(cur, (ast.FunctionDef,
                                          ast.AsyncFunctionDef, ast.Lambda)):
            continue
        first = False
        yield cur
        stack.extend(reversed(list(ast.iter_child_nodes(cur))))


class SummaryTable:
    """Cycle-guarded call summaries: function node -> exact event count,
    or None when the callee's count varies by path / recurses / is too
    dynamic to trust. ``counter_for(fn)`` supplies the event counter in
    the CALLEE's own resolution context (module imports, nesting scope),
    so summaries compose interprocedurally."""

    def __init__(self, counter_for: Callable[[ast.AST], Callable]):
        self._counter_for = counter_for
        self._memo: Dict[int, Optional[int]] = {}
        self._in_progress: set = set()

    def summary(self, fn: ast.AST) -> Optional[int]:
        key = id(fn)
        if key in self._memo:
            return self._memo[key]
        if key in self._in_progress:
            return None  # recursion: refuse to guess
        self._in_progress.add(key)
        try:
            if isinstance(fn, ast.Lambda):
                has_take = any(
                    isinstance(s, ast.Call)
                    and isinstance(s.func, ast.Attribute)
                    and s.func.attr == "take" and not s.args
                    for s in ast.walk(fn.body))
                res: Optional[int] = None if has_take else 0
            else:
                ex = DispatchExecutor(self._counter_for(fn))
                outs = [o for o in ex.run(list(getattr(fn, "body", [])), {})
                        if o.kind in ("return", "fall")]
                counts = {o.count for o in outs if not o.unknown}
                if any(o.unknown for o in outs) or len(counts) != 1:
                    res = None
                else:
                    res = counts.pop()
        finally:
            self._in_progress.discard(key)
        self._memo[key] = res
        return res
