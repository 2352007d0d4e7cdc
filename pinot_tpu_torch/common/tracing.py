"""Query tracing: span trees, the decision ledger and the query registry.

Counterpart of ``pinot_tpu/common/tracing.py`` (the reference's
request-scoped ``TraceContext`` trees, the ``ServerQueryPhase`` /
``BrokerQueryPhase`` timers and the broker's slow-query log), with the
JAX package's addition: a ledger of why execution declined a faster path.

- **Span trees** (:class:`Span` / :class:`SpanRecorder`): the broker's
  compile, routing, scatter / gather and reduce; each server's scheduler
  queue, admission, residency lease, per-segment work, staging and the
  ``Kernel`` spans around the hand-written CUDA launches (closed after the
  wrapper's own device-to-host copy, which waits for the card); the batch
  path's ``ShardedCombine`` with the launcher's queue wait as ``queueMs``.
  Server trees travel on the DataTable wire (``QueryStats.spans``) and the
  broker hangs them under its root's ``ScatterGather``. Every span close
  also appends one flat entry to ``QueryStats.trace``, the legacy
  ``traceInfo["entries"]`` view.
- **The decision ledger**: every decline of a faster rung is a
  ``(decision_point, chosen, declined, reason_code)`` record, counted in
  the query's ``QueryStats.decisions`` (summed at merge) and in the
  process-wide :data:`LEDGER` (the ``decision_declined_total`` family on
  ``/metrics``). The reason namespaces are registered in one registry
  (:func:`reason_registry`), each scanned against its port module's
  source; the sets that live beside their modules (routing, gather,
  reduce) are registered from there.
- **The query registry** (:class:`QueryRegistry`): each executor's running
  queries, the ring of completed ones and the slow-query log.

Spans are recorded only when a recorder is attached to the stats
(``trace=true``, the ``pinot.server.query.trace.sample`` rate, or a
slow-query threshold); an untraced query allocates no recorder and pays
one ``getattr`` a site. The ledger is always on: it fires only at
declines. A recorder belongs to one thread: a worker thread records into
its own stats, whose finished spans the caller's merge adopts.
"""

from __future__ import annotations

import re
import threading
import time

from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

# span-dict keys the serializer owns; attributes must not collide
_RESERVED = ("name", "ms", "queueMs", "workMs", "children")


class Span:
    """One open span. Closed spans become plain dicts (wire-ready)."""

    __slots__ = ("name", "t0", "wall_ms", "queue_ms", "attrs", "children")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.t0 = time.perf_counter()
        self.wall_ms = 0.0
        self.queue_ms: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.children: List[Dict[str, Any]] = []

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "ms": round(self.wall_ms, 3)}
        if self.queue_ms is not None:
            # the explicit queue-vs-work split: queueMs is time spent
            # WAITING at this level, workMs the remainder
            d["queueMs"] = round(self.queue_ms, 3)
            d["workMs"] = round(max(self.wall_ms - self.queue_ms, 0.0), 3)
        for k, v in self.attrs.items():
            if k not in _RESERVED:
                d[k] = v
        if self.children:
            d["children"] = self.children
        return d


class SpanRecorder:
    """Per-query span collector. One per :class:`QueryStats`;
    thread-confined — segment fan-out workers record into their private
    stats' recorders, and ``QueryStats.merge`` re-parents their finished
    spans under the caller's currently-open span.

    ``sink`` is the completed-top-level-span list (normally the stats'
    own ``spans`` field, so finished trees land directly on the wire
    payload); ``legacy`` is the flat entry list (``QueryStats.trace``) —
    every span close appends one ``{"operator", "ms", ...attrs}`` entry,
    preserving the pre-span-tree ``traceInfo["entries"]`` contract."""

    __slots__ = ("spans", "_stack", "_legacy")

    def __init__(self, sink: Optional[List[Dict[str, Any]]] = None,
                 legacy: Optional[List[Dict[str, Any]]] = None):
        self.spans: List[Dict[str, Any]] = sink if sink is not None else []
        self._stack: List[Span] = []
        self._legacy = legacy

    # -- open/close ----------------------------------------------------------
    def span_begin(self, name: str, **attrs: Any) -> Span:
        """Open a child of the current span (or a new root). MUST reach
        ``span_end`` on every path, exception edges included; prefer the
        ``span()`` context manager."""
        sp = Span(name, attrs)
        self._stack.append(sp)
        return sp

    def span_end(self, span: Span, queue_ms: Optional[float] = None,
                 **attrs: Any) -> Optional[Dict[str, Any]]:
        """Close ``span`` (idempotent: a second close is a no-op). A
        still-open child left behind by an error path is swept closed
        into ``span`` first, so exception edges can never leave a
        dangling open span below a closed parent."""
        if span not in self._stack:
            return None
        while self._stack[-1] is not span:
            self.span_end(self._stack[-1])
        self._stack.pop()
        span.wall_ms = (time.perf_counter() - span.t0) * 1e3
        if queue_ms is not None:
            span.queue_ms = queue_ms
        if attrs:
            span.attrs.update(attrs)
        d = span.to_dict()
        target = self._stack[-1].children if self._stack else self.spans
        target.append(d)
        if self._legacy is not None:
            self._legacy.append({"operator": span.name,
                                 "ms": round(span.wall_ms, 3), **span.attrs})
        return d

    @contextmanager
    def span(self, name: str, **attrs: Any):
        sp = self.span_begin(name, **attrs)
        try:
            yield sp
        finally:
            self.span_end(sp)

    def close_all(self) -> None:
        """Close every open span, outermost last (query teardown /
        exception edge)."""
        if self._stack:
            self.span_end(self._stack[0])

    @property
    def open_depth(self) -> int:
        return len(self._stack)

    # -- pre-measured / adopted spans ---------------------------------------
    def add_completed(self, name: str, wall_ms: float,
                      queue_ms: Optional[float] = None,
                      **attrs: Any) -> Dict[str, Any]:
        """Attach an already-measured span (e.g. a queue wait that ended
        before the recorder existed) as a child of the current span."""
        sp = Span(name, attrs)
        sp.wall_ms = wall_ms
        sp.queue_ms = queue_ms
        d = sp.to_dict()
        target = self._stack[-1].children if self._stack else self.spans
        target.append(d)
        if self._legacy is not None:
            self._legacy.append({"operator": name, "ms": round(wall_ms, 3),
                                 **attrs})
        return d

    def adopt(self, span_dicts: List[Dict[str, Any]]) -> None:
        """Re-parent completed span dicts (a worker stats' trees, a
        server's wire trees) under the currently-open span."""
        target = self._stack[-1].children if self._stack else self.spans
        target.extend(span_dicts)


# --------------------------------------------------------------------------
# QueryStats attachment (the stats object stays a plain dataclass; the
# recorder rides as a private attribute so untraced queries allocate nothing)
# --------------------------------------------------------------------------

def stats_tracer(stats: Any) -> Optional[SpanRecorder]:
    """The stats' recorder, or None (untraced: zero-allocation path)."""
    return getattr(stats, "_recorder", None)


def start_trace(stats: Any) -> SpanRecorder:
    """Attach a recorder to ``stats`` (idempotent). Completed roots land
    in ``stats.spans`` (the wire field); flat entries in ``stats.trace``."""
    rec = getattr(stats, "_recorder", None)
    if rec is None:
        rec = SpanRecorder(sink=stats.spans, legacy=stats.trace)
        stats._recorder = rec
    return rec


class _NullSpanCm:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpanCm()


def maybe_span(stats: Any, name: str, **attrs: Any):
    """Context manager that records a span when ``stats`` is traced and
    is a shared no-op singleton otherwise (the off-path cost is one
    ``getattr``)."""
    rec = getattr(stats, "_recorder", None)
    if rec is None:
        return _NULL_SPAN
    return rec.span(name, **attrs)


def attach_root_child(stats: Any, name: str, wall_ms: float,
                      queue_ms: Optional[float] = None, front: bool = False,
                      **attrs: Any) -> None:
    """Retroactively attach a pre-measured child to the stats' FINISHED
    root span (the scheduler-queue wait is measured by the server tier
    after the executor already closed the tree). The root's wall time
    grows to keep the tree self-consistent (children must account inside
    the root)."""
    if not stats.spans:
        return
    root = stats.spans[0]
    sp = Span(name, attrs)
    sp.wall_ms = wall_ms
    sp.queue_ms = queue_ms
    child = sp.to_dict()
    kids = root.setdefault("children", [])
    if front:
        kids.insert(0, child)
    else:
        kids.append(child)
    root["ms"] = round(root.get("ms", 0.0) + wall_ms, 3)
    stats.trace.append({"operator": name, "ms": round(wall_ms, 3), **attrs})


def flatten_spans(span_dicts: List[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """Span trees -> legacy flat entries (pre-order), for consumers that
    want the old shape derived from the tree rather than the emitted
    legacy list."""
    out: List[Dict[str, Any]] = []

    def walk(d: Dict[str, Any]) -> None:
        e = {"operator": d["name"], "ms": d["ms"]}
        for k, v in d.items():
            if k not in ("name", "ms", "children"):
                e[k] = v
        out.append(e)
        for c in d.get("children", ()):
            walk(c)

    for d in span_dicts:
        walk(d)
    return out


def build_broker_root(phase_ms: Dict[str, float],
                      server_spans: List[Dict[str, Any]],
                      total_ms: float,
                      admission_wait_ms: float = 0.0,
                      reduce_folds: Optional[List[Dict[str, Any]]] = None
                      ) -> Dict[str, Any]:
    """Assemble the broker root span from the measured broker phases
    (COMPILATION/ROUTING/SCATTER_GATHER/REDUCE), re-parenting the
    per-server trees under the ScatterGather child — the reduce-side half
    of the reference's per-server ``traceInfo`` keying.

    ``reduce_folds`` is the reduce-as-arrivals split: one Fold child per
    folded DataTable (its work overlapped the gather wait, so the folds'
    wall time lives INSIDE ScatterGather; the Reduce child keeps the
    final merge/trim/HAVING pass and carries a foldMs rollup)."""
    children: List[Dict[str, Any]] = []
    if admission_wait_ms > 0:
        children.append({"name": "Admission",
                         "ms": round(admission_wait_ms, 3),
                         "queueMs": round(admission_wait_ms, 3),
                         "workMs": 0.0})
    for phase, name in (("COMPILATION", "Compile"), ("ROUTING", "Routing")):
        if phase in phase_ms:
            children.append({"name": name,
                             "ms": round(phase_ms[phase], 3)})
    sg: Dict[str, Any] = {
        "name": "ScatterGather",
        "ms": round(phase_ms.get("SCATTER_GATHER", 0.0), 3)}
    if server_spans:
        sg["children"] = list(server_spans)
    children.append(sg)
    if "REDUCE" in phase_ms:
        reduce_span: Dict[str, Any] = {"name": "Reduce",
                                       "ms": round(phase_ms["REDUCE"], 3)}
        if reduce_folds:
            reduce_span["foldMs"] = round(
                sum(f.get("ms", 0.0) for f in reduce_folds), 3)
            reduce_span["children"] = list(reduce_folds)
        children.append(reduce_span)
    return {"name": "BrokerQuery", "ms": round(total_ms, 3),
            "children": children}


# --------------------------------------------------------------------------
# path-decision ledger
# --------------------------------------------------------------------------

# Fused-scan decline codes recorded directly at their sites (never through
# engine/errors.py classify_decline's message table): the fused scan's
# ``decline("...")`` literals in engine/fused_scan.py and the executors'
# ``reasons.append("...")``. The codes the fused scan, a kernel built by
# hand, cannot reach on the card (a build or launch failure raises) stay
# registered under JAX's names.
DIRECT_DECLINE_CODES = frozenset({
    "pallas_too_many_groups",
    "pallas_distinct_agg",
    "pallas_docs_over_i32",
    "pallas_column_not_packable",
    "pallas_value_layout_unsupported",
    "pallas_disabled_on_backend",
    "pallas_shape_blocked",
    "pallas_exec_failed",
    "pallas_build_failed",
})

# The fused scan's preflight rules (tools/preflight.py RULES), the codes
# compile_program's ScanLimitError carries: a shape over one of the
# kernel's limits declines at the "pallas" point with its rule's code. JAX
# has the namespace under the same name, its rules modelling Mosaic's
# lowering; the port's name its own kernel's limits.
PALLAS_PREFLIGHT_REASONS = frozenset({
    "pallas_preflight_column_slots",
    "pallas_preflight_tile_align",
    "pallas_preflight_filter_stack",
    "pallas_preflight_value_stack",
    "pallas_preflight_accumulator_rows",
    "pallas_preflight_program_int32",
    "pallas_preflight_smem_budget",
})

# Reason codes of the star-tree decision point (engine/startree_exec.py:
# pick_star_tree's note() / decline() sites and _matching_ids' reasons).
# The chosen-tree records ("startree:scan-><rung>:tree<i>") carry the
# dynamic reason STARTREE_TREE_REASON matches instead.
STARTREE_DECISION_REASONS = frozenset({
    "startree_upsert_valid_docs",
    "startree_filter_or_not_shape",
    "startree_group_expression",
    "startree_group_off_split_order",
    "startree_filter_non_dimension",
    "startree_predicate_type_unsupported",
    "startree_agg_not_pairable",
    "startree_expression_agg_no_pair",
    "startree_missing_function_pair",
    "startree_no_fitting_tree",
    "startree_raw_dimension",
    "startree_dictid_overflow_noncontiguous",
    # the JAX executor's walker refusing a tree its pick accepted (the
    # port's walker serves every tree its pick accepts)
    "startree_walker_declined",
})

# the chosen-tree ledger reason: which of the segment's trees served
STARTREE_TREE_REASON = re.compile(r"tree\d+\Z")

# --------------------------------------------------------------------------
# the reason registry: one lookup and one conformance harness for every
# reason namespace
# --------------------------------------------------------------------------

# the consuming-segment rung's declines and its index rung's outcomes
MUTABLE_DECLINE_REASONS = frozenset({
    "mutable_empty_watermark",   # nothing published yet: host answers
    "mutable_hll_lut_unstable",  # HLL register LUTs go stale as the
                                 # dictionary grows mid-consume
    "mutable_exec_failed",       # the JAX rung's staging or kernel raised
    "mutable_index_unsupported_shape",  # OR / NOT, non-EQ/IN/RANGE, MV,
                                        # dictionary-less, or upsert
    "mutable_index_over_threshold",     # broad match: the chunk scan wins
    "mutable_index_exec_failed",        # the JAX gather raised
    "mutable_index_served",             # the gather served the snapshot
})
# the broker's hybrid time-boundary split (broker/broker.py _split_hybrid)
HYBRID_ROUTE_REASONS = frozenset({
    "hybrid_single_table",    # only one physical table: no split
    "hybrid_no_time_column",  # the split's range cannot be written
    "hybrid_no_boundary",     # no boundary yet: realtime serves all
    "hybrid_time_split",      # offline <= boundary < realtime
})
# the seal swap (server/data_manager.py on_sealed)
SEAL_SWAP_REASONS = frozenset({
    "seal_swap",      # the local consumer's seal replaces its segment
    "seal_download",  # a replica fetched the committer's seal
})
# the index rung (engine/index_exec.py): every outcome on an
# index-candidate filter, chosen and declined
INDEX_DECISION_REASONS = frozenset({
    "index_served",              # the gather served the segment
    "index_filter_shape",        # OR / NOT or a non-column predicate
    "index_pred_type_unsupported",  # not EQ / IN / RANGE
    "index_missing_index",       # a predicate column has no usable index
    "index_selectivity_over_threshold",  # broad match: the scan wins
    "index_upsert_valid_docs",   # the valid-doc bitmap ANDs the filter
    "index_plan_error",          # the device plan declined -> scan
    "index_exec_failed",         # the JAX gather raised -> scan
})


# race waivers: the ``threads`` lint family's ``# race-ok:`` annotations
# (pinot_tpu_torch/tools/lint/threads.py). Each code names a concurrency
# design, not a dismissal; the lint rejects any code not in this set, so
# the vocabulary grows only here, next to its meaning. The first four are
# the JAX package's (pinot_tpu/common/tracing.py:684-700).
RACE_OK_REASONS = frozenset({
    "single_writer",         # one runtime thread performs every write;
                             # readers take GIL-atomic snapshots and
                             # tolerate one batch of staleness
    "publish_once",          # reference assigned once at setup, never
                             # reassigned; readers null-check
    "delegates_locking",     # the field holds an object that does its own
                             # locking, and the reference never changes
                             # after __init__
    "quiesced_by_refcount",  # teardown mutation that runs only after the
                             # residency refcount proves no reader holds
                             # the object
    "owner_serialized",      # a helper object private to one owner, which
                             # calls it only under the owner's lock (a
                             # staged segment's or batch's H2D copies)
})


class ReasonNamespace:
    """One decision point's reason namespace: its registered codes and
    what the conformance harness needs to scan its port modules' sources:
    regexes whose group(1) captures a reason literal at a record site, an
    optional prefix that makes every quoted ``"<prefix>..."`` literal a
    reason, an optional pattern of allowed dynamic reasons (``tree<i>``),
    and a floor on the sites found (a scan that finds nothing means the
    patterns drifted). ``module`` is one module name or a tuple of them
    (the fused scan's declines are recorded in two)."""

    __slots__ = ("name", "codes", "module", "literal_patterns", "prefix",
                 "dynamic", "min_sites", "exact")

    def __init__(self, name: str, codes: frozenset, module,
                 literal_patterns: Tuple[str, ...] = (),
                 prefix: Optional[str] = None,
                 dynamic: Optional["re.Pattern"] = None,
                 min_sites: int = 1, exact: bool = False):
        self.name = name
        self.codes = codes
        self.module = module
        self.literal_patterns = literal_patterns
        self.prefix = prefix
        self.dynamic = dynamic
        self.min_sites = min_sites
        self.exact = exact

    @property
    def modules(self) -> Tuple[str, ...]:
        return (self.module,) if isinstance(self.module, str) \
            else tuple(self.module)

    def scan_source(self) -> set:
        """Every reason literal found at this namespace's record sites in
        its modules' sources. A namespace rooted at a package scans every
        ``.py`` beneath it (``race_ok`` waivers live wherever shared state
        lives)."""
        import importlib
        import os

        paths: List[str] = []
        for name in self.modules:
            mod = importlib.import_module(name)
            if hasattr(mod, "__path__"):
                for root, dirs, files in os.walk(list(mod.__path__)[0]):
                    dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                    paths.extend(os.path.join(root, f) for f in sorted(files)
                                 if f.endswith(".py"))
            else:
                paths.append(mod.__file__)
        found: set = set()
        for path in paths:
            with open(path, encoding="utf-8") as f:
                src = f.read()
            for pat in self.literal_patterns:
                found |= set(re.findall(pat, src))
            if self.prefix:
                found |= set(
                    re.findall(rf'"({self.prefix}[a-z0-9_]+)"', src))
        return found

    def conformance(self) -> Tuple[set, set]:
        """(literals found, unregistered literals); dynamic reasons
        matching ``dynamic`` need no registration."""
        found = self.scan_source()
        bad = {r for r in found - self.codes
               if not (self.dynamic and self.dynamic.fullmatch(r))}
        return found, bad


_REASON_REGISTRY: Dict[str, ReasonNamespace] = {}
_REGISTRY_LOCK = threading.Lock()


def _pallas_codes() -> frozenset:
    from pinot_tpu_torch.engine.errors import _DECLINE_RULES

    return DIRECT_DECLINE_CODES | frozenset(
        code for _needle, code in _DECLINE_RULES
        if code.startswith("pallas_"))


def _build_registry() -> Dict[str, ReasonNamespace]:
    """The namespaces, built at first use: the routing, gather and reduce
    sets are imported from the modules that keep them, which import this
    one. ``race_ok`` holds the waivers of the port's own lint
    (``tools/lint/threads.py``), scanned over the whole package."""
    from pinot_tpu_torch.broker.broker import GATHER_DECISION_REASONS
    from pinot_tpu_torch.broker.reduce import (
        REDUCE_DECISION_REASONS,
        REDUCE_DEVICE_REASONS,
    )
    from pinot_tpu_torch.broker.routing import ROUTING_DECISION_REASONS

    spaces = (
        ReasonNamespace(
            "pallas", _pallas_codes(),
            ("pinot_tpu_torch.engine.fused_scan",
             "pinot_tpu_torch.engine.executor",
             "pinot_tpu_torch.parallel.executor"),
            literal_patterns=(r'decline\("([a-z0-9_]+)"\)',
                              r'reasons\.append\("([a-z0-9_]+)"\)'),
            min_sites=5),
        ReasonNamespace(
            "pallas_preflight", PALLAS_PREFLIGHT_REASONS,
            ("pinot_tpu_torch.tools.preflight",
             "pinot_tpu_torch.engine.fused_scan"),
            literal_patterns=(r'_Rule\(\s*"([a-z0-9_]+)"',
                              r'ScanLimitError\(\s*"([a-z0-9_]+)"'),
            min_sites=7, exact=True),
        ReasonNamespace(
            "routing", ROUTING_DECISION_REASONS,
            "pinot_tpu_torch.broker.routing",
            literal_patterns=(r'declined\("([a-z_]+)"\)',
                              r'"pruned", "all_servers",\s*\n?\s*'
                              r'"([a-z_]+)"'),
            min_sites=4),
        ReasonNamespace(
            "gather", GATHER_DECISION_REASONS,
            "pinot_tpu_torch.broker.broker",
            literal_patterns=(r'"full_result",\s*\n?\s*"([a-z_]+)"',),
            min_sites=3, exact=True),
        ReasonNamespace(
            "startree", STARTREE_DECISION_REASONS,
            "pinot_tpu_torch.engine.startree_exec",
            prefix="startree_", dynamic=STARTREE_TREE_REASON,
            min_sites=10),
        ReasonNamespace(
            "reduce", REDUCE_DECISION_REASONS,
            "pinot_tpu_torch.broker.reduce",
            literal_patterns=(r'_decline\(\s*"([a-z0-9_]+)"',),
            min_sites=3),
        ReasonNamespace(
            "reduce_device", REDUCE_DEVICE_REASONS,
            "pinot_tpu_torch.broker.reduce",
            literal_patterns=(r'_decline_device\(\s*"([a-z0-9_]+)"',),
            min_sites=4, exact=True),
        ReasonNamespace(
            "mutable", MUTABLE_DECLINE_REASONS,
            "pinot_tpu_torch.engine.mutable_staging",
            literal_patterns=(
                r'_decline\(\s*[a-zA-Z_][a-zA-Z0-9_]*\s*,\s*"([a-z0-9_]+)"',
                r'_decline_rung\(\s*[a-zA-Z_][a-zA-Z0-9_]*\s*,\s*'
                r'"([a-z0-9_]+)"',
                r'_chose_rung\(\s*[a-zA-Z_][a-zA-Z0-9_]*\s*,\s*'
                r'"([a-z0-9_]+)"'),
            min_sites=3),
        ReasonNamespace(
            "hybrid", HYBRID_ROUTE_REASONS, "pinot_tpu_torch.broker.broker",
            prefix="hybrid_", min_sites=4, exact=True),
        ReasonNamespace(
            "seal", SEAL_SWAP_REASONS, "pinot_tpu_torch.server.data_manager",
            literal_patterns=(r'"(seal_[a-z0-9_]+)"',), min_sites=2,
            exact=True),
        ReasonNamespace(
            "index", INDEX_DECISION_REASONS,
            "pinot_tpu_torch.engine.index_exec",
            literal_patterns=(
                r'_decline\(\s*stats,\s*"([a-z0-9_]+)"',
                r'raise _Decline\(\s*"([a-z0-9_]+)"',
                r'_chose\(\s*stats,\s*"([a-z0-9_]+)"'),
            min_sites=6),
        ReasonNamespace(
            "race_ok", RACE_OK_REASONS, "pinot_tpu_torch",
            literal_patterns=(r'#\s*race-ok:\s*([a-z0-9_]+)',),
            min_sites=4, exact=True),
    )
    return {ns.name: ns for ns in spaces}


def reason_registry(name: Optional[str] = None):
    """The reason-namespace registry. With ``name``, the one
    :class:`ReasonNamespace`; without, the whole ``{name: namespace}``
    dict. Every reason code a registered decision point can record lives
    in exactly one namespace here."""
    with _REGISTRY_LOCK:
        if not _REASON_REGISTRY:
            _REASON_REGISTRY.update(_build_registry())
        reg = dict(_REASON_REGISTRY)
    return reg if name is None else reg[name]


def registered_reason_codes() -> frozenset:
    """Union of every namespace's code set."""
    out: set = set()
    for ns in reason_registry().values():
        out |= ns.codes
    return frozenset(out)


class DecisionLedger:
    """Always-on histogram of path-decision records, keyed on the full
    ``(decision_point, chosen, declined, reason_code)`` tuple. One
    process-level instance (:data:`LEDGER`) backs ``/metrics`` and the
    bench per-suite deltas; tests may instantiate private ledgers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, str, str, str], int] = {}  # guarded-by: _lock
        self._registries: List[Any] = []  # guarded-by-writes: _lock

    # the one labeled prometheus family every decline lands in
    METRIC_FAMILY = "decision_declined_total"

    def record(self, point: str, chosen: str, declined: str,
               reason: str) -> None:
        key = (point, chosen, declined, reason)
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
            regs = list(self._registries)
        for reg in regs:
            reg.labeled_meter(self.METRIC_FAMILY,
                              point=point, reason=reason).mark()
        if point == "pallas":
            # a burst of fused-scan declines trips the flight recorder: a
            # storm of declines is how a never-firing kernel looks live
            from pinot_tpu_torch.common.telemetry import TELEMETRY

            TELEMETRY.note_event("pallas_decline")

    def bind_metrics(self, registry: Any) -> None:
        """Surface the histogram on a MetricsRegistry as ONE labeled
        ``decision_declined_total{point=...,reason=...}`` family on
        ``/metrics`` (one name-mangled counter per cell pre-dates labeled
        families; see spi/metrics.py labeled_meter)."""
        with self._lock:
            if registry not in self._registries:
                self._registries.append(registry)
            existing = dict(self._counts)
        registry.set_help(self.METRIC_FAMILY,
                          "Path decisions where execution declined a "
                          "faster rung, by decision point and reason.")
        for (point, _c, _d, reason), n in existing.items():
            registry.labeled_meter(self.METRIC_FAMILY,
                                   point=point, reason=reason).mark(n)

    def snapshot(self) -> Dict[str, int]:
        """``"point:declined->chosen:reason" -> count`` (the same key
        shape ``QueryStats.decisions`` uses)."""
        with self._lock:
            return {decision_key(p, c, d, r): n
                    for (p, c, d, r), n in self._counts.items()}

    def reason_histogram(self) -> Dict[str, int]:
        """reason_code -> count across all decision points."""
        out: Dict[str, int] = {}
        with self._lock:
            for (_p, _c, _d, r), n in self._counts.items():
                out[r] = out.get(r, 0) + n
        return out

    def delta(self, mark: Dict[str, int]) -> Dict[str, int]:
        """Per-suite histogram since ``mark`` (a prior ``snapshot()``)."""
        now = self.snapshot()
        return {k: v - mark.get(k, 0) for k, v in now.items()
                if v - mark.get(k, 0)}


def decision_key(point: str, chosen: str, declined: str,
                 reason: str) -> str:
    return f"{point}:{declined}->{chosen}:{reason}"


def parse_decision_key(key: str) -> Tuple[str, str, str, str]:
    """Inverse of :func:`decision_key` -> (point, chosen, declined,
    reason)."""
    point, rest = key.split(":", 1)
    path, reason = rest.rsplit(":", 1)
    declined, chosen = path.split("->", 1)
    return point, chosen, declined, reason


LEDGER = DecisionLedger()


def record_decision(stats: Any, point: str, chosen: str, declined: str,
                    reason: str) -> None:
    """One ledger record: execution declined ``declined`` in favor of
    ``chosen`` at ``point`` because ``reason``. Lands in the per-query
    ``QueryStats.decisions`` dict (summed across segments/shards/servers
    at merge) AND the process :data:`LEDGER` histogram — both always on;
    a decline is never silent."""
    if stats is not None:
        key = decision_key(point, chosen, declined, reason)
        stats.decisions[key] = stats.decisions.get(key, 0) + 1
    LEDGER.record(point, chosen, declined, reason)


# --------------------------------------------------------------------------
# query registry: /debug/queries + slow-query log
# --------------------------------------------------------------------------

class QueryRegistry:
    """Backing store for ``/debug/queries``: the currently-running query
    set, a ring buffer of the last N completed, and a slow-query log
    (``pinot.server.query.slow.threshold.ms``) that retains the full
    span tree for over-threshold queries — the executor force-records
    spans for every query while the threshold is configured, and ships
    them on the wire only when the query was actually traced/sampled, so
    a slow query's forensics survive even when sampling missed it."""

    def __init__(self, ring_size: int = 128, slow_log_size: int = 32,
                 slow_threshold_ms: float = 0.0):
        self.ring_size = max(1, int(ring_size))
        self.slow_log_size = max(1, int(slow_log_size))
        self.slow_threshold_ms = float(slow_threshold_ms)
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: _lock
        self._running: Dict[int, Dict[str, Any]] = {}  # guarded-by: _lock
        self._completed: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._slow: List[Dict[str, Any]] = []  # guarded-by: _lock
        self.slow_queries = 0  # guarded-by: _lock

    @property
    def force_trace(self) -> bool:
        """True when every query must record spans so the slow log can
        retain trees sampling missed."""
        return self.slow_threshold_ms > 0

    def begin(self, ctx: Any, stats: Any = None) -> Dict[str, Any]:
        token: Dict[str, Any] = {
            "sql": getattr(ctx, "sql", None),
            "table": getattr(ctx, "table_name", None),
            "requestId": getattr(ctx, "request_id", None),
            "phase": "executing",
            "t0": time.perf_counter(),
            "stats": stats,
        }
        with self._lock:
            self._seq += 1
            token["id"] = self._seq
            self._running[token["id"]] = token
        return token

    def phase(self, token: Dict[str, Any], phase: str) -> None:
        token["phase"] = phase

    def end(self, token: Dict[str, Any], error: Any = None) -> float:
        elapsed_ms = (time.perf_counter() - token["t0"]) * 1e3
        stats = token.get("stats")
        entry: Dict[str, Any] = {
            "id": token["id"],
            "sql": token["sql"],
            "table": token["table"],
            "elapsedMs": round(elapsed_ms, 3),
        }
        if token.get("requestId"):
            entry["requestId"] = token["requestId"]
        if error is not None:
            entry["error"] = f"{type(error).__name__}: {error}"[:200]
        if stats is not None and stats.decisions:
            entry["decisions"] = dict(stats.decisions)
        slow = self.slow_threshold_ms > 0 \
            and elapsed_ms >= self.slow_threshold_ms
        if slow and stats is not None and stats.spans:
            # copy the LIST (dicts shared): the executor may clear the
            # stats' wire field when the query wasn't actually traced
            entry["spans"] = list(stats.spans)
        with self._lock:
            self._running.pop(token["id"], None)
            self._completed.append(entry)
            if len(self._completed) > self.ring_size:
                del self._completed[0]
            if slow:
                self.slow_queries += 1
                self._slow.append(entry)
                if len(self._slow) > self.slow_log_size:
                    del self._slow[0]
        if stats is not None and stats.spans:
            # flight-recorder feed: every completed query whose span tree
            # was recorded (traced / sampled / slow-log-forced) lands in
            # the black box's bounded ring — copied like the slow log, so
            # the executor clearing the wire field can't empty it
            from pinot_tpu_torch.common.telemetry import TELEMETRY

            fr = dict(entry)
            fr.setdefault("spans", list(stats.spans))
            TELEMETRY.recorder.note_query(fr)
        return elapsed_ms

    def snapshot(self) -> Dict[str, Any]:
        """``/debug/queries`` body."""
        now = time.perf_counter()
        with self._lock:
            running = list(self._running.values())
            completed = list(self._completed)
            slow = list(self._slow)
            slow_n = self.slow_queries
        run_out = []
        for t in running:
            lease = getattr(t.get("stats"), "lease", None)
            run_out.append({
                "id": t["id"],
                "sql": t["sql"],
                "table": t["table"],
                "phase": t["phase"],
                "elapsedMs": round((now - t["t0"]) * 1e3, 3),
                "pinsHeld": len(lease._pinned) if lease is not None else 0,
            })
        return {
            "running": run_out,
            "completed": completed,
            "slow": slow,
            "slowThresholdMs": self.slow_threshold_ms,
            "slowQueries": slow_n,
        }
