"""Server query executor: per-segment fused scan, decode, merge, reduce.

Counterpart of ``pinot_tpu/engine/executor.py`` (``ServerQueryExecutor``,
``decode_scalar_result`` at :1093, ``decode_grouped_result`` at :1127) for
the scan rung. Per segment: plan -> fused scan (probe first when the group
space exceeds MAX_SCAN_GROUPS) -> decode; then merge and reduce. A plan the
fused scan declines raises :class:`NotPortedError` with the reason code:
there is no silent host fallback. Segments run one after another on the
current stream; ``_execute_aggregation`` and ``_execute_group_by`` are the
points a subclass overrides to combine segments otherwise
(``pinot_tpu_torch.parallel.ShardedQueryExecutor``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pinot_tpu_torch.device import resolve_device
from pinot_tpu_torch.engine import fused_scan
from pinot_tpu_torch.engine.aggregates import AggDef, resolve_agg
from pinot_tpu_torch.engine.errors import NotPortedError, PlanError, QueryError
from pinot_tpu_torch.engine.plan import SegmentPlan, plan_segment
from pinot_tpu_torch.engine.results import (
    AggResult,
    GroupByResult,
    QueryStats,
    ResultTable,
    reduce_aggregation,
    reduce_group_by,
)
from pinot_tpu_torch.engine.staging import StagedSegment
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.segment.immutable import ImmutableSegment


class ServerQueryExecutor:
    """One per server; owns the staged segments of one device."""

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        # segment name -> (segment, its staged image)
        self._staged: Dict[str, Tuple[ImmutableSegment, StagedSegment]] = {}

    def stage(self, segment: ImmutableSegment) -> StagedSegment:
        hit = self._staged.get(segment.segment_name)
        if hit is not None and hit[0] is segment:
            return hit[1]
        staged = StagedSegment(segment, device=self.device)
        self._staged[segment.segment_name] = (segment, staged)
        return staged

    def execute(self, ctx: QueryContext, segments: List[ImmutableSegment]
                ) -> Tuple[ResultTable, QueryStats]:
        if not segments:
            raise QueryError(f"no segments for table {ctx.table_name!r}")
        known = set(segments[0].metadata.columns)
        for c in ctx.referenced_columns():
            if c not in known:
                raise QueryError(f"unknown column {c!r} in table "
                                 f"{ctx.table_name!r}")
        stats = QueryStats(num_segments_queried=len(segments))
        scans0 = fused_scan.SCAN_COUNTER.launches
        probes0 = fused_scan.PROBE_COUNTER.launches
        aggs = [resolve_agg(f) for f in ctx.aggregations]
        if ctx.is_group_by:
            merged = self._execute_group_by(ctx, aggs, segments, stats)
        else:
            merged = self._execute_aggregation(ctx, aggs, segments, stats)
        stats.scan_launches = fused_scan.SCAN_COUNTER.launches - scans0
        stats.probe_launches = fused_scan.PROBE_COUNTER.launches - probes0
        if ctx.is_group_by:
            types = {n: cm.data_type.label
                     for n, cm in segments[0].metadata.columns.items()}
            return reduce_group_by(ctx, aggs, merged, types), stats
        return reduce_aggregation(ctx, aggs, merged), stats

    def _execute_aggregation(self, ctx: QueryContext, aggs: List[AggDef],
                             segments: List[ImmutableSegment],
                             stats: QueryStats) -> AggResult:
        merged: Optional[AggResult] = None
        for seg in segments:
            scan = self._scan_segment(ctx, seg, stats)
            part = decode_scalar_result(scan.plan, scan.tree)
            if merged is None:
                merged = part
            else:
                merged.merge(part, aggs)
        return merged

    def _execute_group_by(self, ctx: QueryContext, aggs: List[AggDef],
                          segments: List[ImmutableSegment],
                          stats: QueryStats) -> GroupByResult:
        merged = GroupByResult()
        for seg in segments:
            scan = self._scan_segment(ctx, seg, stats)
            merged.merge(decode_grouped_result(scan.plan, seg, scan.tree),
                         aggs)
        return merged

    def _scan_segment(self, ctx: QueryContext, seg: ImmutableSegment,
                      stats: QueryStats) -> fused_scan.SegmentScan:
        try:
            plan = plan_segment(ctx, seg)
        except PlanError as e:
            raise NotPortedError(e.reason_code, str(e)) from e
        reasons: List[str] = []
        scan = fused_scan.run_segment(plan, self.stage(seg),
                                      on_decline=reasons.append)
        if scan is None:
            raise NotPortedError(reasons[0] if reasons else "unknown",
                                 f"segment {seg.segment_name!r}")
        stats.num_segments_processed += 1
        stats.total_docs += seg.num_docs
        stats.num_docs_scanned += scan.matched
        stats.num_segments_matched += 1 if scan.matched else 0
        return scan


def decode_scalar_result(plan: SegmentPlan, out: Dict[str, Any]) -> AggResult:
    states: List[Any] = []
    for i, aspec in enumerate(plan.spec[1]):
        raw = out[f"agg{i}"]
        base = aspec[0]
        if base == "count":
            states.append(int(raw))
        elif base in ("sum", "min", "max"):
            states.append(float(raw))
        elif base == "avg":
            states.append((float(raw[0]), int(raw[1])))
        elif base == "minmaxrange":
            states.append((float(raw[0]), float(raw[1])))
        else:
            raise AssertionError(base)
    return AggResult(states)


def decode_grouped_result(plan: SegmentPlan, provider: Any,
                          out: Dict[str, Any]) -> GroupByResult:
    """Composed keys -> per-column dictIds -> values, with the planner's
    own strides and bases."""
    presence = np.asarray(out["presence"])
    gidx = np.nonzero(presence)[0]
    result = GroupByResult()
    if gidx.size == 0:
        return result
    strides = plan.group_strides.astype(np.int64)
    bases = plan.group_bases or [0] * len(plan.group_cards)
    key_cols: List[List[Any]] = []
    for i, ((_strat, col), card) in enumerate(zip(plan.group_defs,
                                                   plan.group_cards)):
        dids = (gidx // strides[i]) % card
        d = provider.data_source(col).dictionary
        key_cols.append(d.get_values(dids + int(bases[i])))
    keys = list(zip(*key_cols))

    states_per_agg: List[List[Any]] = []
    for i, aspec in enumerate(plan.spec[1]):
        raw = out[f"agg{i}"]
        base = aspec[0]
        if base == "count":
            states_per_agg.append([int(v) for v in np.asarray(raw)[gidx]])
        elif base in ("sum", "min", "max"):
            states_per_agg.append([float(v) for v in np.asarray(raw)[gidx]])
        elif base == "avg":
            s = np.asarray(raw[0])[gidx]
            c = np.asarray(raw[1])[gidx]
            states_per_agg.append([(float(a), int(b)) for a, b in zip(s, c)])
        elif base == "minmaxrange":
            lo = np.asarray(raw[0])[gidx]
            hi = np.asarray(raw[1])[gidx]
            states_per_agg.append([(float(a), float(b))
                                   for a, b in zip(lo, hi)])
        else:
            raise AssertionError(base)
    n_aggs = len(plan.agg_defs)
    for gi, key in enumerate(keys):
        result.groups[key] = [states_per_agg[ai][gi] for ai in range(n_aggs)]
    return result


__all__ = ["ServerQueryExecutor", "decode_scalar_result",
           "decode_grouped_result", "NotPortedError"]
