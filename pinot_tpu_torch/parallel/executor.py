"""Sharded query executor: a multi-segment query as one scan on the card.

Counterpart of ``pinot_tpu/parallel/executor.py`` (``ShardedQueryExecutor``)
for one card: a query over more than one segment (after the base class's
pruning) plans once against the segments' ``SegmentBatch`` and runs as
one launch of the fused scan over the whole batch
(``parallel/combine.py``), with one device-to-host copy of its outputs,
where the per-segment executor runs one launch and one copy per segment.
Batches are cached by the set of segments the pruner kept, within a
byte budget (least recently used evicted first past it). The merged
groups are trimmed to ``num_groups_limit`` in the base class's
``execute``, and, as in the JAX package, a query over more than one
segment skips the metadata answer and scans. A single segment, segments
that cannot share a batch, or a plan the batch's key space refuses take
the per-segment path of the base class, with the decision recorded in
``QueryStats.decisions`` (upsert segments among them: their valid-doc
bitmaps change under a batch), as ``sharded_combine:sharded_combine->
per_segment:<code>``; a plan the device planner refuses there (a host-only
aggregation, say) then reaches the host engine per segment, as in the JAX
package. Selection and DISTINCT are the base class's: the JAX sharded
executor does not override them. A plan the fused scan declines over the
batch raises :class:`NotPortedError`: the JAX package would serve it on
its jnp combine, which is not ported.

The JAX executor's launch scheduler and coalescing, residency and
admission, sliced execution, star-tree and index routing and the doc-axis
mesh are not part of this executor.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pinot_tpu_torch.engine import fused_scan
from pinot_tpu_torch.engine.aggregates import AggDef
from pinot_tpu_torch.engine.errors import NotPortedError, PlanError
from pinot_tpu_torch.engine.executor import (
    DEFAULT_NUM_GROUPS_LIMIT,
    ServerQueryExecutor,
    decode_grouped_result,
    decode_scalar_result,
)
from pinot_tpu_torch.engine.plan import plan_segment
from pinot_tpu_torch.engine.results import (
    AggResult,
    GroupByResult,
    QueryStats,
    ResultTable,
    record_decision,
)
from pinot_tpu_torch.parallel.batch import SegmentBatch, StagedBatch
from pinot_tpu_torch.parallel.combine import (
    BATCH_KERNELS,
    SEG_SHARDS,
    SHARDED_PROBE_COUNTER,
    SHARDED_SCAN_COUNTER,
    pad_segments,
)
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.segment.immutable import ImmutableSegment

# bound queries kept per executor (the JAX executor's param-cache cap)
PARAM_CACHE_CAP = 256
# share of the card's memory the staged batches may hold together (the JAX
# package's HBM budget fraction): each holds a device copy of every column
# it was asked for, and nothing else bounds them until residency is ported
BATCH_BUDGET_FRACTION = 0.75


def default_batch_budget(device: torch.device) -> Optional[int]:
    """Bytes the staged batches may hold on ``device``: a share of the
    card's memory, no bound on the CPU."""
    if device.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total * BATCH_BUDGET_FRACTION)


class ShardedQueryExecutor(ServerQueryExecutor):
    """Executor whose combine is one scan over the segment batch."""

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 num_groups_limit: int = DEFAULT_NUM_GROUPS_LIMIT):
        super().__init__(device, num_groups_limit=num_groups_limit)
        # device bytes the staged batches may hold together (None: no
        # bound); the batch a query runs on is kept even past it
        self.batch_budget_bytes = default_batch_budget(self.device)
        # batches built and staged so far (a cache hit stages none)
        self.batches_staged = 0
        # segment names -> (batch, its device image), least recently used
        # first
        self._batches: ("OrderedDict[Tuple[str, ...], "
                        "Tuple[SegmentBatch, StagedBatch]]") = OrderedDict()
        # (sql, batch name, S) -> the bound scan: effective plan, scan plan,
        # program (uploaded at its first launch) and staged inputs, so a
        # repeated query plans, probes and uploads nothing
        self._param_cache: "OrderedDict[Tuple, fused_scan.ScanInputs]" = \
            OrderedDict()

    def execute(self, ctx: QueryContext, segments: List[ImmutableSegment]
                ) -> Tuple[ResultTable, QueryStats]:
        scans0 = SHARDED_SCAN_COUNTER.launches
        probes0 = SHARDED_PROBE_COUNTER.launches
        table, stats = super().execute(ctx, segments)
        stats.sharded_scan_launches = SHARDED_SCAN_COUNTER.launches - scans0
        stats.sharded_probe_launches = (SHARDED_PROBE_COUNTER.launches
                                        - probes0)
        return table, stats

    # -- combine overrides --------------------------------------------------
    def _execute_aggregation(self, ctx: QueryContext, aggs: List[AggDef],
                             segments: List[ImmutableSegment],
                             stats: QueryStats) -> AggResult:
        got = self._run_sharded(ctx, segments, stats)
        if got is None:
            return super()._execute_aggregation(ctx, aggs, segments, stats)
        batch, tree, plan = got
        return decode_scalar_result(plan, batch, tree)

    def _execute_group_by(self, ctx: QueryContext, aggs: List[AggDef],
                          segments: List[ImmutableSegment],
                          stats: QueryStats) -> GroupByResult:
        got = self._run_sharded(ctx, segments, stats)
        if got is None:
            return super()._execute_group_by(ctx, aggs, segments, stats)
        batch, tree, plan = got
        return decode_grouped_result(plan, batch, tree)

    # -- the batch path -------------------------------------------------------
    def batch_for(self, segments: List[ImmutableSegment]
                  ) -> Tuple[SegmentBatch, StagedBatch]:
        """The cached batch of these segments and its device image, built
        on first use; raises ValueError when they cannot share a batch."""
        key = tuple(s.segment_name for s in segments)
        hit = self._batches.get(key)
        if any(s.valid_doc_ids is not None for s in segments):
            # a bitmap attached after the batch was built must not be
            # served the batch's arrays: drop it, the per-segment path
            # (which reads the bitmap) serves
            if hit is not None:
                self._evict_batch(hit[0])
            raise ValueError("upsert-managed segments are not batchable")
        if hit is not None and all(c is s for c, s in
                                   zip(hit[0].segments, segments)):
            self._batches.move_to_end(key)
            return hit
        if hit is not None:
            # a reloaded segment keeps its name but must not serve the old
            # segment's device arrays or bound programs
            self._evict_batch(hit[0])
        batch = SegmentBatch(segments)
        staged = StagedBatch(batch, device=self.device,
                             num_segs=pad_segments(batch.num_segments,
                                                   SEG_SHARDS))
        self._batches[key] = (batch, staged)
        self.batches_staged += 1
        self._enforce_batch_budget(batch)
        return batch, staged

    def _enforce_batch_budget(self, keep: SegmentBatch) -> None:
        """Evict the least recently used batches but ``keep`` while the
        batches hold more than the budget."""
        if self.batch_budget_bytes is None:
            return
        sizes = [(b, st.nbytes()) for b, st in self._batches.values()]
        total = sum(n for _, n in sizes)
        for b, n in sizes:
            if total <= self.batch_budget_bytes:
                break
            if b is not keep:
                self._evict_batch(b)
                total -= n

    def _evict_batch(self, batch: SegmentBatch) -> None:
        for k in [k for k, v in self._batches.items() if v[0] is batch]:
            del self._batches[k]
        for k in [k for k in self._param_cache if k[1] == batch.segment_name]:
            del self._param_cache[k]

    def _run_sharded(self, ctx: QueryContext,
                     segments: List[ImmutableSegment], stats: QueryStats
                     ) -> Optional[Tuple[SegmentBatch, Dict, object]]:
        """-> (batch, decode tree, effective plan) from one launch over the
        batch, or None when the segments take the per-segment path."""
        if len(segments) < 2:
            return None
        try:
            batch, staged = self.batch_for(segments)
            key = (ctx.sql if ctx.sql is not None else repr(ctx),
                   batch.segment_name, staged.num_segs)
            inp = self._param_cache.get(key)
            plan = plan_segment(ctx, batch) if inp is None else None
        except (PlanError, ValueError) as e:
            record_decision(stats, "sharded_combine", "per_segment",
                            "sharded_combine",
                            e.reason_code if isinstance(e, PlanError)
                            else "segments_not_batchable")
            return None
        if inp is None:
            inp = self._bind(plan, staged)
            self._param_cache[key] = inp
            if len(self._param_cache) > PARAM_CACHE_CAP:
                self._param_cache.popitem(last=False)
            # binding staged the columns this query reads
            self._enforce_batch_budget(batch)
        else:
            self._param_cache.move_to_end(key)
        tree = fused_scan.assemble_outputs(inp.plan.spec, inp.pp, inp.scan())
        seg_matched = tree["seg_matched"][:batch.num_segments]
        stats.num_segments_processed += batch.num_segments
        stats.total_docs += batch.num_docs
        stats.num_docs_scanned += int(seg_matched.sum())
        stats.num_segments_matched += int(np.count_nonzero(seg_matched))
        return batch, tree, inp.plan

    def _bind(self, plan, staged: StagedBatch) -> fused_scan.ScanInputs:
        """Plan -> scan inputs over the batch: extraction, the batch-wide
        probe and narrowing when the group space needs it, the program."""
        reasons: List[str] = []
        inp = fused_scan.scan_inputs(plan, staged, on_decline=reasons.append)
        if inp is None:
            raise NotPortedError(reasons[0] if reasons else "unknown",
                                 f"batch {staged.batch.segment_name!r}")
        return inp


def scan_counters() -> Dict[str, fused_scan.KernelCounter]:
    """The launch counters of every kernel the executors' paths run."""
    return {c.name: c for k in (fused_scan.SEGMENT_KERNELS, BATCH_KERNELS)
            for c in (k.scan_counter, k.probe_counter)}
