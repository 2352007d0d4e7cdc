"""Sharded query executor: a multi-segment query as one call on the card.

Counterpart of ``pinot_tpu/parallel/executor.py`` (``ShardedQueryExecutor``)
for one card: a query over more than one segment (after the base class's
pruning) plans once against the segments' ``SegmentBatch`` and runs as
one call over the whole batch, with one device-to-host copy of its
outputs, where the per-segment executor runs one call and one copy per
segment. Binding (``_bind``, JAX ``_bind_launch`` :526) picks the call as
the JAX executor does: one launch of the fused scan
(``parallel/combine.py``) where it is eligible, else the jnp combine
(``combine.batch_body_combine``, JAX ``_bind_jnp`` :544), with the fused
scan's decline recorded as ``pallas:pallas_combine->jnp_combine:<code>``
once per bound query; ``use_fused_scan=False`` sends every plan to the
jnp combine. Batches are cached by the set of segments the pruner kept,
within a byte budget (least recently used evicted first past it), and a
bound query is cached per batch, so a repeated query plans and binds
nothing. The merged groups are trimmed to ``num_groups_limit`` in the base
class's ``execute``, and, as in the JAX package, a query over more than
one segment skips the metadata answer and scans.

The per-segment path of the base class serves, with the decision
recorded in ``QueryStats.decisions`` as ``sharded_combine:sharded_combine->
per_segment:<code>``: a single segment, segments that cannot share a batch
(upsert segments among them: their valid-doc bitmaps change under a
batch), a plan the batch's key space refuses, and a combined result the
decode refuses (more live groups than the compact cap); a plan the device
planner refuses there (a host-only aggregation, say) then reaches the
host engine per segment, as in the JAX package. A selective filter the
segments' indexes serve leaves the batch for the per-segment path too,
with no decision (JAX ``_index_rung_fit`` :136), so the index rung serves
each segment; ahead of it, so does a query one of the segments' star-trees
fits (JAX ``_any_star_tree_fit`` :122-134, :147-149, :172-174), so each
segment's node slice serves it. Selection and DISTINCT are the base
class's: the JAX sharded executor does not override them.

The JAX executor's launch scheduler and coalescing, residency and
admission, sliced execution and the doc-axis mesh are not part of this
executor.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pinot_tpu_torch.engine import (
    fused_scan,
    index_exec,
    kernels,
    startree_device,
)
from pinot_tpu_torch.engine.aggregates import AggDef
from pinot_tpu_torch.engine.errors import PlanError
from pinot_tpu_torch.engine.executor import (
    DEFAULT_NUM_GROUPS_LIMIT,
    ServerQueryExecutor,
    decode_grouped_result,
    decode_scalar_result,
)
from pinot_tpu_torch.engine.plan import SegmentPlan, plan_segment
from pinot_tpu_torch.engine.results import (
    AggResult,
    GroupByResult,
    QueryStats,
    ResultTable,
    record_decision,
)
from pinot_tpu_torch.parallel.batch import SegmentBatch, StagedBatch
from pinot_tpu_torch.parallel.combine import (
    BATCH_GENERAL_COUNTER,
    BATCH_KERNELS,
    SEG_SHARDS,
    SHARDED_PROBE_COUNTER,
    SHARDED_SCAN_COUNTER,
    combine_to_host,
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


@dataclass
class CombineInputs:
    """A plan bound to the jnp combine over a staged batch."""

    plan: SegmentPlan                         # the outputs decode against it
    cols: Dict[str, Dict[str, torch.Tensor]]  # StagedBatch.column trees
    params: Tuple                             # the plan's params, on device
    num_docs: torch.Tensor                    # [S] int64

    def run(self) -> np.ndarray:
        """The packed outputs, copied to the host."""
        return combine_to_host(self.plan.spec, self.cols, self.params,
                               self.num_docs)


class ShardedQueryExecutor(ServerQueryExecutor):
    """Executor whose combine is one call over the segment batch."""

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 use_fused_scan: bool = True,
                 num_groups_limit: int = DEFAULT_NUM_GROUPS_LIMIT):
        super().__init__(device, use_fused_scan=use_fused_scan,
                         num_groups_limit=num_groups_limit)
        # device bytes the staged batches may hold together (None: no
        # bound); the batch a query runs on is kept even past it
        self.batch_budget_bytes = default_batch_budget(self.device)
        # batches built and staged so far (a cache hit stages none)
        self.batches_staged = 0
        # segment names -> (batch, its device image), least recently used
        # first
        self._batches: ("OrderedDict[Tuple[str, ...], "
                        "Tuple[SegmentBatch, StagedBatch]]") = OrderedDict()
        # (sql, batch name, S) -> the bound query: the fused scan's inputs
        # (effective plan, scan plan, program, staged inputs) or the jnp
        # combine's, so a repeated query plans, probes and uploads nothing
        self._param_cache: ("OrderedDict[Tuple, Union[fused_scan.ScanInputs,"
                            " CombineInputs]]") = OrderedDict()

    def execute(self, ctx: QueryContext, segments: List[ImmutableSegment]
                ) -> Tuple[ResultTable, QueryStats]:
        scans0 = SHARDED_SCAN_COUNTER.launches
        probes0 = SHARDED_PROBE_COUNTER.launches
        general0 = BATCH_GENERAL_COUNTER.launches
        table, stats = super().execute(ctx, segments)
        stats.sharded_scan_launches = SHARDED_SCAN_COUNTER.launches - scans0
        stats.sharded_probe_launches = (SHARDED_PROBE_COUNTER.launches
                                        - probes0)
        stats.batch_general_launches = (BATCH_GENERAL_COUNTER.launches
                                        - general0)
        return table, stats

    # -- combine overrides --------------------------------------------------
    def _execute_aggregation(self, ctx: QueryContext, aggs: List[AggDef],
                             segments: List[ImmutableSegment],
                             stats: QueryStats) -> AggResult:
        got = (None if self._any_star_tree_fit(ctx, aggs, segments)
               else self._run_sharded(ctx, segments, stats))
        if got is None:
            return super()._execute_aggregation(ctx, aggs, segments, stats)
        batch, tree, plan = got
        return decode_scalar_result(plan, batch, tree)

    def _execute_group_by(self, ctx: QueryContext, aggs: List[AggDef],
                          segments: List[ImmutableSegment],
                          stats: QueryStats) -> GroupByResult:
        got = (None if self._any_star_tree_fit(ctx, aggs, segments)
               else self._run_sharded(ctx, segments, stats))
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

    def _any_star_tree_fit(self, ctx: QueryContext, aggs: List[AggDef],
                           segments: List[ImmutableSegment]) -> bool:
        """Does a tree of any segment fit the query? Then the per-segment
        path serves it, and records its own decisions."""
        return any(self._star_tree_pick(ctx, aggs, s) is not None
                   for s in segments if s.star_trees)

    def _run_sharded(self, ctx: QueryContext,
                     segments: List[ImmutableSegment], stats: QueryStats
                     ) -> Optional[Tuple[SegmentBatch, Dict, object]]:
        """-> (batch, decode tree, effective plan) from one call over the
        batch, or None when the segments take the per-segment path."""
        if len(segments) < 2 or index_exec.batch_index_eligible(ctx,
                                                               segments):
            return None
        try:
            batch, staged = self.batch_for(segments)
            key = (ctx.sql if ctx.sql is not None else repr(ctx),
                   batch.segment_name, staged.num_segs)
            inp = self._param_cache.get(key)
            plan = plan_segment(ctx, batch) if inp is None else None
        except (PlanError, ValueError) as e:
            self._leave_batch(stats, e)
            return None
        if inp is None:
            inp = self._bind(plan, staged, stats)
            self._param_cache[key] = inp
            if len(self._param_cache) > PARAM_CACHE_CAP:
                self._param_cache.popitem(last=False)
            # binding staged the columns this query reads
            self._enforce_batch_budget(batch)
        else:
            self._param_cache.move_to_end(key)
        if isinstance(inp, CombineInputs):
            try:
                tree = kernels.unpack_outputs(inp.run(), inp.plan.spec,
                                              num_seg=staged.num_segs)
            except PlanError as e:  # more live groups than the compact cap
                self._leave_batch(stats, e)
                return None
        else:
            tree = fused_scan.assemble_outputs(inp.plan.spec, inp.pp,
                                               inp.scan())
        seg_matched = tree["seg_matched"][:batch.num_segments]
        stats.num_segments_processed += batch.num_segments
        stats.total_docs += batch.num_docs
        stats.num_docs_scanned += int(seg_matched.sum())
        stats.num_segments_matched += int(np.count_nonzero(seg_matched))
        if inp.plan.spec[2]:    # grouped: the ladder rung that served
            rung = kernels.grouped_rung(inp.plan.spec, tree)
            stats.group_by_rung = (rung if stats.group_by_rung
                                   in (None, rung) else "mixed")
        return batch, tree, inp.plan

    @staticmethod
    def _leave_batch(stats: QueryStats, e: Exception) -> None:
        record_decision(stats, "sharded_combine", "per_segment",
                        "sharded_combine",
                        e.reason_code if isinstance(e, PlanError)
                        else "segments_not_batchable")

    def _bind(self, plan: SegmentPlan, staged: StagedBatch,
              stats: QueryStats
              ) -> Union[fused_scan.ScanInputs, CombineInputs]:
        """Plan -> the fused scan's inputs over the batch (extraction, the
        batch-wide probe and narrowing when the group space needs it, the
        program), or, where the fused scan declines or is off, the jnp
        combine's, with the decline recorded."""
        reasons: List[str] = []
        if self.use_fused_scan:
            inp = fused_scan.scan_inputs(plan, staged,
                                         on_decline=reasons.append)
            if inp is not None:
                return inp
        else:
            reasons.append("pallas_disabled_on_backend")
        for r in reasons:
            record_decision(stats, "pallas", "jnp_combine", "pallas_combine",
                            r)
        return CombineInputs(
            plan=plan,
            cols={name: staged.column(name).tree() for name in plan.columns},
            params=kernels.device_params(plan, self.device),
            num_docs=staged.num_docs_tensor())


def scan_counters() -> Dict[str, fused_scan.KernelCounter]:
    """The launch counters of every kernel the executors' paths run."""
    return {c.name: c for k in (fused_scan.SEGMENT_KERNELS, BATCH_KERNELS)
            for c in (k.scan_counter, k.probe_counter)}


def rung_counters() -> Dict[str, fused_scan.KernelCounter]:
    """The call counters of the PyTorch rungs: the general rung per
    segment, the jnp combine over a batch, the index rung's gather and the
    star-tree rung's node slice."""
    return {c.name: c for c in (kernels.RUNG_COUNTER, BATCH_GENERAL_COUNTER,
                                index_exec.INDEX_COUNTER,
                                startree_device.STARTREE_COUNTER)}
