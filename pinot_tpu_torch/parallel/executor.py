"""Sharded query executor: a multi-segment query as one call over a mesh.

Counterpart of ``pinot_tpu/parallel/executor.py`` (``ShardedQueryExecutor``):
a query over more than one segment (after the base class's pruning) plans
once against the segments' ``SegmentBatch`` and runs as one call over the
whole batch, with one device-to-host copy of its outputs, where the
per-segment executor runs one call and one copy per segment. The call
runs over the executor's combine mesh (``parallel/mesh.py``,
``ShardedQueryExecutor(mesh=..., doc_shards=...)``, JAX :50-55): one
cell on ``device`` without a mesh (``doc_shards`` cells on it along the
doc axis), else the mesh's cells, each scanning its block of the batch,
the partials folded on the mesh's root. The per-segment path of the base
class runs on the root. The slice planner pads to the mesh's ``seg``
axis (JAX :209), a jnp combine whose capacity the ``doc`` axis does not
divide leaves the batch with JAX's ``PlanError`` (:551-554,
``capacity_mesh_mismatch``), and both query caches key on the mesh.
Binding (``_bind``, JAX ``_bind_launch`` :526) picks the call as the JAX
executor does: one launch of the fused scan
(``parallel/combine.py``) where it is eligible, else the jnp combine
(``combine.batch_body_combine``, JAX ``_bind_jnp`` :544), with the fused
scan's decline recorded as ``pallas:pallas_combine->jnp_combine:<code>``
once per bound query; ``use_fused_scan=False`` sends every plan to the
jnp combine. Batches are cached by the set of segments the pruner kept,
and a bound query is cached per batch, so a repeated query plans and
binds nothing. The merged groups are trimmed to ``num_groups_limit`` in the base
class's ``execute``, and, as in the JAX package, a query over more than
one segment skips the metadata answer and scans.

The per-segment path of the base class serves, with the decision
recorded in ``QueryStats.decisions`` as ``sharded_combine:sharded_combine->
per_segment:<code>``: a single segment, segments that cannot share a batch
(upsert segments among them: their valid-doc bitmaps change under a
batch), a plan the batch's key space refuses, and a combined result the
decode refuses (more live groups than the compact cap); a consuming
segment among them serves on its own rung (``mutable_device``). A plan
the device planner refuses there (a host-only aggregation, say) then
reaches the
host engine per segment, as in the JAX package. A selective filter the
segments' indexes serve leaves the batch for the per-segment path too,
with no decision (JAX ``_index_rung_fit`` :136), so the index rung serves
each segment; ahead of it, so does a query one of the segments' star-trees
fits (JAX ``_any_star_tree_fit`` :122-134, :147-149, :172-174), so each
segment's node slice serves it. Selection and DISTINCT are the base
class's: the JAX sharded executor does not override them.

Residency and launches (JAX :60-493): a staged batch is a resident of
the executor's ``ResidencyManager`` (``_BatchResident``), pinned by the
query's lease, byte-accounted, evicted under the budget with its bound
queries, demoted to its host image (``BatchHostImage``: pinned copies of
its tensors and the ``SegmentBatch``) and adopted back from it
(``batch_for``), its tensors restored by copies. A sliced
lease runs the combine in budget-sized slices (``_execute_sliced``:
``plan_slices``, a batch a slice, ``release_slice`` between them); where
one segment alone is over the free budget, the per-segment sliced path
serves, recorded as ``sharded_combine:sharded_sliced->per_segment_sliced:
slice_pad_over_budget``. Bound queries have two cache tiers: the param
tier by the exact query (its plan, program or params) and the launch tier
by the literal-normalized key (``ScanProgram.layout_key`` with the
columns, or the jnp combine's spec), which holds the ``LaunchKernel``
over the staged inputs and is the coalescing identity. Every batch launch
goes through the mesh's ``LaunchScheduler`` (``parallel/launcher.py``),
and the query's ``QueryStats.launch`` adds one record a launch. A launch
that fails raises in every query that rode it: the JAX executor's repair
from Pallas to jnp (:434-474) is not copied, and a failed cell's launch
raises in the query.

A traced query's batch launch is one ``ShardedCombine`` span (the
launcher's queue wait as its ``queueMs`` and the mesh's shape, JAX :376,
:393) and a sliced lease's slices ``Slice`` spans (JAX :219). The
launches a request was served by, its own or a coalesced one, come back
on the request and count in the query's stats.

The column borrower (``_borrow_batch_column``, JAX :813-883): a
per-segment staging (the general rung, the index rung, the top-k) of a
segment a resident batch holds reads that batch's jnp-combine column
instead of uploading its own, where the bytes coincide: the same segment
object, the batch's capacity equal to the segment's, a single-value
column, an identity remap into the unified dictionary, and the dtypes the
segment would stage. The ``dictvals`` tensor is shared; the ``fwd`` and
``null`` rows are cloned on the device (a view would keep the whole batch
alive after its eviction, and residency would count the segment's bytes
wrong). Packed dictIds and value columns are never borrowed: their
layouts (the unified cardinality's bit width, tile padding) are not the
segment's.
"""

from __future__ import annotations

import threading

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pinot_tpu_torch.common.tracing import (
    maybe_span,
    record_decision,
    stats_tracer,
)
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
    merge_launch,
)
from pinot_tpu_torch.engine.staging import (
    StagedColumn,
    raw_staged_dtype,
    staged_int_dtype,
)
from pinot_tpu_torch.parallel.batch import (
    BatchHostImage,
    MeshStagedBatch,
    SegmentBatch,
    StagedBatch,
)
from pinot_tpu_torch.parallel.combine import (
    BATCH_GENERAL_COUNTER,
    BATCH_KERNELS,
    combine_to_host,
    sharded_fused_scan_many,
    sharded_fused_scan_probe_many,
)
from pinot_tpu_torch.parallel.launcher import LaunchKernel, launcher_for_mesh
from pinot_tpu_torch.parallel.mesh import CombineMesh, make_combine_mesh
from pinot_tpu_torch.query.context import QueryContext, filter_fingerprint
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.segment.mutable import is_mutable
from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration

# bound queries (param tier) and launch kernels (launch tier) kept per
# executor, least recently used first out (the JAX executor's caps)
PARAM_CACHE_CAP = 256
LAUNCH_CACHE_CAP = 128


@dataclass
class CombineInputs:
    """A plan bound to the jnp combine over a staged batch."""

    plan: SegmentPlan   # the outputs decode against it
    # StagedBatch.column trees, the plan's params on the device and [S]
    # int64 docs; over a mesh a list of trees and of params, one a cell,
    # and the cells' docs (``MeshStagedBatch.combine_num_docs``)
    cols: Any
    params: Any
    num_docs: Any

    def run(self) -> np.ndarray:
        """The packed outputs, copied to the host."""
        return combine_to_host(self.plan.spec, self.cols, self.params,
                               self.num_docs)


@dataclass
class BoundQuery:
    """A query bound to a staged batch: what its launch takes and what its
    outputs decode against."""

    plan: SegmentPlan                 # the effective plan (decode)
    launch_key: Tuple                 # the launch tier's key
    params: Any                       # per-query launch input: the fused
    #                                   scan's ScanProgram, or the jnp
    #                                   combine's device params
    make_kernel: Callable[[], LaunchKernel]
    pp: Optional[fused_scan.ScanPlan] = None   # the fused scan's, or None
    # the probe's (program, packed columns) when binding narrowed the
    # group space with a probe scan, else None
    probe: Optional[Tuple] = None
    # the staged inputs the launch reads: ScanInputs or CombineInputs
    inputs: Any = None


def _host(outs: fused_scan.ScanOutputs) -> fused_scan.ScanOutputs:
    return outs.to_host()


class ShardedQueryExecutor(ServerQueryExecutor):
    """Executor whose combine is one call over the segment batch, on the
    cells of ``mesh`` (``make_combine_mesh``), or without one on
    ``doc_shards`` cells of ``device`` (one by default)."""

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 use_fused_scan: bool = True,
                 num_groups_limit: int = DEFAULT_NUM_GROUPS_LIMIT,
                 hbm_budget_bytes=None, host_budget_bytes=None,
                 config=None, mesh: Optional[CombineMesh] = None,
                 doc_shards: int = 1):
        super().__init__(mesh.root if mesh is not None else device,
                         use_fused_scan=use_fused_scan,
                         num_groups_limit=num_groups_limit,
                         hbm_budget_bytes=hbm_budget_bytes,
                         host_budget_bytes=host_budget_bytes, config=config)
        self.mesh = mesh if mesh is not None else make_combine_mesh(
            [self.device] * doc_shards, doc_shards)
        # batches built (or adopted from the host tier) and staged so far;
        # a cache hit stages none
        self.batches_staged = 0
        self.batches_adopted = 0
        # segment names -> (batch, its device image)
        self._batches: Dict[Tuple[str, ...],
                            Tuple[SegmentBatch, StagedBatch]] = {}
        self._batches_lock = threading.Lock()
        # (sql, batch name, S, filter fingerprint) -> BoundQuery; launch
        # key -> LaunchKernel
        self._param_cache: "OrderedDict[Tuple, BoundQuery]" = OrderedDict()
        self._launch_cache: "OrderedDict[Tuple, LaunchKernel]" = \
            OrderedDict()
        self._cache_lock = threading.Lock()
        cfg = config if config is not None else PinotConfiguration()
        self._launch_max_batch = max(1, cfg.get_int(
            CommonConstants.LAUNCH_MAX_BATCH_KEY,
            CommonConstants.DEFAULT_LAUNCH_MAX_BATCH))
        # per-segment stagings borrow the resident batches' columns
        self.residency.column_borrower = self._borrow_batch_column
        self.launcher = launcher_for_mesh(self.mesh)
        self.launcher.set_window(
            max_ms=cfg.get_float(CommonConstants.LAUNCH_WINDOW_MS_KEY,
                                 CommonConstants.DEFAULT_LAUNCH_WINDOW_MS),
            hot_ms=cfg.get_float(
                CommonConstants.LAUNCH_WINDOW_HOT_MS_KEY,
                CommonConstants.DEFAULT_LAUNCH_WINDOW_HOT_MS))

    # -- combine overrides --------------------------------------------------
    def _execute_aggregation(self, ctx: QueryContext, aggs: List[AggDef],
                             segments: List[ImmutableSegment],
                             stats: QueryStats) -> AggResult:
        if self._any_star_tree_fit(ctx, aggs, segments):
            return super()._execute_aggregation(ctx, aggs, segments, stats)
        if self._sliced(stats):
            return self._execute_sliced(ctx, aggs, segments, stats,
                                        grouped=False)
        got = (self._run_sharded(ctx, segments, stats)
               if self._device_admitted(stats) else None)
        if got is None:
            return super()._execute_aggregation(ctx, aggs, segments, stats)
        batch, tree, plan = got
        return decode_scalar_result(plan, batch, tree)

    def _execute_group_by(self, ctx: QueryContext, aggs: List[AggDef],
                          segments: List[ImmutableSegment],
                          stats: QueryStats) -> GroupByResult:
        if self._any_star_tree_fit(ctx, aggs, segments):
            return super()._execute_group_by(ctx, aggs, segments, stats)
        if self._sliced(stats):
            return self._execute_sliced(ctx, aggs, segments, stats,
                                        grouped=True)
        got = (self._run_sharded(ctx, segments, stats)
               if self._device_admitted(stats) else None)
        if got is None:
            return super()._execute_group_by(ctx, aggs, segments, stats)
        batch, tree, plan = got
        return decode_grouped_result(plan, batch, tree)

    @staticmethod
    def _sliced(stats: QueryStats) -> bool:
        return stats.lease is not None and stats.lease.sliced

    def _execute_sliced(self, ctx: QueryContext, aggs: List[AggDef],
                        segments: List[ImmutableSegment], stats: QueryStats,
                        grouped: bool):
        """A working set over the budget, in budget-sized slices (JAX
        :195-243): a batch of a slice's segments, one launch, its partial
        merged, then ``release_slice`` (unpin, demote past the budget)
        before the next slice stages. A repeated pass promotes the slices
        from the host tier. Where even one segment cannot fit the free
        budget, the per-segment sliced path serves."""
        lease = stats.lease
        slices = self.residency.plan_slices(
            segments, ctx.referenced_columns(), lease,
            pad_to=self.mesh.n_seg)
        base = (ServerQueryExecutor._execute_group_by if grouped
                else ServerQueryExecutor._execute_aggregation)
        if slices is None:
            record_decision(stats, "sharded_combine", "per_segment_sliced",
                            "sharded_sliced", "slice_pad_over_budget")
            return base(self, ctx, aggs, segments, stats)
        merged = GroupByResult() if grouped else None
        for i, chunk in enumerate(slices):
            with maybe_span(stats, "Slice", index=i, segments=len(chunk)):
                got = self._run_sharded(ctx, chunk, stats)
                if got is not None:
                    batch, tree, plan = got
                    part = (decode_grouped_result(plan, batch, tree)
                            if grouped
                            else decode_scalar_result(plan, batch, tree))
                else:
                    part = base(self, ctx, aggs, chunk, stats)
                if grouped:
                    merged.merge(part, aggs)
                elif merged is None:
                    merged = part
                else:
                    merged.merge(part, aggs)
                # the slice's boundary: unpin, demote past the budget
                self.residency.release_slice(lease)
        return merged

    def _any_star_tree_fit(self, ctx: QueryContext, aggs: List[AggDef],
                           segments: List[ImmutableSegment]) -> bool:
        """Does a tree of any segment fit the query? Then the per-segment
        path serves it, and records its own decisions."""
        return any(self._star_tree_pick(ctx, aggs, s) is not None
                   for s in segments if s.star_trees)

    # -- batches --------------------------------------------------------------
    def batch_for(self, segments: List[ImmutableSegment], lease=None
                  ) -> Tuple[SegmentBatch, StagedBatch]:
        """The cached batch of these segments and its device image: built
        on first use, or adopted from its host image; raises ValueError
        when they cannot share a batch."""
        if any(is_mutable(s) for s in segments):
            # consuming segments grow: the per-segment path serves each on
            # its own rung
            raise ValueError("consuming segments are not batchable")
        key = tuple(s.segment_name for s in segments)
        with self._batches_lock:
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
            return hit
        if hit is not None:
            # a reloaded segment keeps its name but must not serve the old
            # segment's device arrays or bound queries
            self._evict_batch(hit[0])
        # a demoted batch comes back from its host image: its tensors are
        # restored by copies, its dictionaries are the image's batch's
        name = "batch(" + ",".join(key) + ")"
        image = self.residency.promote_host(name, segments, lease)
        batch = image.batch if image is not None else SegmentBatch(segments)
        staged = (StagedBatch(batch, device=self.device,
                              num_segs=batch.num_segments, host_image=image)
                  if self.mesh.size == 1 else
                  MeshStagedBatch(batch, self.mesh, host_image=image))
        with self._batches_lock:
            # another thread may have built it first: share its batch
            cur = self._batches.get(key)
            if cur is not None and all(c is s for c, s in
                                       zip(cur[0].segments, segments)):
                return cur
            self._batches[key] = (batch, staged)
            self.batches_staged += 1
            self.batches_adopted += int(image is not None)
        return batch, staged

    def _evict_batch(self, batch: SegmentBatch) -> None:
        """Drop everything derived from a batch: its registration, both
        cache tiers' entries (their kernels hold its tensors), its device
        tensors and its residency entry."""
        name = batch.segment_name
        with self._batches_lock:
            staged = [v[1] for k, v in self._batches.items()
                      if v[0] is batch]
            for k in [k for k, v in self._batches.items() if v[0] is batch]:
                del self._batches[k]
        with self._cache_lock:
            for k in [k for k, v in self._param_cache.items()
                      if v.launch_key[-2] == name]:
                del self._param_cache[k]
            for k in [k for k in self._launch_cache if k[-2] == name]:
                del self._launch_cache[k]
        for st in staged:
            st.release()
        self.residency.discard(name)

    def evict_segment(self, segment_name: str) -> None:
        """Every batch holding the segment goes too."""
        with self._batches_lock:
            stale = [b for k, (b, _) in self._batches.items()
                     if segment_name in k]
        for b in stale:
            self._evict_batch(b)
        super().evict_segment(segment_name)

    def _borrow_batch_column(self, segment: ImmutableSegment, name: str
                             ) -> Optional[StagedColumn]:
        """The general rung's arrays of ``segment``'s column ``name`` from
        a resident batch's device copy, or None where no batch holds the
        same bytes (see the module docstring)."""
        with self._batches_lock:
            held = [(k, b, st) for k, (b, st) in self._batches.items()
                    if segment.segment_name in k]
        cm = segment.metadata.columns.get(name)
        if cm is None or not cm.single_value:
            return None
        if cm.has_dictionary:
            want = np.dtype(np.int32)
        else:
            want = raw_staged_dtype(cm)
        dv_want = (None if not (cm.has_dictionary and cm.data_type.is_numeric)
                   else staged_int_dtype(cm) if cm.data_type.is_integral
                   else np.dtype(np.float32))
        for key, batch, staged in held:
            i = key.index(segment.segment_name)
            if batch.segments[i] is not segment:
                continue    # a reloaded segment: the batch's copy is stale
            if batch.capacity != segment.padded_capacity:
                continue    # the row would have the wrong length
            sc = staged.held_column(name)
            if sc is None or sc.fwd is None:
                continue
            if cm.has_dictionary:
                r = batch._remaps.get(name)
                r = None if r is None else r[i]
                if (r is None or len(r) != cm.cardinality
                        or not np.array_equal(
                            r, np.arange(cm.cardinality, dtype=r.dtype))):
                    continue    # unified dictIds differ from the segment's
            if _np_dtype(sc.fwd) != want:
                continue
            if dv_want is not None and (sc.dictvals is None
                                        or _np_dtype(sc.dictvals) != dv_want):
                continue
            if cm.has_nulls and sc.null is None:
                continue
            fwd, null = staged.segment_rows(name, i)
            out = StagedColumn(
                fwd=fwd, dictvals=sc.dictvals if dv_want is not None else None,
                null=null if cm.has_nulls else None)
            self.residency.note_borrow(batch.segment_name)
            return out
        return None

    # -- the batch path -----------------------------------------------------
    def _run_sharded(self, ctx: QueryContext,
                     segments: List[ImmutableSegment], stats: QueryStats
                     ) -> Optional[Tuple[SegmentBatch, Dict, object]]:
        """-> (batch, decode tree, effective plan) from one launch over the
        batch, or None when the segments take the per-segment path."""
        if len(segments) < 2 or index_exec.batch_index_eligible(ctx,
                                                               segments):
            return None
        lease = stats.lease
        try:
            batch, staged = self.batch_for(segments, lease)
            bname = batch.segment_name
            # pinned by the lease: no other query's enforcement frees the
            # tensors this launch reads
            self.residency.register(
                bname, lambda: _BatchResident(self, batch, staged),
                same=lambda r: r.batch is batch, lease=lease)
            # the filter fingerprint: a rewritten filter under the same
            # SQL binds again (JAX :349-352)
            pkey = (ctx.sql if ctx.sql is not None else repr(ctx), bname,
                    staged.num_segs, filter_fingerprint(ctx), self.mesh.key)
            with self._cache_lock:
                bound = self._param_cache.get(pkey)
                if bound is not None:
                    self._param_cache.move_to_end(pkey)
            plan = plan_segment(ctx, batch) if bound is None else None
        except (PlanError, ValueError) as e:
            self._leave_batch(stats, e)
            return None
        if bound is None:
            try:
                bound = self._bind(plan, staged, stats)
            except PlanError as e:   # a capacity the doc axis does not divide
                self._leave_batch(stats, e)
                return None
            with self._cache_lock:
                self._param_cache[pkey] = bound
                if len(self._param_cache) > PARAM_CACHE_CAP:
                    self._param_cache.popitem(last=False)
        kernel = self._launch_kernel(bound.launch_key, bound.make_kernel)
        # the span covers the launcher's queue, the launch and the copy to
        # the host; queueMs is the request's measured queue wait (JAX :376)
        rec = stats_tracer(stats)
        sp = rec.span_begin("ShardedCombine") if rec is not None else None
        req = None
        try:
            req = self.launcher.submit(kernel, bound.params,
                                       bound.inputs.num_docs)
            result = req.result()
        finally:
            if sp is not None:
                rec.span_end(
                    sp,
                    queue_ms=(round(req.queue_wait_ms, 3)
                              if req is not None else None),
                    kernel="fused_scan" if bound.pp is not None
                    else "general",
                    segments=batch.num_segments,
                    mesh=f"{self.mesh.n_seg}x{self.mesh.n_doc}",
                    batch_size=req.batch_size if req is not None else 0,
                    launches=(req.launched.kernel_launches()
                              if req is not None else 0))
        # the launch (or the coalesced launch it rode) counts here
        stats.add_launches(req.launched)
        merge_launch(stats.launch, {
            "launches": 1,
            "coalesced": 1 if req.batch_size > 1 else 0,
            "batchSize": req.batch_size,
            "launchesSaved": req.launches_saved,
            "queueWaitMs": round(req.queue_wait_ms, 3)})
        if bound.pp is None:
            try:
                tree = kernels.unpack_outputs(result, bound.plan.spec,
                                              num_seg=staged.num_segs)
            except PlanError as e:  # more live groups than the compact cap
                self._leave_batch(stats, e)
                return None
        else:
            tree = fused_scan.assemble_outputs(bound.plan.spec, bound.pp,
                                               result)
        # the launch staged columns: measure, enforce, and feed the drift
        # of the segments' estimates against the batch's measured bytes
        self.residency.account(bname, lease)
        if lease is not None and lease._est:
            est = sum(lease._est.get(s.segment_name, 0) for s in segments)
            measured = self.residency.resident_nbytes(bname)
            if est > 0 and measured > 0:
                self.residency.observe_estimate(est, measured)
        seg_matched = tree["seg_matched"][:batch.num_segments]
        stats.num_segments_processed += batch.num_segments
        stats.total_docs += batch.num_docs
        stats.num_docs_scanned += int(seg_matched.sum())
        stats.num_segments_matched += int(np.count_nonzero(seg_matched))
        if bound.plan.spec[2]:    # grouped: the ladder rung that served
            rung = kernels.grouped_rung(bound.plan.spec, tree)
            stats.group_by_rung = (rung if stats.group_by_rung
                                   in (None, rung) else "mixed")
        return batch, tree, bound.plan

    @staticmethod
    def _leave_batch(stats: QueryStats, e: Exception) -> None:
        record_decision(stats, "sharded_combine", "per_segment",
                        "sharded_combine",
                        e.reason_code if isinstance(e, PlanError)
                        else "segments_not_batchable")

    def _launch_kernel(self, key: Tuple,
                       make_kernel: Callable[[], LaunchKernel]
                       ) -> LaunchKernel:
        """The launch tier's kernel under ``key``, made on a miss (JAX
        ``_launch_kernel`` :504)."""
        with self._cache_lock:
            kernel = self._launch_cache.get(key)
            if kernel is None:
                kernel = make_kernel()
                self._launch_cache[key] = kernel
                if len(self._launch_cache) > LAUNCH_CACHE_CAP:
                    self._launch_cache.popitem(last=False)
            else:
                self._launch_cache.move_to_end(key)
            return kernel

    def _bind(self, plan: SegmentPlan, staged: StagedBatch,
              stats: QueryStats) -> BoundQuery:
        """Plan -> the fused scan's program over the batch (extraction, the
        probe through the launcher and narrowing when the group space
        needs it), or, where the fused scan declines or is off, the jnp
        combine's params, with the decline recorded."""
        bname = staged.batch.segment_name
        S = staged.num_segs
        reasons: List[str] = []
        if self.use_fused_scan and plan.spec in self._pallas_blocked:
            reasons.append(self._pallas_blocked.reason_for(plan.spec))
        elif self.use_fused_scan:
            inp = fused_scan.scan_inputs(
                plan, staged, on_decline=reasons.append,
                run_probe=lambda prog, words, num_docs: self._probe(
                    prog, words, num_docs, bname, S, stats),
                lut_run_cap=self.lut_run_cap)
            if inp is not None:
                return self._bind_fused(inp, bname, S)
        else:
            reasons.append("pallas_disabled_on_backend")
        for r in reasons:
            record_decision(stats, "pallas", "jnp_combine", "pallas_combine",
                            r)
        inp = self._combine_inputs(plan, staged)
        first = inp.cols if self.mesh.size == 1 else inp.cols[0]
        layouts = tuple(sorted((name, tuple(sorted(t)))
                               for name, t in first.items()))
        launch_key = ("jnp", plan.spec, layouts, self.mesh.key, bname, S)
        spec, cols = plan.spec, inp.cols
        max_batch = self._launch_max_batch

        def make_kernel() -> LaunchKernel:
            # the jnp combine has no form over several parameter sets:
            # the dispatcher runs them one after another
            return LaunchKernel(
                launch_key,
                lambda params, num_docs: combine_to_host(spec, cols, params,
                                                         num_docs),
                max_batch=max_batch)

        return BoundQuery(plan=plan, launch_key=launch_key,
                          params=inp.params, make_kernel=make_kernel,
                          inputs=inp)

    def _combine_inputs(self, plan: SegmentPlan,
                        staged: StagedBatch) -> CombineInputs:
        """The jnp combine's staged inputs: on one cell the batch's column
        trees and the params on its device; over a mesh a tree and the
        params a cell (one params copy a device). A capacity the doc axis
        does not divide raises JAX's ``PlanError`` (:551-554) before
        anything stages."""
        m = self.mesh
        if m.size == 1:
            return CombineInputs(
                plan=plan,
                cols={name: staged.column(name).tree()
                      for name in plan.columns},
                params=kernels.device_params(plan, self.device),
                num_docs=staged.combine_num_docs())
        if plan.spec[-1] % m.n_doc:
            raise PlanError(f"capacity {plan.spec[-1]} !| doc axis "
                            f"{m.n_doc}")
        cells = {name: staged.column_cells(name) for name in plan.columns}
        params = {d: kernels.device_params(plan, d) for d in m.devices}
        return CombineInputs(
            plan=plan,
            cols=[{name: cells[name][c].tree() for name in plan.columns}
                  for c in range(m.size)],
            params=[params[d] for d in m.cells],
            num_docs=staged.combine_num_docs())

    def _bind_fused(self, inp: fused_scan.ScanInputs, bname: str,
                    S: int) -> BoundQuery:
        pp = inp.pp
        launch_key = ("fused", inp.prog.layout_key(), tuple(pp.packed_names),
                      tuple(pp.value_names), self.mesh.key, bname, S)
        words, values, tiles = inp.words, inp.values, inp.tiles
        max_batch = self._launch_max_batch

        def make_kernel() -> LaunchKernel:
            return LaunchKernel(
                launch_key,
                lambda prog, num_docs: _host(BATCH_KERNELS.scan(
                    prog, words, values, num_docs, tiles)),
                many=lambda progs, num_docs: [
                    _host(o) for o in sharded_fused_scan_many(
                        progs, words, values, num_docs, tiles)],
                max_batch=max_batch)

        return BoundQuery(plan=inp.plan, launch_key=launch_key,
                          params=inp.prog, make_kernel=make_kernel, pp=pp,
                          probe=inp.probe, inputs=inp)

    def _probe(self, prog: fused_scan.ScanProgram, words, num_docs,
               bname: str, S: int, stats: QueryStats
               ) -> fused_scan.ScanOutputs:
        """The group-range probe at binding, through the launcher: probes
        of one layout from concurrent bindings share a launch, which each
        of them counts."""
        key = ("fused_probe", prog.layout_key(), self.mesh.key, bname, S)
        max_batch = self._launch_max_batch
        kernel = self._launch_kernel(key, lambda: LaunchKernel(
            key,
            lambda p, nd: _host(BATCH_KERNELS.probe(p, words, nd)),
            many=lambda ps, nd: [_host(o) for o in
                                 sharded_fused_scan_probe_many(ps, words,
                                                               nd)],
            max_batch=max_batch))
        req = self.launcher.submit(kernel, prog, num_docs)
        out = req.result()
        stats.add_launches(req.launched)
        return out


class _BatchResident:
    """A staged batch as a resident (JAX :920-954): its device bytes; its
    release drops the batch with its bound queries; its demotion leaves a
    ``BatchHostImage``. Lock order: the manager's lock, then the
    executor's."""

    __slots__ = ("executor", "batch", "staged")

    def __init__(self, executor: ShardedQueryExecutor, batch: SegmentBatch,
                 staged: StagedBatch):
        self.executor = executor
        self.batch = batch
        self.staged = staged

    def nbytes(self) -> int:
        return self.staged.nbytes()

    def release(self) -> None:
        self.executor._evict_batch(self.batch)

    def demote(self) -> Optional[BatchHostImage]:
        image = self.staged.demote()
        self.executor._evict_batch(self.batch)
        return image if image.nbytes() > 0 else None


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


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
