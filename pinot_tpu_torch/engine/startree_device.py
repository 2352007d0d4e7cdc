"""Star-tree device rung: a gathered node slice through the general rung.

Counterpart of ``pinot_tpu/engine/startree_device.py`` (:45-203). The
JAX rung is ``jax.jit`` over the jnp kernel body, not Pallas; here it is
the port's general-rung body (``engine/kernels.py``), PyTorch ops on the
same device:

1. ``resolve_matches`` and ``StarTree.select_records`` pick the records
   on the host (the walk).
2. The record indices pad to a power-of-two capacity and go to the device
   as one int32 tensor; the kernel gathers each staged node column
   (``StagedSegment.startree_nodes``) at them with ``index_select`` and
   runs the body over the gathered block with the filter ``("true",)``:
   the dense, hash or sort grouping, the packed outputs, one copy to the
   host. Padding slots gather record 0 and the body's ``doc < num_docs``
   mask drops them; their keys (record 0 may hold STAR, -1, in a grouped
   dimension, a negative key) never reach a scatter: the dense rung parks
   masked docs in its overflow slots, the hash rung reads only masked
   docs, the sort rung clamps its lookup.
3. The decode makes the query's aggregations again from the rewritten
   leaves (``StarTreePlan.agg_map``: COUNT is the sum of the count column,
   AVG a sum and a count).

A node plan over ``MAX_DEVICE_GROUPS`` keys, or a decode past the compact
cap, raises PlanError and the host walker serves. A selection of no
records launches nothing. Float sums are added in no fixed order on the
card, so they agree with the walker's numpy sums within rel 1e-5, not bit
for bit; counts, min / max and keys are exact.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.engine import kernels
from pinot_tpu_torch.engine.aggregates import AggDef
from pinot_tpu_torch.engine.fused_scan import KernelCounter
from pinot_tpu_torch.engine.plan import StarTreePlan, plan_star_tree
from pinot_tpu_torch.engine.results import AggResult, GroupByResult, QueryStats
from pinot_tpu_torch.query.context import QueryContext

POS_INF = float("inf")
NEG_INF = float("-inf")

# node-slice calls of the star-tree rung, on any device (PyTorch ops, as
# the general rung's RUNG_COUNTER)
STARTREE_COUNTER = KernelCounter("startree_node_slice")


def build_startree_kernel(spec: Tuple) -> Callable:
    """``fn(cols, idx, params, n) -> packed f64 tensor``: each staged node
    column gathered at ``idx`` (padded record indices), then the body over
    the block's first ``n`` rows (JAX ``build_startree_kernel`` :45). Each
    call counts one on ``STARTREE_COUNTER``."""
    body = kernels.build_kernel_body(spec, sparse_k=kernels.sparse_mode(spec))

    def kernel(cols, idx: torch.Tensor, params, n: int) -> torch.Tensor:
        gathered = {name: {k: v.index_select(0, idx)
                           for k, v in tree.items()}
                    for name, tree in cols.items()}
        device = kernels._check_device(gathered, params, idx.device)
        STARTREE_COUNTER.add()
        return kernels.pack_outputs(body(gathered, params, n, 0, device),
                                    spec)

    return kernel


def _empty_states(aggs: List[AggDef]) -> List[Any]:
    """The scalar states of no record, as the scan rungs give them."""
    return [{"count": 0, "sum": 0.0, "min": POS_INF, "max": NEG_INF,
             "avg": (0.0, 0)}[agg.base] for agg in aggs]


def _leaf_states(base: str, leaves: List[np.ndarray], gidx) -> List[Any]:
    """One aggregation's states per live group from its leaves."""
    if base == "count":
        return [int(v) for v in np.asarray(leaves[0])[gidx]]
    if base in ("sum", "min", "max"):
        return [float(v) for v in np.asarray(leaves[0])[gidx]]
    if base == "avg":
        s = np.asarray(leaves[0])[gidx]
        c = np.asarray(leaves[1])[gidx]
        return [(float(a), int(b)) for a, b in zip(s, c)]
    raise AssertionError(base)


def _decode_grouped(plan: StarTreePlan, segment,
                    out: Dict[str, Any]) -> GroupByResult:
    """Live groups -> keys of dictionary values, with the plan's strides
    and bases."""
    presence = np.asarray(out["presence"])
    gidx = np.nonzero(presence)[0]
    result = GroupByResult()
    if gidx.size == 0:
        return result
    strides = plan.group_strides.astype(np.int64)
    key_cols: List[List[Any]] = []
    for i, col in enumerate(plan.group_cols):
        dids = (gidx // strides[i]) % plan.group_cards[i]
        d = segment.data_source(col).dictionary
        key_cols.append(d.get_values(dids + plan.group_bases[i]))
    keys = list(zip(*key_cols))
    states_per_agg = [
        _leaf_states(base, [out[f"agg{j}"] for j in leaf_idx], gidx)
        for base, leaf_idx in plan.agg_map]
    for gi, key in enumerate(keys):
        result.groups[key] = [states_per_agg[ai][gi]
                              for ai in range(len(plan.agg_map))]
    return result


def _decode_scalar(plan: StarTreePlan, out: Dict[str, Any]) -> AggResult:
    states: List[Any] = []
    for base, leaf_idx in plan.agg_map:
        leaves = [out[f"agg{j}"] for j in leaf_idx]
        if base == "count":
            states.append(int(leaves[0]))
        elif base in ("sum", "min", "max"):
            states.append(float(leaves[0]))
        else:  # avg
            states.append((float(leaves[0]), int(leaves[1])))
    return AggResult(states)


def node_slice_inputs(executor, plan: StarTreePlan, segment,
                      tree_index: int, idx: np.ndarray,
                      stats: Optional[QueryStats] = None):
    """-> (node columns, padded indices, params), all on the executor's
    device: the kernel's inputs for the selected records ``idx``, the
    node columns staged through ``stats``'s lease."""
    return _node_inputs(executor.stage(segment, stats), plan, tree_index,
                        idx)


def _node_inputs(staged, plan: StarTreePlan, tree_index: int,
                 idx: np.ndarray):
    nodes = staged.startree_nodes(tree_index)
    cols = {key: {"fwd": nodes[key]} for key in plan.columns}
    padded = np.zeros(plan.spec[-1], dtype=np.int32)
    padded[:idx.shape[0]] = idx
    idx_dev = torch.from_numpy(padded).to(staged.device)
    return cols, idx_dev, kernels.device_params(plan, staged.device)


def execute_star_tree_device(executor, ctx: QueryContext,
                             aggs: List[AggDef], segment, tree,
                             matches: Dict[str, Any], stats: QueryStats,
                             tree_index: int) -> Any:
    """-> AggResult / GroupByResult from the tree's node columns on the
    executor's device, or raises PlanError (the host walker serves): the
    walk, the node plan, one call and one copy to the host (none for an
    empty selection), the decode."""
    group_cols = [e.name for e in ctx.group_by]
    idx = tree.select_records(matches, group_cols)
    n = int(idx.shape[0])
    plan = plan_star_tree(ctx, segment, tree, matches, n)
    if n == 0:
        # nothing selected: no launch, the scan rungs' empty shapes
        stats.num_segments_processed += 1
        stats.total_docs += segment.num_docs
        if ctx.is_group_by:
            return GroupByResult()
        return AggResult(_empty_states(aggs))
    # the segment's resident is pinned by the query's lease, so its node
    # arrays stay for the call
    staged = executor.stage(segment, stats)

    def launch():
        cols, idx_dev, params = _node_inputs(staged, plan, tree_index, idx)
        kernel = executor.kernels.get(plan.spec, build_startree_kernel)
        packed = kernel(cols, idx_dev, params, n)
        return kernels.unpack_outputs(packed.cpu().numpy(), plan.spec)

    # concurrent identical queries (the same compiled ctx over the same
    # staged tree) share one node-slice call and copy (JAX :170-196)
    out, _ = executor.kernel_flight.do(
        ("startree", id(ctx), segment.segment_name, tree_index, id(staged)),
        launch)
    stats.num_segments_processed += 1
    stats.total_docs += segment.num_docs
    stats.num_docs_scanned += n
    stats.num_segments_matched += 1
    if not ctx.is_group_by:
        return _decode_scalar(plan, out)
    return _decode_grouped(plan, segment, out)
