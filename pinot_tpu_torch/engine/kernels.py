"""The general device rung: spec -> a function of tensors per plan.

Counterpart of ``pinot_tpu/engine/kernels.py``: the jnp body the JAX
package jits per spec and serves every plan its fused Pallas scan declines
with. Here the body is eager PyTorch ops on tensors of one device, one
function per spec (``KernelCache``); it is the port's counterpart of jnp
under ``jax.jit``, so it has no plain version apart from itself and runs
the same ops on the CPU and on the card.

- filter tree  -> boolean doc mask (dictId compares, LUT gathers; ANY of
                  a multi-value row's dictIds; raw value compares and
                  ``isin``; null bitmaps; the upsert valid-doc snapshot)
- projection   -> dictId gathers (``dictvals[fwd]``), raw values as staged
- aggregation  -> masked reductions; group-by through composed keys and one
                  ``index_add_`` / ``scatter_reduce_`` per leaf (the JAX
                  package stacks same-typed leaves into one scatter on the
                  TPU; a CUDA scatter gains nothing from that)

Group-by takes one rung of a cardinality ladder, as in the JAX package:
dense scatters up to ``SPARSE_MIN_GROUPS`` composed keys (output gathered
to its live groups past ``COMPACT_MIN_GROUPS``); past it, an
open-addressing hash table over the live docs, with the sort rung where the
table overflows (``_emit_grouped_rung``). The hash, its table, probes,
claims and the overflow decision are the JAX package's, so the rung that
serves is the same on every input.

Host syncs: the only one is the overflow flag of the ``cond`` mode (read
once per segment, then one branch runs, where ``lax.cond`` hides it);
``nonzero(size=K)`` becomes a cumsum and a scatter into ``K + 1`` slots.
Sums accumulate in the widened dtype (i64 or f64), so float sums agree with
the JAX package's f32 accumulation within rel 1e-5, not bit for bit. The
docs outside the filter scatter into ``OVERFLOW_SLOTS`` dropped slots
where the JAX body uses one: the leaves are the same.

The outputs of a segment call are packed into one f64 tensor
(``pack_outputs``) and copied to the host once (``unpack_outputs``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from pinot_tpu_torch.engine.errors import PlanError
from pinot_tpu_torch.engine.fused_scan import KernelCounter, _ParamCursor
from pinot_tpu_torch.engine.staging import from_host

POS_INF = float("inf")
NEG_INF = float("-inf")

# accumulator dtypes, chosen per aggregation at plan time
# (plan._acc_dtype); results widen to i64/f64
_ACC = {"i32": torch.int32, "i64": torch.int64,
        "f32": torch.float32, "f64": torch.float64}

# segment calls of the general rung, on any device (the rung is PyTorch
# ops: it has no plain version apart from itself)
RUNG_COUNTER = KernelCounter("general_rung", "general_launches")


def _acc_info(acc: str):
    """(dtype, widened dtype, min-neutral, max-neutral) for an acc tag."""
    dt = _ACC[acc]
    if acc in ("i32", "i64"):
        info = torch.iinfo(dt)
        return dt, torch.int64, info.max, info.min
    return dt, torch.float64, POS_INF, NEG_INF


# per-column arrays with a leading capacity dimension (gathered down to a
# live window); the others (dictvals) are shared
_CAPACITY_KEYS = ("fwd", "null", "mv", "mvcount")


class _Cols:
    """One call's columns (``{name: StagedColumn.tree()}``): each array,
    the int64 copy of dictIds (``fwd`` and ``mv``, the index dtype of
    gathers and scatters) made at most once per column per call, and the
    dictionary values. ``live(pos)`` views the same columns through a
    window of doc positions."""

    def __init__(self, tree: Dict[str, Dict[str, torch.Tensor]],
                 pos: torch.Tensor = None):
        self.tree = tree
        self.pos = pos
        self._got: Dict[Tuple[str, str], torch.Tensor] = {}

    def get(self, name: str, key: str) -> torch.Tensor:
        t = self._got.get((name, key))
        if t is None:
            t = self.tree[name][key]
            if self.pos is not None and key in _CAPACITY_KEYS:
                t = t.index_select(0, self.pos)
            self._got[(name, key)] = t
        return t

    def fwd(self, name: str) -> torch.Tensor:
        return self.get(name, "fwd")

    def idx(self, name: str, key: str = "fwd") -> torch.Tensor:
        t = self._got.get((name, key + "#long"))
        if t is None:
            t = self.get(name, key).long()
            self._got[(name, key + "#long")] = t
        return t

    def dictvals(self, name: str) -> torch.Tensor:
        return self.tree[name]["dictvals"]

    def entries(self, name: str) -> torch.Tensor:
        """[rows, max_mv] bool: the entries of each MV row that exist."""
        mv, cnt = self.get(name, "mv"), self.get(name, "mvcount")
        return (torch.arange(mv.shape[1], device=mv.device)[None, :]
                < cnt[:, None])

    def live(self, pos: torch.Tensor) -> "_Cols":
        return _Cols(self.tree, pos)


# --------------------------------------------------------------------------
# filter mask and value expressions
# --------------------------------------------------------------------------

def _emit_filter(spec: Tuple, cols: _Cols, pc: _ParamCursor, capacity: int,
                 device: torch.device) -> torch.Tensor:
    op = spec[0]
    if op == "true":
        return torch.ones(capacity, dtype=torch.bool, device=device)
    if op == "false":
        return torch.zeros(capacity, dtype=torch.bool, device=device)
    if op == "validdocs":
        # the upsert valid-doc snapshot [capacity] (the executor fills the
        # planner's placeholder)
        return pc.take()
    if op in ("and", "or"):
        m = _emit_filter(spec[1][0], cols, pc, capacity, device)
        for s in spec[1][1:]:
            x = _emit_filter(s, cols, pc, capacity, device)
            m = (m & x) if op == "and" else (m | x)
        return m
    if op == "not":
        return ~_emit_filter(spec[1][0], cols, pc, capacity, device)
    col = spec[1]
    # dictionary SV (eq/neq/range/lut) and raw values (veq/vneq/vrange/vin/
    # vnotin) compare ``fwd``: dictIds or values in their staged dtype
    if op in ("eq", "veq"):
        return cols.fwd(col) == pc.take()
    if op in ("neq", "vneq"):
        return cols.fwd(col) != pc.take()
    if op == "range":
        iv = pc.take()
        fwd = cols.fwd(col)
        return (fwd >= iv[0]) & (fwd <= iv[1])
    if op == "lut":
        return pc.take().index_select(0, cols.idx(col))
    if op.startswith("mv_"):
        # ANY of the row's values matches (entries past its count do not)
        mv = cols.get(col, "mv")
        sub = op[3:]
        if sub == "eq":
            hit = mv == pc.take()
        elif sub == "neq":
            hit = mv != pc.take()
        elif sub == "range":
            iv = pc.take()
            hit = (mv >= iv[0]) & (mv <= iv[1])
        else:  # lut
            ids = cols.idx(col, "mv")
            hit = pc.take().index_select(0, ids.reshape(-1)).view(ids.shape)
        return (hit & cols.entries(col)).any(dim=1)
    if op == "vrange":
        lo, hi = pc.take(), pc.take()
        fwd = cols.fwd(col)
        m = (fwd >= lo) if spec[2] else (fwd > lo)
        return m & ((fwd <= hi) if spec[3] else (fwd < hi))
    if op in ("vin", "vnotin"):
        # the JAX body's [capacity, n] compare, without the intermediate
        return torch.isin(cols.fwd(col), pc.take(),
                          invert=op == "vnotin")
    if op == "isnull":
        return cols.get(col, "null")
    if op == "isnotnull":
        return ~cols.get(col, "null")
    raise AssertionError(f"unknown filter op {op!r}")


def _emit_value(vspec: Tuple, cols: _Cols, pc: _ParamCursor,
                compute_dt: torch.dtype) -> torch.Tensor:
    op = vspec[0]
    if op == "lit":
        return pc.take()
    if op == "col":
        _, name, has_dict = vspec
        if has_dict:
            return cols.dictvals(name).index_select(0, cols.idx(name))
        return cols.fwd(name)
    if op == "fn":
        _, name, args = vspec
        a, b = (_emit_value(x, cols, pc, compute_dt).to(compute_dt)
                for x in args)
        if name == "plus":
            return a + b
        if name == "minus":
            return a - b
        if name == "times":
            return a * b
        if name == "divide":
            return a / b
        if name == "mod":
            return torch.remainder(a, b)
        if name == "floordiv":
            return torch.div(a, b, rounding_mode="floor")
    raise AssertionError(f"unknown value op {vspec!r}")


def _masked_values(aspec, cols: _Cols, pc: _ParamCursor):
    """MV values are read in the MV branch (dense mv + counts), not here."""
    base, mv, vspec, acc = aspec[0], aspec[1], aspec[2], aspec[3]
    dt, wide, min_n, max_n = _acc_info(acc)
    vals = (None if vspec is None or mv
            else _emit_value(vspec, cols, pc, dt).to(dt))
    return base, vals, dt, wide, min_n, max_n


# --------------------------------------------------------------------------
# the body
# --------------------------------------------------------------------------

def build_kernel_body(spec: Tuple, capacity_override: int = 0,
                      sparse_k: int = 0, sparse_rung: str = "cond"):
    """spec = (filter_spec, agg_specs, group_specs, num_groups, capacity)
    -> fn(cols, params, num_docs, doc_offset, device) -> dict of tensors.

    ``cols`` maps each column to its ``StagedColumn.tree()``, ``params``
    are the plan's params on the columns' device (``device_params``).
    ``doc_offset`` is the global doc index of local row 0 and
    ``capacity_override`` the local capacity, for a doc range of a
    segment. ``sparse_k`` > 0 groups over K compact slots;
    ``sparse_rung`` picks how:

    - "cond": the hash rung, or the sort rung where the hash table
      overflows (the overflow flag is read on the host, once);
    - "hash": the hash rung only; the ``"rung"`` output flags an overflow,
      whose leaves the caller discards for the sort rung's;
    - "sort": the sort rung only.
    """
    filter_spec, agg_specs, group_specs, num_groups, capacity = spec
    if capacity_override:
        capacity = capacity_override

    def kernel(cols, params, num_docs: int, doc_offset: int = 0,
               device: torch.device = None):
        device = _check_device(cols, params, device)
        cols = _Cols(cols)
        pc = _ParamCursor(params)
        # not in place: a lone isnull leaf returns the staged bitmap itself
        mask = _emit_filter(filter_spec, cols, pc, capacity, device) & (
            (torch.arange(capacity, device=device) + doc_offset) < num_docs)

        if not group_specs:
            out: Dict[str, Any] = {"num_matched": mask.sum()}
            for i, aspec in enumerate(agg_specs):
                out[f"agg{i}"] = _emit_scalar_agg(aspec, cols, pc, mask)
            pc.finish()
            return out

        strides = pc.take()           # [g] int32
        bases = pc.take()             # [g] int64: keys subtract them
        keys = torch.zeros(capacity, dtype=torch.int32, device=device)
        for gi, (strat, payload) in enumerate(group_specs):
            if strat == "gdict":
                k = cols.fwd(payload) - bases[gi].to(torch.int32)
            elif strat == "graw":   # value-space key: value - the column min
                k = (cols.fwd(payload) - bases[gi]).to(torch.int32)
            else:  # gexpr: bounded integral expression, key = value - lo
                v = _emit_value(payload, cols, pc, torch.int64)
                k = (v - bases[gi]).to(torch.int32)
            keys += k * strides[gi]
        if sparse_k:
            return _emit_grouped_rung(agg_specs, cols, pc, mask, keys,
                                      num_groups, sparse_k, capacity,
                                      sparse_rung)
        # keys a correct plan cannot produce park in the overflow bucket
        # with the docs outside the mask (the JAX scatter drops them)
        seg_ids = torch.where(mask & (keys >= 0) & (keys < num_groups),
                              keys, num_groups).long()
        out = _emit_grouped_all(agg_specs, cols, pc, mask, seg_ids,
                                num_groups)
        pc.finish()
        return out

    return kernel


def _first_true(flags: torch.Tensor, K: int, fill: int = 0) -> torch.Tensor:
    """int64 [K]: positions of the first K set flags, ascending, ``fill``
    past them (``jnp.nonzero(size=K, fill_value=fill)`` without a host
    sync: a cumsum, then a scatter into K + 1 slots whose last is
    discarded)."""
    r = torch.cumsum(flags, 0) - 1
    tgt = torch.where(flags & (r < K), r, K)
    out = torch.full((K + 1,), fill, dtype=torch.int64, device=flags.device)
    out.scatter_(0, tgt, torch.arange(flags.shape[0], device=flags.device))
    return out[:K]


# composed keys never reach this value (MAX_DEVICE_GROUPS < 2^31)
_SENTINEL_KEY = (1 << 31) - 1


def compact_from_sorted(sk: torch.Tensor, K: int):
    """Compaction core of the sort rung: ``sk`` = ascending int32 keys with
    _SENTINEL_KEY fill. -> (first, n_live, uniq): first-occurrence flags
    over sk, the live distinct-key count, and the first K live keys
    (SENT-filled past n_live)."""
    valid = sk != _SENTINEL_KEY
    first = valid.clone()
    first[1:] &= sk[1:] != sk[:-1]
    n_live = first.sum()
    pos = _first_true(first, K, fill=sk.shape[0] - 1)
    live = (torch.arange(K, device=sk.device)
            < torch.clamp(n_live, max=K))
    uniq = torch.where(live, sk[pos], _SENTINEL_KEY)
    return first, n_live, uniq


def _emit_grouped_sparse(agg_specs, cols, pc, mask, keys, num_groups, K):
    """The sort rung for large composed key spaces: sort the masked keys,
    compact the live groups into K slots, scatter over [K + 1]. The output
    is already compact ("ck" = sorted live keys, "compact_n" = live count);
    more than K live groups report compact_n > K, which the decode refuses
    (``unpack_outputs``) rather than truncate."""
    device = keys.device
    mk = torch.where(mask, keys, _SENTINEL_KEY)
    sk, _ = torch.sort(mk)
    _first, n_live, uniq = compact_from_sorted(sk, K)
    live = uniq != _SENTINEL_KEY
    # doc -> slot through a dense key-space LUT, one gather per doc; fill
    # slots park at the LUT's overflow cell
    lut = torch.full((num_groups + 1,), K, dtype=torch.int64, device=device)
    park = torch.where(live, uniq, num_groups).long()
    lut.scatter_(0, park, torch.where(
        live, torch.arange(K, device=device), K))
    rank = lut.index_select(0, torch.clamp(keys, 0, num_groups - 1).long())
    seg_ids = torch.where(mask, rank, K)
    out = _emit_grouped_all(agg_specs, cols, pc, mask, seg_ids, K)
    out["ck"] = uniq
    out["compact_n"] = n_live
    return out


# --------------------------------------------------------------------------
# hash-aggregation rung: between the dense scatter and the sort rung, for a
# huge key space with few live rows (SSB Q3.2/Q4.3): the live docs are
# compacted to a window and their keys placed in an open-addressing table
# by scatter-min, so the cost scales with live rows. Too many live docs, a
# key left unplaced, or more live groups than K is an overflow, and the
# sort rung serves.
# --------------------------------------------------------------------------

# open-addressing table: 2^15 slots, 4x the compact output K
_HASH_BITS = 15
HASH_TABLE_SLOTS = 1 << _HASH_BITS
# linear-probe passes; each is one scatter-min and one gather over the
# live window
HASH_PROBES = 4
# live-doc window: more matched docs than this -> sort rung
HASH_LIVE_DOCS = 1 << 16
# Knuth multiplicative hash (2^32 / phi)
_HASH_MULT = 2654435761


def _compact_positions(mask: torch.Tensor, L: int):
    """(pos, n): int64 positions of the first L masked docs, ascending,
    and the masked count (a 0-d tensor)."""
    return _first_true(mask, L), mask.sum()


def _hash_slots(mk: torch.Tensor) -> torch.Tensor:
    """The JAX package's slot of each int32 key, bit for bit: the top
    ``_HASH_BITS`` of ``uint32(key) * _HASH_MULT mod 2^32``. The product
    is taken in int64 in 16-bit halves of the multiplier, so no partial
    product leaves int64 (CUDA has no uint32 multiply in PyTorch)."""
    k = mk.long() & 0xFFFFFFFF
    lo, hi = _HASH_MULT & 0xFFFF, _HASH_MULT >> 16
    prod = (k * lo + (((k * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return prod >> (32 - _HASH_BITS)


def _hash_probe(mask, keys, K, capacity):
    """Place the masked composed keys into the open-addressing table.

    -> (overflow, pos, mask_live, seg_ids, ck, n_live): ``pos`` indexes the
    live-doc window, ``seg_ids`` [L] maps each live doc to its compact slot
    (K = parked), ``ck`` the K live keys in slot order (SENT-filled),
    ``n_live`` the live group count, ``overflow`` a 0-d bool: the sort rung
    must serve instead."""
    device = keys.device
    SENT = _SENTINEL_KEY
    H = HASH_TABLE_SLOTS
    L = min(capacity, HASH_LIVE_DOCS)

    pos, n_docs = _compact_positions(mask, L)
    mask_live = torch.arange(L, device=device) < torch.clamp(n_docs, max=L)
    mk = torch.where(mask_live, keys.index_select(0, pos), SENT)

    slot = torch.where(mask_live, _hash_slots(mk), H)   # fill docs park at H
    placed = ~mask_live
    table = torch.full((H + 1,), SENT, dtype=torch.int32, device=device)
    for p in range(HASH_PROBES):
        if p:
            slot = torch.where(placed, slot, (slot + 1) & (H - 1))
        put = torch.where(placed, H, slot)
        # scatter-min claims a slot for the smallest competing key; docs
        # whose key won (or was there) are placed, the rest probe on
        table.scatter_reduce_(0, put, torch.where(placed, SENT, mk), "amin")
        placed = placed | (table.index_select(0, put) == mk)
    # a later pass can steal a claimed slot (lower it with a smaller key
    # after its claimant stopped probing): re-validate every claim against
    # the final table; a stolen claim is an overflow
    placed = placed & (table.index_select(
        0, torch.where(mask_live, slot, H)) == mk)

    live_tab = table[:H] != SENT
    n_live = live_tab.sum()
    overflow = (n_docs > L) | (mask_live & ~placed).any() | (n_live > K)

    # slot -> compact rank; park slot H -> K
    rk = torch.cumsum(live_tab, 0) - 1
    rank = torch.where(live_tab, torch.clamp(rk, max=K), K)
    rank_ext = torch.cat([rank, rank.new_full((1,), K)])
    seg_ids = torch.where(placed & mask_live, rank_ext.index_select(0, slot),
                          K)
    # the first K live slots' keys, in slot order (the decode is
    # order-agnostic)
    spos = _first_true(live_tab, K)
    livek = torch.arange(K, device=device) < torch.clamp(n_live, max=K)
    ck = torch.where(livek, table.index_select(0, spos), SENT)
    return overflow, pos, mask_live, seg_ids, ck, n_live


def _hash_finish(agg_specs, cols: _Cols, pc, probe, K):
    """Aggregate over the live-doc window: each column's dictIds are
    gathered down to [L] first, so the scatters scale with live rows."""
    _, pos, mask_live, seg_ids, ck, n_live = probe
    out = _emit_grouped_all(agg_specs, cols.live(pos), pc, mask_live,
                            seg_ids, K)
    out["ck"] = ck
    out["compact_n"] = n_live
    return out


def _emit_grouped_rung(agg_specs, cols, pc, mask, keys, num_groups, K,
                       capacity, rung):
    """Sparse grouping (see build_kernel_body for the modes). The
    ``"rung"`` output is 0 when the hash table served, 1 when the sort
    rung ran (or, in "hash" mode, must run)."""
    one = torch.ones((), dtype=torch.int32, device=keys.device)
    if rung == "sort":
        out = _emit_grouped_sparse(agg_specs, cols, pc, mask, keys,
                                   num_groups, K)
        pc.finish()
        out["rung"] = one
        return out
    probe = _hash_probe(mask, keys, K, capacity)
    overflow = probe[0]
    if rung == "hash":
        out = _hash_finish(agg_specs, cols, pc, probe, K)
        pc.finish()
        out["rung"] = overflow.to(torch.int32)
        return out
    # "cond": the one host sync of the body, then only one branch runs
    if bool(overflow):
        out = _emit_grouped_sparse(agg_specs, cols, pc, mask, keys,
                                   num_groups, K)
        out["rung"] = one
    else:
        out = _hash_finish(agg_specs, cols, pc, probe, K)
        out["rung"] = one - 1
    pc.finish()
    return out


# overflow slots of a grouped scatter: the docs outside the mask spread
# over this many addresses (by doc position), where the JAX body sends them
# all to one; on the card, millions of atomics into one address serialize
OVERFLOW_SLOTS = 1024


def _emit_grouped_all(agg_specs, cols: _Cols, pc, mask, seg_ids,
                      num_groups):
    """Every grouped aggregation, one scatter per leaf over ``num_groups``
    slots plus the overflow slots, which are dropped. Every doc outside
    ``mask`` has its ``seg_ids`` entry at ``num_groups`` (the overflow), so
    values scatter unmasked."""
    device = seg_ids.device
    hll_ids = seg_ids
    spread = torch.arange(seg_ids.shape[0], device=device) & (
        OVERFLOW_SLOTS - 1)
    seg_ids = torch.where(seg_ids < num_groups, seg_ids, num_groups + spread)
    n = num_groups + OVERFLOW_SLOTS
    count = torch.zeros(n, dtype=torch.int64, device=device).index_add_(
        0, seg_ids, mask.long())[:num_groups]
    out: Dict[str, Any] = {"presence": count}

    def scatter(vals, dt, fill, how):
        acc = torch.full((n,), fill, dtype=dt, device=device)
        if how == "sum":
            acc.index_add_(0, seg_ids, vals.to(dt).expand(seg_ids.shape))
        else:
            acc.scatter_reduce_(0, seg_ids, vals.expand(seg_ids.shape), how)
        return acc[:num_groups]

    for i, aspec in enumerate(agg_specs):
        key = f"agg{i}"
        if aspec[0] == "distinctcounthll":
            # composed (group, bucket) id space, one overflow group (the
            # buckets spread it); registers start at 0, the JAX package's
            # clamp of untouched buckets
            m = 1 << aspec[2]
            idx = cols.idx(aspec[1])
            bucket = pc.take().index_select(0, idx)
            rank = pc.take().index_select(0, idx)
            ids = hll_ids * m + bucket
            regs = torch.zeros((num_groups + 1) * m, dtype=torch.int32,
                               device=device)
            regs.scatter_reduce_(0, ids, rank, "amax")
            out[key] = regs[:num_groups * m]
            continue
        base, vals, dt, wide, min_n, max_n = _masked_values(aspec, cols, pc)
        if base == "count":
            out[key] = count
        elif base == "sum":
            out[key] = scatter(vals, wide, 0, "sum")
        elif base == "min":
            out[key] = scatter(vals, dt, min_n, "amin").double()
        elif base == "max":
            out[key] = scatter(vals, dt, max_n, "amax").double()
        elif base == "avg":
            out[key] = (scatter(vals, wide, 0, "sum"), count)
        elif base == "minmaxrange":
            out[key] = (scatter(vals, dt, min_n, "amin").double(),
                        scatter(vals, dt, max_n, "amax").double())
        else:
            raise AssertionError(f"agg {base} has no device grouped kernel")
    return out


def _emit_scalar_agg(aspec, cols: _Cols, pc, mask):
    device = mask.device
    if aspec[0] == "distinctcount":
        _, colname, card = aspec
        presence = torch.zeros(card, dtype=torch.int32, device=device)
        # [card] 0/1; the host maps present dictIds to values
        return presence.scatter_reduce_(0, cols.idx(colname), mask.int(),
                                        "amax")
    if aspec[0] == "distinctcounthll":
        # register update: masked scatter-max over per-dictId (bucket, rank)
        # tables; registers start at 0 (untouched buckets stay 0)
        _, colname, log2m = aspec
        idx = cols.idx(colname)
        bucket = pc.take().index_select(0, idx)
        rank = pc.take().index_select(0, idx)
        regs = torch.zeros(1 << log2m, dtype=torch.int32, device=device)
        return regs.scatter_reduce_(0, bucket.long(),
                                    torch.where(mask, rank, 0), "amax")
    base, vals, dt, wide, min_n, max_n = _masked_values(aspec, cols, pc)
    if aspec[1]:
        return _emit_scalar_mv(base, aspec[2][1], cols, mask, dt, wide,
                               min_n, max_n)
    if base == "count":
        return mask.sum()
    any_match = mask.any()

    def lo():
        v = torch.where(mask, vals, min_n).min().double()
        return torch.where(any_match, v, POS_INF)

    def hi():
        v = torch.where(mask, vals, max_n).max().double()
        return torch.where(any_match, v, NEG_INF)

    if base == "sum":
        return torch.where(mask, vals, 0).sum(dtype=wide)
    if base == "min":
        return lo()
    if base == "max":
        return hi()
    if base == "avg":
        return torch.where(mask, vals, 0).sum(dtype=wide), mask.sum()
    if base == "minmaxrange":
        return lo(), hi()
    raise AssertionError(f"agg {base} has no device scalar kernel")


def _emit_scalar_mv(base: str, col: str, cols: _Cols, mask, dt, wide,
                    min_n, max_n):
    """countmv/summv/minmv/maxmv/avgmv over the entries of the matched
    rows (the JAX body's MV branch, :851-872)."""
    entry = cols.entries(col) & mask[:, None]
    if base == "count":
        return torch.where(mask, cols.get(col, "mvcount"), 0).sum(
            dtype=torch.int64)
    ids = cols.idx(col, "mv")
    fv = cols.dictvals(col).index_select(0, ids.reshape(-1)).view(
        ids.shape).to(dt)
    any_entry = entry.any()
    if base == "sum":
        return torch.where(entry, fv, 0).sum(dtype=wide)
    if base == "min":
        v = torch.where(entry, fv, min_n).min().double()
        return torch.where(any_entry, v, POS_INF)
    if base == "max":
        v = torch.where(entry, fv, max_n).max().double()
        return torch.where(any_entry, v, NEG_INF)
    if base == "avg":
        return torch.where(entry, fv, 0).sum(dtype=wide), entry.sum()
    raise AssertionError(f"MV agg {base} has no device kernel")


# --------------------------------------------------------------------------
# entry: spec -> one call per segment, its outputs in one f64 tensor
# --------------------------------------------------------------------------

def device_params(plan, device: torch.device) -> Tuple:
    """The plan's params as tensors on ``device``, uploaded once per plan
    and device: arrays keep their dtype, numpy scalars become 0-d
    tensors."""
    got = plan.device_params.get(device)
    if got is None:
        # None stays: the validdocs placeholder, filled per call
        got = tuple(None if p is None
                    else from_host(p).to(device)
                    for p in plan.params)
        plan.device_params[device] = got
    return got


def _check_device(cols, params, device=None) -> torch.device:
    """The one device every input lies on (``device`` when there is no
    input: a plan that reads no column and takes no param)."""
    devices = {t.device for tree in cols.values() for t in tree.values()}
    devices |= {p.device for p in params}
    if not devices and device is not None:
        return torch.device(device)
    if len(devices) != 1:
        raise ValueError(f"the general rung's inputs lie on {len(devices)} "
                         f"devices ({sorted(map(str, devices))}); it needs "
                         "one")
    return devices.pop()


def build_kernel(spec: Tuple) -> Callable:
    """One segment's entry: fn(cols, params, num_docs, device) -> packed
    f64 tensor (one device tensor, one copy to the host; see
    ``output_layout``). Each call counts one on ``RUNG_COUNTER``."""
    body = build_kernel_body(spec, sparse_k=sparse_mode(spec))

    def kernel(cols, params, num_docs: int,
               device: torch.device = None) -> torch.Tensor:
        device = _check_device(cols, params, device)
        RUNG_COUNTER.add()
        return pack_outputs(body(cols, params, num_docs, 0, device), spec)

    return kernel


class KernelCache:
    """spec -> the rung's function for that spec (the plan cache's
    kernels); ``build`` names another builder over the same specs (the
    star-tree rung's), cached apart from the general rung's."""

    def __init__(self):
        self._cache: Dict[Tuple, Callable] = {}

    def get(self, spec: Tuple, build: Callable = None) -> Callable:
        key = spec if build is None else (build.__name__, spec)
        k = self._cache.get(key)
        if k is None:
            k = (build or build_kernel)(spec)
            self._cache[key] = k
        return k

    def __len__(self) -> int:
        return len(self._cache)


# --------------------------------------------------------------------------
# packed output: every output leaf in one f64 vector (f64 keeps counts and
# int sums exact to 2^53). At COMPACT_MIN_GROUPS or more groups the grouped
# leaves are gathered to their live groups (compact layout), so the copy
# scales with the groups that exist; more than K live groups is refused at
# decode (PlanError), never truncated.
# --------------------------------------------------------------------------

COMPACT_MIN_GROUPS = 8192
COMPACT_K = 8192

# past this key-space size grouping leaves the dense scatter for the hash
# and sort rungs
SPARSE_MIN_GROUPS = 1 << 15


def sparse_mode(spec: Tuple) -> int:
    """0 = dense grouping; else the compact K of the sparse rungs (shared
    with compact_mode, so the packed layout is the same either way)."""
    _, agg_specs, group_specs, num_groups, _ = spec
    if not group_specs or num_groups < SPARSE_MIN_GROUPS:
        return 0
    if any(a[0] in ("distinctcount", "distinctcounthll") for a in agg_specs):
        return 0
    return min(COMPACT_K, num_groups)


def compact_mode(spec: Tuple) -> int:
    """0 = dense; else the compact K for this spec. distinctcount/HLL
    leaves carry their own [cardinality]/[G*m] shapes and stay dense."""
    _, agg_specs, group_specs, num_groups, _ = spec
    if not group_specs or num_groups < COMPACT_MIN_GROUPS:
        return 0
    if any(a[0] in ("distinctcount", "distinctcounthll") for a in agg_specs):
        return 0
    return min(COMPACT_K, num_groups)


def output_layout(spec: Tuple, num_seg: int = 0) -> List[Tuple[str, int]]:
    """[(key, size)] slices of the packed vector, in pack order. Key
    ``aggI.J`` is leaf J of a multi-leaf state (avg, minmaxrange).
    ``num_seg > 0`` appends per-segment matched counts. In compact mode,
    grouped leaves shrink to K gathered entries prefixed by the live-group
    count and their group indices."""
    _, agg_specs, group_specs, num_groups, _ = spec
    K = compact_mode(spec)
    if K:
        num_groups = K
    reducers = partial_reduce_ops(spec)
    entries: List[Tuple[str, int]] = []
    if K:
        entries.append(("compact_n", 1))
        entries.append(("compact_idx", K))
        entries.append(("presence", K))
    elif group_specs:
        entries.append(("presence", num_groups))
    else:
        entries.append(("num_matched", 1))
    for i, aspec in enumerate(agg_specs):
        if aspec[0] == "distinctcount":
            entries.append((f"agg{i}", aspec[2]))  # [cardinality] presence
            continue
        if aspec[0] == "distinctcounthll":
            entries.append((f"agg{i}", (num_groups or 1) * (1 << aspec[2])))
            continue
        nleaves = len(reducers[f"agg{i}"])
        size = num_groups if group_specs else 1
        if nleaves == 1:
            entries.append((f"agg{i}", size))
        else:
            entries.extend((f"agg{i}.{j}", size) for j in range(nleaves))
    if sparse_mode(spec):
        # which sparse rung served (0 = hash table, 1 = sort)
        entries.append(("rung", 1))
    if num_seg:
        entries.append(("seg_matched", num_seg))
    return entries


def pack_outputs(out: Dict[str, Any], spec: Tuple) -> torch.Tensor:
    """The output tree -> one f64 tensor on its device. Sparse trees
    (``"ck"`` present) arrive compact, their keys going out as compact_idx
    (a composed key is the dense group index); dense trees past the
    compact threshold are gathered to their live groups here."""
    num_seg = out["seg_matched"].shape[0] if "seg_matched" in out else 0
    K = compact_mode(spec)
    idx = gat = n = None
    if K:
        if "ck" in out:
            n, idx = out["compact_n"], out["ck"]
        else:
            live = out["presence"] > 0
            # fill 0 is safe: positions >= n are ignored by the decode
            gat = idx = _first_true(live, K)
            n = live.sum()
    parts = []
    for key, _ in output_layout(spec, num_seg):
        if key == "compact_n":
            leaf = n
        elif key == "compact_idx":
            leaf = idx
        elif "." in key:
            k, j = key.split(".")
            leaf = out[k][int(j)]
            if gat is not None:
                leaf = leaf.index_select(0, gat)
        else:
            leaf = out[key]
            if gat is not None and key != "seg_matched":
                leaf = leaf.index_select(0, gat)
        parts.append(leaf.to(torch.float64).reshape(-1))
    return torch.cat(parts)


def unpack_outputs(packed, spec: Tuple, num_seg: int = 0) -> Dict[str, Any]:
    """Packed f64 vector (host numpy) -> the output tree the decode reads:
    scalar leaves as numbers, vector leaves as arrays; compact leaves are
    scattered back into dense [num_groups] arrays."""
    packed = np.asarray(packed)
    grouped = bool(spec[2])
    num_groups = spec[3]
    K = compact_mode(spec)
    dc = {f"agg{i}" for i, a in enumerate(spec[1])
          if a[0] in ("distinctcount", "distinctcounthll")}
    out: Dict[str, Any] = {}
    multi: Dict[str, Dict[int, Any]] = {}
    off = 0
    n = 0
    idx = None

    def expand(leaf):
        if idx is None:
            return leaf
        dense = np.zeros(num_groups, dtype=leaf.dtype)
        dense[idx] = leaf[:n]
        return dense

    for key, size in output_layout(spec, num_seg):
        leaf = packed[off:off + size]
        off += size
        if key == "compact_n":
            n = int(leaf[0])
            if n > K:
                raise PlanError(
                    f"{n} live groups exceed the compact cap {K} "
                    f"-> host path serves the full result")
            continue
        if key == "compact_idx":
            idx = leaf[:n].astype(np.int64)
            continue
        if "." in key:
            k, j = key.split(".")
            multi.setdefault(k, {})[int(j)] = \
                expand(leaf) if grouped else leaf[0]
            continue
        if key == "num_matched":
            out[key] = leaf[0]
        elif key == "rung":
            out[key] = int(leaf[0])
        elif key == "seg_matched":
            out[key] = leaf
        elif grouped or key in dc:
            out[key] = expand(leaf)
        else:
            out[key] = leaf[0]
    for k, leaves in multi.items():
        out[k] = tuple(leaves[j] for j in sorted(leaves))
    return out


def partial_reduce_ops(spec: Tuple) -> Dict[str, Tuple[str, ...]]:
    """Per-output-leaf merge op ('sum'|'min'|'max') for combining partials
    across segments (the state algebra of the combine)."""
    _, agg_specs, group_specs, _, _ = spec
    ops: Dict[str, Tuple[str, ...]] = {}
    if group_specs:
        ops["presence"] = ("sum",)
    else:
        ops["num_matched"] = ("sum",)
    for i, aspec in enumerate(agg_specs):
        ops[f"agg{i}"] = {
            "count": ("sum",),
            "sum": ("sum",),
            "min": ("min",),
            "max": ("max",),
            "avg": ("sum", "sum"),
            "minmaxrange": ("min", "max"),
            "distinctcount": ("max",),
            "distinctcounthll": ("max",),  # register merge = max
        }[aspec[0]]
    return ops


def grouped_rung(spec: Tuple, out: Dict[str, Any]) -> str:
    """Which group-by rung served an unpacked output: 'dense' | 'compact'
    (dense scatter, compact copy) | 'hash' | 'sort'."""
    if sparse_mode(spec):
        return "sort" if out.get("rung") else "hash"
    return "compact" if compact_mode(spec) else "dense"
