"""Fused scan: bit-unpack -> filter -> group keys -> aggregate, in one pass.

Counterpart of ``pinot_tpu/engine/pallas_kernels.py``. The eligibility
rules (``extract_plan``), the group-range probe (``probe_plan_of``,
``decode_probe_ranges``, ``probe_narrowed_plan``) and the runner
(``scan_inputs``, ``run_segment``) follow the JAX package, with the same
decline reason codes. The TPU kernel (``build_kernel``, specialised per plan
by tracing) becomes one hand-written CUDA kernel (``csrc/fused_scan.cu``)
that serves every plan: the host compiles the plan into a small postfix
program (``compile_program``) which the kernel interprets once per thread
and tile, over a 16-doc mask. The host also marks the filter's packed columns
(``ScanProgram.early``: read for every doc; the others only for passing
docs) and lays out the kernel's shared memory (``scan_layout``).

Every input is laid out as a batch of S segments: packed columns
``[S, T, W]``, value columns ``[S, T * TILE]`` (decoded dictionary values,
or a raw column's values), ``num_docs`` an int64 ``[S]`` tensor; a plan
that reads no column passes ``tiles`` (T). One segment is the batch S = 1;
a ``SegmentBatch`` (``pinot_tpu_torch/parallel``) is scanned in one
launch.

Exactness on the card: integer sums accumulate in i64, float sums in f64,
min/max in f32, counts in i64. The JAX package reaches the same integer
results through 12-bit limbs and float sums through Neumaier f32 pairs,
which the TPU needs and this card does not.

``fused_scan`` and ``fused_scan_probe`` are a staged segment's wrappers
(``SEGMENT_KERNELS``; a batch has its own pair, each pair with its own
launch counters): CUDA tensors launch the kernel, CPU tensors run
``fused_scan_plain``, the same function in plain PyTorch. All outputs
are views of one buffer, so ``assemble_outputs`` brings them to the host in
one copy (the JAX package's ``pack_outputs``/``unpack_outputs``).

``counted_scan_many`` is one launch over Q programs of one layout
(``ScanProgram.layout_key``: they differ only in literal words) on the
same inputs, the kernel source's query-axis entry
(``fused_scan_many_kernel``): a block serves a group of up to ``QG``
programs (``query_group``), reading each tile and decoding each filter op
once for all of them, through a table of the group's masks a dictId
where that is cheaper (``lut_leaves``); ``scan_layout_many`` lays out its
shared memory. Its plain version is ``fused_scan_many_plain``, a loop of
``fused_scan_plain``.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.engine.errors import classify_decline
from pinot_tpu_torch.engine.results import launch_sink
from pinot_tpu_torch.engine.staging import TILE, StagedSegment, staged_int_dtype

# group-dimension padding of the JAX kernel's one-hot chunks
G_CHUNK = 128
# most (padded) groups the fused scan serves; larger key spaces go through
# the group-range probe first
MAX_SCAN_GROUPS = 8192
# 12-bit value limbs of the JAX kernel's exact int sums: the limb count is
# part of the plan the eligibility rules produce (this kernel sums in i64)
LIMB_BITS = 12
_F32_EXACT = 1 << 24
_I32_MAX = (1 << 31) - 1
# i64 sums must stay inside i64 for exact reassembly (common/bounds.py)
I64_FOLD_BOUND = 1 << 62
# LUT predicates: up to this many dictId runs become static OR-of-interval
# leaves; more ride one padded interval-set ("ivs") node up to the run cap
_MAX_LUT_RUNS = 8
DEFAULT_LUT_RUN_CAP = 64


class _Ineligible(Exception):
    pass


def _lut_runs(lut: np.ndarray, cap: int) -> Optional[List[Tuple[int, int]]]:
    """Boolean LUT -> inclusive dictId runs, or None past ``cap`` runs."""
    idx = np.nonzero(np.asarray(lut, dtype=bool))[0]
    if idx.size == 0:
        return []
    breaks = np.nonzero(np.diff(idx) > 1)[0]
    if breaks.size + 1 > cap:
        return None
    runs = []
    start = 0
    for b in list(breaks) + [idx.size - 1]:
        runs.append((int(idx[start]), int(idx[b])))
        start = b + 1
    return runs


def _limbs_for(max_abs: int) -> int:
    return max(1, -(-max(max_abs.bit_length(), 1) // LIMB_BITS))


@dataclass
class ScanPlan:
    """Staging-independent extraction of a SegmentPlan (the JAX package's
    ``PallasPlan``, field for field)."""

    packed_names: List[str]
    value_names: List[str]
    value_is_int: Tuple[bool, ...]
    filter_tree: Tuple
    n_slots: int
    group_idx: Tuple[int, ...]
    group_strides: Tuple[int, ...]
    group_key_offset: int
    num_groups_padded: int
    aggs: Tuple[Tuple[str, Optional[Tuple], Optional[int]], ...]
    static_params: np.ndarray             # [2 * n_slots] i32 interval bounds
    value_limbs: Tuple[int, ...] = ()


class _ParamCursor:
    """Walks the plan params in the order the planner wrote them."""

    def __init__(self, params):
        self.params = params
        self.i = 0

    def take(self):
        p = self.params[self.i]
        self.i += 1
        return p

    def finish(self):
        if self.i != len(self.params):
            raise AssertionError(
                f"param cursor finished at {self.i} of {len(self.params)} "
                "params: pack/unpack drift between the planner and the scan")


def extract_plan(plan, provider, on_decline=None,
                 lut_run_cap: int = DEFAULT_LUT_RUN_CAP,
                 unchecked_groups: bool = False) -> Optional[ScanPlan]:
    """SegmentPlan -> ScanPlan, or None when the fused scan does not cover
    the shape (``on_decline`` receives the reason code).
    ``unchecked_groups`` skips the group bound: the probe path extracts the
    full plan first and re-extracts against the narrowed plan."""

    def decline(reason: str) -> None:
        if on_decline is not None:
            on_decline(reason)

    filter_spec, agg_specs, group_specs, num_groups, _ = plan.spec
    if group_specs and num_groups > MAX_SCAN_GROUPS and not unchecked_groups:
        decline("pallas_too_many_groups")
        return None
    if any(a[0] in ("distinctcount", "distinctcounthll") for a in agg_specs):
        decline("pallas_distinct_agg")
        return None
    if provider.metadata.num_docs > _I32_MAX:
        decline("pallas_docs_over_i32")
        return None

    try:
        packed_names: List[str] = []

        def packed_idx(col: str) -> int:
            cm = provider.metadata.column(col)
            if not (cm.has_dictionary and cm.single_value):
                raise _Ineligible("unpackable column")
            if col not in packed_names:
                packed_names.append(col)
            return packed_names.index(col)

        pc = _ParamCursor(plan.params)
        intervals: List[Tuple[int, int]] = []

        def iv_leaf(col: str, lo: int, hi: int) -> Tuple:
            slot = len(intervals)
            intervals.append((lo, hi))
            return ("iv", packed_idx(col), slot)

        def walk(node) -> Tuple:
            op = node[0]
            if op == "true":
                return ("true",)
            if op in ("and", "or"):
                return (op, tuple(walk(c) for c in node[1]))
            if op == "not":
                return ("not", (walk(node[1][0]),))
            if op in ("eq", "neq"):
                did = int(pc.take())
                leaf = iv_leaf(node[1], did, did)
                return ("not", (leaf,)) if op == "neq" else leaf
            if op == "range":
                iv = np.asarray(pc.take())
                return iv_leaf(node[1], int(iv[0]), int(iv[1]))
            if op == "lut":
                lut = np.asarray(pc.take())
                runs = _lut_runs(lut, max(_MAX_LUT_RUNS, lut_run_cap))
                if runs is None:
                    raise _Ineligible("lut with too many runs")
                if not runs:
                    return ("not", (("true",),))
                if len(runs) <= _MAX_LUT_RUNS:
                    leaves = tuple(iv_leaf(node[1], lo, hi) for lo, hi in runs)
                    return leaves[0] if len(leaves) == 1 else ("or", leaves)
                pi = packed_idx(node[1])
                n_pad = 1 << (len(runs) - 1).bit_length()
                slot0 = len(intervals)
                intervals.extend(runs)
                intervals.extend([(1, 0)] * (n_pad - len(runs)))  # empty pads
                return ("ivs", pi, slot0, n_pad)
            raise _Ineligible(op)

        tree = walk(filter_spec)

        group_idx: List[int] = []
        strides: List[int] = []
        key_offset = 0
        if group_specs:
            for strat, col in group_specs:
                if strat != "gdict":
                    raise _Ineligible("raw group key")
                group_idx.append(packed_idx(col))
            strides = [int(s) for s in np.asarray(pc.take())]
            bases = [int(b) for b in np.asarray(pc.take())]
            key_offset = sum(b * s for b, s in zip(bases, strides))
            G = -(-num_groups // G_CHUNK) * G_CHUNK
        else:
            G = G_CHUNK  # single group at key 0

        value_names: List[str] = []
        value_is_int: List[bool] = []
        value_limbs: List[int] = []

        def leaf_idx(name: str):
            cm = provider.metadata.column(name)
            if not (cm.single_value and cm.data_type.is_numeric):
                raise _Ineligible("non-numeric/MV agg value column")
            is_int = cm.data_type.is_integral
            max_abs: Optional[int] = None
            limbs = 0
            if is_int:
                if cm.min_value is None or cm.max_value is None:
                    raise _Ineligible("no stats for int value bound")
                max_abs = max(abs(int(cm.min_value)), abs(int(cm.max_value)))
                if staged_int_dtype(cm) != np.dtype(np.int32):
                    if max_abs * max(1, provider.metadata.num_docs) \
                            >= I64_FOLD_BOUND:
                        raise _Ineligible("i64 sum bound over i64")
                    limbs = _limbs_for(max_abs)
            if name not in value_names:
                value_names.append(name)
                value_is_int.append(is_int)
                value_limbs.append(limbs)
            vi = value_names.index(name)
            return (("v64", vi) if limbs else ("v", vi)), is_int, max_abs

        def compile_vexpr(vspec):
            if vspec is None:
                raise _Ineligible("missing agg value")
            if vspec[0] == "col":
                return leaf_idx(vspec[1])
            if vspec[0] == "lit":
                v = float(np.asarray(pc.take()))
                if v.is_integer() and abs(v) <= _I32_MAX:
                    return ("litc", int(v)), True, abs(int(v))
                return ("litf", v), False, None
            if (vspec[0] == "fn" and vspec[1] in ("times", "plus", "minus")
                    and len(vspec[2]) == 2):
                le, li, lm = compile_vexpr(vspec[2][0])
                re_, ri, rm = compile_vexpr(vspec[2][1])
                if li and ri:
                    max_abs = lm * rm if vspec[1] == "times" else lm + rm
                    if max_abs > _I32_MAX:
                        raise _Ineligible("int expr bound exceeds i32")
                    return (vspec[1], le, re_), True, max_abs
                if _has_v64(le) or _has_v64(re_):
                    raise _Ineligible("i64 column in float expression")
                return (vspec[1], le, re_), False, None
            raise _Ineligible(f"agg value {vspec[0]!r}")

        aggs: List[Tuple[str, Optional[Tuple], Optional[int]]] = []
        for aspec in agg_specs:
            base, mv, vspec = aspec[0], aspec[1], aspec[2]
            if mv:
                raise _Ineligible("mv aggregation")
            if base == "count":
                aggs.append(("count", None, None))
                continue
            if base not in ("sum", "avg", "min", "max", "minmaxrange"):
                raise _Ineligible(base)
            vexpr, is_int, max_abs = compile_vexpr(vspec)
            if base in ("sum", "avg"):
                aggs.append((base, vexpr,
                             _limbs_for(max_abs) if is_int else None))
            else:
                # min/max rows are f32: ints past 2^24 would round
                if is_int and max_abs >= _F32_EXACT:
                    raise _Ineligible("int min/max not f32-exact")
                aggs.append((base, vexpr, None))
        pc.finish()
    except _Ineligible as e:
        reason = classify_decline(str(e))
        if not reason.startswith("pallas_"):
            reason = f"pallas_{reason}"
        decline(reason)
        return None

    params = np.asarray([v for lo, hi in intervals for v in (lo, hi)],
                        dtype=np.int32).reshape(-1)
    return ScanPlan(
        packed_names=packed_names, value_names=value_names,
        value_is_int=tuple(value_is_int), filter_tree=tree,
        n_slots=len(intervals), group_idx=tuple(group_idx),
        group_strides=tuple(strides), group_key_offset=key_offset,
        num_groups_padded=G, aggs=tuple(aggs), static_params=params,
        value_limbs=tuple(value_limbs))


def _has_v64(vexpr: Tuple) -> bool:
    if vexpr[0] == "v64":
        return True
    if vexpr[0] in ("v", "litc", "litf", "id"):
        return False
    return _has_v64(vexpr[1]) or _has_v64(vexpr[2])


# --------------------------------------------------------------------------
# group-range probe: the same scan with masked min/max of each group
# column's dictId, so the host can narrow large-but-sparse key spaces
# (SSB Q3.2/Q4.3) under MAX_SCAN_GROUPS before the real scan
# --------------------------------------------------------------------------

def probe_plan_of(pp: ScanPlan) -> ScanPlan:
    aggs: List[Tuple[str, Optional[Tuple], Optional[int]]] = []
    for gi in pp.group_idx:
        aggs.append(("min", ("id", gi), None))
        aggs.append(("max", ("id", gi), None))
    return ScanPlan(
        packed_names=list(pp.packed_names), value_names=[], value_is_int=(),
        filter_tree=pp.filter_tree, n_slots=pp.n_slots, group_idx=(),
        group_strides=(), group_key_offset=0, num_groups_padded=G_CHUNK,
        aggs=tuple(aggs), static_params=pp.static_params, value_limbs=())


def decode_probe_ranges(pp: ScanPlan, out_mm: np.ndarray,
                        n_cols: int) -> List[Tuple[int, int]]:
    """Probe output rows -> per-group-column inclusive observed dictId
    ranges; a column no matched row touched collapses to (0, 0)."""
    _, _, mm_row = _row_layout(pp.aggs)
    mm = np.asarray(out_mm)
    ranges: List[Tuple[int, int]] = []
    for i in range(n_cols):
        vexpr = pp.aggs[2 * i][1]
        lo = float(mm[mm_row[(vexpr, "min")], 0])
        hi = float(mm[mm_row[(vexpr, "max")], 0])
        if not (np.isfinite(lo) and np.isfinite(hi)) or lo > hi:
            ranges.append((0, 0))
        else:
            ranges.append((int(lo), int(hi)))
    return ranges


def probe_narrowed_plan(plan, provider, run_probe, decline
                        ) -> Optional[Tuple[ScanPlan, object]]:
    """Full unchecked extraction -> probe scan (``run_probe(probe_pp)``
    returns its min/max rows) -> narrowed plan -> re-extraction. Returns
    (ScanPlan, effective plan) or None with the reason on ``decline``."""
    from pinot_tpu_torch.engine.plan import narrow_plan_groups

    pp_full = extract_plan(plan, provider, on_decline=decline,
                           unchecked_groups=True)
    if pp_full is None:
        return None
    for card in plan.group_cards:
        if card >= _F32_EXACT:   # dictIds past 2^24 would round in f32
            decline("pallas_too_many_groups")
            return None
    probe_pp = probe_plan_of(pp_full)
    ranges = decode_probe_ranges(probe_pp, run_probe(probe_pp),
                                 len(plan.group_cards))
    eff = narrow_plan_groups(plan, ranges)
    if eff.num_groups > MAX_SCAN_GROUPS:
        decline("pallas_too_many_groups")
        return None
    pp = extract_plan(eff, provider, on_decline=decline)
    if pp is None:
        return None
    return pp, eff


class _DeferredDecline:
    """Holds extract declines so the probe path can retry on the group
    bound alone; ``flush`` forwards them when no retry happens."""

    def __init__(self, on_decline):
        self.on_decline = on_decline
        self.reasons: List[str] = []

    def __call__(self, reason: str) -> None:
        self.reasons.append(reason)

    @property
    def only_group_bound(self) -> bool:
        return self.reasons == ["pallas_too_many_groups"]

    def flush(self) -> None:
        if self.on_decline is not None:
            for r in self.reasons:
                self.on_decline(r)


# --------------------------------------------------------------------------
# plan -> scan program (the kernel's input; csrc/fused_scan.cu reads it)
# --------------------------------------------------------------------------

# filter ops, 4 ints each: (op, a, b, c)
F_TRUE, F_IV, F_IVS, F_AND, F_OR, F_NOT = range(6)
# value ops, 4 ints each: (op, a, b, is_float)
V_COL, V_ID, V_LITC, V_LITF, V_TIMES, V_PLUS, V_MINUS = range(7)
_V_BINARY = {"times": V_TIMES, "plus": V_PLUS, "minus": V_MINUS}
# accumulator rows, 3 ints each: (kind, expr, out row); the count row is
# implicit
R_ISUM, R_FSUM, R_MIN, R_MAX = 1, 2, 3, 4
# value column element types
T_F32, T_I32, T_I64 = 0, 1, 2
_TORCH_VTYPE = {torch.float32: T_F32, torch.int32: T_I32, torch.int64: T_I64}

# limits of the kernel's inputs (csrc/fused_scan.cu sizes its stacks from
# the program's depths)
MAX_COLS = 16
MAX_FILTER_STACK = 32
MAX_VALUE_STACK = 8
MAX_ROWS = 16
MAX_OPERANDS = 8
# packed widths (staging.pack_bits) and their log2, which the kernel takes
_LOG2 = {1: 0, 2: 1, 4: 2, 8: 3, 16: 4, 32: 5}


def _row_layout(aggs):
    """Output rows of a plan's aggregations, shared by every reader:
    int sums and float sums one row per distinct expression, min/max one
    row per (expression, kind). -> (isum_row, fsum_row, mm_row) maps."""
    isum_row: Dict[Tuple, int] = {}
    fsum_row: Dict[Tuple, int] = {}
    mm_row: Dict[Tuple[Tuple, str], int] = {}
    for base, vexpr, limbs in aggs:
        if base in ("sum", "avg"):
            rows = isum_row if limbs is not None else fsum_row
            rows.setdefault(vexpr, len(rows))
        elif base in ("min", "minmaxrange"):
            mm_row.setdefault((vexpr, "min"), len(mm_row))
        if base in ("max", "minmaxrange"):
            mm_row.setdefault((vexpr, "max"), len(mm_row))
    return isum_row, fsum_row, mm_row


@dataclass
class ScanProgram:
    """A ScanPlan compiled for the kernel: one int32 array in sections,
    plus the sizes the wrapper needs to allocate and check."""

    prog: np.ndarray
    bits: Tuple[int, ...]
    value_is_int: Tuple[bool, ...]
    filter_off: int
    filter_n: int
    vops_off: int
    expr_off: int
    n_exprs: int
    rows_off: int
    n_rows: int
    group_off: int
    n_group: int
    iv_off: int
    key_offset: int
    G: int                       # output groups (1 for a scalar scan)
    scalar: bool
    n_isum: int
    n_fsum: int
    n_mm: int
    rows: Tuple[Tuple[int, int, int], ...]
    probe: bool
    log2_bits: Tuple[int, ...]   # log2 of each packed column's width
    # packed columns an IV/IVS op reads ("early"): the kernel reads them for
    # every doc; the others (group keys, ID values) only for passing docs
    early: Tuple[int, ...]
    filter_depth: int            # deepest filter stack
    value_depth: int             # deepest value stack over the expressions
    # a passing doc's operands the kernel loads together, in order:
    # (True, packed column) for a group key or ID value, (False, value
    # column); at most MAX_OPERANDS, the rest are loaded where read
    operands: Tuple[Tuple[bool, int], ...]
    # the program uploaded to a device, kept so a cached program is
    # uploaded once (device -> tensor)
    _on: Dict[torch.device, torch.Tensor] = field(
        default_factory=dict, repr=False, compare=False)
    # the kernel's argv slots that depend only on the program and the
    # batch's shape ((device, S, T) ->)
    _argv: Dict[Tuple, np.ndarray] = field(
        default_factory=dict, repr=False, compare=False)

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = torch.from_numpy(self.prog).to(device)
            self._on[device] = t
        return t

    def layout_key(self) -> Tuple:
        """What two programs must share to run as one launch of the query
        axis: every size and offset the launch's argv takes, the group
        key offset, and the program's words with its literals (LITC / LITF
        operands, group strides, interval bounds) zeroed. Programs equal
        in it differ only in literal words."""
        words = self.prog.copy()
        for i in range(self.vops_off, self.expr_off, 4):
            if words[i] in (V_LITC, V_LITF):
                words[i + 1] = 0
        words[self.group_off + 1:self.iv_off:2] = 0
        words[self.iv_off:] = 0
        return (self.probe, self.G, self.scalar, self.key_offset,
                self.bits, self.value_is_int, self.filter_depth,
                self.value_depth, self.operands, self.rows, self.n_exprs,
                self.filter_n, self.n_group, self.n_isum, self.n_fsum,
                self.n_mm, words.tobytes())


def compile_program(pp: ScanPlan, bits: Tuple[int, ...],
                    probe: bool = False) -> ScanProgram:
    if len(bits) != len(pp.packed_names):
        raise ValueError("one bit width per packed column is required")
    if len(pp.packed_names) > MAX_COLS or len(pp.value_names) > MAX_COLS:
        raise ValueError(f"more than {MAX_COLS} packed or value columns")
    if any(b not in _LOG2 for b in bits):
        raise ValueError(f"packed widths must be one of {sorted(_LOG2)}")

    filt: List[Tuple[int, int, int, int]] = []
    depth = [0, 0]   # current, max

    def push(op):
        filt.append(op)
        if op[0] in (F_TRUE, F_IV, F_IVS):
            depth[0] += 1
        elif op[0] in (F_AND, F_OR):
            depth[0] -= 1
        depth[1] = max(depth[1], depth[0])

    def emit_filter(node):
        op = node[0]
        if op == "true":
            push((F_TRUE, 0, 0, 0))
        elif op in ("and", "or"):
            for k, c in enumerate(node[1]):
                emit_filter(c)
                if k:
                    push((F_AND if op == "and" else F_OR, 0, 0, 0))
        elif op == "not":
            emit_filter(node[1][0])
            push((F_NOT, 0, 0, 0))
        elif op == "ivs":
            push((F_IVS, node[1], node[2], node[3]))
        else:
            push((F_IV, node[1], node[2], 0))

    emit_filter(pp.filter_tree)
    if depth[1] > MAX_FILTER_STACK:
        raise ValueError("filter tree too deep for the scan kernel")

    vops: List[Tuple[int, int, int, int]] = []
    exprs: List[Tuple[int, int]] = []
    expr_index: Dict[Tuple, int] = {}

    def is_int(vexpr) -> bool:
        if vexpr[0] in ("v", "v64"):
            return pp.value_is_int[vexpr[1]]
        if vexpr[0] in ("id", "litc"):
            return True
        if vexpr[0] == "litf":
            return False
        return is_int(vexpr[1]) and is_int(vexpr[2])

    def emit_value(vexpr, d: int) -> int:
        op = vexpr[0]
        if op in ("v", "v64"):
            vops.append((V_COL, vexpr[1], 0, 0 if is_int(vexpr) else 1))
            return d + 1
        if op == "id":
            vops.append((V_ID, vexpr[1], 0, 0))
            return d + 1
        if op == "litc":
            vops.append((V_LITC, int(vexpr[1]), 0, 0))
            return d + 1
        if op == "litf":
            fbits = int(np.array([vexpr[1]], dtype=np.float32).view(np.int32)[0])
            vops.append((V_LITF, fbits, 0, 1))
            return d + 1
        d1 = emit_value(vexpr[1], d)
        d2 = emit_value(vexpr[2], d + 1)
        vops.append((_V_BINARY[op], 0, 0, 0 if is_int(vexpr) else 1))
        return max(d1, d2)

    value_depth = 0

    def expr_id(vexpr) -> int:
        nonlocal value_depth
        e = expr_index.get(vexpr)
        if e is None:
            start = len(vops)
            d = emit_value(vexpr, 0)
            if d > MAX_VALUE_STACK:
                raise ValueError("value expression too deep for the kernel")
            value_depth = max(value_depth, d)
            e = len(exprs)
            exprs.append((start, len(vops) - start))
            expr_index[vexpr] = e
        return e

    isum_row, fsum_row, mm_row = _row_layout(pp.aggs)
    rows: List[Tuple[int, int, int]] = []
    for vexpr, r in isum_row.items():
        rows.append((R_ISUM, expr_id(vexpr), r))
    for vexpr, r in fsum_row.items():
        rows.append((R_FSUM, expr_id(vexpr), r))
    for (vexpr, kind), r in mm_row.items():
        rows.append((R_MIN if kind == "min" else R_MAX, expr_id(vexpr), r))
    if len(rows) > MAX_ROWS:
        raise ValueError(f"more than {MAX_ROWS} accumulator rows")

    sections: List[np.ndarray] = []
    offsets = []
    for part in (filt, vops, exprs, rows,
                 list(zip(pp.group_idx, pp.group_strides)),
                 pp.static_params.reshape(-1).tolist()):
        offsets.append(sum(s.size for s in sections))
        sections.append(np.asarray(part, dtype=np.int64).reshape(-1))
    prog = np.concatenate(sections)
    if prog.size and (prog.max() > _I32_MAX or prog.min() < -_I32_MAX - 1):
        raise ValueError("scan program value outside int32")
    scalar = not pp.group_idx
    early = tuple(sorted({op[1] for op in filt if op[0] in (F_IV, F_IVS)}))
    operands: List[Tuple[bool, int]] = []
    for opnd in ([(True, g) for g in pp.group_idx]
                 + [(op[0] == V_ID, op[1]) for op in vops
                    if op[0] in (V_COL, V_ID)]):
        if opnd not in operands:
            operands.append(opnd)
    return ScanProgram(
        prog=prog.astype(np.int32), bits=tuple(bits),
        value_is_int=tuple(pp.value_is_int),
        filter_off=offsets[0], filter_n=len(filt), vops_off=offsets[1],
        expr_off=offsets[2], n_exprs=len(exprs), rows_off=offsets[3],
        n_rows=len(rows), group_off=offsets[4], n_group=len(pp.group_idx),
        iv_off=offsets[5], key_offset=int(pp.group_key_offset),
        G=1 if scalar else pp.num_groups_padded, scalar=scalar,
        n_isum=len(isum_row), n_fsum=len(fsum_row), n_mm=len(mm_row),
        rows=tuple(rows), probe=probe,
        log2_bits=tuple(_LOG2[b] for b in bits), early=early,
        filter_depth=depth[1], value_depth=value_depth,
        operands=tuple(operands[:MAX_OPERANDS]))


# --------------------------------------------------------------------------
# the wrapper, its launch counters and the plain version
# --------------------------------------------------------------------------

class KernelCounter:
    """Launches of one kernel, counted where the kernel is launched and
    nowhere else: into the process total ``launches`` (a run shows the
    main path went through the kernel) and, where the launching thread is
    bound to a query's ``QueryStats`` (``results.count_launches_into``),
    into that query's ``field``. Threads may launch concurrently, so
    ``add`` holds a lock."""

    def __init__(self, name: str, field: Optional[str] = None):
        self.name = name
        self.field = field
        self.launches = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.launches += 1
        sink = launch_sink()
        if sink is not None and self.field is not None:
            setattr(sink, self.field, getattr(sink, self.field) + 1)

    def reset(self) -> None:
        with self._lock:
            self.launches = 0


SCAN_COUNTER = KernelCounter("fused_scan", "scan_launches")
PROBE_COUNTER = KernelCounter("fused_scan_probe", "probe_launches")


@dataclass
class ScanOutputs:
    """The scan's outputs, each a view of ``buf``."""

    buf: torch.Tensor       # [n] i64: every output below, one after another
    layout: Tuple[int, int, int, int, int]   # (G, n_isum, n_fsum, n_mm, S)
    cnt: torch.Tensor       # [G] i64 matched docs per group
    isum: torch.Tensor      # [n_isum, G] i64
    fsum: torch.Tensor      # [n_fsum, G] f64
    matched: torch.Tensor   # [S] i64 docs passing the filter, per segment
    mm: torch.Tensor        # [n_mm, G] f32

    def to_host(self) -> "ScanOutputs":
        """The same outputs on the host, in one device-to-host copy."""
        return _carve(self.buf.cpu(), self.layout)


def _carve(buf: torch.Tensor, layout: Tuple[int, int, int, int, int]
           ) -> ScanOutputs:
    G, n_isum, n_fsum, n_mm, S = layout
    at = 0

    def take(n: int) -> torch.Tensor:
        nonlocal at
        at += n
        return buf[at - n:at]

    cnt = take(G)
    isum = take(n_isum * G).view(n_isum, G)
    fsum = take(n_fsum * G).view(torch.float64).view(n_fsum, G)
    matched = take(S)
    mm = take((n_mm * G + 1) // 2).view(torch.float32)[:n_mm * G]
    return ScanOutputs(buf=buf, layout=layout, cnt=cnt, isum=isum, fsum=fsum,
                       matched=matched, mm=mm.view(n_mm, G))


def _alloc_outputs(prog: ScanProgram, S: int, device) -> ScanOutputs:
    G = prog.G
    n = G * (1 + prog.n_isum + prog.n_fsum) + S + (prog.n_mm * G + 1) // 2
    out = _carve(torch.zeros(n, dtype=torch.int64, device=device),
                 (G, prog.n_isum, prog.n_fsum, prog.n_mm, S))
    for kind, _e, r in prog.rows:
        if kind == R_MIN:
            out.mm[r].fill_(float("inf"))
        elif kind == R_MAX:
            out.mm[r].fill_(float("-inf"))
    return out


def scan_shape(packed: List[torch.Tensor], values: List[torch.Tensor],
               num_docs: torch.Tensor, tiles: Optional[int] = None
               ) -> Tuple[int, int]:
    """(S, T) of a scan's inputs: segments from ``num_docs``, tiles per
    segment from the first packed or value column, else ``tiles``."""
    if (not isinstance(num_docs, torch.Tensor) or num_docs.dim() != 1
            or num_docs.dtype != torch.int64
            or not num_docs.is_contiguous()):
        raise ValueError("num_docs must be a contiguous int64 [S] tensor")
    if packed:
        if packed[0].dim() != 3:
            raise ValueError("packed columns must be [S, T, W]")
        T = packed[0].shape[1]
    elif values:
        T = values[0].shape[-1] // TILE
    elif tiles:
        T = tiles
    else:
        raise ValueError("a scan that reads no column needs its tile count")
    return num_docs.shape[0], T


def _check_inputs(prog: ScanProgram, packed: List[torch.Tensor],
                  values: List[torch.Tensor], num_docs: torch.Tensor,
                  tiles: Optional[int] = None) -> torch.device:
    if len(packed) != len(prog.bits) or len(values) != len(prog.value_is_int):
        raise ValueError("packed/value inputs do not match the program")
    S, tiles = scan_shape(packed, values, num_docs, tiles)
    device = num_docs.device
    for w, b in zip(packed, prog.bits):
        if (w.dtype != torch.int32 or w.device != device
                or tuple(w.shape) != (S, tiles, TILE * b // 32)
                or not w.is_contiguous()):
            raise ValueError(f"packed column must be contiguous int32 "
                             f"[{S}, {tiles}, {TILE * b // 32}] on {device}")
    for v, is_int in zip(values, prog.value_is_int):
        ok = (v.dtype in (torch.int32, torch.int64) if is_int
              else v.dtype == torch.float32)
        if (not ok or v.device != device
                or tuple(v.shape) != (S, tiles * TILE)
                or not v.is_contiguous()):
            raise ValueError(f"value column must be contiguous "
                             f"[{S}, {tiles * TILE}] "
                             f"{'int' if is_int else 'f32'} on {device}")
    return device


def fused_scan(prog: ScanProgram, packed: List[torch.Tensor],
               values: List[torch.Tensor], num_docs: torch.Tensor,
               tiles: Optional[int] = None) -> ScanOutputs:
    """Run the scan program over staged columns laid out as a batch (see
    the module docstring; one segment is ``S = 1``). CUDA tensors launch
    the kernel (or raise); CPU tensors run the plain version."""
    return counted_scan(prog, packed, values, num_docs,
                        PROBE_COUNTER if prog.probe else SCAN_COUNTER, tiles)


def fused_scan_probe(prog: ScanProgram, packed: List[torch.Tensor],
                     num_docs: torch.Tensor) -> ScanOutputs:
    """The group-range probe (a probe program, no value columns) over one
    segment's staged columns."""
    if not prog.probe:
        raise ValueError("fused_scan_probe takes a probe program")
    return fused_scan(prog, packed, [], num_docs)


class ScanKernels(NamedTuple):
    """The wrappers the scans of one kind of staged input launch through:
    a staged segment's (``SEGMENT_KERNELS``) or a staged batch's
    (``StagedBatch.kernels``), each with its own launch counter, so a run
    shows which path served. ``scan_inputs`` picks the pair."""

    scan: Callable    # (prog, words, values, num_docs, tiles) -> outputs
    probe: Callable   # (probe prog, words, num_docs) -> ScanOutputs
    scan_counter: KernelCounter
    probe_counter: KernelCounter


SEGMENT_KERNELS = ScanKernels(fused_scan, fused_scan_probe, SCAN_COUNTER,
                              PROBE_COUNTER)


def counted_scan(prog: ScanProgram, packed: List[torch.Tensor],
                 values: List[torch.Tensor], num_docs: torch.Tensor,
                 counter: KernelCounter, tiles: Optional[int] = None
                 ) -> ScanOutputs:
    """``fused_scan`` with the counter its launch adds one to."""
    device = _check_inputs(prog, packed, values, num_docs, tiles)
    if device.type == "cpu":
        return fused_scan_plain(prog, packed, values, num_docs, tiles)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = _launch(prog, packed, values, num_docs, tiles)
    counter.add()
    return out


def counted_scan_many(progs: List[ScanProgram], packed: List[torch.Tensor],
                      values: List[torch.Tensor], num_docs: torch.Tensor,
                      counter: KernelCounter, tiles: Optional[int] = None
                      ) -> List[ScanOutputs]:
    """Q programs of one layout over the same inputs, one outputs each:
    one launch of the query-axis kernel on a CUDA tensor, Q = 1 included
    (``counter`` adds one), ``fused_scan_many_plain`` on a CPU tensor."""
    if not progs:
        raise ValueError("no programs")
    key = progs[0].layout_key()
    if any(p.layout_key() != key for p in progs[1:]):
        raise ValueError("the programs of one launch must share a layout")
    device = _check_inputs(progs[0], packed, values, num_docs, tiles)
    if device.type == "cpu":
        return fused_scan_many_plain(progs, packed, values, num_docs, tiles)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    argv, outs = prepare_launch_many(progs, packed, values, num_docs, tiles)
    enqueue(argv, torch.cuda.current_stream(num_docs.device), many=True)
    counter.add()
    return outs


def fused_scan_many_plain(progs: List[ScanProgram],
                          packed: List[torch.Tensor],
                          values: List[torch.Tensor], num_docs: torch.Tensor,
                          tiles: Optional[int] = None) -> List[ScanOutputs]:
    """The query axis in plain PyTorch: one ``fused_scan_plain`` a
    program."""
    return [fused_scan_plain(p, packed, values, num_docs, tiles)
            for p in progs]


# argv slots shared with csrc/fused_scan.cu (fused_scan_launch,
# fused_scan_many_launch)
(_A_NUM_DOCS, _A_NUM_TILES, _A_SEG_TILES, _A_G, _A_N_PACKED, _A_N_VALUES,
 _A_PROG, _A_PROG_LEN, _A_FILTER_OFF, _A_FILTER_N, _A_VOPS_OFF, _A_EXPR_OFF,
 _A_ROWS_OFF, _A_N_ROWS, _A_GROUP_OFF, _A_N_GROUP, _A_IV_OFF, _A_KEY_OFFSET,
 _A_N_ISUM, _A_N_FSUM, _A_N_MM, _A_SCALAR, _A_ACC_SMEM, _A_OUT_CNT,
 _A_OUT_ISUM, _A_OUT_FSUM, _A_OUT_MM, _A_OUT_MATCHED, _A_SMEM,
 _A_PROG_SMEM_OFF, _A_MSTACK_OFF, _A_VSTACK_OFF, _A_ACC_OFF, _A_RACC_OFF,
 _A_WLIST_OFF, _A_N_OPND, _A_Q, _A_OUT_QSTRIDE, _A_QG,
 _A_ACC_QSTRIDE, _A_LUT_OFF, _A_LUT_BYTES) = range(42)
_A_PACKED, _A_LOG2_BITS, _A_VALUES, _A_VTYPES = 48, 64, 80, 96
_A_SLOT_PACKED, _A_SLOT_VALUE = 112, 128
_A_LEN = 144
_BLOCK = 256
# shared memory of an SM (H100), what the card reserves per block, and the
# most one block may take (SMEM_BLOCK_MAX)
_SMEM_SM = 228 * 1024
_SMEM_RESERVED = 1024
_SMEM_BLOCK_MAX = 227 * 1024
# programs a block of the query axis serves (QG in csrc/fused_scan.cu):
# the default pinot.server.query.launch.max.batch
QG = 8


def _align16(n: int) -> int:
    return -(-n // 16) * 16


class ScanLayout(NamedTuple):
    """The kernel's shared memory, in bytes: the program (the query axis:
    its group's ``qg`` programs) at 0, the filter's and the values' stacks
    below their tops ([depth][BLOCK]), a scalar scan's per-thread rows
    ([qg][rows][BLOCK]), each warp's list of passing docs, the query
    axis's leaf tables (``lut_bytes``), then the block-private
    accumulators of a grouped scan, one set a program ``acc_qstride``
    bytes apart."""

    prog_off: int
    mstack_off: int
    vstack_off: int
    racc_off: int
    wlist_off: int
    acc_off: int
    acc_smem: bool               # grouped accumulators in shared memory
    smem: int                    # the whole dynamic allocation
    qg: int = 1                  # programs a block serves
    acc_qstride: int = 0         # bytes of one program's accumulators
    lut_off: int = 0             # the query axis's leaf tables
    lut_bytes: int = 0


# bytes of the warps' lists of passing docs: a u16 per doc of a tile (and
# on the query axis a u8 of the doc's programs)
_WLIST_BYTES = 2 * TILE
_WLIST_MANY_BYTES = 3 * TILE


# the query axis's leaf tables (csrc/fused_scan.cu lut_leaf): a leaf over
# 4- or 8-bit dictIds takes a table of 2^B 16-byte entries when its
# group's SWAR tests (instructions a program and interval, by log2 width)
# would cost more than a table leaf's _LUT_COST; at most _MAX_LUTS tables
# and _LUT_CAP bytes a block
_LUT_COST = 176
_LUT_SWAR = {2: 32, 3: 60}
_MAX_LUTS = 8
_LUT_CAP = 16 * 1024


def lut_leaves(prog: ScanProgram, qg: int) -> List[int]:
    """The log2 widths of the leaves, in filter order, that take a table in
    a query-axis block serving ``qg`` programs (as the kernel walks them)."""
    total, widths = 0, []
    for k in range(prog.filter_n):
        op, col, _slot, n = (int(x) for x in prog.prog[
            prog.filter_off + 4 * k: prog.filter_off + 4 * k + 4])
        if op not in (F_IV, F_IVS):
            continue
        lb, n = prog.log2_bits[col], 1 if op == F_IV else n
        if (lb not in _LUT_SWAR or qg * n * _LUT_SWAR[lb] <= _LUT_COST
                or len(widths) == _MAX_LUTS):
            continue
        size = 16 << (1 << lb)
        if total + size <= _LUT_CAP:
            total += size
            widths.append(lb)
    return widths


def _acc_bytes(prog: ScanProgram) -> int:
    """One program's grouped accumulators (0 for a scalar scan)."""
    return (0 if prog.scalar else
            prog.G * (8 * (1 + prog.n_isum + prog.n_fsum) + 4 * prog.n_mm))


def _layout(prog: ScanProgram, sizes: List[int], qg: int, acc_one: int
            ) -> ScanLayout:
    """Offsets of the sections ``sizes`` (program, filter stack, value
    stack, scalar rows, warp lists, leaf tables), then the grouped
    accumulators of ``qg`` programs, ``acc_one`` bytes each, where they
    fit beside two blocks on an SM."""
    budget = _SMEM_SM // 2 - _SMEM_RESERVED
    acc_smem = not prog.scalar and sum(sizes) + qg * acc_one <= budget
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + n)
    (prog_off, mstack_off, vstack_off, racc_off, wlist_off, lut_off,
     acc_off) = offs
    return ScanLayout(
        prog_off=prog_off, mstack_off=mstack_off, vstack_off=vstack_off,
        racc_off=racc_off, wlist_off=wlist_off, acc_off=acc_off,
        acc_smem=acc_smem, smem=acc_off + (qg * acc_one if acc_smem else 0),
        qg=qg, acc_qstride=acc_one if acc_smem else 0, lut_off=lut_off,
        lut_bytes=acc_off - lut_off)


def scan_layout(prog: ScanProgram) -> ScanLayout:
    """Shared memory of one launch. A grouped scan's accumulators take
    shared memory only while two blocks still fit on an SM: one block of 8
    warps leaves the SM waiting on memory (on SSB, device-memory atomics at
    4 blocks per SM beat shared ones at 1)."""
    return _layout(prog, [
        _align16(4 * prog.prog.size),
        _align16(2 * _BLOCK * max(prog.filter_depth - 1, 0)),
        8 * _BLOCK * max(prog.value_depth - 1, 0),
        8 * _BLOCK * prog.n_rows if prog.scalar else 0,
        _WLIST_BYTES, 0], 1, _acc_bytes(prog))


def scan_layout_many(prog: ScanProgram, qg: int) -> ScanLayout:
    """Shared memory of a query-axis block serving ``qg`` programs of
    ``prog``'s layout: their programs, 16-byte filter-stack entries (the
    group's four mask words), ``qg`` sets of scalar rows (u64 sums, f32
    min/max), list entries of a u16 doc and a u8 of its programs, the
    leaf tables (``lut_leaves``), and ``qg`` sets of grouped accumulators
    while they fit beside two blocks on an SM (``scan_layout``'s rule),
    else device memory."""
    if not 1 <= qg <= QG:
        raise ValueError(f"a query-axis block serves 1 to {QG} programs")
    return _layout(prog, [
        _align16(4 * qg * prog.prog.size),
        16 * _BLOCK * max(prog.filter_depth - 1, 0),
        8 * _BLOCK * max(prog.value_depth - 1, 0),
        _BLOCK * qg * (8 * (prog.n_isum + prog.n_fsum) + 4 * prog.n_mm)
        if prog.scalar else 0,
        _WLIST_MANY_BYTES,
        sum(16 << (1 << lb) for lb in lut_leaves(prog, qg))], qg,
        _align16(_acc_bytes(prog)))


def query_group(prog: ScanProgram, q: int) -> Tuple[int, int]:
    """(programs a block serves, blocks on grid y) of a query-axis launch
    over ``q`` programs of ``prog``'s layout: up to ``QG`` a block, fewer
    only where ``QG`` programs' shared memory would not fit in a block."""
    if q < 1:
        raise ValueError("no programs")
    qg = min(QG, q)
    while qg > 1 and scan_layout_many(prog, qg).smem > _SMEM_BLOCK_MAX:
        qg -= 1
    return qg, -(-q // qg)


def launch_grid(smem: int, many: bool = False) -> int:
    """Blocks on grid x for ``smem`` bytes of shared memory on the current
    card (occupancy x SMs, before the cap at one block per tile), of the
    one-query kernel or (``many``) the query axis's."""
    from pinot_tpu_torch.engine._build import load_library

    grid = ctypes.c_int(0)
    err = load_library("fused_scan").fused_scan_grid(smem, int(many),
                                                     ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(f"fused_scan occupancy query failed: CUDA error "
                           f"{err}")
    return grid.value


def _launch(prog: ScanProgram, packed, values, num_docs, tiles=None
            ) -> ScanOutputs:
    """One launch of the kernel."""
    argv, out = prepare_launch(prog, packed, values, num_docs, tiles)
    enqueue(argv, torch.cuda.current_stream(num_docs.device))
    return out


def _argv_template(prog: ScanProgram, S: int, seg_tiles: int, device,
                   qg: int = 0) -> np.ndarray:
    """The argv slots that depend only on the program and the batch's
    shape: of a one-query launch (``qg`` = 0) or of a query-axis launch
    with ``qg`` programs a block (its layout)."""
    key = (device, S, seg_tiles, qg)
    got = prog._argv.get(key)
    if got is not None:
        return got
    lay = scan_layout_many(prog, qg) if qg else scan_layout(prog)
    argv = np.zeros(_A_LEN, dtype=np.int64)
    argv[_A_NUM_TILES] = S * seg_tiles
    argv[_A_SEG_TILES] = seg_tiles
    argv[_A_G] = prog.G
    argv[_A_N_PACKED] = len(prog.bits)
    argv[_A_N_VALUES] = len(prog.value_is_int)
    argv[_A_PROG] = prog.on(device).data_ptr()
    argv[_A_PROG_LEN] = prog.prog.size
    argv[_A_FILTER_OFF] = prog.filter_off
    argv[_A_FILTER_N] = prog.filter_n
    argv[_A_VOPS_OFF] = prog.vops_off
    argv[_A_EXPR_OFF] = prog.expr_off
    argv[_A_ROWS_OFF] = prog.rows_off
    argv[_A_N_ROWS] = prog.n_rows
    argv[_A_GROUP_OFF] = prog.group_off
    argv[_A_N_GROUP] = prog.n_group
    argv[_A_IV_OFF] = prog.iv_off
    argv[_A_KEY_OFFSET] = prog.key_offset
    argv[_A_N_ISUM] = prog.n_isum
    argv[_A_N_FSUM] = prog.n_fsum
    argv[_A_N_MM] = prog.n_mm
    argv[_A_SCALAR] = int(prog.scalar)
    argv[_A_ACC_SMEM] = int(lay.acc_smem)
    argv[_A_SMEM] = lay.smem
    argv[_A_PROG_SMEM_OFF] = lay.prog_off
    argv[_A_MSTACK_OFF] = lay.mstack_off
    argv[_A_VSTACK_OFF] = lay.vstack_off
    argv[_A_ACC_OFF] = lay.acc_off
    argv[_A_RACC_OFF] = lay.racc_off
    argv[_A_WLIST_OFF] = lay.wlist_off
    argv[_A_N_OPND] = len(prog.operands)
    argv[_A_Q] = 1
    argv[_A_QG] = lay.qg
    argv[_A_ACC_QSTRIDE] = lay.acc_qstride
    argv[_A_LUT_OFF] = lay.lut_off
    argv[_A_LUT_BYTES] = lay.lut_bytes
    argv[_A_SLOT_PACKED:_A_SLOT_PACKED + MAX_COLS] = -1
    argv[_A_SLOT_VALUE:_A_SLOT_VALUE + MAX_COLS] = -1
    for k, (is_packed, c) in enumerate(prog.operands):
        argv[(_A_SLOT_PACKED if is_packed else _A_SLOT_VALUE) + c] = k
    for i, lb in enumerate(prog.log2_bits):
        argv[_A_LOG2_BITS + i] = lb
    prog._argv[key] = argv
    return argv


def prepare_launch(prog: ScanProgram, packed, values, num_docs, tiles=None
                   ) -> Tuple[np.ndarray, ScanOutputs]:
    """The kernel's argv for one launch and the outputs it adds into
    (zeroed, min/max rows at +-inf)."""
    device = num_docs.device
    S, seg_tiles = scan_shape(packed, values, num_docs, tiles)
    template = _argv_template(prog, S, seg_tiles, device)
    out = _alloc_outputs(prog, S, device)
    argv = template.copy()
    argv[_A_NUM_DOCS] = num_docs.data_ptr()
    argv[_A_OUT_CNT] = out.cnt.data_ptr()
    argv[_A_OUT_ISUM] = out.isum.data_ptr()
    argv[_A_OUT_FSUM] = out.fsum.data_ptr()
    argv[_A_OUT_MM] = out.mm.data_ptr()
    argv[_A_OUT_MATCHED] = out.matched.data_ptr()
    for i, w in enumerate(packed):
        argv[_A_PACKED + i] = w.data_ptr()
    for i, v in enumerate(values):
        argv[_A_VALUES + i] = v.data_ptr()
        argv[_A_VTYPES + i] = _TORCH_VTYPE[v.dtype]
    return argv, out


def prepare_launch_many(progs: List[ScanProgram], packed, values, num_docs,
                        tiles=None) -> Tuple[np.ndarray, List[ScanOutputs]]:
    """The argv of one launch of the query-axis kernel over ``progs`` (one
    layout) and each program's outputs: the programs stacked [Q,
    prog_len] on the device, ``query_group``'s programs a block, the
    outputs rows of one [Q, n] buffer."""
    device = num_docs.device
    S, seg_tiles = scan_shape(packed, values, num_docs, tiles)
    qg, _ = query_group(progs[0], len(progs))
    template = _argv_template(progs[0], S, seg_tiles, device, qg)
    stacked = torch.from_numpy(np.stack([p.prog for p in progs])).to(device)
    one = _alloc_outputs(progs[0], S, device)
    n = one.buf.numel()
    buf = one.buf.repeat(len(progs))     # every row zeroed, +-inf set
    outs = [_carve(buf[q * n:(q + 1) * n], one.layout)
            for q in range(len(progs))]
    argv = template.copy()
    argv[_A_PROG] = stacked.data_ptr()
    argv[_A_Q] = len(progs)
    argv[_A_OUT_QSTRIDE] = n * 8
    argv[_A_NUM_DOCS] = num_docs.data_ptr()
    argv[_A_OUT_CNT] = outs[0].cnt.data_ptr()
    argv[_A_OUT_ISUM] = outs[0].isum.data_ptr()
    argv[_A_OUT_FSUM] = outs[0].fsum.data_ptr()
    argv[_A_OUT_MM] = outs[0].mm.data_ptr()
    argv[_A_OUT_MATCHED] = outs[0].matched.data_ptr()
    for i, w in enumerate(packed):
        argv[_A_PACKED + i] = w.data_ptr()
    for i, v in enumerate(values):
        argv[_A_VALUES + i] = v.data_ptr()
        argv[_A_VTYPES + i] = _TORCH_VTYPE[v.dtype]
    # ``stacked`` may be freed once the launch is enqueued: the allocator
    # reuses its memory only after the kernel, in stream order
    return argv, outs


def enqueue(argv: np.ndarray, stream: "torch.cuda.Stream",
            many: bool = False) -> None:
    """Launch the kernel with a prepared argv on ``stream`` (its device):
    the one-query kernel (``prepare_launch``) or the query axis's
    (``many``, ``prepare_launch_many``); raises if the launch is
    refused."""
    from pinot_tpu_torch.engine._build import load_library

    lib = load_library("fused_scan")
    launch = lib.fused_scan_many_launch if many else lib.fused_scan_launch
    with torch.cuda.device(stream.device):
        err = launch(argv.ctypes.data_as(ctypes.c_void_p),
                     ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"fused_scan kernel launch failed: CUDA error "
                           f"{err} ({lib.fused_scan_error_string(err).decode()})")


def _f32_of_bits(bits: int) -> float:
    return float(np.array([bits], dtype=np.int32).view(np.float32)[0])


def unpack_planar(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Planar words [..., tiles, W] -> dictIds [... * tiles * TILE]
    int64, tile after tile."""
    K = 32 // bits
    w = words.to(torch.int64) & 0xFFFFFFFF
    mask = (1 << bits) - 1
    planes = [(w >> (k * bits)) & mask for k in range(K)]
    return torch.stack(planes, dim=-2).reshape(-1)


def _filter_mask(prog: ScanProgram, ids: List[torch.Tensor], cap: int,
                 device) -> torch.Tensor:
    """The ``cap`` docs whose dictIds pass the program's filter (padding
    included)."""
    p = prog.prog.tolist()
    stack: List[torch.Tensor] = []
    for i in range(prog.filter_n):
        op, a, b, c = p[prog.filter_off + 4 * i: prog.filter_off + 4 * i + 4]
        if op == F_TRUE:
            stack.append(torch.ones(cap, dtype=torch.bool, device=device))
        elif op == F_IV:
            lo, hi = p[prog.iv_off + 2 * b], p[prog.iv_off + 2 * b + 1]
            stack.append((ids[a] >= lo) & (ids[a] <= hi))
        elif op == F_IVS:
            m = torch.zeros(cap, dtype=torch.bool, device=device)
            for s in range(b, b + c):
                lo, hi = p[prog.iv_off + 2 * s], p[prog.iv_off + 2 * s + 1]
                m |= (ids[a] >= lo) & (ids[a] <= hi)
            stack.append(m)
        elif op == F_NOT:
            stack.append(~stack.pop())
        else:
            y, x = stack.pop(), stack.pop()
            stack.append(x & y if op == F_AND else x | y)
    return stack.pop()


def _valid_mask(num_docs: torch.Tensor, tiles: int) -> torch.Tensor:
    return (torch.arange(tiles * TILE, device=num_docs.device)[None, :]
            < num_docs[:, None]).reshape(-1)


def doc_masks(prog: ScanProgram, packed: List[torch.Tensor],
              num_docs: torch.Tensor, values: List[torch.Tensor] = (),
              tiles: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(valid, matched): bool ``[S * T * TILE]`` masks, in the batch's doc
    order, of the docs that exist (below their segment's ``num_docs``) and
    of those that also pass the program's filter."""
    S, T = scan_shape(packed, list(values), num_docs, tiles)
    ids = [unpack_planar(w, b) for w, b in zip(packed, prog.bits)]
    valid = _valid_mask(num_docs, T)
    return valid, _filter_mask(prog, ids, S * T * TILE,
                               num_docs.device) & valid


def fused_scan_plain(prog: ScanProgram, packed: List[torch.Tensor],
                     values: List[torch.Tensor], num_docs: torch.Tensor,
                     tiles: Optional[int] = None) -> ScanOutputs:
    """The kernel's function in plain PyTorch: the same program, evaluated
    over the whole batch at once (per-segment valid masks, exact i64 and
    f64 accumulation into the rows every segment shares)."""
    device = num_docs.device
    S, tiles = scan_shape(packed, values, num_docs, tiles)
    p = prog.prog.tolist()
    ids = [unpack_planar(w, b) for w, b in zip(packed, prog.bits)]
    cap = S * tiles * TILE
    mask = _filter_mask(prog, ids, cap, device) & _valid_mask(num_docs,
                                                              tiles)

    out = _alloc_outputs(prog, S, device)
    out.matched += mask.view(S, -1).sum(dim=1)
    key = torch.zeros(cap, dtype=torch.int64, device=device)
    for g in range(prog.n_group):
        col, stride = p[prog.group_off + 2 * g: prog.group_off + 2 * g + 2]
        key += ids[col] * stride
    key -= prog.key_offset
    hit = mask & (key >= 0) & (key < prog.G)
    k = key[hit]
    out.cnt.index_add_(0, k, torch.ones_like(k))

    def eval_expr(e: int) -> torch.Tensor:
        start, n = p[prog.expr_off + 2 * e: prog.expr_off + 2 * e + 2]
        st: List[torch.Tensor] = []
        for i in range(start, start + n):
            op, a, _b, is_float = p[prog.vops_off + 4 * i:
                                    prog.vops_off + 4 * i + 4]
            if op == V_COL:
                v = values[a].reshape(-1)[hit]
                st.append(v if is_float else v.to(torch.int64))
            elif op == V_ID:
                st.append(ids[a][hit])
            elif op == V_LITC:
                st.append(torch.tensor(a, dtype=torch.int64, device=device))
            elif op == V_LITF:
                st.append(torch.tensor(_f32_of_bits(a),
                                       dtype=torch.float32, device=device))
            else:
                y, x = st.pop(), st.pop()
                if is_float:
                    x, y = x.to(torch.float32), y.to(torch.float32)
                st.append(x * y if op == V_TIMES
                          else x + y if op == V_PLUS else x - y)
        return st.pop().expand(k.shape)

    for kind, e, r in prog.rows:
        v = eval_expr(e)
        if kind == R_ISUM:
            out.isum[r].index_add_(0, k, v.to(torch.int64))
        elif kind == R_FSUM:
            out.fsum[r].index_add_(0, k, v.to(torch.float32).to(torch.float64))
        else:
            out.mm[r].scatter_reduce_(0, k, v.to(torch.float32),
                                      "amin" if kind == R_MIN else "amax")
    return out


# --------------------------------------------------------------------------
# outputs -> the decode tree (the JAX package's assemble_outputs contract)
# --------------------------------------------------------------------------

def assemble_outputs(plan_spec: Tuple, pp: ScanPlan,
                     out: ScanOutputs) -> Dict[str, object]:
    """Scan outputs (any device) -> host numpy tree, in one device-to-host
    copy: ``presence`` or ``num_matched``, then ``agg{i}`` leaves (avg is
    (sum, count), minmaxrange is (min, max)), then ``seg_matched`` [S];
    int sums stay exact int64."""
    _, _, group_specs, num_groups, _ = plan_spec
    isum_row, fsum_row, mm_row = _row_layout(pp.aggs)
    grouped = bool(group_specs)
    n = num_groups if grouped else 1
    host = out.to_host()
    cnt = host.cnt.numpy()[:n]
    isum = host.isum.numpy()[:, :n]
    fsum = host.fsum.numpy()[:, :n]
    mm = host.mm.numpy()[:, :n]
    tree: Dict[str, object] = ({"presence": cnt} if grouped
                               else {"num_matched": cnt[0]})
    for i, (base, vexpr, limbs) in enumerate(pp.aggs):
        if base == "count":
            leaf = cnt
        elif base in ("sum", "avg"):
            leaf = (isum[isum_row[vexpr]] if limbs is not None
                    else fsum[fsum_row[vexpr]])
            if base == "avg":
                leaf = (leaf, cnt)
        elif base == "min":
            leaf = mm[mm_row[(vexpr, "min")]]
        elif base == "max":
            leaf = mm[mm_row[(vexpr, "max")]]
        else:
            leaf = (mm[mm_row[(vexpr, "min")]], mm[mm_row[(vexpr, "max")]])
        if not grouped:
            leaf = (tuple(x[0] for x in leaf) if isinstance(leaf, tuple)
                    else leaf[0])
        tree[f"agg{i}"] = leaf
    tree["seg_matched"] = host.matched.numpy()
    return tree


# --------------------------------------------------------------------------
# runner: a staged segment, or a staged segment batch
# --------------------------------------------------------------------------

def _stage_packed(pp: ScanPlan, staged, S: int, decline):
    words, bits = [], []
    for nm in pp.packed_names:
        pc = staged.packed_column(nm)
        if pc is None:
            decline("pallas_column_not_packable")
            return None
        words.append(pc.words.reshape(S, -1, pc.words.shape[-1]))
        bits.append(pc.bits)
    return words, tuple(bits)


def _stage_values(pp: ScanPlan, staged, S: int, decline):
    cols = []
    for nm in pp.value_names:
        v = staged.value_column(nm)
        if v is None:
            decline("pallas_value_layout_unsupported")
            return None
        cols.append(v.reshape(S, -1))
    return cols


@dataclass
class ScanInputs:
    pp: ScanPlan                  # the (narrowed) plan's scan plan
    plan: object                  # effective plan the outputs decode against
    prog: ScanProgram
    words: List[torch.Tensor]     # packed columns [S, T, W], in prog.bits order
    values: List[torch.Tensor]    # value columns [S, T * TILE]
    num_docs: torch.Tensor        # [S] int64
    tiles: int                    # T, tiles per segment
    # the probe's (program, packed columns) when the group space was
    # narrowed by a probe scan, else None
    probe: Optional[Tuple[ScanProgram, List[torch.Tensor]]]
    kernels: ScanKernels          # the wrappers these inputs launch through

    def scan(self) -> ScanOutputs:
        """The scan, in one launch on the card."""
        return self.kernels.scan(self.prog, self.words, self.values,
                                 self.num_docs, self.tiles)


def scan_inputs(plan, staged, on_decline: Callable = None,
                run_probe: Optional[Callable] = None
                ) -> Optional[ScanInputs]:
    """The scan program and staged columns of a plan over ``staged``, a
    ``StagedSegment`` (launched through ``SEGMENT_KERNELS``) or a staged
    segment batch (anything with ``provider``, ``packed_column``,
    ``value_column``, ``num_docs_tensor``, ``scan_capacity`` and its own
    ``kernels``), probing
    first (one launch) when the group key space exceeds MAX_SCAN_GROUPS;
    ``run_probe(prog, words, num_docs)`` launches it where given (the
    batch executor's launcher), else the staged input's probe wrapper.
    None when the plan is not eligible (``on_decline`` receives the reason
    code)."""

    def decline(reason: str) -> None:
        if on_decline is not None:
            on_decline(reason)

    kernels = (SEGMENT_KERNELS if isinstance(staged, StagedSegment)
               else staged.kernels)
    num_docs = staged.num_docs_tensor()
    S = num_docs.shape[0]
    defer = _DeferredDecline(on_decline)
    pp = extract_plan(plan, staged.provider, on_decline=defer)
    eff = plan
    probe = None
    if pp is None:
        if not defer.only_group_bound:
            defer.flush()
            return None

        launch_probe = run_probe or kernels.probe

        def probe_rows(probe_pp: ScanPlan):
            nonlocal probe
            got = _stage_packed(probe_pp, staged, S, decline)
            if got is None:
                raise RuntimeError("probe columns were packable for the "
                                   "full plan but not for the probe")
            words, bits = got
            probe = (compile_program(probe_pp, bits, probe=True), words)
            return launch_probe(*probe, num_docs).to_host().mm.numpy()

        res = probe_narrowed_plan(plan, staged.provider, probe_rows, decline)
        if res is None:
            return None
        pp, eff = res

    got = _stage_packed(pp, staged, S, decline)
    if got is None:
        return None
    words, bits = got
    vals = _stage_values(pp, staged, S, decline)
    if vals is None:
        return None
    return ScanInputs(pp=pp, plan=eff, prog=compile_program(pp, bits),
                      words=words, values=vals, num_docs=num_docs,
                      tiles=staged.scan_capacity() // TILE, probe=probe,
                      kernels=kernels)


@dataclass
class SegmentScan:
    tree: Dict[str, object]   # decode tree (assemble_outputs)
    plan: object              # effective plan the tree decodes against
    matched: int              # docs that passed the filter


def run_segment(plan, staged: StagedSegment, on_decline: Callable = None
                ) -> Optional[SegmentScan]:
    """Fused scan of one staged segment (see ``scan_inputs``). None when
    the plan is not eligible (``on_decline`` receives the reason code)."""
    inp = scan_inputs(plan, staged, on_decline)
    if inp is None:
        return None
    tree = assemble_outputs(inp.plan.spec, inp.pp, inp.scan())
    return SegmentScan(tree=tree, plan=inp.plan,
                       matched=int(tree["seg_matched"].sum()))
