"""Kernel preflight: the fused scan's fixed limits checked for a plan
before it reaches the card.

Counterpart of ``pinot_tpu/tools/preflight.py`` in its shapes (``Verdict``
and its ``row``, the verdict table, ``fuzz_specs``, ``preflight_ssb_plans``,
``seed_blocklist``, ``attach_verdicts``, ``serializable_table``), for
another kernel. JAX's preflight models Mosaic's lowering on a TPU (VMEM,
SMEM, tile alignment), which is costly to run. The port's kernel
(``engine/csrc/fused_scan.cu``) is built once and interprets a program,
and building a program is host work of microseconds, so a verdict is
``compile_program``'s own: the program's shared memory a block and its
words where it builds, else the ``pallas_preflight_<rule>`` code of the
``ScanLimitError`` it raises (the code ``scan_inputs`` declines with):

- ``column_slots``: at most ``MAX_COLS`` packed and ``MAX_COLS`` value
  columns (the kernel's argv slots);
- ``tile_align``: packed widths of 1, 2, 4, 8, 16 or 32 bits (the planar
  words the kernel unpacks by shifts);
- ``filter_stack``: the filter's postfix stack at most
  ``MAX_FILTER_STACK`` deep;
- ``value_stack``: each value expression's stack at most
  ``MAX_VALUE_STACK`` deep;
- ``accumulator_rows``: at most ``MAX_ROWS`` sum, min and max rows;
- ``program_int32``: every program word (literals, group strides,
  interval bounds) inside int32;
- ``smem_budget``: the program, the stacks, a scalar scan's rows and the
  warps' lists within one block's shared memory (227 KB on an H100).

What ``extract_plan`` declines first (more than ``MAX_SCAN_GROUPS`` groups
with no probe to narrow them, DISTINCTCOUNT, more than 2^31 docs, the
shapes ``classify_decline`` names) never reaches a program: an SSB flight
declined there is recorded as not extractable, with extract's code.

``python -m pinot_tpu_torch.tools.preflight`` builds a small SSB fixture,
stages it on the card (``--device cpu`` for the CPU) and prints the table
(``--json`` for machines).
"""

from __future__ import annotations

import json

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.engine import fused_scan as fs


@dataclass(frozen=True)
class _Rule:
    code: str        # the decline reason (pallas_preflight_*)
    title: str       # one line for the verdict table and the README


# compile_program's order: the first violated rule is the code it raises
RULES: Tuple[_Rule, ...] = (
    _Rule("pallas_preflight_column_slots",
          "at most MAX_COLS packed and MAX_COLS value columns"),
    _Rule("pallas_preflight_tile_align",
          "packed widths are 1, 2, 4, 8, 16 or 32 bits"),
    _Rule("pallas_preflight_filter_stack",
          "the filter's postfix stack is at most MAX_FILTER_STACK deep"),
    _Rule("pallas_preflight_value_stack",
          "each value expression's stack is at most MAX_VALUE_STACK deep"),
    _Rule("pallas_preflight_accumulator_rows",
          "at most MAX_ROWS sum, min and max rows"),
    _Rule("pallas_preflight_program_int32",
          "every program word (literals, strides, bounds) fits int32"),
    _Rule("pallas_preflight_smem_budget",
          "program, stacks, scalar rows and warp lists fit one block's "
          "shared memory"),
)
_CODES = frozenset(r.code for r in RULES)


@dataclass
class Verdict:
    """One shape's preflight outcome."""

    shape: str                        # flight id or fuzz label
    source: str                       # "ssb" | "fuzz"
    ok: bool
    rule: Optional[str] = None        # the code the plan declines with
    detail: str = ""
    smem_bytes: int = 0
    program_words: int = 0

    def row(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "shape": self.shape, "source": self.source,
            "verdict": "pass" if self.ok else "fail",
            "smem_bytes": self.smem_bytes,
            "program_words": self.program_words,
        }
        if not self.ok:
            out["rule"] = self.rule
            out["detail"] = self.detail
        return out


# --------------------------------------------------------------------------
# one scan plan's verdict
# --------------------------------------------------------------------------

def preflight_program(pp: "fs.ScanPlan", bits: Tuple[int, ...],
                      shape: str = "", source: str = "fuzz") -> Verdict:
    """What ``compile_program(pp, bits)`` does with the plan: where it
    builds the program, its shared memory a block and its words; else the
    code of the limit it declines with."""
    try:
        prog = fs.compile_program(pp, tuple(bits))
    except fs.ScanLimitError as e:
        return Verdict(shape=shape, source=source, ok=False, rule=e.reason,
                       detail=str(e))
    return Verdict(shape=shape, source=source, ok=True,
                   smem_bytes=fs.scan_layout(prog).smem,
                   program_words=int(prog.prog.size))


# --------------------------------------------------------------------------
# a plan over a staged segment -> its scan plan (no scan launch)
# --------------------------------------------------------------------------

def extract_query_program(plan, staged):
    """-> ``(ScanPlan, bits, effective plan, None)``: the scan plan and
    packed widths ``scan_inputs`` would compile for ``plan`` over
    ``staged`` (the probe narrowing included: one probe launch on the
    card, its plain version on the CPU), or ``(None, None, None, reason)``
    where the fused scan declines the plan before a program exists."""
    reasons: List[str] = []
    got = fs.scan_plan(plan, staged, reasons.append)
    if got is None:
        return None, None, None, (reasons or ["unknown"])[0]
    pp, eff, _probe, _words, bits = got
    return pp, tuple(bits), eff, None


# --------------------------------------------------------------------------
# the fuzzed shape grid
# --------------------------------------------------------------------------

def _mk_plan(packed: int = 1, values: int = 0, filter_tree=("true",),
             n_slots: int = 0, params=None, groups: int = 0,
             strides: Tuple[int, ...] = (),
             aggs=(("count", None, None),),
             value_is_int: Optional[Tuple[bool, ...]] = None
             ) -> "fs.ScanPlan":
    """A hand-built scan plan: ``packed`` packed columns, ``values``
    value columns (ints unless ``value_is_int`` says otherwise), group
    keys on the first ``len(strides)`` packed columns."""
    if params is None:
        params = np.zeros(2 * n_slots, dtype=np.int64)
    vint = (tuple(value_is_int) if value_is_int is not None
            else (True,) * values)
    return fs.ScanPlan(
        packed_names=[f"p{i}" for i in range(packed)],
        value_names=[f"v{i}" for i in range(values)],
        value_is_int=vint, filter_tree=filter_tree, n_slots=n_slots,
        group_idx=tuple(range(len(strides))),
        group_strides=tuple(int(s) for s in strides),
        group_key_offset=0,
        num_groups_padded=groups if strides else fs.G_CHUNK,
        aggs=tuple(aggs), static_params=np.asarray(params),
        value_limbs=(0,) * values)


def _nested(op: str, depth: int, leaf):
    """A right-nested chain of ``op`` whose postfix stack is ``depth``
    deep (a filter: ``depth - 1`` ANDs; a value: ``depth - 1`` TIMES)."""
    node = leaf(depth - 1)
    for i in range(depth - 2, -1, -1):
        node = ((op, (leaf(i), node)) if op == "and"
                else (op, leaf(i), node))
    return node


def fuzz_specs() -> List[Tuple[str, "fs.ScanPlan", Tuple[int, ...]]]:
    """The fuzzed plan grid: ``(label, ScanPlan, bits)`` at each limit and
    one past it, and the shapes the main path emits (grouped at the dense
    rung's widths, interval sets, wide rows). Passing shapes show the
    model admits what the engine builds; failing ones pin each rule."""
    shapes: List[Tuple[str, Any, Tuple[int, ...]]] = []

    def add(label, pp, bits=None):
        shapes.append((label, pp, tuple(bits if bits is not None
                                        else (8,) * len(pp.packed_names))))

    def iv(i):
        return ("iv", 0, i)

    # the argv's column slots
    add("cols16", _mk_plan(packed=16))
    add("cols17_over", _mk_plan(packed=17))
    add("values16", _mk_plan(values=16, aggs=tuple(
        ("sum", ("v", i), 1) for i in range(16))))
    add("values17_over", _mk_plan(values=17))
    # packed widths: every word-aligned width, then straddling ones
    for b in (1, 2, 4, 8, 16, 32):
        add(f"bits{b}", _mk_plan(), (b,))
    add("bits6_straddle", _mk_plan(), (6,))
    add("bits12_straddle", _mk_plan(), (12,))
    # filter depth: at the stack's bound, then past it
    for d, label in ((1, "filter1"), (8, "filter8"),
                     (fs.MAX_FILTER_STACK, f"filter{fs.MAX_FILTER_STACK}"),
                     (fs.MAX_FILTER_STACK + 1,
                      f"filter{fs.MAX_FILTER_STACK + 1}_over")):
        add(label, _mk_plan(filter_tree=_nested("and", d, iv), n_slots=d))
    add("filter_not_or", _mk_plan(filter_tree=(
        "not", (("or", tuple(iv(i) for i in range(8))),)), n_slots=8))
    # value expression depth
    for d, label in ((fs.MAX_VALUE_STACK, f"value{fs.MAX_VALUE_STACK}"),
                     (fs.MAX_VALUE_STACK + 1,
                      f"value{fs.MAX_VALUE_STACK + 1}_over")):
        add(label, _mk_plan(values=1, aggs=(("sum", _nested(
            "times", d, lambda i: ("v", 0) if i % 2 else ("litc", 3)),
            1),)))
    # accumulator rows: 16 sums, then one min more
    sums = tuple(("sum", ("v", i), 1) for i in range(16))
    add("rows16", _mk_plan(values=16, aggs=sums))
    add("rows17_over", _mk_plan(values=16, aggs=sums + (
        ("min", ("v", 0), None),)))
    add("rows_minmaxrange8", _mk_plan(values=8, aggs=tuple(
        ("minmaxrange", ("v", i), None) for i in range(8))))
    # program words: a group stride and a literal past int32
    add("stride_int32_over", _mk_plan(
        packed=2, groups=8192, strides=(1 << 31, 1)))
    add("literal_int32_over", _mk_plan(values=1, aggs=(
        ("sum", ("times", ("v", 0), ("litc", 1 << 31)), 1),)))
    # interval sets: what the run cap admits, then a program past a block
    for runs in (8, 64):
        add(f"ivs{runs}", _mk_plan(filter_tree=("ivs", 0, 0, runs),
                                   n_slots=runs))
    add("ivs32768_smem_over", _mk_plan(
        filter_tree=("ivs", 0, 0, 32768), n_slots=32768))
    # grouped scans at the dense rung's widths, scalar rows at the bound
    for g in (128, 1024, fs.MAX_SCAN_GROUPS):
        add(f"groups{g}", _mk_plan(packed=2, groups=g, strides=(g, 1),
                                   values=1,
                                   aggs=(("count", None, None),
                                         ("sum", ("v", 0), 1))))
    add("groups8192_rows16", _mk_plan(
        packed=1, groups=fs.MAX_SCAN_GROUPS, strides=(1,), values=16,
        aggs=sums))
    add("scalar_rows16_float", _mk_plan(
        values=16, aggs=tuple(("sum", ("v", i), None) for i in range(16)),
        value_is_int=(False,) * 16))
    return shapes


def launch_inputs(pp: "fs.ScanPlan", bits: Tuple[int, ...], device,
                  tiles: int = 3, seed: int = 0):
    """Random inputs a fuzz shape's program can launch on: ``(words,
    values, num_docs)`` for one segment of ``tiles`` tiles ending in a
    remainder tile. A group key column's dictIds stay where their
    strides keep the key inside the plan's groups."""
    import torch

    from pinot_tpu_torch.engine.staging import TILE, pack_planar

    rng = np.random.default_rng(seed)
    n = tiles * TILE
    span = {c: max(1, pp.num_groups_padded // max(1, int(s)))
            for c, s in zip(pp.group_idx, pp.group_strides)}
    words = []
    for c, b in enumerate(bits):
        hi = min(1 << b, span.get(c, 1 << b))
        ids = rng.integers(0, hi, n, dtype=np.int64)
        words.append(torch.from_numpy(pack_planar(ids, b).view(np.int32))
                     .reshape(1, tiles, -1).to(device))
    values = [torch.from_numpy(
        rng.integers(-100, 100, n).astype(np.int32) if is_int
        else rng.normal(0.0, 50.0, n).astype(np.float32)).reshape(1, n)
        .to(device) for is_int in pp.value_is_int]
    num_docs = torch.tensor([n - 123], dtype=torch.int64, device=device)
    return words, values, num_docs


# --------------------------------------------------------------------------
# the plan space: SSB's flights and the fuzz grid -> the verdict table
# --------------------------------------------------------------------------

def preflight_ssb_plans(segs, device: str = "cuda"
                        ) -> Tuple[List[Verdict], Dict[str, Tuple]]:
    """Each SSB flight's scan plan over ``segs[0]`` staged on ``device``
    (a group key space past MAX_SCAN_GROUPS narrows by a probe launch
    there), through ``compile_program``.
    Returns (verdicts, {qid: plan.spec}); the specs are the blocklist keys
    ``seed_blocklist`` uses for predicted failures."""
    from pinot_tpu_torch.engine.plan import plan_segment
    from pinot_tpu_torch.engine.staging import StagedSegment
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.tools import ssb

    staged = StagedSegment(segs[0], device=device)
    verdicts: List[Verdict] = []
    plan_specs: Dict[str, Tuple] = {}
    for qid in sorted(ssb.QUERIES):
        plan = plan_segment(compile_query(ssb.QUERIES[qid]), segs[0])
        plan_specs[qid] = plan.spec
        pp, bits, _eff, reason = extract_query_program(plan, staged)
        if pp is None:
            # declined before a program exists, with extract's own code
            verdicts.append(Verdict(shape=qid, source="ssb", ok=False,
                                    rule=reason,
                                    detail=f"not extractable: {reason}"))
            continue
        verdicts.append(preflight_program(pp, bits, shape=qid,
                                          source="ssb"))
    return verdicts, plan_specs


def run_preflight(segs=None, fuzz: bool = True, rows: int = 6000,
                  device: str = "cuda") -> Dict[str, Any]:
    """The verdict table (the body ``GET /debug/pallas`` carries) over
    ``segs`` (SSB segments; None builds a 2-segment fixture of ``rows``
    rows) and, with ``fuzz``, the fuzz grid."""
    from pinot_tpu_torch.tools import ssb

    if segs is None:
        segs, _frames = ssb.build_segments(0, num_segments=2, rows=rows)
    ssb_verdicts, plan_specs = preflight_ssb_plans(segs, device)
    verdicts = list(ssb_verdicts)
    if fuzz:
        verdicts += [preflight_program(pp, bits, shape=label,
                                       source="fuzz")
                     for label, pp, bits in fuzz_specs()]
    return {
        "limits": {"max_cols": fs.MAX_COLS,
                   "max_filter_stack": fs.MAX_FILTER_STACK,
                   "max_value_stack": fs.MAX_VALUE_STACK,
                   "max_rows": fs.MAX_ROWS,
                   "smem_block_bytes": fs._SMEM_BLOCK_MAX},
        "shapes": [v.row() for v in verdicts],
        "passed": sum(1 for v in verdicts if v.ok),
        "failed": sum(1 for v in verdicts if not v.ok),
        "ssb_failed": [v.shape for v in ssb_verdicts if not v.ok],
        "_plan_specs": plan_specs,   # stripped before serialization
    }


def serializable_table(table: Dict[str, Any]) -> Dict[str, Any]:
    """The verdict table without the in-memory plan specs."""
    return {k: v for k, v in table.items() if not k.startswith("_")}


def seed_blocklist(blocklist, table: Dict[str, Any]) -> int:
    """Add each SSB shape the preflight fails on a kernel limit to
    ``blocklist`` with its rule code (a shape declined before a program
    exists declines there by itself); -> how many were added."""
    plan_specs = table.get("_plan_specs", {})
    n = 0
    for row in table["shapes"]:
        if row["source"] != "ssb" or row["verdict"] == "pass" \
                or row["rule"] not in _CODES:
            continue
        spec = plan_specs.get(row["shape"])
        if spec is None:
            continue
        blocklist.add(spec, reason=row["rule"])
        n += 1
    return n


def attach_verdicts(executor, table: Dict[str, Any]) -> int:
    """The table on the executor's ``GET /debug/pallas``, its failed SSB
    shapes in the executor's blocklist; -> shapes added."""
    executor.preflight_verdicts = serializable_table(table)
    return seed_blocklist(executor._pallas_blocked, table)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m pinot_tpu_torch.tools.preflight",
        description="The fused scan's limits over SSB's flights and a "
                    "fuzzed shape grid.")
    ap.add_argument("--rows", type=int, default=6000,
                    help="fixture rows for the flights' plans")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--no-fuzz", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the fixture is staged (a wide group key "
                         "narrows by a probe launch there)")
    args = ap.parse_args(argv)
    out = serializable_table(run_preflight(rows=args.rows,
                                           fuzz=not args.no_fuzz,
                                           device=args.device))
    if args.as_json:
        print(json.dumps(out, indent=1, sort_keys=True))
    else:
        for row in out["shapes"]:
            mark = ("PASS" if row["verdict"] == "pass"
                    else f"FAIL {row['rule']}: {row['detail']}")
            print(f"{row['source']:4} {row['shape']:22} {mark}")
        print(f"preflight: {out['passed']} pass, {out['failed']} fail "
              f"(ssb failures: {out['ssb_failed'] or 'none'})")
    return 1 if out["ssb_failed"] else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
