"""Storage and kernel microbenchmarks (the pinot-perf JMH equivalent).

Counterpart of ``pinot_tpu/tools/microbench.py``: the same seven entries
over the port's own primitives. The host helpers come from
``pinot_tpu_torch.native`` (built with ``g++`` at first use); the scan and
group-by entries are torch ops on the card, each call timed up to
``torch.cuda.synchronize()``. Usage:

    python -m pinot_tpu_torch.tools.microbench [--device cpu] [name ...]

It runs on ``"cuda"`` unless ``--device cpu`` is given, and prints one JSON
line a benchmark: its name and its rates, under the JAX entries' keys
(``backend`` is the torch device type on the two torch entries).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

N_ROWS = 1 << 20


def _timed(fn: Callable[[], None], min_time_s: float = 0.5,
           warmup: int = 2) -> Tuple[float, int]:
    """(seconds per call, iterations)."""
    for _ in range(warmup):
        fn()
    iters = 0
    t0 = time.perf_counter()
    while True:
        fn()
        iters += 1
        dt = time.perf_counter() - t0
        if dt >= min_time_s:
            return dt / iters, iters


def bench_bitpack(device: str = "cuda") -> Dict:
    """Fixed-bit pack/unpack (BenchmarkFixedBitSVForwardIndexReader)."""
    from pinot_tpu_torch import native

    rng = np.random.default_rng(1)
    ids = rng.integers(0, 1 << 7, N_ROWS).astype(np.int32)
    packed = native.bitpack(ids, 7)
    t_pack, _ = _timed(lambda: native.bitpack(ids, 7))
    t_unpack, _ = _timed(lambda: native.bitunpack(packed, N_ROWS, 7))
    return {"pack_Mrows_s": round(N_ROWS / t_pack / 1e6, 1),
            "unpack_Mrows_s": round(N_ROWS / t_unpack / 1e6, 1),
            "native": native.library_path() is not None}


def bench_varint_postings(device: str = "cuda") -> Dict:
    """Posting-list encode/decode (the RoaringBitmap benchmarks)."""
    from pinot_tpu_torch import native

    rng = np.random.default_rng(2)
    docs = np.unique(rng.integers(0, N_ROWS, N_ROWS // 4)).astype(np.int32)
    blob = native.varint_encode(docs)
    t_enc, _ = _timed(lambda: native.varint_encode(docs))
    t_dec, _ = _timed(lambda: native.varint_decode(blob, len(docs)))
    return {"encode_Mdocs_s": round(len(docs) / t_enc / 1e6, 1),
            "decode_Mdocs_s": round(len(docs) / t_dec / 1e6, 1)}


def bench_dictionary(device: str = "cuda") -> Dict:
    """Sorted-dictionary lookups (BenchmarkDictionary)."""
    from pinot_tpu_torch.segment.dictionary import build_dictionary
    from pinot_tpu_torch.spi.data import DataType

    vals = np.unique(np.random.default_rng(3).integers(0, 1 << 30, 100_000))
    d = build_dictionary(vals, DataType.LONG)
    probes = vals[::7]

    def lookups():
        for v in probes[:1000]:
            d.index_of(int(v))

    t, _ = _timed(lookups)
    return {"index_of_Mops_s": round(1000 / t / 1e6, 3)}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_scan_kernel(device: str = "cuda") -> Dict:
    """Masked filtered sum over 1M rows on the card, the
    SVScanDocIdIterator analogue (BenchmarkScanDocIdIterators)."""
    import torch

    from pinot_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(4)
    fwd = torch.from_numpy(rng.integers(0, 1000, N_ROWS)
                           .astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.random(N_ROWS).astype(np.float32)).to(dev)
    lo, hi = 100, 300

    def scan():
        m = (fwd >= lo) & (fwd <= hi)
        out = (torch.where(m, vals, 0).sum(), m.sum())
        _sync(dev)
        return out

    t, _ = _timed(scan)
    return {"Mrows_s": round(N_ROWS / t / 1e6, 1), "backend": dev.type}


def bench_group_by_kernel(device: str = "cuda") -> Dict:
    """Keyed segment sum over 1M rows on the card (BenchmarkCombineGroupBy)."""
    import torch

    from pinot_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 1024, N_ROWS)
                            .astype(np.int64)).to(dev)
    vals = torch.from_numpy(rng.random(N_ROWS).astype(np.float32)).to(dev)

    def grouped():
        out = torch.zeros(1024, dtype=vals.dtype, device=dev)
        out.index_add_(0, keys, vals)
        _sync(dev)
        return out

    t, _ = _timed(grouped)
    return {"Mrows_s": round(N_ROWS / t / 1e6, 1), "backend": dev.type}


def bench_datatable_wire(device: str = "cuda") -> Dict:
    """Binary columnar DataTable round trip (BenchmarkDataTableSerDe)."""
    from pinot_tpu_torch.common.datatable import DataTable
    from pinot_tpu_torch.engine.results import DataSchema, QueryStats

    rng = np.random.default_rng(6)
    n = 50_000
    schema = DataSchema(["s", "i", "f"], ["STRING", "LONG", "DOUBLE"])
    rows = [[f"key{i % 1000}", int(v), float(v) / 3]
            for i, v in enumerate(rng.integers(0, 1 << 40, n))]
    dt = DataTable.for_selection(schema, rows, QueryStats())
    raw = dt.to_bytes()
    t_ser, _ = _timed(lambda: dt.to_bytes())
    t_de, _ = _timed(lambda: DataTable.from_bytes(raw))
    return {"serialize_Mrows_s": round(n / t_ser / 1e6, 2),
            "deserialize_Mrows_s": round(n / t_de / 1e6, 2),
            "bytes_per_row": round(len(raw) / n, 1)}


def bench_sql_parse(device: str = "cuda") -> Dict:
    """Parser throughput (the BenchmarkQueryParser equivalents)."""
    from pinot_tpu_torch.query import compile_query

    sql = ("SELECT a, b, sum(x), avg(y) FROM t WHERE a IN ('p','q') AND "
           "ts BETWEEN 100 AND 900 AND b != 'z' GROUP BY a, b "
           "ORDER BY sum(x) DESC LIMIT 50")
    t, _ = _timed(lambda: compile_query(sql))
    return {"queries_per_s": round(1 / t, 0)}


BENCHMARKS: Dict[str, Callable[..., Dict]] = {
    "bitpack": bench_bitpack,
    "varint_postings": bench_varint_postings,
    "dictionary": bench_dictionary,
    "scan_kernel": bench_scan_kernel,
    "group_by_kernel": bench_group_by_kernel,
    "datatable_wire": bench_datatable_wire,
    "sql_parse": bench_sql_parse,
}


def run(names: Optional[List[str]] = None,
        device: str = "cuda") -> List[Dict]:
    """One result dict a benchmark (``{"bench": name, ...}``)."""
    chosen = names or sorted(BENCHMARKS)
    unknown = [n for n in chosen if n not in BENCHMARKS]
    if unknown:
        raise KeyError(f"unknown benchmarks {unknown}; "
                       f"have {sorted(BENCHMARKS)}")
    return [{"bench": name, **BENCHMARKS[name](device)} for name in chosen]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pinot_tpu_torch.tools.microbench")
    ap.add_argument("names", nargs="*", help="benchmarks (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="device of the scan and group-by entries")
    args = ap.parse_args(argv)
    try:
        results = run(args.names, args.device)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2
    for r in results:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
