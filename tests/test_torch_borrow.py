"""The column borrower in the port against the JAX package's.

A per-segment staging reads a resident batch's device column instead of
uploading it again (JAX ``pinot_tpu/parallel/executor.py:813
_borrow_batch_column``; oracle ``tests/test_launcher.py:506``, ``:532``).
The same JAX-built segments carried across with ``columns_of`` run through
the JAX ``ShardedQueryExecutor`` (its jnp path on the CPU) and the port's
``ShardedQueryExecutor(device="cpu", use_fused_scan=False)`` (the jnp
combine stages the batch's general-rung columns, which the per-segment
general rung then borrows): a one-segment query after a batch query
borrows in both, with rows equal to the JAX host executor's; ``dictvals``
is the batch's tensor while the ``fwd`` row is a copy; a segment whose
dictionary is not the unified one borrows at most its identity-remapped
columns; evicting the lending batch leaves residency's bytes right; and
the eviction cost ranks a segment a resident batch holds as a borrowed
build.
"""

import numpy as np
import pytest

from pinot_tpu.engine import ServerQueryExecutor as JaxExecutor
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded
from pinot_tpu.query import compile_query as j_compile
from pinot_tpu.segment import SegmentBuilder, load_segment
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema
from pinot_tpu.spi.table import IndexingConfig
from pinot_tpu_torch.engine import residency as t_residency
from pinot_tpu_torch.engine.staging import StagedSegment
from pinot_tpu_torch.parallel import ShardedQueryExecutor
from pinot_tpu_torch.query import compile_query as t_compile
from pinot_tpu_torch.segment import columns_of, segment_from_arrays

DOCS = 1500
SQL = ("SELECT region, sum(qty), max(raw_amt) FROM sales "
       "GROUP BY region ORDER BY region")


def _schema():
    return Schema("sales", [
        FieldSpec("region", DataType.STRING),
        FieldSpec("kind", DataType.STRING),
        FieldSpec("qty", DataType.LONG, FieldType.METRIC),
        FieldSpec("raw_amt", DataType.LONG, FieldType.METRIC),
    ])


def carry(jsegs):
    return [segment_from_arrays(j.segment_name, j.num_docs, columns_of(j),
                                table_name="sales") for j in jsegs]


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    """3 segments, each holding every region, kind and qty value (its
    dictionaries equal the unified ones: the identity remap the borrow
    needs); ``raw_amt`` is raw."""
    out = tmp_path_factory.mktemp("torch_borrow")
    rng = np.random.default_rng(11)
    regions, kinds = ["east", "west", "north", "south"], ["a", "b", "c"]
    jsegs = []
    for i in range(3):
        b = SegmentBuilder(_schema(), f"sales_{i}",
                           indexing_config=IndexingConfig(
                               no_dictionary_columns=["raw_amt"]))
        b.build({
            "region": regions + [regions[j] for j in
                                 rng.integers(0, 4, DOCS - 4)],
            "kind": kinds + [kinds[j] for j in rng.integers(0, 3, DOCS - 3)],
            "qty": list(np.r_[np.arange(1, 50),
                              rng.integers(1, 50, DOCS - 49)]),
            "raw_amt": list(rng.integers(0, 10_000, DOCS)),
        }, str(out))
        jsegs.append(load_segment(str(out / f"sales_{i}")))
    return jsegs, carry(jsegs)


def _port():
    return ShardedQueryExecutor(device="cpu", use_fused_scan=False)


def _batch_of(ex, segments):
    return ex._batches[tuple(s.segment_name for s in segments)]


def test_per_segment_query_after_a_batch_query_borrows(segs):
    jsegs, tsegs = segs
    jdev, port = JSharded(), _port()
    jdev.execute(j_compile(SQL), jsegs)
    port.execute(t_compile(SQL), tsegs)
    assert port.residency.stats_snapshot()["borrows"] == 0
    got, stats = port.execute(t_compile(SQL), [tsegs[0]])
    jgot, _ = jdev.execute(j_compile(SQL), [jsegs[0]])
    want, _ = JaxExecutor(use_device=False).execute(j_compile(SQL),
                                                    [jsegs[0]])
    assert got.rows == want.rows == jgot.rows
    assert stats.general_launches == 1
    # region and qty (identity remaps) and raw_amt (the same raw values)
    assert port.residency.stats_snapshot()["borrows"] == 3
    assert jdev.residency.stats_snapshot()["borrows"] >= 1


def test_dictvals_is_the_batch_tensor_and_rows_are_copies(segs):
    _, tsegs = segs
    port = _port()
    port.execute(t_compile(SQL), tsegs)
    port.execute(t_compile(SQL), [tsegs[1]])
    _, batch = _batch_of(port, tsegs)
    staged = port.residency.stage(tsegs[1])
    mine, lent = staged.column("qty"), batch.column("qty")
    assert mine.dictvals.data_ptr() == lent.dictvals.data_ptr()
    # the row is a copy on the device: a view would keep the whole batch
    # alive after the batch's eviction
    assert mine.fwd.untyped_storage().data_ptr() \
        != lent.fwd.untyped_storage().data_ptr()
    assert mine.fwd.shape == (tsegs[1].padded_capacity,)
    assert bool((mine.fwd == lent.fwd[1]).all())
    own = StagedSegment(tsegs[1], device="cpu").column("qty")
    assert bool((own.fwd == mine.fwd).all())
    assert bool((own.dictvals == mine.dictvals).all())
    assert own.fwd.dtype == mine.fwd.dtype
    raw = staged.column("raw_amt")
    assert raw.dictvals is None and bool(
        (raw.fwd == StagedSegment(tsegs[1], device="cpu")
         .column("raw_amt").fwd).all())


def test_incompatible_remaps_stage_their_own(tmp_path):
    """A segment whose dictionary differs from the unified one borrows at
    most its identity-remapped column (JAX :532)."""
    jsegs = []
    for i, vals in enumerate((["aa", "bb"], ["bb", "cc"])):
        b = SegmentBuilder(Schema("skew", [
            FieldSpec("d", DataType.STRING),
            FieldSpec("m", DataType.LONG, FieldType.METRIC)]), f"skew_{i}")
        b.build({"d": [vals[j % 2] for j in range(64)],
                 "m": list(range(64))}, str(tmp_path))
        jsegs.append(load_segment(str(tmp_path / f"skew_{i}")))
    tsegs = [segment_from_arrays(j.segment_name, j.num_docs, columns_of(j),
                                 table_name="skew") for j in jsegs]
    sql = "SELECT d, sum(m) FROM skew GROUP BY d ORDER BY d"
    jdev, port = JSharded(), _port()
    jdev.execute(j_compile(sql), jsegs)
    port.execute(t_compile(sql), tsegs)
    j0 = jdev.residency.stats_snapshot()["borrows"]
    got, _ = port.execute(t_compile(sql), [tsegs[1]])
    jgot, _ = jdev.execute(j_compile(sql), [jsegs[1]])
    want, _ = JaxExecutor(use_device=False).execute(j_compile(sql),
                                                    [jsegs[1]])
    assert got.rows == want.rows == jgot.rows
    # 'm' (the same value set) borrows, 'd' ('bb' is unified id 1, its own
    # id 0) never
    assert port.residency.stats_snapshot()["borrows"] == 1
    assert jdev.residency.stats_snapshot()["borrows"] - j0 <= 1
    staged = port.residency.stage(tsegs[1])
    _, batch = _batch_of(port, tsegs)
    assert staged.column("d").fwd.data_ptr() \
        != batch.column("d").fwd.data_ptr()
    assert staged.column("d").fwd.tolist()[:2] == [0, 1]


def test_evicting_the_lender_leaves_the_bytes_right(segs):
    _, tsegs = segs
    port = _port()
    port.execute(t_compile(SQL), tsegs)
    got, _ = port.execute(t_compile(SQL), [tsegs[2]])
    assert port.residency.stats_snapshot()["borrows"] == 3
    batch, staged_batch = _batch_of(port, tsegs)
    port._evict_batch(batch)
    assert staged_batch.nbytes() == 0
    name = tsegs[2].segment_name
    assert port.residency.resident_names() == [name]
    own = _port()
    own.execute(t_compile(SQL), [tsegs[2]])
    # what the segment holds is what it would hold had it staged its own
    assert port.residency.stats_snapshot()["stagedBytes"] \
        == port.residency.resident_nbytes(name) \
        == own.residency.resident_nbytes(name) > 0
    again, _ = port.execute(t_compile(SQL), [tsegs[2]])
    assert again.rows == got.rows


def test_a_borrowing_segment_ranks_as_a_borrowed_build(segs):
    _, tsegs = segs
    port = _port()
    port.execute(t_compile(SQL), tsegs)
    port.execute(t_compile(SQL), [tsegs[0]])
    mgr = port.residency
    name = tsegs[0].segment_name
    with mgr._lock:
        cost = mgr._rebuild_cost_locked(name, mgr._entries[name])
    assert cost == t_residency.COST_BORROWED_BUILD
    port._evict_batch(_batch_of(port, tsegs)[0])
    with mgr._lock:
        cost = mgr._rebuild_cost_locked(name, mgr._entries[name])
    assert cost == t_residency.COST_COLUMN_BUILD
    assert t_residency.COST_HOST_RESTAGE < t_residency.COST_BATCH_RESTAGE \
        < t_residency.COST_BORROWED_BUILD < t_residency.COST_COLUMN_BUILD


def test_borrow_touches_the_lending_batch(segs):
    _, tsegs = segs
    port = _port()
    port.execute(t_compile(SQL), tsegs)
    port.execute(t_compile(SQL), [tsegs[1]])
    bname = _batch_of(port, tsegs)[0].segment_name
    # the segment was staged (touched) before its columns were borrowed:
    # the borrows touched the batch after it
    assert port.residency.resident_names() == [tsegs[1].segment_name,
                                               bname]
    port.residency.stage(tsegs[1])
    assert port.residency.resident_names()[-1] == tsegs[1].segment_name
    port.residency.note_borrow(bname)
    assert port.residency.resident_names()[-1] == bname


def test_no_borrow_from_a_stale_or_wider_batch(segs):
    jsegs, tsegs = segs
    port = _port()
    port.execute(t_compile(SQL), tsegs)
    # a reloaded segment (same name, new object) stages its own
    reloaded = carry([jsegs[0]])[0]
    port.residency.evict(reloaded.segment_name)
    port.execute(t_compile(SQL), [reloaded])
    assert port.residency.stats_snapshot()["borrows"] == 0
    # a batch whose capacity differs from the segment's lends nothing
    bigger = carry(jsegs)
    big_frame = columns_of(jsegs[1])
    big = segment_from_arrays("sales_big", jsegs[1].num_docs * 4,
                              {n: _tiled(a, 4) for n, a in
                               big_frame.items()}, table_name="sales")
    port2 = _port()
    port2.execute(t_compile(SQL), [bigger[0], big])
    assert big.padded_capacity > bigger[0].padded_capacity
    port2.execute(t_compile(SQL), [bigger[0]])
    assert port2.residency.stats_snapshot()["borrows"] == 0


def _tiled(arrays, k):
    """A column's arrays repeated ``k`` times (a larger segment with the
    same dictionary)."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(arrays):
        v = getattr(arrays, f.name)
        if f.name in ("dict_ids", "values") and v is not None:
            v = np.tile(np.asarray(v), k)
        out[f.name] = v
    return type(arrays)(**out)


def test_the_fused_scan_borrows_nothing(segs):
    """Packed dictIds and value columns follow the port's own layouts (the
    unified cardinality's bit width, tile padding): never borrowed."""
    _, tsegs = segs
    port = ShardedQueryExecutor(device="cpu")
    port.execute(t_compile(SQL), tsegs)
    got, stats = port.execute(t_compile(SQL), [tsegs[0]])
    assert stats.general_launches == 0
    assert port.residency.stats_snapshot()["borrows"] == 0
    staged = port.residency.stage(tsegs[0])
    assert staged._columns == {}
