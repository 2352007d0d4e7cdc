"""The broker's merge over a mesh of 8 CPU cells against the JAX merge on
the 8 virtual devices of ``tests/conftest.py``.

Oracle: ``tests/test_reduce_device.py``'s ``eight_devices`` cases, run on
the port's ``BrokerReduceService(devices=["cpu"] * 8)``
(``parallel/reduce_device.py`` ``broker_mesh``): group-by parity (:80),
the sort rung (:109), the slice-exchange flavor past ``_PSUM_SLOTS``
(:128), the ``numGroupsLimit`` trim (:149) and the SSB flights (:214).
Results are bit-identical (cells and their types) to JAX's device merge
and to the row oracle, the ``reduce:`` decisions equal, and the device
path serves. ``device_group_merge`` over 8 cells is held leaf by leaf to
JAX's ``device_group_merge(broker_mesh(), ...)`` on each rung and
flavor, and to the port's one-cell merge.
"""

import numpy as np
import pytest
import torch

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.broker.reduce import BrokerReduceService as JReduce  # noqa: E402
from pinot_tpu.parallel import reduce_device as j_rdev  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.broker.reduce import BrokerReduceService  # noqa: E402
from pinot_tpu_torch.parallel import reduce_device as t_rdev  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402

from tests.test_torch_reduce import (  # noqa: E402
    PARITY_SQL,
    _gb_build,
    _merge_case,
    _pair_tables,
    _parity_tables,
    _reduce_keys,
    assert_bit_identical,
    ssb_server_tables,  # noqa: F401 - the module fixture
)

pytestmark = pytest.mark.reduce_device

CELLS = ["cpu"] * 8


def _mesh_service(**kw):
    return BrokerReduceService(devices=CELLS, device_reduce=True, **kw)


def _run(sql, tables, **kw):
    """(port result, port stats) over 8 cells, bit-identical to JAX's
    device merge on its 8 devices and to the port's row oracle, with
    equal ``reduce:`` decisions."""
    pt, jt = tables
    pr, ps, pe = _mesh_service(**kw).reduce(t_compile(sql), pt)
    jr, js, je = JReduce(vectorized=True, device_reduce=True,
                         **kw).reduce(j_compile(sql), jt)
    assert_bit_identical(pr, jr, sql)
    assert _reduce_keys(ps) == _reduce_keys(js), sql
    assert ps.reduce_path == js.reduce_path, sql
    assert ps.num_groups_limit_reached == js.num_groups_limit_reached
    assert pe == je
    orr, _, _ = BrokerReduceService(device="cpu", vectorized=False,
                                    **kw).reduce(t_compile(sql), pt)
    assert_bit_identical(pr, orr, sql)
    return pr, ps


def test_service_mesh_is_the_devices():
    svc = _mesh_service()
    assert svc.devices == tuple(torch.device("cpu") for _ in CELLS)
    assert svc.device == torch.device("cpu")
    assert BrokerReduceService(device="cpu").devices == (
        torch.device("cpu"),)


def test_broker_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: broker_mesh() is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        t_rdev.broker_mesh()
    assert t_rdev.broker_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2


@pytest.mark.parametrize("sql", PARITY_SQL)
def test_group_by_parity(sql, eight_devices):
    _, ps = _run(sql, _parity_tables(sql, PARITY_SQL.index(sql) + 11))
    assert ps.reduce_path == "device"
    assert not _reduce_keys(ps)


def test_sort_rung_parity(monkeypatch, eight_devices):
    monkeypatch.setattr(t_rdev, "DENSE_SLOTS", 1)
    monkeypatch.setattr(j_rdev, "DENSE_SLOTS", 1)
    sql = ("SELECT k, sum(v), count(*) FROM t GROUP BY k "
           "ORDER BY sum(v) DESC, k LIMIT 500")
    tables = _pair_tables(_gb_build(
        3, 6, 500, lambda r: [float(r.randint(0, 9999)), r.randint(1, 5)],
        lambda r: (r.randint(-(1 << 40), 1 << 40),),
        schema_types={"k": "LONG"}))
    acc = _mesh_service().accumulator(t_compile(sql))
    for t in tables[0]:
        acc.add(t)
    acc.finish()
    assert acc.merge_rung == "sort"
    _, ps = _run(sql, tables)
    assert ps.reduce_path == "device"


def test_slice_exchange_parity(monkeypatch, eight_devices):
    """Dense slot spaces past ``_PSUM_SLOTS`` fold by slices: each cell
    one slice of every partial."""
    monkeypatch.setattr(t_rdev, "_PSUM_SLOTS", 1)
    monkeypatch.setattr(j_rdev, "_PSUM_SLOTS", 1)
    calls = []
    real = t_rdev._slice_exchange

    def spy(parts, op, identity, mesh):
        calls.append((len(parts), op, len(mesh)))
        return real(parts, op, identity, mesh)

    monkeypatch.setattr(t_rdev, "_slice_exchange", spy)
    sql = ("SELECT k, sum(v), min(v), max(v), count(*) FROM t GROUP BY k "
           "ORDER BY sum(v) DESC, k LIMIT 500")
    tables = _pair_tables(_gb_build(
        7, 6, 500,
        lambda r: [float(r.randint(0, 9999)), float(r.randint(0, 99)),
                   float(r.randint(100, 199)), r.randint(1, 5)],
        lambda r: (r.randint(0, 800),), schema_types={"k": "INT"}))
    _, ps = _run(sql, tables)
    assert ps.reduce_path == "device"
    # the arrival index and the four states, each over the 8 cells
    assert sorted(c[1] for c in calls) == ["max", "min", "min", "sum", "sum"]
    assert all(c[0] == 8 and c[2] == 8 for c in calls)


def test_num_groups_limit_trim(eight_devices):
    sql = "SELECT k, count(*) FROM t GROUP BY k LIMIT 100000"
    tables = _pair_tables(_gb_build(
        11, 4, 60, lambda r: [r.randint(1, 5)],
        lambda r: (r.randint(0, 500),), schema_types={"k": "INT"}))
    pr, ps = _run(sql, tables, num_groups_limit=50)
    assert ps.reduce_path == "device"
    assert ps.num_groups_limit_reached and len(pr.rows) == 50


@pytest.mark.parametrize("qid", sorted(j_ssb.QUERIES))
def test_ssb_flights(ssb_server_tables, qid, eight_devices):  # noqa: F811
    sql, tables, whole = ssb_server_tables[qid]
    pr, ps = _run(sql, tables)
    grouped = t_compile(sql).is_group_by \
        and any(t.num_rows() for t in tables[0])
    assert ps.reduce_path == ("device" if grouped else "vectorized")
    assert not _reduce_keys(ps)
    assert_bit_identical(pr, whole, qid)


@pytest.mark.parametrize("flavor", ["dense", "slices", "sort"])
@pytest.mark.parametrize("n", [1, 7, 300, 4099])
def test_merge_leaf_by_leaf(flavor, n, monkeypatch, eight_devices):
    if flavor == "sort":
        monkeypatch.setattr(t_rdev, "DENSE_SLOTS", 0)
        monkeypatch.setattr(j_rdev, "DENSE_SLOTS", 0)
    if flavor == "slices":
        monkeypatch.setattr(t_rdev, "_PSUM_SLOTS", 1)
        monkeypatch.setattr(j_rdev, "_PSUM_SLOTS", 1)
    ops = ["sum", "sum", "min", "max", "min", "max"]
    comp, space, vals = _merge_case(n, n, 97, ops)
    first, folded = t_rdev.device_group_merge(comp, space, vals, ops, CELLS)
    one_first, one_folded = t_rdev.device_group_merge(comp, space, vals,
                                                      ops, "cpu")
    jfirst, jfolded = j_rdev.device_group_merge(j_rdev.broker_mesh(), comp,
                                                space, vals, ops)
    assert first.dtype == np.int64 and np.array_equal(first, jfirst)
    assert np.array_equal(first, one_first)
    for got, one, want in zip(folded, one_folded, jfolded):
        want = np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(got, one)


def test_merge_cap_matches_jax_on_eight_devices():
    for n in (0, 1, 7, 8, 9, 1000, 4097):
        assert t_rdev._merge_cap(n, 8) == j_rdev._merge_cap(n, 8)
