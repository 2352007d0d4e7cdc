"""The geo index: the port's grid cells, index files, reader and the
``ST_DISTANCE`` filter path against the JAX package's (oracle
tests/test_geospatial.py:88-158).

The same seeded WKT points (clustered near one city, scattered over a
continent) go through JAX's ``SegmentBuilder`` and the port's with an H3
field config:

- the cell functions equal JAX's over random points and radii;
- the four ``geo*`` files are byte-equal, the rest of the directory too,
  and ``metadata.json`` differs only in the creation time;
- ``ids_within`` equals JAX's for the same centers and radii;
- ``count(*)`` / ``sum(v)`` under ``ST_DISTANCE(loc, 'POINT…') < r``
  equal a numpy haversine oracle and JAX's, with and without the index,
  through both host engines, with the same ``plan:`` decisions and no
  device launch;
- each package loads the other's geo segment and answers the same;
- the in-memory segment (``segment_from_arrays(..., geo_columns=)``)
  serves the index as the loaded one does; a reload adds none, as in JAX.
"""

import json
import os

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JExecutor  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import SegmentBuilder as JBuilder  # noqa: E402
from pinot_tpu.segment import load_segment as j_load  # noqa: E402
from pinot_tpu.spi import data as jdata  # noqa: E402
from pinot_tpu.spi import table as jtable  # noqa: E402
from pinot_tpu.utils import geo as jgeo  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.segment.creator import SegmentBuilder  # noqa: E402
from pinot_tpu_torch.segment.immutable import load_segment  # noqa: E402
from pinot_tpu_torch.spi import data as tdata  # noqa: E402
from pinot_tpu_torch.spi import table as ttable  # noqa: E402
from pinot_tpu_torch.utils import geo as tgeo  # noqa: E402

N = 3000
CENTERS = [(-122.4, 37.77), (-122.41, 37.76), (-100.0, 40.0)]
RADII = [100.0, 500.0, 2500.0, 5000.0, 300_000.0]


def _schema(mod):
    return mod.Schema("places", [
        mod.FieldSpec("loc", mod.DataType.STRING),
        mod.FieldSpec("v", mod.DataType.LONG, mod.FieldType.METRIC)])


def _config(mod, res="10"):
    return mod.TableConfig(table_name="places", field_config_list=[
        mod.FieldConfig("loc", index_type="H3",
                        properties={"resolutions": res})])


def _points(seed=31, n=N):
    rng = np.random.default_rng(seed)
    near = rng.integers(0, 2, n).astype(bool)
    lngs = np.where(near, -122.4 + rng.normal(0, 0.02, n),
                    rng.uniform(-120, -70, n))
    lats = np.where(near, 37.77 + rng.normal(0, 0.02, n),
                    rng.uniform(25, 48, n))
    wkt = [f"SRID=4326;POINT ({x:.6f} {y:.6f})" for x, y in zip(lngs, lats)]
    return wkt, np.round(lngs, 6), np.round(lats, 6)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    wkt, lngs, lats = _points()
    rows = {"loc": wkt, "v": list(range(N))}
    jdir = str(tmp_path_factory.mktemp("jax"))
    tdir = str(tmp_path_factory.mktemp("port"))
    JBuilder(_schema(jdata), "p0", table_config=_config(jtable)).build(
        rows, jdir)
    SegmentBuilder(_schema(tdata), "p0", table_config=_config(ttable)).build(
        {"loc": np.asarray(wkt), "v": np.arange(N, dtype=np.int64)}, tdir)
    # the same rows without the index
    JBuilder(_schema(jdata), "plain").build(rows, jdir)
    SegmentBuilder(_schema(tdata), "plain").build(
        {"loc": np.asarray(wkt), "v": np.arange(N, dtype=np.int64)}, tdir)
    return {"jdir": os.path.join(jdir, "p0"), "tdir": os.path.join(tdir, "p0"),
            "jplain": os.path.join(jdir, "plain"),
            "tplain": os.path.join(tdir, "plain"),
            "lngs": lngs, "lats": lats}


def test_cells_equal_jax():
    rng = np.random.default_rng(5)
    lngs = rng.uniform(-180, 180, 500)
    lats = rng.uniform(-90, 90, 500)
    for res in (4, 9, 12):
        assert np.array_equal(tgeo.cells_of(lngs, lats, res),
                              jgeo.cells_of(lngs, lats, res))
        for x, y in zip(lngs[:20], lats[:20]):
            assert tgeo.cell_of(x, y, res) == jgeo.cell_of(x, y, res)
    for (x, y), r in zip([(0.0, 60.0), (-122.4, 37.77), (10.0, 89.9)],
                         [1_270_000, 3000, 5000]):
        for res in (6, 9, 12):
            assert tgeo.cell_disk(x, y, r, res) == jgeo.cell_disk(x, y, r, res)


def _files(seg_dir):
    return sorted(os.path.relpath(os.path.join(r, f), seg_dir)
                  for r, _d, fs in os.walk(seg_dir) for f in fs
                  if f != "metadata.json")


@pytest.mark.parametrize("pair", [("jdir", "tdir"), ("jplain", "tplain")])
def test_index_files_byte_equal(built, pair):
    jd, td = built[pair[0]], built[pair[1]]
    assert _files(jd) == _files(td)
    for rel in _files(jd):
        with open(os.path.join(jd, rel), "rb") as a, \
                open(os.path.join(td, rel), "rb") as b:
            assert a.read() == b.read(), rel
    geo_files = {f for f in _files(jd) if ".geo" in f}
    want = {f"columns/loc.{s}.npy"
            for s in ("geocells", "geolng", "geolat", "geometa")}
    assert geo_files == (want if pair[0] == "jdir" else set())
    jm = json.load(open(os.path.join(jd, "metadata.json")))
    tm = json.load(open(os.path.join(td, "metadata.json")))
    assert {k for k in jm if jm[k] != tm[k]} <= {"creationTimeMs"}
    assert tm["columns"]["loc"]["hasGeoIndex"] == (pair[0] == "jdir")


def test_ids_within_equal(built):
    jr = j_load(built["jdir"]).data_source("loc").geo_index
    tr = load_segment(built["tdir"]).data_source("loc").geo_index
    assert tr is not None and tr.resolution == jr.resolution == 10
    for x, y in CENTERS:
        for r in RADII:
            for inclusive in (True, False):
                assert np.array_equal(
                    tr.ids_within(x, y, r, inclusive=inclusive),
                    jr.ids_within(x, y, r, inclusive=inclusive))
            assert np.array_equal(tr.candidate_dict_ids(x, y, r),
                                  jr.candidate_dict_ids(x, y, r))


def _sqls():
    for x, y in CENTERS:
        for r in RADII:
            pt = f"SRID=4326;POINT ({x} {y})"
            yield (x, y, r, f"SELECT count(*), sum(v) FROM places "
                            f"WHERE stdistance(loc, '{pt}') < {r}")


def _host_decisions(stats):
    return {k: v for k, v in stats.decisions.items()
            if k.startswith("plan:")}


@pytest.mark.parametrize("which", ["tdir", "tplain", "jdir", "jplain"])
def test_distance_parity_through_both_engines(built, which):
    """The port's executor over its own or JAX's directory (with and
    without the index) against the numpy oracle and JAX's executor over
    JAX's directory of the same kind; the index path and the scan path
    give the same rows and decisions."""
    indexed = which in ("tdir", "jdir")
    tseg = load_segment(built[which])
    jseg = j_load(built["jdir" if indexed else "jplain"])
    assert (tseg.data_source("loc").geo_index is not None) == indexed
    tex = ServerQueryExecutor(device="cpu")
    jex = JExecutor()
    lngs, lats = built["lngs"], built["lats"]
    v = np.arange(N)
    for x, y, r, sql in _sqls():
        keep = tgeo.haversine_m(lngs, lats, x, y) < r
        want = [int(keep.sum()), float(v[keep].sum()) if keep.any() else None]
        got, gs = tex.execute(t_compile(sql), [tseg])
        jt, js = jex.execute(j_compile(sql), [jseg])
        assert got.rows[0][0] == jt.rows[0][0] == want[0], sql
        if want[0]:
            assert got.rows[0][1] == pytest.approx(want[1], rel=1e-9)
            assert jt.rows[0][1] == pytest.approx(want[1], rel=1e-9)
        assert _host_decisions(gs) == _host_decisions(js), sql
        assert gs.scan_launches == 0


def test_jax_reads_port_geo_segment(built):
    jseg = j_load(built["tdir"])
    assert jseg.metadata.column("loc").has_geo_index
    jex = JExecutor()
    lngs, lats = built["lngs"], built["lats"]
    for x, y, r, sql in _sqls():
        keep = tgeo.haversine_m(lngs, lats, x, y) < r
        jt, _ = jex.execute(j_compile(sql), [jseg])
        assert jt.rows[0][0] == int(keep.sum())


def test_in_memory_segment_serves_the_index(built):
    wkt, lngs, lats = _points()
    seg = SegmentBuilder(_schema(tdata), "mem", table_config=_config(
        ttable, "10,11")).build({"loc": np.asarray(wkt),
                                 "v": np.arange(N, dtype=np.int64)})
    reader = seg.data_source("loc").geo_index
    assert reader is not None and reader.resolution == 10
    assert seg.metadata.columns["loc"].has_geo_index
    disk = load_segment(built["tdir"]).data_source("loc").geo_index
    assert np.array_equal(reader.cells, disk.cells)
    tex = ServerQueryExecutor(device="cpu")
    for x, y, r, sql in _sqls():
        keep = tgeo.haversine_m(lngs, lats, x, y) < r
        got, _ = tex.execute(t_compile(sql), [seg])
        assert got.rows[0][0] == int(keep.sum())


def test_non_point_values_build_no_index(tmp_path):
    """A polygon among the values declines the build, as JAX's does."""
    vals = ["SRID=4326;POINT (1 2)",
            "SRID=4326;POLYGON ((0 0, 1 0, 1 1, 0 1, 0 0))"]
    rows = {"loc": vals, "v": [1, 2]}
    JBuilder(_schema(jdata), "s", table_config=_config(jtable)).build(
        rows, str(tmp_path / "j"))
    SegmentBuilder(_schema(tdata), "s", table_config=_config(ttable)).build(
        {"loc": np.asarray(vals), "v": np.asarray([1, 2])},
        str(tmp_path / "t"))
    assert not load_segment(str(tmp_path / "t" / "s")).metadata.columns[
        "loc"].has_geo_index
    assert not j_load(str(tmp_path / "j" / "s")).metadata.column(
        "loc").has_geo_index


def test_planar_center_and_other_shapes_decline(built):
    """A planar center, a lower bound, or the literal first: the index
    declines (the scan answers), as in JAX."""
    from pinot_tpu_torch.engine import host_eval

    tseg = load_segment(built["tdir"])
    jseg = j_load(built["jdir"])
    tex = ServerQueryExecutor(device="cpu")
    jex = JExecutor()
    for where in ("stdistance(loc, 'POINT (-122.4 37.77)') < 3",
                  "stdistance(loc, 'SRID=4326;POINT (-122.4 37.77)') > 3000",
                  "stdistance('SRID=4326;POINT (-122.4 37.77)', loc) < 3000"):
        sql = f"SELECT count(*) FROM places WHERE {where}"
        got, _ = tex.execute(t_compile(sql), [tseg])
        jt, _ = jex.execute(j_compile(sql), [jseg])
        assert got.rows == jt.rows, sql
        pred = t_compile(sql).filter.predicate
        swapped = "('SRID" in where
        assert (host_eval._try_geo_index(tseg, pred) is not None) == swapped


def test_reload_adds_no_geo_index(built, tmp_path):
    """JAX's preprocessor builds no geo index on reload; neither does the
    port's."""
    import shutil

    from pinot_tpu_torch.segment.preprocessor import preprocess_segment

    d = str(tmp_path / "plain")
    shutil.copytree(built["tplain"], d)
    preprocess_segment(d, _config(ttable).indexing_config)
    assert not load_segment(d).metadata.columns["loc"].has_geo_index
    assert not any(".geo" in f for f in _files(d))
