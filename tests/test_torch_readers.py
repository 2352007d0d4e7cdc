"""The port's record readers against the JAX package's, on the same files.

Each reader of ``pinot_tpu_torch/ingestion/readers.py`` (CSV, JSON lines
and arrays, Parquet, Avro, ProtoBuf) gives the rows and the
``read_columnar`` columns that ``pinot_tpu/ingestion/readers.py`` gives:
multi-value cells, nulls, missing columns, ragged rows, an empty file.
Each package's Avro container reads the other's (both codecs, nested
records, ``fixed``, enums, maps, unions, named types), and the two write
the same bytes. A reader whose library does not import raises at
``init``.
"""

import copy
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from pinot_tpu.ingestion import avro as javro
from pinot_tpu.ingestion import protobuf as jproto
from pinot_tpu.ingestion.readers import create_record_reader as j_reader
from pinot_tpu_torch.ingestion import avro as tavro
from pinot_tpu_torch.ingestion import protobuf as tproto
from pinot_tpu_torch.ingestion.readers import (
    ParquetRecordReader,
    ProtoBufRecordReader,
    create_record_reader as t_reader,
)
from pinot_tpu_torch.spi.readers import GenericRow, RecordReaderConfig


def _rows(reader):
    return [dict(r) for r in reader]


def _columns(cols):
    return None if cols is None else {
        k: (v.tolist() if isinstance(v, np.ndarray) else list(v))
        for k, v in cols.items()}


def _both(path, fmt=None, fields=None, config=None):
    """(JAX rows, port rows, JAX columns, port columns) of one file."""
    j = j_reader(path, fmt, fields_to_read=fields,
                 config=copy.deepcopy(config))
    t = t_reader(path, fmt, fields_to_read=fields,
                 config=copy.deepcopy(config))
    return _rows(j), _rows(t), _columns(j.read_columnar()), \
        _columns(t.read_columnar())


CSV_CASES = {
    "mv_undeclared": ("name,tags\nbob,red;blue\neve,green\n", None, None),
    "mv_declared": ("name,tags\na;b,x;y\nplain,z\n", None,
                    {"multiValueColumns": ["tags"]}),
    "mv_none_declared": ("name,tags\na;b,x;y\n", None,
                         {"multiValueColumns": []}),
    "mv_empty_parts": ("t\n;x;;y;\n;\n", None, None),
    "nulls": ("a,b,c\n,1,x\nx,,\n,,\n", None, None),
    "missing_column": ("a\nx\ny\n", ["a", "missing"], None),
    "fields_subset": ("a,b,c\n1,2,3\n4,5,6\n", ["c", "a"], None),
    "ragged": ("a,b,c\n1,2\n3,4,5,6\n7\n", None, None),
    "duplicate_header": ("a,a,b\n1,2,3\n4,5,6\n", None, None),
    "quoted": ('a,b\n"x,y","multi\nline"\n"say ""hi""",2\n', None, None),
    "header_only": ("a,b\n", None, None),
    "delimiter": ("a|b\n1|p;q\n2|\n", None,
                  {"delimiter": "|", "multiValueColumns": ["b"]}),
    "mv_delimiter": ("a,b\n1,p:q\n", None, {"multiValueDelimiter": ":"}),
    "nul_and_long": ("a\nhas\x00nul\n" + "x" * 600 + "\n", None, None),
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_csv_rows_and_columns_equal_jax(tmp_path, case):
    text, fields, config = CSV_CASES[case]
    path = tmp_path / "d.csv"
    path.write_text(text)
    jr, tr, jc, tc = _both(str(path), fields=fields, config=config)
    assert tr == jr
    assert tc == jc


def test_csv_empty_file_raises_in_both(tmp_path):
    (tmp_path / "empty.csv").write_text("")
    for reader in (j_reader, t_reader):
        with pytest.raises(ValueError, match="empty CSV"):
            reader(str(tmp_path / "empty.csv"))


def test_csv_columns_at_size(tmp_path):
    """A file of many rows, every column on the column-at-a-time path,
    cells equal to JAX's row-by-row loop, the MV column split."""
    rng = np.random.default_rng(3)
    n = 5000
    lines = ["k,v,f,tags"] + [
        f"k{rng.integers(0, 50)},{rng.integers(-9, 9)},"
        f"{'' if i % 7 == 0 else rng.random()},"
        f"{';'.join(f't{j}' for j in range(i % 4))}"
        for i in range(n)]
    path = tmp_path / "big.csv"
    path.write_text("\n".join(lines) + "\n")
    cfg = {"multiValueColumns": ["tags"]}
    jr, tr, jc, tc = _both(str(path), config=cfg)
    assert tr == jr and tc == jc
    assert tc["f"][0] is None and tc["tags"][2] == ["t0", "t1"]


@pytest.mark.parametrize("layout", ["lines", "array", "lines_blank"])
@pytest.mark.parametrize("fields", [None, ["a", "tags"]])
def test_json_rows_equal_jax(tmp_path, layout, fields):
    recs = [{"a": "x", "n": 1}, {"a": "y", "tags": ["t1", "t2"]},
            {"n": None, "nested": {"k": [1, 2]}}]
    path = tmp_path / "rows.json"
    if layout == "array":
        import json

        path.write_text(json.dumps(recs))
    else:
        import json

        sep = "\n\n" if layout == "lines_blank" else "\n"
        path.write_text(sep.join(json.dumps(r) for r in recs) + "\n")
    jr, tr, jc, tc = _both(str(path), fields=fields)
    assert tr == jr and jc is None and tc is None


@pytest.mark.parametrize("fields", [None, ["city", "v", "missing"]])
def test_parquet_rows_and_columns_equal_jax(tmp_path, fields):
    path = tmp_path / "rows.parquet"
    pd.DataFrame({"city": ["sf", "nyc", None], "v": [1, 2, 3],
                  "f": [0.5, np.nan, 2.0]}).to_parquet(path)
    jr, tr, jc, tc = _both(str(path), fields=fields)
    assert [{k: ("nan",) if v != v else v for k, v in r.items()}
            for r in tr] == [{k: ("nan",) if v != v else v
                              for k, v in r.items()} for r in jr]
    assert tc.keys() == jc.keys()

    def cells(vals):    # NaN == NaN here
        return [("nan",) if isinstance(v, float) and v != v else v
                for v in vals]

    for k in jc:
        assert cells(tc[k]) == cells(jc[k])
    if fields:
        assert tc["missing"] == [None, None, None]


def test_readers_without_their_library_raise_at_init(tmp_path, monkeypatch):
    path = tmp_path / "rows.parquet"
    pd.DataFrame({"a": [1]}).to_parquet(path)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError):
        ParquetRecordReader().init(str(path))
    monkeypatch.setitem(sys.modules, "google.protobuf", None)
    with pytest.raises(ImportError):
        ProtoBufRecordReader().init(str(path), config={
            "descriptorFile": str(path), "protoClassName": "x.Y"})


def test_unknown_format_and_extension_dispatch(tmp_path):
    path = tmp_path / "rows.txt"
    path.write_text("a\n1\n")
    for reader in (j_reader, t_reader):
        with pytest.raises(ValueError, match="unsupported input format"):
            reader(str(path))
    assert _rows(t_reader(str(path), "CSV")) == [{"a": "1"}]
    row = GenericRow()
    row.put_value("a", 1)
    assert row.get_value("a") == 1 and RecordReaderConfig(x=1)["x"] == 1


# -- Avro ---------------------------------------------------------------------

AVRO_SCHEMA = {
    "type": "record", "name": "Event", "namespace": "test",
    "fields": [
        {"name": "id", "type": "long"},
        {"name": "small", "type": "int"},
        {"name": "name", "type": "string"},
        {"name": "score", "type": "double"},
        {"name": "ratio", "type": "float"},
        {"name": "active", "type": "boolean"},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "attrs", "type": {"type": "map", "values": "int"}},
        {"name": "maybe", "type": ["null", "string"]},
        {"name": "kind", "type": {"type": "enum", "name": "Kind",
                                  "symbols": ["A", "B", "C"]}},
        {"name": "raw", "type": "bytes"},
        {"name": "digest", "type": {"type": "fixed", "name": "MD4",
                                    "size": 4}},
        {"name": "where", "type": {
            "type": "record", "name": "Place", "fields": [
                {"name": "city", "type": "string"},
                {"name": "geo", "type": {
                    "type": "record", "name": "Geo", "fields": [
                        {"name": "lat", "type": "double"},
                        {"name": "lon", "type": "double"}]}}]}},
        {"name": "home", "type": ["null", "Place"]},
        {"name": "kind2", "type": "Kind"},
    ],
}


def _avro_rows(n):
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        place = {"city": f"c{i % 3}",
                 "geo": {"lat": float(rng.random()), "lon": -1.5 * i}}
        out.append({
            "id": int(rng.integers(-(1 << 50), 1 << 50)), "small": i - 3,
            "name": ["alpha", "βeta", ""][i % 3], "score": float(i) / 3,
            "ratio": 0.5 * i, "active": bool(i % 2),
            "tags": [f"t{j}" for j in range(i % 4)],
            "attrs": {f"k{j}": j for j in range(i % 3)},
            "maybe": None if i % 2 else f"m{i}",
            "kind": "ABC"[i % 3], "raw": bytes(range(i % 5)),
            "digest": bytes([i % 256, 1, 2, 3]), "where": place,
            "home": None if i % 3 else place, "kind2": "CBA"[i % 3]})
    return out


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_avro_containers_read_across_packages(tmp_path, codec, writer):
    rows = _avro_rows(40)
    w = javro if writer == "jax" else tavro
    path = str(tmp_path / "e.avro")
    w.write_container(path, copy.deepcopy(AVRO_SCHEMA), rows, codec=codec)
    for r in (javro, tavro):
        schema, values = r.read_container(path)
        assert schema["name"] == "Event"
        assert list(values) == rows
    assert _rows(t_reader(path)) == _rows(j_reader(path))
    assert _rows(t_reader(path, fields_to_read=["id", "where"])) == \
        _rows(j_reader(path, fields_to_read=["id", "where"]))


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_writers_write_the_same_bytes(tmp_path, codec):
    rows = _avro_rows(25)
    paths = []
    for name, w in (("j", javro), ("t", tavro)):
        paths.append(str(tmp_path / f"{name}.avro"))
        w.write_container(paths[-1], copy.deepcopy(AVRO_SCHEMA), rows,
                          codec=codec)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_avro_scalar_container_and_errors(tmp_path):
    path = str(tmp_path / "s.avro")
    tavro.write_container(path, "long", [1, -2, 3])
    assert _rows(j_reader(path)) == _rows(t_reader(path)) == [
        {"value": 1}, {"value": -2}, {"value": 3}]
    bad = tmp_path / "bad.avro"
    bad.write_bytes(b"nope")
    for r in (javro, tavro):
        with pytest.raises(ValueError):
            r.read_container(str(bad))
    with pytest.raises(tavro.AvroError):
        tavro.write_container(path, "long", [1], codec="snappy")
    with open(path, "rb") as f:
        blob = f.read()
    (tmp_path / "cut.avro").write_bytes(blob[:-20])
    with pytest.raises(tavro.AvroError):
        list(tavro.read_container(str(tmp_path / "cut.avro"))[1])


# -- ProtoBuf -----------------------------------------------------------------

PROTO_SRC = """
syntax = "proto3";
package bench;

message Order {
  string region = 1;
  int64 qty = 2;
  double price = 3;
  repeated string tags = 4;
  Status status = 5;
  enum Status { NEW = 0; SHIPPED = 1; }
  Item item = 6;
  repeated Item items = 7;
}

message Item {
  string sku = 1;
  int32 n = 2;
}
"""


@pytest.fixture(scope="module")
def proto_env(tmp_path_factory):
    out = tmp_path_factory.mktemp("proto")
    (out / "order.proto").write_text(PROTO_SRC)
    desc = out / "order.desc"
    subprocess.run(["protoc", f"--proto_path={out}",
                    f"--descriptor_set_out={desc}", "order.proto"],
                   check=True, timeout=60)
    Order = jproto.load_message_class(str(desc), "bench.Order")
    msgs = []
    for i in range(30):
        m = Order()
        m.region = ["east", "west", ""][i % 3]
        m.qty = i
        m.price = i * 1.5
        m.tags.extend([f"t{i % 3}", "all"][:i % 3])
        m.status = i % 2
        if i % 2:
            m.item.sku = f"s{i}"
            m.item.n = i
        for j in range(i % 3):
            it = m.items.add()
            it.sku, it.n = f"x{j}", j
        msgs.append(m)
    paths = {}
    for name, mod in (("jax", jproto), ("port", tproto)):
        paths[name] = str(out / f"{name}.pb")
        mod.write_delimited(paths[name], msgs)
    return str(desc), paths


def test_protobuf_delimited_bytes_equal(proto_env):
    _desc, paths = proto_env
    assert open(paths["jax"], "rb").read() == open(paths["port"], "rb").read()


@pytest.mark.parametrize("fields", [None, ["qty", "item", "absent"]])
def test_protobuf_rows_equal_jax(proto_env, fields):
    desc, paths = proto_env
    cfg = {"descriptorFile": desc, "protoClassName": "bench.Order"}
    jr, tr, jc, tc = _both(paths["port"], "proto", fields=fields, config=cfg)
    assert tr == jr and len(tr) == 30 and jc is None and tc is None
    if fields is None:
        assert tr[1]["status"] == "SHIPPED" and tr[2]["item"] is None
        assert tr[2]["items"] == [{"sku": "x0", "n": 0},
                                  {"sku": "x1", "n": 1}]
    # the .pb extension picks the reader
    assert _rows(t_reader(paths["jax"], config=cfg)) == _rows(
        j_reader(paths["jax"], config=cfg))


def test_protobuf_truncated_and_unconfigured_raise(proto_env, tmp_path):
    desc, paths = proto_env
    blob = open(paths["port"], "rb").read()
    cut = tmp_path / "cut.pb"
    cut.write_bytes(blob[:-3])
    cfg = {"descriptorFile": desc, "protoClassName": "bench.Order"}
    with pytest.raises(ValueError, match="truncated"):
        list(t_reader(str(cut), config=cfg))
    with pytest.raises(ValueError, match="descriptorFile"):
        t_reader(paths["port"])
