"""The port's batch ingestion against the JAX package's, on the same files.

``pinot_tpu_torch/ingestion/batchjob.py`` (the job spec, the Java glob,
the job runner in order and in a spawn pool, the columnar and the row
paths) builds segment directories byte-equal to
``pinot_tpu/ingestion/batchjob.py``'s from the same landing files, apart
from the creation and build times: tests/test_batch_ingest.py's cases
that need no reference checkout, more glob trees, parallelism 2, and an
example directory in the reference's layout written here. Both CLIs'
``LaunchDataIngestionJob`` and ``Quickstart -exampleDir`` print the same
directories and rows; SegmentGenerationAndPush ingests the same landing
files in both clusters (tests/test_scheduler_plugins.py:237); a job reads
its schema from the port's REST controller; and chip_smoke's phase 22 runs
at a small size on the CPU.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest
import yaml

import chip_smoke
from pinot_tpu.ingestion import batchjob as jbatch
from pinot_tpu.spi import Schema as JSchema
from pinot_tpu.spi.table import TableConfig as JTableConfig
from pinot_tpu_torch.common.telemetry import TELEMETRY
from pinot_tpu_torch.ingestion import batchjob as tbatch
from pinot_tpu_torch.segment.creator import SegmentBuilder
from pinot_tpu_torch.segment.immutable import load_segment
from pinot_tpu_torch.spi.data import Schema as TSchema
from pinot_tpu_torch.spi.table import TableConfig as TTableConfig


def assert_same_dirs(a, b):
    """Segment directories equal file for file, the metadata's creation
    time and star-tree build seconds aside (chip_smoke's phase 22 check)."""
    assert chip_smoke._dir_differences(a, b) == []


def _run_both(tmp_path, schema_dict, spec_kw, table_dict=None):
    """The same job through both packages' runners into their own output
    directories. -> (JAX dirs, port dirs)."""
    out = []
    for name, mod, schema_cls, cfg_cls in (
            ("jax", jbatch, JSchema, JTableConfig),
            ("port", tbatch, TSchema, TTableConfig)):
        spec = mod.SegmentGenerationJobSpec(
            output_dir_uri=str(tmp_path / f"out_{name}"), **spec_kw)
        out.append(mod.SegmentGenerationJobRunner(
            spec, schema=schema_cls.from_dict(schema_dict),
            table_config=(cfg_cls.from_dict(table_dict)
                          if table_dict else None)).run())
    jd, td = out
    assert [os.path.basename(d) for d in jd] == \
        [os.path.basename(d) for d in td]
    for a, b in zip(jd, td):
        assert_same_dirs(a, b)
    return jd, td


SV_MV = {"schemaName": "t", "dimensionFieldSpecs": [
    {"name": "name", "dataType": "STRING"},
    {"name": "tags", "dataType": "STRING", "singleValueField": False}]}


def test_sv_string_with_semicolon_survives(tmp_path):
    (tmp_path / "d.csv").write_text("name,tags\na;b,x;y\nplain,z\n,\n")
    _jd, td = _run_both(tmp_path, SV_MV, dict(
        input_dir_uri=str(tmp_path), include_file_name_pattern="glob:*.csv",
        table_name="t", data_format="csv"))
    seg = load_segment(td[0])
    assert seg.get_value("name", 0) == "a;b"
    assert list(seg.get_value("tags", 0)) == ["x", "y"]


def test_missing_csv_column_null_fills(tmp_path):
    (tmp_path / "d.csv").write_text("a\nx\ny\n")
    _jd, td = _run_both(tmp_path, {
        "schemaName": "t", "dimensionFieldSpecs": [
            {"name": "a", "dataType": "STRING"},
            {"name": "missing", "dataType": "STRING"}],
        "metricFieldSpecs": [{"name": "m", "dataType": "LONG"}]}, dict(
        input_dir_uri=str(tmp_path), include_file_name_pattern="glob:*.csv",
        table_name="t", data_format="csv"))
    seg = load_segment(td[0])
    assert seg.num_docs == 2 and seg.metadata.column("missing").has_nulls


NULLS = {"schemaName": "t",
         "dimensionFieldSpecs": [{"name": "a", "dataType": "STRING"}],
         "metricFieldSpecs": [{"name": "n", "dataType": "LONG"},
                              {"name": "f", "dataType": "DOUBLE"}]}


@pytest.mark.parametrize("fmt", ["jsonl", "csv"])
def test_nulls_survive_both_paths(tmp_path, fmt):
    """The row path (JSON) restores the nulls the transformers recorded;
    the columnar path (CSV) reads empty cells as nulls: the same
    segment."""
    if fmt == "jsonl":
        (tmp_path / "d.jsonl").write_text(
            '{"a": "x", "n": 5, "f": 0.1}\n{"a": "y"}\n'
            '{"n": -3, "f": 1e-7}\n')
    else:
        (tmp_path / "d.csv").write_text("a,n,f\nx,5,0.1\ny,,\n,-3,1e-07\n")
    _jd, td = _run_both(tmp_path, NULLS, dict(
        input_dir_uri=str(tmp_path),
        include_file_name_pattern=f"glob:*.{fmt}", table_name="t",
        data_format=fmt))
    seg = load_segment(td[0])
    assert seg.metadata.column("n").has_nulls
    assert seg.metadata.column("f").has_nulls


def test_float_column_round_trips_through_csv(tmp_path):
    """A DOUBLE and a FLOAT column written to CSV read back to the same
    values: the job's segment equals the one built from the frame."""
    rng = np.random.default_rng(4)
    n = 3000
    frame = {"k": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
             "d": rng.normal(0, 1e6, n), "fl": rng.random(n).astype(
                 np.float32), "i": rng.integers(-(1 << 40), 1 << 40, n)}
    schema = {"schemaName": "fl",
              "dimensionFieldSpecs": [{"name": "k", "dataType": "STRING"}],
              "metricFieldSpecs": [{"name": "d", "dataType": "DOUBLE"},
                                   {"name": "fl", "dataType": "FLOAT"},
                                   {"name": "i", "dataType": "LONG"}]}
    land = tmp_path / "in"
    land.mkdir()
    with open(land / "fl.csv", "w") as f:
        f.write("k,d,fl,i\n")
        for row in zip(frame["k"], frame["d"].tolist(),
                       frame["fl"].tolist(), frame["i"].tolist()):
            f.write(f"{row[0]}," + ",".join(map(repr, row[1:])) + "\n")
    _jd, td = _run_both(tmp_path, schema, dict(
        input_dir_uri=str(land), include_file_name_pattern="glob:*.csv",
        table_name="fl", data_format="csv"))
    SegmentBuilder(TSchema.from_dict(schema), "fl_batch_0").build(
        frame, str(tmp_path / "frame"))
    assert_same_dirs(td[0], str(tmp_path / "frame" / "fl_batch_0"))


def test_columnar_path_sanitizes(tmp_path):
    long = "x" * 600
    (tmp_path / "d.csv").write_text(f"a\nhas\x00nul\n{long}\nok\n")
    _jd, td = _run_both(tmp_path, {
        "schemaName": "t", "dimensionFieldSpecs": [
            {"name": "a", "dataType": "STRING", "maxLength": 512}]}, dict(
        input_dir_uri=str(tmp_path), include_file_name_pattern="glob:*.csv",
        table_name="t", data_format="csv"))
    seg = load_segment(td[0])
    assert seg.get_value("a", 0) == "hasnul"
    assert len(seg.get_value("a", 1)) == 512


def test_transforms_take_the_row_path(tmp_path):
    (tmp_path / "d.csv").write_text("a,n\nx,1\ny,2\nz,3\n")
    schema = {"schemaName": "t", "dimensionFieldSpecs": [
        {"name": "a", "dataType": "STRING"}],
        "metricFieldSpecs": [{"name": "n", "dataType": "LONG"}]}
    table = {"tableName": "t", "tableType": "OFFLINE", "ingestionConfig": {
        "filterConfig": {"filterFunction": "a = 'y'"}}}
    _jd, td = _run_both(tmp_path, schema, dict(
        input_dir_uri=str(tmp_path), include_file_name_pattern="glob:*.csv",
        table_name="t", data_format="csv"), table_dict=table)
    assert load_segment(td[0]).num_docs == 2


@pytest.mark.parametrize("parallelism", [1, 2])
def test_job_parallelism_builds_every_file(tmp_path, parallelism):
    inp = tmp_path / "in"
    inp.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        lines = ["k,v"] + [f"k{j % 3},{int(rng.integers(0, 9))}"
                           for j in range(200)]
        (inp / f"part{i}.csv").write_text("\n".join(lines))
    jd, td = _run_both(tmp_path, {
        "schemaName": "pj",
        "dimensionFieldSpecs": [{"name": "k", "dataType": "STRING"}],
        "metricFieldSpecs": [{"name": "v", "dataType": "LONG"}]}, dict(
        input_dir_uri=str(inp), include_file_name_pattern="glob:**/*.csv",
        table_name="pj", data_format="csv", parallelism=parallelism,
        segment_name_prefix="pj_seg"))
    assert [os.path.basename(d) for d in td] == ["pj_seg_0", "pj_seg_1",
                                                 "pj_seg_2"]
    assert sum(load_segment(d).num_docs for d in td) == 600


def test_no_input_files_and_no_schema_raise(tmp_path):
    spec = tbatch.SegmentGenerationJobSpec(
        input_dir_uri=str(tmp_path), include_file_name_pattern="glob:*.csv",
        output_dir_uri=str(tmp_path / "o"))
    with pytest.raises(ValueError, match="schemaURI"):
        tbatch.SegmentGenerationJobRunner(spec)
    with pytest.raises(FileNotFoundError):
        tbatch.SegmentGenerationJobRunner(
            spec, schema=TSchema.from_dict(SV_MV)).run()


GLOB_TREE = ["root.csv", "a.json", "c.txt", "d1.csv", "b1.csv", "b2.csv",
             "archive/old.csv", "archive/deep/older.csv", "x/y/z.json",
             "x/y/z.csv", "weird[1].csv", "sp ace.csv"]
GLOBS = [("glob:*.csv", None), ("glob:**/*.csv", None),
         ("glob:**/*.csv", "glob:archive/*"),
         ("glob:**/*.csv", "glob:archive/**"), ("glob:*.{csv,json}", None),
         ("glob:[ab]*.*", None), ("glob:[!ab]*.csv", None),
         ("glob:b?.csv", None), ("glob:{*.csv,*.json}", None),
         ("glob:**", None), ("glob:x/**/z.*", None), ("glob:**/y/*", None),
         ("*.csv", None)]


@pytest.mark.parametrize("pattern,exclude", GLOBS,
                         ids=[f"{p}|{e}" for p, e in GLOBS])
def test_java_glob_trees_match_jax(tmp_path, pattern, exclude):
    for rel in GLOB_TREE:
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("a\n1\n")
    got = tbatch._match_glob(str(tmp_path), pattern, exclude)
    assert got == jbatch._match_glob(str(tmp_path), pattern, exclude)
    if pattern == "glob:*.csv":
        assert [os.path.relpath(p, tmp_path) for p in got] == [
            "b1.csv", "b2.csv", "d1.csv", "root.csv", "sp ace.csv",
            "weird[1].csv"]


def test_glob_errors():
    for bad in ("glob:{a,b", "glob:[ab"):
        with pytest.raises(ValueError):
            tbatch._glob_regex(bad)


JOB = {"jobType": "SegmentCreationAndTarPush", "inputDirURI": "rawdata",
       "includeFileNamePattern": "glob:**/*.csv",
       "outputDirURI": "file://segments",
       "segmentCreationJobParallelism": 2,
       "tableSpec": {"tableName": "baseballStats",
                     "schemaURI": "file://baseballStats_schema.json",
                     "tableConfigURI":
                         "baseballStats_offline_table_config.json"},
       "recordReaderSpec": {"dataFormat": "CSV", "configs": {}},
       "segmentNameGeneratorSpec": {"configs": {
           "segment.name.prefix": "baseball"}}}

BASEBALL_SCHEMA = {
    "schemaName": "baseballStats",
    "dimensionFieldSpecs": [
        {"name": "playerID", "dataType": "STRING"},
        {"name": "yearID", "dataType": "INT"},
        {"name": "teamID", "dataType": "STRING"},
        {"name": "league", "dataType": "STRING"},
        {"name": "playerName", "dataType": "STRING"}],
    "metricFieldSpecs": [
        {"name": "runs", "dataType": "INT"},
        {"name": "hits", "dataType": "INT"},
        {"name": "homeRuns", "dataType": "INT"},
        {"name": "baseOnBalls", "dataType": "INT"}]}
BASEBALL_TABLE = {
    "tableName": "baseballStats", "tableType": "OFFLINE",
    "segmentsConfig": {"replication": "1", "segmentPushType": "APPEND"},
    "tableIndexConfig": {"loadMode": "MMAP"},
    "tenants": {}, "metadata": {}}


def _example_dir(root, rows=(300, 200), seed=9):
    """A directory in the reference's example layout: the schema, the
    offline table config, ``ingestionJobSpec.yaml`` and CSV rawdata."""
    root.mkdir(parents=True)
    raw = root / "rawdata"
    raw.mkdir()
    rng = np.random.default_rng(seed)
    for i, n in enumerate(rows):
        lines = [",".join(f["name"] for f in (
            BASEBALL_SCHEMA["dimensionFieldSpecs"]
            + BASEBALL_SCHEMA["metricFieldSpecs"]))]
        for j in range(n):
            lines.append(",".join([
                f"p{rng.integers(0, 40)}", str(1990 + j % 20),
                ["BOS", "NYA", "SFN"][j % 3], ["AL", "NL"][j % 2],
                f"Player {rng.integers(0, 40)}"] + [
                str(rng.integers(0, 100)) for _ in range(4)]))
        (raw / f"part{i}.csv").write_text("\n".join(lines) + "\n")
    (root / "baseballStats_schema.json").write_text(
        json.dumps(BASEBALL_SCHEMA))
    (root / "baseballStats_offline_table_config.json").write_text(
        json.dumps(BASEBALL_TABLE))
    (root / "ingestionJobSpec.yaml").write_text(yaml.safe_dump(JOB))
    return root


def test_job_spec_from_yaml_matches_jax(tmp_path):
    ex = _example_dir(tmp_path / "ex")
    specs = [m.SegmentGenerationJobSpec.from_yaml(
        str(ex / "ingestionJobSpec.yaml")) for m in (jbatch, tbatch)]
    for s in specs:
        s.resolve_relative(str(ex))
    assert vars(specs[1]) == vars(specs[0])
    assert specs[1].data_format == "csv" and specs[1].parallelism == 2
    assert specs[1].output_dir_uri == str(ex / "segments")
    assert specs[1].segment_name_prefix == "baseball"
    assert tbatch.SegmentGenerationJobSpec.from_dict(JOB).input_dir_uri == \
        "rawdata"


def test_launch_data_ingestion_job_in_both_clis(tmp_path, capsys):
    from pinot_tpu.tools.admin import main as jmain
    from pinot_tpu_torch.tools.admin import main as tmain

    dirs = []
    for name, main in (("jax", jmain), ("port", tmain)):
        ex = _example_dir(tmp_path / name)
        assert main(["LaunchDataIngestionJob", "-jobSpecFile",
                     str(ex / "ingestionJobSpec.yaml")]) == 0
        dirs.append(capsys.readouterr().out.strip().splitlines())
    assert [os.path.basename(d) for d in dirs[1]] == \
        [os.path.basename(d) for d in dirs[0]] == ["baseball_0",
                                                   "baseball_1"]
    for a, b in zip(*dirs):
        assert_same_dirs(a, b)
    assert sum(load_segment(d).num_docs for d in dirs[1]) == 500


def test_quickstart_example_dir_in_both_clis(tmp_path, capsys):
    from pinot_tpu.tools.admin import main as jmain
    from pinot_tpu_torch.tools.admin import main as tmain

    queries = ["SELECT count(*) FROM baseballStats",
               "SELECT league, sum(homeRuns), count(*) FROM baseballStats "
               "GROUP BY league ORDER BY league",
               "SELECT teamID, max(runs) FROM baseballStats WHERE yearID > "
               "2000 GROUP BY teamID ORDER BY teamID"]
    outs = []
    try:
        for name, main, extra in (("jax", jmain, []),
                                  ("port", tmain, ["-device", "cpu"])):
            ex = _example_dir(tmp_path / name)
            args = ["Quickstart", "-exampleDir", str(ex), "-dataDir",
                    str(tmp_path / f"qs_{name}")] + extra
            for q in queries:
                args += ["-query", q]
            assert main(args) == 0
            lines = capsys.readouterr().out.strip().splitlines()
            outs.append([json.loads(line)["resultTable"]
                         for line in lines[-len(queries):]])
    finally:
        TELEMETRY.reset()
    assert outs[1] == outs[0]
    assert outs[1][0]["rows"] == [[500]]


def test_schema_and_table_config_from_file(tmp_path):
    ex = _example_dir(tmp_path / "ex")
    s = TSchema.from_file(str(ex / "baseballStats_schema.json"))
    c = TTableConfig.from_file(str(ex / "baseballStats_offline_table_config"
                                      ".json"))
    assert s.column_names == JSchema.from_file(
        str(ex / "baseballStats_schema.json")).column_names
    assert c.table_name_with_type == "baseballStats_OFFLINE"


def _landing(tmp_path):
    import pandas as pd

    input_dir = tmp_path / "landing"
    input_dir.mkdir(parents=True)
    pd.DataFrame({"k": ["a", "b", "a"], "v": [1, 2, 3]}).to_csv(
        input_dir / "d1.csv", index=False)
    return input_dir


def _mnt_schema(mod_schema):
    return mod_schema.from_dict({
        "schemaName": "mnt",
        "dimensionFieldSpecs": [{"name": "k", "dataType": "STRING"}],
        "metricFieldSpecs": [{"name": "v", "dataType": "LONG"}]})


def test_segment_generation_and_push_in_both_clusters(tmp_path):
    """tests/test_scheduler_plugins.py:237 on both packages' clusters: the
    landing files ingested once each, the same answers, the same
    processed set, a poisoned file set stopped after MAX_TASK_ATTEMPTS."""
    from pinot_tpu.tools.cluster import EmbeddedCluster as JCluster
    from pinot_tpu_torch.controller.tasks import (
        MAX_TASK_ATTEMPTS,
        ingested_files_path,
    )
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster as TCluster

    got = {}
    for name, make, schema_cls, cfg_cls in (
            ("jax", lambda d: JCluster(num_servers=1, data_dir=d),
             JSchema, JTableConfig),
            ("port", lambda d: TCluster(num_servers=1, device="cpu",
                                        data_dir=d), TSchema, TTableConfig)):
        input_dir = _landing(tmp_path / name)
        cluster = make(str(tmp_path / name / "c"))
        cfg = cfg_cls.from_dict({
            "tableName": "mnt", "tableType": "OFFLINE",
            "task": {"taskTypeConfigsMap": {
                "SegmentGenerationAndPushTask": {
                    "inputDirURI": str(input_dir), "inputFormat": "csv"}}}})
        try:
            cluster.create_table(cfg, _mnt_schema(schema_cls))
            tm = cluster.controller.task_manager
            minion = cluster.add_minion(start=False)
            assert len(tm.generate_tasks()) == 1
            assert minion.run_one_task()
            assert cluster.wait_for_ev_converged("mnt_OFFLINE")
            first = cluster.query_rows("SELECT count(*), sum(v) FROM mnt")
            assert tm.generate_tasks() == []
            time.sleep(0.01)
            with open(input_dir / "d2.csv", "w") as f:
                f.write("k,v\nc,10\n")
            (input_dir / "bad.csv").write_text("")   # an empty CSV fails
            assert len(tm.generate_tasks()) == 1
            minion.run_one_task()
            errors = 1
            while tm.generate_tasks():
                minion.run_one_task()
                errors += 1
            # d2 is stuck with bad.csv in one poisoned file set
            assert errors == MAX_TASK_ATTEMPTS
            os.remove(input_dir / "bad.csv")
            assert len(tm.generate_tasks()) == 1
            assert minion.run_one_task()
            assert cluster.wait_for_docs("mnt", 4)
            done = cluster.store.get(ingested_files_path("mnt_OFFLINE"))
            got[name] = (first, cluster.query_rows(
                "SELECT k, sum(v) FROM mnt GROUP BY k ORDER BY k"),
                sorted(done))
        finally:
            cluster.shutdown()
            TELEMETRY.reset()
    assert got["port"] == got["jax"]
    assert got["port"][0] == [[3, 6.0]]
    assert got["port"][2] == ["d1.csv", "d2.csv"]


def test_job_reads_its_schema_from_the_rest_controller(tmp_path):
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster
    from pinot_tpu_torch.transport.rest import serve_cluster

    cluster = EmbeddedCluster(num_servers=1, device="cpu",
                              data_dir=str(tmp_path / "c"))
    apis = serve_cluster(cluster)
    try:
        cluster.create_table(TTableConfig("mnt"), _mnt_schema(TSchema))
        input_dir = _landing(tmp_path)
        job = {"jobType": "SegmentCreationAndPush",
               "inputDirURI": str(input_dir),
               "includeFileNamePattern": "glob:*.csv",
               "outputDirURI": str(tmp_path / "out"),
               "tableSpec": {"tableName": "mnt", "schemaURI":
                             f"http://localhost:{apis[0].port}/schemas/mnt"}}
        (tmp_path / "job.yaml").write_text(yaml.safe_dump(job))
        dirs = tbatch.run_ingestion_job(str(tmp_path / "job.yaml"),
                                        cluster=cluster)
        assert [os.path.basename(d) for d in dirs] == ["mnt_batch_0"]
        assert cluster.wait_for_ev_converged("mnt_OFFLINE")
        assert cluster.query_rows("SELECT sum(v) FROM mnt") == [[6.0]]
    finally:
        for api in apis:
            api.stop()
        cluster.shutdown()
        TELEMETRY.reset()


def test_chip_smoke_phase_22_small(tmp_path):
    out = chip_smoke.phase_ingest(1, device="cpu", **chip_smoke.INGEST_SMALL)
    TELEMETRY.reset()
    batch, streams = out["batch"], out["streams"]
    assert batch["rows"] == 12000 and batch["files"] == 2
    assert out["task"]["segments"] == 3
    assert out["s3"]["segments"] == 2
    for name in ("kafka", "socket"):
        assert streams[name]["after"]["sealed"] == 4
        assert streams[name]["before"]["consuming"] == 2
    # the plain version counts no launch on the CPU
    assert set(out["launches"].values()) == {0}
    shutil.rmtree(tmp_path, ignore_errors=True)
