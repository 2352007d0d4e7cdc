"""The port's deep stores, crypters, retries, environment and plugins.

Held against the JAX package: the retry policies and the service manager
(tests/test_retry.py's cases on both packages), crypters that decrypt each
other's files, ``fetch_segment`` (retries, an unknown scheme failing at
once, a crypted ``file://`` store decrypted only in its local copy, the
``http://`` fetcher and its escaping name), SigV4 signatures equal to
JAX's on the same requests, the port's ``S3PinotFS`` against JAX's
``MockS3Server`` and the other way, a segment pushed as ``s3://`` into the
port's cluster, a server's registration carrying ``PINOT_FAILURE_DOMAIN``
and the assignment spreading replicas over domains, and the plugin loader.
"""

import datetime
import json
import os
import threading
import time
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from pinot_tpu.spi import crypt as jcrypt
from pinot_tpu.spi import retry as jretry
from pinot_tpu.spi import s3fs as js3
from pinot_tpu_torch.common.telemetry import TELEMETRY
from pinot_tpu_torch.spi import crypt as tcrypt
from pinot_tpu_torch.spi import filesystem as tfs
from pinot_tpu_torch.spi import retry as tretry
from pinot_tpu_torch.spi import s3fs as ts3
from pinot_tpu_torch.spi.data import Schema
from pinot_tpu_torch.spi.table import TableConfig

RETRY = [jretry, tretry]


# -- retry policies and the service manager -----------------------------------

@pytest.mark.parametrize("mod", RETRY, ids=["jax", "port"])
def test_retry_succeeds_after_transient_failures(mod):
    calls = {"n": 0}

    def op():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert mod.fixed_delay(5, delay_ms=1).attempt(op) == "ok"
    assert calls["n"] == 3


@pytest.mark.parametrize("mod", RETRY, ids=["jax", "port"])
def test_retry_exhaustion_and_gates(mod):
    def down():
        raise OSError("down")

    with pytest.raises(mod.AttemptsExceededError) as e:
        mod.exponential_backoff(3, initial_delay_ms=1).attempt(down)
    assert e.value.attempts == 3 and isinstance(e.value.last, OSError)
    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        raise ValueError("bad input")

    with pytest.raises(ValueError):
        mod.fixed_delay(5, delay_ms=1).attempt(bad)

    def missing():
        calls["n"] += 1
        raise KeyError("nope")

    with pytest.raises(KeyError):
        mod.fixed_delay(5, delay_ms=1).attempt(
            missing, retriable=lambda e: not isinstance(e, KeyError))
    assert calls["n"] == 2
    with pytest.raises(ValueError):
        mod.FixedDelayRetryPolicy(0, 1)


def test_retry_delays_equal_jax():
    for mod in RETRY:
        p = mod.exponential_backoff(4, initial_delay_ms=100, delay_scale=2.0)
        p._randomize = False
        assert [p.delay_s(i) for i in range(3)] == [0.1, 0.2, 0.4]
    jp = jretry.exponential_backoff(4, initial_delay_ms=100)
    tp = tretry.exponential_backoff(4, initial_delay_ms=100)
    for i in range(4):
        assert 0 <= tp.delay_s(i) < 0.1 * 2 ** i
        assert 0 <= jp.delay_s(i) < 0.1 * 2 ** i


def _log_services(mod, fail_at=None):
    log = []

    class Svc(mod.ServiceStartable):
        def __init__(self, name):
            self.name = name

        def start(self):
            if self.name == fail_at:
                raise RuntimeError(f"{self.name} failed to start")
            log.append(("start", self.name))

        def stop(self):
            log.append(("stop", self.name))

        @property
        def service_role(self):
            return self.name

    mgr = mod.ServiceManager()
    for n in ("CONTROLLER", "BROKER", "SERVER"):
        mgr.register(Svc(n))
    try:
        mgr.start_all()
        mgr.stop_all()
    except RuntimeError:
        pass
    return log, mgr.roles


@pytest.mark.parametrize("fail_at", [None, "BROKER"])
def test_service_manager_equal_jax(fail_at):
    assert _log_services(tretry, fail_at) == _log_services(jretry, fail_at)


# -- crypters -----------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, 31, 32, 33, 25600, 100_003])
@pytest.mark.parametrize("enc,dec", [(jcrypt, tcrypt), (tcrypt, jcrypt)],
                         ids=["jax_to_port", "port_to_jax"])
def test_crypters_decrypt_each_others_files(tmp_path, size, enc, dec):
    payload = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    p = tmp_path / "seg.bin"
    p.write_bytes(payload)
    enc.KeyedStreamCrypter(b"s3cret-key").encrypt(str(p))
    cipher = p.read_bytes()
    assert cipher.startswith(b"PCRY1\x00") and len(cipher) == size + 22
    if size:
        assert cipher[22:] != payload
    dec.KeyedStreamCrypter(b"s3cret-key").decrypt(str(p))
    assert p.read_bytes() == payload
    # the same nonce gives the same ciphertext in both packages
    nonce = cipher[6:22]
    assert tcrypt.KeyedStreamCrypter(b"s3cret-key")._xor(payload, nonce) \
        == cipher[22:]


def test_crypter_errors_and_registry(tmp_path):
    p = tmp_path / "plain.bin"
    p.write_bytes(b"not encrypted")
    with pytest.raises(ValueError):
        tcrypt.KeyedStreamCrypter(b"k").decrypt(str(p))
    with pytest.raises(ValueError):
        tcrypt.KeyedStreamCrypter(b"")
    assert isinstance(tcrypt.get_crypter("NoOp"), tcrypt.NoOpPinotCrypter)
    tcrypt.register_crypter("test-keyed",
                            lambda: tcrypt.KeyedStreamCrypter(b"k"))
    assert isinstance(tcrypt.get_crypter("TEST-KEYED"),
                      tcrypt.KeyedStreamCrypter)
    with pytest.raises(ValueError):
        tcrypt.get_crypter("aes-gcm-unregistered")
    tcrypt.get_crypter("noop").encrypt(str(p))
    assert p.read_bytes() == b"not encrypted"


# -- fetch_segment ------------------------------------------------------------

def test_fetch_retries_then_raises(tmp_path):
    src = tmp_path / "seg_src"
    src.mkdir()
    (src / "col.npy").write_bytes(b"data")
    attempts = {"n": 0}

    class FlakyFS(tfs.PinotFS):
        def copy_to_local_dir(self, uri, local_dir):
            attempts["n"] += 1
            if attempts["n"] < 3:
                raise OSError("transient deep-store fault")
            return str(src)

    class DeadFS(tfs.PinotFS):
        def copy_to_local_dir(self, uri, local_dir):
            raise OSError("down")

    tfs.register_fs("flaky", FlakyFS)
    tfs.register_fs("dead", DeadFS)
    out = tfs.fetch_segment("flaky://deep/seg_src", str(tmp_path / "l"),
                            retries=3, backoff_s=0.01)
    assert attempts["n"] == 3 and out == str(tmp_path / "l" / "seg_src")
    assert (tmp_path / "l" / "seg_src" / "col.npy").read_bytes() == b"data"
    assert sorted(os.listdir(tmp_path / "l")) == ["seg_src"]
    with pytest.raises(tretry.AttemptsExceededError) as e:
        tfs.fetch_segment("dead://x/y", str(tmp_path), retries=2,
                          backoff_s=0.01)
    assert isinstance(e.value.last, OSError)
    t0 = time.perf_counter()
    with pytest.raises(ValueError):
        tfs.fetch_segment("s4://bucket/seg", str(tmp_path), retries=5,
                          backoff_s=5.0)
    assert time.perf_counter() - t0 < 1.0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_crypted_file_store_is_decrypted_only_in_its_copy(tmp_path, writer):
    deep = tmp_path / "deepstore" / "segX"
    (deep / "columns").mkdir(parents=True)
    files = {"columns/col.npy": b"columnar payload" * 100,
             "metadata.json": b'{"segmentName": "segX"}'}
    for rel, data in files.items():
        (deep / rel).write_bytes(data)
    enc = (jcrypt if writer == "jax" else tcrypt).KeyedStreamCrypter(b"dk")
    for rel in files:
        enc.encrypt(str(deep / rel))
    encrypted = {rel: (deep / rel).read_bytes() for rel in files}
    tcrypt.register_crypter("deeptest",
                            lambda: tcrypt.KeyedStreamCrypter(b"dk"))
    local = tmp_path / "local"
    for _ in range(2):      # a second replica's fetch also succeeds
        out = tfs.fetch_segment(f"file://{deep}", str(local),
                                crypter="deeptest")
        assert out == str(local / "segX")
        for rel, data in files.items():
            assert (local / "segX" / rel).read_bytes() == data
    for rel in files:      # the store untouched
        assert (deep / rel).read_bytes() == encrypted[rel]
    # without a crypter the file:// store is served in place, and a
    # crypter needs a local directory; a wrong key fails, not retried
    assert tfs.fetch_segment(f"file://{deep}") == str(deep)
    with pytest.raises(ValueError):
        tfs.fetch_segment(f"file://{deep}", crypter="deeptest")
    with pytest.raises(ValueError):
        tfs.fetch_segment(f"file://{local / 'segX'}", str(tmp_path / "l2"),
                          crypter="deeptest")
    assert not os.path.exists(tmp_path / "l2" / "segX")


class _SegmentHttp:
    """A segment directory over HTTP: ``/<name>/__files__`` lists its
    files (or ``names``), ``/<name>/<file>`` serves each."""

    def __init__(self, root, names=None):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                seg, _, rel = self.path.lstrip("/").partition("/")
                path = os.path.join(root, seg)
                if not os.path.isdir(path):
                    self.send_response(404)
                    self.end_headers()
                    return
                if rel == "__files__":
                    body = json.dumps(server.names or sorted(
                        os.path.relpath(os.path.join(r, f), path)
                        for r, _d, fs in os.walk(path) for f in fs)).encode()
                elif os.path.isfile(os.path.join(path, rel)):
                    with open(os.path.join(path, rel), "rb") as f:
                        body = f.read()
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.names = names
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def test_http_fetch_and_the_escaping_name(tmp_path):
    src = tmp_path / "store" / "seg_h"
    (src / "columns").mkdir(parents=True)
    (src / "columns" / "a.npy").write_bytes(b"alpha")
    (src / "metadata.json").write_bytes(b"{}")
    srv = _SegmentHttp(str(tmp_path / "store"))
    try:
        url = f"{srv.url}/seg_h"
        fs = tfs.get_fs(url)
        assert isinstance(fs, tfs.HttpSegmentFetcher) and fs.exists(url)
        assert not fs.exists(f"{srv.url}/nope")
        out = tfs.fetch_segment(url, str(tmp_path / "dl"))
        assert (tmp_path / "dl" / "seg_h" / "columns" / "a.npy"
                ).read_bytes() == b"alpha"
        assert out == str(tmp_path / "dl" / "seg_h")
        with pytest.raises(NotImplementedError):
            fs.delete(url)
        srv.names = ["../../evil.txt"]
        with pytest.raises(ValueError, match="escaping"):
            tfs.fetch_segment(url, str(tmp_path / "dl2"), retries=3,
                              backoff_s=5.0)
        assert not os.path.exists(tmp_path / "evil.txt")
        # a remote fetch needs a local directory
        with pytest.raises(ValueError):
            tfs.fetch_segment(url)
    finally:
        srv.stop()


# -- S3 -----------------------------------------------------------------------

REQUESTS = [
    ("GET", "http://localhost:9000/bucket/key", b""),
    ("PUT", "http://127.0.0.1:4567/b/tables/t/seg_0/columns/a%20b.npy",
     b"payload" * 99),
    ("GET", "http://h:1/b?list-type=2&prefix=pfx%2Fmany%2F&"
            "continuation-token=pfx%2Fmany%2Ffile%2003.bin", b""),
    ("DELETE", "https://s3.example/b/k%C3%A9y", b""),
    ("HEAD", "http://h:1/b/k", b""),
]


@pytest.mark.parametrize("method,url,payload", REQUESTS)
def test_sigv4_equal_jax(method, url, payload):
    now = datetime.datetime(2026, 7, 30, 12, 0, 0,
                            tzinfo=datetime.timezone.utc)
    for region in ("us-east-1", "eu-west-3"):
        args = (method, url, {"x-extra": " v "}, payload, "AK", "SK",
                region)
        assert ts3.sign_request(*args, now=now) == \
            js3.sign_request(*args, now=now)
    assert ts3.signing_key("SK", "20260730", "us-east-1", "s3") == \
        js3.signing_key("SK", "20260730", "us-east-1", "s3")


@pytest.mark.parametrize("server,client", [(js3, ts3), (ts3, js3)],
                         ids=["port_client_jax_server",
                              "jax_client_port_server"])
def test_s3_clients_against_each_others_servers(tmp_path, server, client):
    srv = server.MockS3Server().start()
    try:
        fs = client.S3PinotFS(endpoint=srv.endpoint,
                              access_key=srv.access_key,
                              secret_key=srv.secret_key, region=srv.region)
        srv.page_size = 3
        src = tmp_path / "many"
        (src / "sub").mkdir(parents=True)
        for i in range(8):
            (src / f"file {i:02d}.bin").write_bytes(bytes([i]) * (i + 1))
        (src / "sub" / "b.npy").write_bytes(b"beta")
        fs.copy_from_local_dir(str(src), "s3://b/pfx/many")
        keys = fs.list_files("s3://b/pfx/many")
        assert len(keys) == 9 and "pfx/many/sub/b.npy" in keys
        srv.objects["b/pfx/many/"] = b""     # a directory marker
        out = fs.copy_to_local_dir("s3://b/pfx/many", str(tmp_path / "dl"))
        assert (tmp_path / "dl" / "many" / "file 07.bin").read_bytes() == \
            bytes([7]) * 8
        assert (tmp_path / "dl" / "many" / "sub" / "b.npy").read_bytes() == \
            b"beta"
        assert out.endswith("many")
        with pytest.raises(FileNotFoundError):
            fs.copy_to_local_dir("s3://b/pfx/NOPE", str(tmp_path / "dl2"))
        assert fs.exists("s3://b/pfx/many")
        assert not fs.exists("s3://b/pfx/NOPE")
        fs.delete("s3://b/pfx/many")
        assert fs.list_files("s3://b/pfx/many") == []
        bad = client.S3PinotFS(endpoint=srv.endpoint,
                               access_key=srv.access_key,
                               secret_key="wrong", region=srv.region)
        with pytest.raises(urllib.error.HTTPError) as e:
            bad.list_files("s3://b/x")
        assert e.value.code == 403
    finally:
        srv.stop()


def test_s3_needs_an_endpoint_and_refuses_escaping_keys(tmp_path,
                                                        monkeypatch):
    monkeypatch.delenv("PINOT_S3_ENDPOINT", raising=False)
    with pytest.raises(ValueError, match="endpoint"):
        ts3.S3PinotFS()
    srv = ts3.MockS3Server().start()
    try:
        fs = ts3.S3PinotFS(endpoint=srv.endpoint, access_key=srv.access_key,
                           secret_key=srv.secret_key, region=srv.region)
        srv.objects["b/seg/../../evil.bin"] = b"x"
        with pytest.raises(ValueError, match="escaping"):
            fs.copy_to_local_dir("s3://b/seg", str(tmp_path / "dl"))
    finally:
        srv.stop()


def _s3_env(monkeypatch, srv):
    monkeypatch.setenv("PINOT_S3_ENDPOINT", srv.endpoint)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", srv.access_key)
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", srv.secret_key)
    monkeypatch.setenv("AWS_REGION", srv.region)


def test_segment_through_s3_in_the_ports_cluster(tmp_path, monkeypatch):
    """A segment the JAX builder wrote, put into the port's mock S3 and
    pushed as ``s3://``: each server copies it into its own directory and
    answers as the JAX executor does over the same directory."""
    from pinot_tpu.engine import ServerQueryExecutor as JExecutor
    from pinot_tpu.query import compile_query as j_compile
    from pinot_tpu.segment import SegmentBuilder as JBuilder
    from pinot_tpu.segment import load_segment as j_load
    from pinot_tpu.spi import Schema as JSchema
    from pinot_tpu_torch.segment.metadata import SegmentMetadata
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster

    schema = {"schemaName": "s3t", "dimensionFieldSpecs": [
        {"name": "k", "dataType": "STRING"}],
        "metricFieldSpecs": [{"name": "v", "dataType": "LONG"}]}
    rng = np.random.default_rng(4)
    frame = {"k": ["a", "b", "c"] * 100,
             "v": rng.integers(0, 10, 300).tolist()}
    JBuilder(JSchema.from_dict(schema), "s3t_0").build(frame,
                                                       str(tmp_path / "b"))
    srv = ts3.MockS3Server().start()
    _s3_env(monkeypatch, srv)
    ts3.S3PinotFS().copy_from_local_dir(str(tmp_path / "b" / "s3t_0"),
                                        "s3://deep/segments/s3t_0")
    cluster = EmbeddedCluster(num_servers=2, device="cpu",
                              data_dir=str(tmp_path / "c"))
    try:
        cluster.create_table(TableConfig("s3t"), Schema.from_dict(schema))
        cluster.controller.add_segment(
            "s3t_OFFLINE", SegmentMetadata.load(
                str(tmp_path / "b" / "s3t_0" / "metadata.json")),
            "s3://deep/segments/s3t_0")
        assert cluster.wait_for_ev_converged("s3t_OFFLINE")
        sql = "SELECT k, count(*), sum(v) FROM s3t GROUP BY k ORDER BY k"
        got = cluster.query_rows(sql)
        want, _ = JExecutor(use_device=False).execute(
            j_compile(sql), [j_load(str(tmp_path / "b" / "s3t_0"))])
        assert got == want.rows
        hosts = [sid for sid, s in cluster.servers.items()
                 if s.data_manager.get("s3t_OFFLINE") is not None
                 and s.data_manager.get("s3t_OFFLINE").has_segment("s3t_0")]
        assert len(hosts) == 1
        assert os.path.isdir(os.path.join(
            cluster.server_segment_dir, hosts[0], "s3t_OFFLINE", "s3t_0"))
    finally:
        cluster.shutdown()
        TELEMETRY.reset()
        srv.stop()


# -- environment ----------------------------------------------------------------

def test_environment_providers(monkeypatch):
    from pinot_tpu_torch.spi.environment import (
        EnvVarEnvironmentProvider,
        get_environment_provider,
        register_environment_provider,
    )

    monkeypatch.setenv("PINOT_FAILURE_DOMAIN", "zone-b")
    assert EnvVarEnvironmentProvider().failure_domain() == "zone-b"
    assert get_environment_provider().failure_domain() == "zone-b"
    monkeypatch.delenv("PINOT_FAILURE_DOMAIN")
    assert get_environment_provider("env").failure_domain() is None
    assert get_environment_provider("noop").get_environment() == {}
    register_environment_provider("fixed", lambda: type(
        "P", (EnvVarEnvironmentProvider,),
        {"get_environment": lambda self: {"failureDomain": "r1"}})())
    assert get_environment_provider("FIXED").failure_domain() == "r1"
    with pytest.raises(ValueError):
        get_environment_provider("azure")


def test_registration_carries_the_failure_domain(tmp_path, monkeypatch):
    """tests/test_fetcher_crypt_rest.py:286-297 on both packages: every
    server of a cluster started under PINOT_FAILURE_DOMAIN registers it."""
    from pinot_tpu.tools.cluster import EmbeddedCluster as JCluster
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster as TCluster

    monkeypatch.setenv("PINOT_FAILURE_DOMAIN", "rack-7")
    got = []
    for make in (lambda: JCluster(num_servers=2,
                                  data_dir=str(tmp_path / "j")),
                 lambda: TCluster(num_servers=2, device="cpu")):
        cluster = make()
        try:
            got.append(sorted((i.instance_id, i.failure_domain)
                              for i in cluster.store.instances("SERVER")))
        finally:
            cluster.shutdown()
    TELEMETRY.reset()
    assert got[1] == got[0] == [("server_0", "rack-7"),
                                ("server_1", "rack-7")]


def test_assignment_spreads_replicas_over_domains():
    from pinot_tpu.controller import assignment as jassign
    from pinot_tpu_torch.controller import assignment as tassign

    domains = {"s1": "zoneA", "s2": "zoneA", "s3": "zoneB", "s4": "zoneB"}
    current = {"seg0": {"s3": "ONLINE"}, "seg1": {"s4": "ONLINE"}}
    for seg in ("seg2", "seg3"):
        chosen = tassign.BalancedSegmentAssignment(domains=domains).assign(
            seg, current, ["s1", "s2", "s3", "s4"], 2)
        assert chosen == jassign.BalancedSegmentAssignment(
            domains=domains).assign(seg, current, ["s1", "s2", "s3", "s4"],
                                    2)
        assert {domains[c] for c in chosen} == {"zoneA", "zoneB"}
    d3 = {"s1": "fd1", "s2": "fd1", "s3": "fd2"}
    cur = {"seg0": {"s1": "ONLINE", "s2": "ONLINE"}}
    t = tassign.compute_target_assignment(cur, ["s1", "s2", "s3"], 2,
                                          domains=d3)
    assert t == jassign.compute_target_assignment(
        cur, ["s1", "s2", "s3"], 2, domains=d3)
    assert {d3[i] for i in t["seg0"]} == {"fd1", "fd2"}


# -- plugins --------------------------------------------------------------------

def test_plugin_loader(tmp_path, monkeypatch):
    from pinot_tpu_torch.ingestion.stream import _FACTORIES
    from pinot_tpu_torch.spi.plugin import MODULE_PREFIX, PluginManager

    (tmp_path / "my_stream.py").write_text(
        "from pinot_tpu_torch.ingestion.stream import (\n"
        "    StreamConsumerFactory, register_stream_type)\n"
        "class MyFactory(StreamConsumerFactory):\n"
        "    pass\n"
        "register_stream_type('mytest_port', MyFactory)\n")
    pkg = tmp_path / "my_fs"
    pkg.mkdir()
    (pkg / "__init__.py").write_text(
        "from pinot_tpu_torch.spi.filesystem import (\n"
        "    LocalPinotFS, register_fs)\n"
        "register_fs('myfs', LocalPinotFS)\n")
    (tmp_path / "_ignored.py").write_text("raise AssertionError\n")
    (tmp_path / "broken.py").write_text("import nonexistent_module\n")
    (tmp_path / "notes.txt").write_text("not a plugin\n")
    pm = PluginManager(str(tmp_path))
    assert pm.load_all() == ["my_fs", "my_stream"]
    assert "mytest_port" in _FACTORIES
    assert isinstance(tfs.get_fs("myfs://x"), tfs.LocalPinotFS)
    assert f"{MODULE_PREFIX}broken" not in __import__("sys").modules
    # loading again registers nothing twice
    assert PluginManager(str(tmp_path)).load_all() == []
    monkeypatch.setenv("PINOT_PLUGINS_DIR", str(tmp_path))
    assert PluginManager().plugins_dir == str(tmp_path)
    assert PluginManager("/nonexistent/dir").load_all() == []
