"""The port's Kafka wire and socket streams against the JAX package's.

``encode_record_batch`` writes JAX's bytes for the same records (the
CRC-32C included, byte loop and vectorised lanes alike) and each package
decodes the other's; the port's Kafka client against JAX's
``KafkaBrokerSim`` and JAX's client against the port's (ApiVersions,
Metadata, ListOffsets, Fetch, an offset past the end, a partition added);
the same for the socket stream's broker and consumer; and a realtime
table on each stream type in both packages' clusters, fed by one broker,
answering the same queries with the same rows, a topic grown mid-stream
included (tests/test_socket_stream.py:126).
"""

import numpy as np
import pytest

from pinot_tpu.ingestion import kafkawire as jkw
from pinot_tpu.ingestion import socketstream as jss
from pinot_tpu.spi import Schema as JSchema
from pinot_tpu.spi import table as jtable
from pinot_tpu_torch.common.telemetry import TELEMETRY
from pinot_tpu_torch.ingestion import kafkawire as tkw
from pinot_tpu_torch.ingestion import socketstream as tss
from pinot_tpu_torch.ingestion.stream import (
    StreamOffset,
    create_consumer_factory,
)
from pinot_tpu_torch.spi import table as ttable
from pinot_tpu_torch.spi.data import Schema as TSchema


def _records(n, seed, key_every=3, big=False):
    rng = np.random.default_rng(seed)
    ts0 = 1_700_000_000_000
    out = []
    for i in range(n):
        key = None if i % key_every else f"k{i}".encode()
        size = int(rng.integers(100, 400) if big else rng.integers(0, 40))
        value = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        out.append((key, value, ts0 + int(rng.integers(0, 5000))))
    return out


@pytest.mark.parametrize("n,big", [(0, False), (1, False), (7, False),
                                   (300, False), (120, True), (500, True)])
@pytest.mark.parametrize("base", [0, 41, (1 << 40) + 3])
def test_record_batch_bytes_equal_jax(n, big, base):
    recs = _records(n, n + base % 97, big=big)
    raw = tkw.encode_record_batch(base, recs)
    assert raw == jkw.encode_record_batch(base, recs)
    want = [(base + i, k, v, ts) for i, (k, v, ts) in enumerate(recs)]
    assert tkw.decode_record_batches(raw) == want
    assert jkw.decode_record_batches(raw) == want


@pytest.mark.parametrize("n", [0, 1, 8191, 8192, 8193, 9000, 75_001,
                               1 << 20])
def test_crc32c_equal_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    assert tkw._crc32c(data) == jkw._crc32c(data)
    assert tkw._crc32c(b"123456789") == 0xE3069283


def test_record_batch_faults():
    recs = [(None, b"value%03d" % i, 1000 + i) for i in range(20)]
    raw = bytearray(tkw.encode_record_batch(0, recs))
    raw[-2] ^= 0x01                 # the last value's last byte
    with pytest.raises(ValueError, match="crc32c"):
        tkw.decode_record_batches(bytes(raw))
    assert len(tkw.decode_record_batches(bytes(raw), verify_crc=False)) == 20
    good = tkw.encode_record_batch(5, _records(3, 2))
    # a truncated trailing batch is dropped, as kafka allows
    assert tkw.decode_record_batches(good + good[:30]) == \
        tkw.decode_record_batches(good)


@pytest.mark.parametrize("server,client", [(jkw, tkw), (tkw, jkw)],
                         ids=["port_client_jax_broker",
                              "jax_client_port_broker"])
def test_kafka_clients_against_each_others_brokers(server, client):
    sim = server.KafkaBrokerSim().start()
    try:
        sim.create_topic("t", 2)
        vals = [{"i": i, "s": "x" * (i % 5)} for i in range(1300)]
        sim.produce("t", vals[0::2], partition=0)
        sim.produce("t", [b"raw-bytes"] * 3, partition=1)
        c = client.KafkaWireClient(sim.host, sim.port)
        try:
            apis = c.api_versions()
            assert apis[client.API_FETCH] == (0, 4)
            assert c.partition_count("t") == 2
            assert c.list_offset("t", 0, client.EARLIEST_TS) == 0
            assert c.list_offset("t", 0, client.LATEST_TS) == 650
            assert c.list_offset("t", 1, client.LATEST_TS) == 3
            got = c.fetch("t", 0, 100)
            assert [r[0] for r in got] == list(range(100, 600))
            assert c.fetch("t", 0, 650) == [] and c.fetch("t", 0, 9999) == []
            with pytest.raises(ValueError):
                c.partition_count("nope")
        finally:
            c.close()
        cfg = ttable.StreamIngestionConfig(
            stream_type="kafka", topic="t",
            properties={"stream.kafka.broker.list":
                        f"{sim.host}:{sim.port}"})
        consumer_cls = client.KafkaPartitionLevelConsumer
        cons = consumer_cls(sim.host, sim.port, "t", 0)
        try:
            b = cons.fetch_messages(StreamOffset(645), max_messages=3)
            assert [m.payload for m in b.messages] == vals[1290::2][:3]
            assert b.next_offset.value == 648
            end = cons.fetch_messages(StreamOffset(650))
            assert end.messages == [] and end.next_offset.value == 650
        finally:
            cons.close()
        assert cons._client._sock is None
        raw = consumer_cls(sim.host, sim.port, "t", 1)
        try:
            assert [m.payload for m in raw.fetch_messages(
                StreamOffset(0)).messages] == [b"raw-bytes"] * 3
        finally:
            raw.close()
        # a partition added mid-stream is served from offset 0
        sim.create_topic("t", 3)
        sim.produce("t", [{"late": 1}], partition=2)
        if client is tkw:
            factory = create_consumer_factory(cfg)
            meta = factory.create_metadata_provider()
            try:
                assert meta.partition_count() == 3
                assert meta.latest_offset(2).value == 1
                assert meta.earliest_offset(2).value == 0
            finally:
                meta.close()
            p2 = factory.create_partition_consumer(2)
            try:
                assert [m.payload for m in p2.fetch_messages(
                    StreamOffset(0)).messages] == [{"late": 1}]
            finally:
                p2.close()
    finally:
        sim.stop()


def test_kafka_factory_needs_a_broker_address():
    with pytest.raises(ValueError, match="host:port"):
        tkw.KafkaWireConsumerFactory(ttable.StreamIngestionConfig(
            stream_type="kafka", topic="t"))


@pytest.mark.parametrize("server,client", [(jss, tss), (tss, jss)],
                         ids=["port_client_jax_broker",
                              "jax_client_port_broker"])
def test_socket_clients_against_each_others_brokers(server, client):
    broker = server.StreamBrokerServer(port=0).start()
    try:
        client.create_topic(broker.url, "t1", num_partitions=3)
        for p in range(3):
            assert client.produce(broker.url, "t1",
                                  [{"p": p, "i": i} for i in range(5)],
                                  partition=p) == 5
        meta = client.SocketStreamMetadataProvider(broker.url, "t1")
        assert meta.partition_count() == 3
        assert meta.latest_offset(2).value == 5
        assert meta.earliest_offset(1).value == 0
        cons = client.SocketPartitionConsumer(broker.url, "t1", 1)
        b = cons.fetch_messages(StreamOffset(3), max_messages=10)
        assert [m.payload["i"] for m in b.messages] == [3, 4]
        assert b.next_offset.value == 5
        assert cons.fetch_messages(StreamOffset(9)).messages == []
        # the topic grows: the old partitions keep their offsets
        client.create_topic(broker.url, "t1", num_partitions=4)
        assert meta.partition_count() == 4
        assert meta.latest_offset(0).value == 5
        with pytest.raises(Exception):
            client.produce(broker.url, "nope", [{}], partition=0)
    finally:
        broker.stop()


def test_socket_factory_needs_a_broker_url():
    with pytest.raises(ValueError, match="broker.url"):
        tss.SocketStreamConsumerFactory(ttable.StreamIngestionConfig(
            stream_type="socket", topic="t"))


SCHEMA = {"schemaName": "ks",
          "dimensionFieldSpecs": [{"name": "region", "dataType": "STRING"}],
          "metricFieldSpecs": [{"name": "qty", "dataType": "LONG"}],
          "dateTimeFieldSpecs": [{"name": "ts", "dataType": "LONG",
                                  "format": "1:MILLISECONDS:EPOCH",
                                  "granularity": "1:MILLISECONDS"}]}
QUERIES = ["SELECT count(*) FROM ks",
           "SELECT region, sum(qty), count(*) FROM ks GROUP BY region "
           "ORDER BY region",
           "SELECT max(ts), min(qty) FROM ks WHERE region <> 'n'"]


def _rows(n, seed, start=0):
    rng = np.random.default_rng(seed)
    return [{"region": ["e", "w", "n"][int(rng.integers(0, 3))],
             "qty": int(rng.integers(1, 9)), "ts": start + i}
            for i in range(n)]


def _table(mod, stream_type, topic, props):
    return mod.TableConfig(
        "ks", mod.TableType.REALTIME,
        validation_config=mod.SegmentsValidationConfig(
            time_column_name="ts"),
        stream_config=mod.StreamIngestionConfig(
            stream_type=stream_type, topic=topic,
            segment_flush_threshold_rows=300, properties=props))


@pytest.mark.parametrize("stream_type", ["kafka", "socket"])
def test_realtime_tables_on_both_clusters(tmp_path, stream_type):
    """One broker (the port's Kafka simulator, JAX's socket broker) feeds a
    realtime table in each package's cluster; the same rows give the same
    answers, before and after the topic grows from 2 to 3 partitions."""
    from pinot_tpu.tools.cluster import EmbeddedCluster as JCluster
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster as TCluster

    topic = f"rt_{stream_type}"
    if stream_type == "kafka":
        broker = tkw.KafkaBrokerSim().start()
        broker.create_topic(topic, 2)
        props = {"stream.kafka.broker.list": f"{broker.host}:{broker.port}"}

        def put(rows, p):
            broker.produce(topic, rows, partition=p)

        def grow(n):
            broker.create_topic(topic, n)
    else:
        broker = jss.StreamBrokerServer(port=0).start()
        jss.create_topic(broker.url, topic, num_partitions=2)
        props = {"stream.socket.broker.url": broker.url}

        def put(rows, p):
            jss.produce(broker.url, topic, rows, partition=p)

        def grow(n):
            jss.create_topic(broker.url, topic, num_partitions=n)

    rows = _rows(1000, 7)
    for p in (0, 1):
        put(rows[p:800:2], p)
    clusters = [JCluster(num_servers=2, data_dir=str(tmp_path / "j")),
                TCluster(num_servers=2, device="cpu",
                         data_dir=str(tmp_path / "t"))]
    try:
        for c, mod, schema_cls in zip(clusters, (jtable, ttable),
                                      (JSchema, TSchema)):
            c.create_table(_table(mod, stream_type, topic, props),
                           schema_cls.from_dict(SCHEMA))
        for c in clusters:
            assert c.wait_for_docs("ks", 800, timeout_s=60)
        answers = [[c.query_rows(q) for q in QUERIES] for c in clusters]
        assert answers[1] == answers[0]
        assert answers[1][0] == [[800]]
        sealed = [m for m in clusters[1].store.segment_metadata_list(
            "ks_REALTIME") if m.status == "ONLINE"]
        assert len(sealed) == 2 and all(m.end_offset for m in sealed)
        grow(3)
        put(rows[800:], 2)
        for c in clusters:
            c.controller.run_realtime_validation()
            assert c.wait_for_docs("ks", 1000, timeout_s=60)
        answers = [[c.query_rows(q) for q in QUERIES] for c in clusters]
        assert answers[1] == answers[0]
        assert answers[1][0] == [[1000]]
        assert clusters[1].wait_for_consumers("ks_REALTIME", timeout_s=60)
    finally:
        for c in clusters:
            c.shutdown()
        TELEMETRY.reset()
        broker.stop()


def test_servers_listen_on_fresh_ports():
    """Each in-process server asked for port 0 binds without SO_REUSEADDR
    (a port no old connection holds in TIME_WAIT) and with a backlog of
    128; one asked for a fixed port keeps SO_REUSEADDR."""
    import socket
    import socketserver

    from pinot_tpu_torch.common.netserver import LISTEN_BACKLOG, listen
    from pinot_tpu_torch.spi.s3fs import MockS3Server
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster
    from pinot_tpu_torch.transport.rest import serve_cluster

    def reuse(sock):
        return sock.getsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR)

    kafka, sock = tkw.KafkaBrokerSim(), tss.StreamBrokerServer()
    s3 = MockS3Server()
    cluster = EmbeddedCluster(num_servers=1, device="cpu")
    apis = serve_cluster(cluster)
    try:
        for srv in (kafka._srv, sock._httpd, s3._httpd,
                    *(a._httpd for a in apis)):
            assert reuse(srv.socket) == 0
            assert srv.request_queue_size == LISTEN_BACKLOG
        port = apis[0].port
        for a in apis:
            a.stop()
        apis = []
        fixed = listen(socketserver.TCPServer, ("127.0.0.1", port),
                       socketserver.BaseRequestHandler)
        try:
            assert reuse(fixed.socket) != 0
        finally:
            fixed.server_close()
    finally:
        for a in apis:
            a.stop()
        cluster.shutdown()
        TELEMETRY.reset()
        for srv in (kafka._srv, sock._httpd, s3._httpd):
            srv.server_close()
