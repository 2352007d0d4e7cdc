"""The Kafka wire stream: the consumer's subset of the Kafka protocol on TCP.

Counterpart of ``pinot_tpu/ingestion/kafkawire.py`` (JAX :42-579; the
reference's pinot-kafka-2.0 ``KafkaPartitionLevelConsumer``,
``KafkaStreamMetadataProvider`` and ``KafkaConsumerFactory``), without a
Kafka client library: ApiVersions (key 18, v0), Metadata (key 3, v1),
ListOffsets (key 2, v1; earliest -2, latest -1) and Fetch (key 1, v4)
with record batches of magic 2 (CRC-32C, zigzag varint record fields;
``encode_record_batch`` gives JAX's bytes for the same records).

``KafkaBrokerSim`` is an in-process broker that answers those requests
with the bytes a broker sends; ``KafkaWireClient`` is one connection,
with a 30 s timeout on its socket; the consumer, the metadata provider
and the factory serve ``stream.type = kafka`` with the broker at
``stream.kafka.broker.list`` (``host:port``). A consumer's ``close``
closes its socket. A fetch past a partition's end returns no records,
and a partition added to a topic is served from offset 0.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.common.netserver import listen
from pinot_tpu_torch.ingestion.stream import (
    MessageBatch,
    PartitionLevelConsumer,
    StreamConsumerFactory,
    StreamMessage,
    StreamMetadataProvider,
    StreamOffset,
    register_stream_type,
)
from pinot_tpu_torch.spi.table import StreamIngestionConfig

API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_VERSIONS = 18

EARLIEST_TS = -2
LATEST_TS = -1


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("short kafka buffer")
        self.pos += n
        return b

    def i8(self) -> int:
        return struct.unpack(">b", self.take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        return None if n < 0 else self.take(n).decode("utf-8")

    def varint(self) -> int:
        """Zigzag varint (kafka record fields)."""
        shift, out = 0, 0
        while True:
            b = self.take(1)[0]
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (out >> 1) ^ -(out & 1)

    def remaining(self) -> int:
        return len(self.buf) - self.pos


def _s(v: Optional[str]) -> bytes:
    if v is None:
        return struct.pack(">h", -1)
    raw = v.encode("utf-8")
    return struct.pack(">h", len(raw)) + raw


def _varint(v: int) -> bytes:
    z = (v << 1) ^ (v >> 63) if v < 0 else v << 1
    out = bytearray()
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _build_crc32c_table() -> tuple:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


# built eagerly at import: the handlers run under ThreadingTCPServer, and a
# lazily-appended list is readable half-built by a concurrent request
_CRC32C_TABLE = _build_crc32c_table()


_CRC32C_NP = np.asarray(_CRC32C_TABLE, dtype=np.uint32)
#: lanes of the vectorised CRC (a power of 2), and the size below which a
#: byte loop is quicker
_CRC_LANES = 512
_CRC_VECTOR_MIN = 8192


def _crc_bytes(crc: int, data) -> int:
    """The CRC register after ``data``, a byte at a time."""
    for b in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return crc


def _shift_columns(n: int) -> np.ndarray:
    """The linear map of ``n`` zero bytes on the CRC register, as the
    images of its 32 unit vectors."""
    c = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    for _ in range(n):
        c = (c >> np.uint32(8)) ^ _CRC32C_NP[c & np.uint32(0xFF)]
    return c


def _apply(cols: np.ndarray, regs: np.ndarray) -> np.ndarray:
    """The linear map given by ``cols`` on each register of ``regs``."""
    out = np.zeros_like(regs)
    for i in range(32):
        out ^= np.where((regs >> np.uint32(i)) & np.uint32(1), cols[i],
                        np.uint32(0))
    return out


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the record-batch checksum kafka uses: JAX's
    value. A large buffer runs as ``_CRC_LANES`` lanes at once (a byte
    column a step, in numpy); the lanes' registers are then folded in
    pairs, the left one carried over the right one's length of zero
    bytes (the CRC register is linear in its start)."""
    n = len(data)
    if n < _CRC_VECTOR_MIN:
        return _crc_bytes(0xFFFFFFFF, data) ^ 0xFFFFFFFF
    m = n // _CRC_LANES
    lanes = np.frombuffer(data, dtype=np.uint8, count=m * _CRC_LANES
                          ).reshape(_CRC_LANES, m)
    regs = np.zeros(_CRC_LANES, dtype=np.uint32)
    regs[0] = 0xFFFFFFFF            # the start register enters lane 0
    for j in range(m):
        regs = (regs >> np.uint32(8)) ^ _CRC32C_NP[
            (regs ^ lanes[:, j]) & np.uint32(0xFF)]
    cols = _shift_columns(m)
    while regs.shape[0] > 1:
        regs = _apply(cols, regs[0::2]) ^ regs[1::2]
        cols = _apply(cols, cols)   # the zero run doubles each fold
    crc = _crc_bytes(int(regs[0]), data[m * _CRC_LANES:])
    return crc ^ 0xFFFFFFFF


# --------------------------------------------------------------------------
# record batches (magic v2)
# --------------------------------------------------------------------------

def encode_record_batch(base_offset: int,
                        records: List[Tuple[Optional[bytes], bytes, int]]
                        ) -> bytes:
    """[(key, value, timestamp_ms)] -> one magic-v2 batch."""
    first_ts = records[0][2] if records else 0
    max_ts = max((r[2] for r in records), default=0)
    body = bytearray()
    for i, (key, value, ts) in enumerate(records):
        rec = bytearray()
        rec += b"\x00"                       # attributes
        rec += _varint(ts - first_ts)        # timestamp delta
        rec += _varint(i)                    # offset delta
        if key is None:
            rec += _varint(-1)
        else:
            rec += _varint(len(key)) + key
        rec += _varint(len(value)) + value
        rec += _varint(0)                    # headers
        body += _varint(len(rec)) + rec

    after_crc = (
        struct.pack(">hiqqqhii", 0, len(records) - 1, first_ts, max_ts,
                    -1, -1, -1, len(records))
        + bytes(body))
    crc = _crc32c(after_crc)
    inner = struct.pack(">ibI", 0, 2, crc) + after_crc  # epoch, magic, crc
    return struct.pack(">qi", base_offset, len(inner)) + inner


def decode_record_batches(buf: bytes, verify_crc: bool = True
                          ) -> List[Tuple[int, Optional[bytes], bytes, int]]:
    """Record set bytes -> [(abs_offset, key, value, timestamp_ms)]."""
    out = []
    r = _Reader(buf)
    while r.remaining() >= 12:
        base_offset = r.i64()
        batch_len = r.i32()
        if r.remaining() < batch_len:
            break  # truncated trailing batch (kafka allows it) — drop
        br = _Reader(r.take(batch_len))
        br.i32()                     # partition leader epoch
        magic = br.i8()
        if magic != 2:
            raise ValueError(f"unsupported record batch magic {magic}")
        crc = br.u32()
        rest = br.buf[br.pos:]
        if verify_crc and _crc32c(rest) != crc:
            raise ValueError("record batch crc32c mismatch")
        attrs = br.i16()
        if attrs & 0x07:
            raise ValueError("compressed batches not supported")
        br.i32()                     # last offset delta
        first_ts = br.i64()
        br.i64()                     # max timestamp
        br.i64()                     # producer id
        br.i16()                     # producer epoch
        br.i32()                     # base sequence
        n = br.i32()
        for _ in range(n):
            size = br.varint()
            rr = _Reader(br.take(size))
            rr.i8()                  # attributes
            ts_delta = rr.varint()
            off_delta = rr.varint()
            klen = rr.varint()
            key = rr.take(klen) if klen >= 0 else None
            vlen = rr.varint()
            value = rr.take(vlen) if vlen >= 0 else b""
            rr.varint()              # headers (0)
            out.append((base_offset + off_delta, key, value,
                        first_ts + ts_delta))
    return out


# --------------------------------------------------------------------------
# in-test broker (KafkaStarterUtils analogue, wire-faithful)
# --------------------------------------------------------------------------

class KafkaBrokerSim:
    """Single-node broker speaking the consumer's protocol subset."""

    def __init__(self, port: int = 0):
        self._topics: Dict[str, List[List[Tuple[Optional[bytes], bytes, int]]]] = {}
        self._lock = threading.Lock()
        sim = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        hdr = self._recv_exact(4)
                        if hdr is None:
                            return
                        size = struct.unpack(">i", hdr)[0]
                        req = self._recv_exact(size)
                        if req is None:
                            return
                        resp = sim._handle(req)
                        self.request.sendall(
                            struct.pack(">i", len(resp)) + resp)
                except (ConnectionError, OSError):
                    pass

            def _recv_exact(self, n):
                buf = b""
                while len(buf) < n:
                    chunk = self.request.recv(n - len(buf))
                    if not chunk:
                        return None
                    buf += chunk
                return buf

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True

        self._srv = listen(Server, ("127.0.0.1", port), Handler)
        self.port = self._srv.server_address[1]
        self.host = "127.0.0.1"
        self._thread: Optional[threading.Thread] = None

    # -- scripting surface ---------------------------------------------------
    def create_topic(self, topic: str, num_partitions: int = 1) -> None:
        with self._lock:
            t = self._topics.get(topic)
            if t is None:
                self._topics[topic] = [[] for _ in range(num_partitions)]
            else:
                while len(t) < num_partitions:
                    t.append([])

    def produce(self, topic: str, records: List[Any],
                partition: int = 0) -> int:
        now = int(time.time() * 1000)
        with self._lock:
            log = self._topics[topic][partition]
            for rec in records:
                value = (rec if isinstance(rec, bytes)
                         else json.dumps(rec).encode("utf-8"))
                log.append((None, value, now))
            return len(log)

    def start(self) -> "KafkaBrokerSim":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True, name="kafka-sim")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()

    # -- protocol ------------------------------------------------------------
    def _handle(self, req: bytes) -> bytes:
        r = _Reader(req)
        api_key, api_version, corr = r.i16(), r.i16(), r.i32()
        r.string()  # client id
        head = struct.pack(">i", corr)
        if api_key == API_VERSIONS:
            apis = [(API_FETCH, 0, 4), (API_LIST_OFFSETS, 0, 1),
                    (API_METADATA, 0, 1), (API_VERSIONS, 0, 0)]
            body = struct.pack(">hi", 0, len(apis)) + b"".join(
                struct.pack(">hhh", *a) for a in apis)
            return head + body
        if api_key == API_METADATA:
            return head + self._metadata(r)
        if api_key == API_LIST_OFFSETS:
            return head + self._list_offsets(r)
        if api_key == API_FETCH:
            return head + self._fetch(r)
        raise ValueError(f"unsupported api key {api_key}")

    def _metadata(self, r: _Reader) -> bytes:
        n = r.i32()
        names = ([r.string() for _ in range(n)] if n >= 0
                 else sorted(self._topics))
        out = bytearray()
        # brokers [node_id host port rack], controller_id
        out += struct.pack(">i", 1)
        out += struct.pack(">i", 0) + _s(self.host) \
            + struct.pack(">i", self.port) + _s(None)
        out += struct.pack(">i", 0)
        out += struct.pack(">i", len(names))
        with self._lock:
            for name in names:
                parts = self._topics.get(name)
                err = 0 if parts is not None else 3  # UNKNOWN_TOPIC
                out += struct.pack(">h", err) + _s(name) + b"\x00"
                out += struct.pack(">i", len(parts or []))
                for p in range(len(parts or [])):
                    # error, partition, leader, replicas [0], isr [0]
                    out += struct.pack(">hiiii", 0, p, 0, 1, 0)
                    out += struct.pack(">ii", 1, 0)
        return bytes(out)

    def _list_offsets(self, r: _Reader) -> bytes:
        r.i32()  # replica id
        n_topics = r.i32()
        out = bytearray(struct.pack(">i", n_topics))
        with self._lock:
            for _ in range(n_topics):
                name = r.string()
                n_parts = r.i32()
                out += _s(name) + struct.pack(">i", n_parts)
                for _ in range(n_parts):
                    part, ts = r.i32(), r.i64()
                    log = self._topics.get(name, [[]])[part] \
                        if name in self._topics else []
                    off = 0 if ts == EARLIEST_TS else len(log)
                    out += struct.pack(">ihqq", part, 0, -1, off)
        return bytes(out)

    def _fetch(self, r: _Reader) -> bytes:
        r.i32()  # replica
        r.i32()  # max wait
        r.i32()  # min bytes
        r.i32()  # max bytes
        r.i8()   # isolation level
        n_topics = r.i32()
        out = bytearray(struct.pack(">ii", 0, n_topics))  # throttle, topics
        with self._lock:
            for _ in range(n_topics):
                name = r.string()
                n_parts = r.i32()
                out += _s(name) + struct.pack(">i", n_parts)
                for _ in range(n_parts):
                    part, offset = r.i32(), r.i64()
                    r.i32()  # partition max bytes
                    log = self._topics.get(name, [])
                    plog = log[part] if part < len(log) else []
                    hw = len(plog)
                    chunk = plog[offset:offset + 500]
                    record_set = (encode_record_batch(offset, chunk)
                                  if chunk else b"")
                    out += struct.pack(">ihqqi", part, 0, hw, hw, 0)
                    out += struct.pack(">i", len(record_set)) + record_set
        return bytes(out)


# --------------------------------------------------------------------------
# client + plugin
# --------------------------------------------------------------------------

class KafkaWireClient:
    """One broker connection; blocking request/response with kafka framing."""

    def __init__(self, host: str, port: int, client_id: str = "pinot-tpu"):
        self.client_id = client_id
        self.host, self.port = host, port
        self._corr = 0
        self._sock: Optional[socket.socket] = None  # lazy: connect on use
        self._lock = threading.Lock()

    def request(self, api_key: int, api_version: int, body: bytes) -> _Reader:
        with self._lock:
            if self._sock is None:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=30)
            self._corr += 1
            corr = self._corr
            req = (struct.pack(">hhi", api_key, api_version, corr)
                   + _s(self.client_id) + body)
            self._sock.sendall(struct.pack(">i", len(req)) + req)
            size = struct.unpack(">i", self._recv(4))[0]
            resp = _Reader(self._recv(size))
        got = resp.i32()
        if got != corr:
            raise ValueError(f"correlation mismatch {got} != {corr}")
        return resp

    def _recv(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("kafka broker closed the connection")
            buf += chunk
        return buf

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- API calls the plugin uses ------------------------------------------
    def api_versions(self) -> Dict[int, Tuple[int, int]]:
        r = self.request(API_VERSIONS, 0, b"")
        err = r.i16()
        if err:
            raise ValueError(f"ApiVersions error {err}")
        return {k: (lo, hi) for k, lo, hi in
                (struct.unpack(">hhh", r.take(6))
                 for _ in range(r.i32()))}

    def partition_count(self, topic: str) -> int:
        body = struct.pack(">i", 1) + _s(topic)
        r = self.request(API_METADATA, 1, body)
        n_brokers = r.i32()
        for _ in range(n_brokers):
            r.i32()
            r.string()
            r.i32()
            r.string()
        r.i32()  # controller
        if r.i32() < 1:
            raise ValueError(f"no metadata for topic {topic!r}")
        err = r.i16()
        r.string()
        r.i8()
        if err:
            raise ValueError(f"metadata error {err} for topic {topic!r}")
        return r.i32()

    def list_offset(self, topic: str, partition: int, timestamp: int) -> int:
        body = (struct.pack(">ii", -1, 1) + _s(topic)
                + struct.pack(">iiq", 1, partition, timestamp))
        r = self.request(API_LIST_OFFSETS, 1, body)
        r.i32()  # topic count (1)
        r.string()
        r.i32()  # partition count (1)
        part, err, _ts, off = r.i32(), r.i16(), r.i64(), r.i64()
        if err:
            raise ValueError(f"ListOffsets error {err} on {topic}/{part}")
        return off

    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 1 << 20, max_wait_ms: int = 100
              ) -> List[Tuple[int, Optional[bytes], bytes, int]]:
        body = (struct.pack(">iiiib", -1, max_wait_ms, 1, max_bytes, 0)
                + struct.pack(">i", 1) + _s(topic)
                + struct.pack(">iiqi", 1, partition, offset, max_bytes))
        r = self.request(API_FETCH, 4, body)
        r.i32()  # throttle
        r.i32()  # topic count (1)
        r.string()
        r.i32()  # partition count (1)
        part, err = r.i32(), r.i16()
        r.i64()  # high watermark
        r.i64()  # last stable offset
        n_aborted = r.i32()
        for _ in range(max(n_aborted, 0)):
            r.i64()
            r.i64()
        if err:
            raise ValueError(f"Fetch error {err} on {topic}/{part}")
        record_set = r.take(r.i32())
        return decode_record_batches(record_set)


class KafkaPartitionLevelConsumer(PartitionLevelConsumer):
    """Ref: KafkaPartitionLevelConsumer.java — poll records from one
    partition starting at an offset."""

    def __init__(self, host: str, port: int, topic: str, partition: int):
        self._client = KafkaWireClient(host, port)
        self.topic = topic
        self.partition = partition

    def fetch_messages(self, start: StreamOffset, max_messages: int = 5000,
                       timeout_ms: int = 5000) -> MessageBatch:
        records = self._client.fetch(self.topic, self.partition,
                                     start.value,
                                     max_wait_ms=min(timeout_ms, 500))
        msgs = []
        next_off = start.value
        for abs_off, _key, value, ts in records:
            if abs_off < start.value:
                continue  # batch started before the requested offset
            if len(msgs) >= max_messages:
                break
            try:
                payload = json.loads(value.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                payload = value
            msgs.append(StreamMessage(payload=payload,
                                      offset=StreamOffset(abs_off),
                                      timestamp_ms=ts))
            next_off = abs_off + 1
        return MessageBatch(messages=msgs, next_offset=StreamOffset(next_off))

    def close(self) -> None:
        self._client.close()


class KafkaStreamMetadataProvider(StreamMetadataProvider):
    def __init__(self, host: str, port: int, topic: str):
        self._client = KafkaWireClient(host, port)
        self.topic = topic

    def partition_count(self) -> int:
        return self._client.partition_count(self.topic)

    def earliest_offset(self, partition: int) -> StreamOffset:
        return StreamOffset(
            self._client.list_offset(self.topic, partition, EARLIEST_TS))

    def latest_offset(self, partition: int) -> StreamOffset:
        return StreamOffset(
            self._client.list_offset(self.topic, partition, LATEST_TS))

    def close(self) -> None:
        self._client.close()


class KafkaWireConsumerFactory(StreamConsumerFactory):
    """Ref: KafkaConsumerFactory — stream.type=kafka; broker address from
    ``stream.kafka.broker.list`` ('host:port')."""

    def __init__(self, config: StreamIngestionConfig):
        super().__init__(config)
        addr = config.properties.get("stream.kafka.broker.list", "")
        if ":" not in addr:
            raise ValueError(
                "stream.kafka.broker.list must be 'host:port', got "
                f"{addr!r}")
        host, port = addr.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.topic = config.topic

    def create_partition_consumer(self, partition: int
                                  ) -> KafkaPartitionLevelConsumer:
        return KafkaPartitionLevelConsumer(self.host, self.port, self.topic,
                                           partition)

    def create_metadata_provider(self) -> KafkaStreamMetadataProvider:
        return KafkaStreamMetadataProvider(self.host, self.port, self.topic)


register_stream_type("kafka", KafkaWireConsumerFactory)
