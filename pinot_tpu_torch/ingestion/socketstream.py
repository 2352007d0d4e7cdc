"""The socket stream: a partitioned log served over HTTP.

Counterpart of ``pinot_tpu/ingestion/socketstream.py`` (JAX :53-285, the
pinot-kafka-2.0 consumer's shape over a transport of its own):

- ``StreamBrokerServer``: partitioned append-only logs behind an HTTP
  server on real sockets; producers POST records (``produce``), topics
  are created or grown (``create_topic``), consumers GET an
  offset-addressed fetch and the topic's metadata;
- ``SocketStreamConsumerFactory`` under ``stream.type = socket``: the
  partition consumer and the metadata provider (partitions, earliest and
  latest offsets) over the broker's URL, the table config's
  ``stream.socket.broker.url`` property.

Every request has a timeout.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
import urllib.request

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

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

BROKER_URL_PROP = "stream.socket.broker.url"


# --------------------------------------------------------------------------
# broker server
# --------------------------------------------------------------------------

class _Topic:
    def __init__(self, num_partitions: int):
        self.partitions: List[List[Dict[str, Any]]] = [
            [] for _ in range(num_partitions)]
        self.lock = threading.Lock()


class StreamBrokerServer:
    """Standalone partitioned-log broker over HTTP (real sockets)."""

    def __init__(self, port: int = 0):
        self._topics: Dict[str, _Topic] = {}
        self._lock = threading.Lock()
        broker = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _json(self, code: int, payload) -> None:
                raw = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def _body(self):
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n).decode()) if n else {}

            def do_POST(self):
                try:
                    parts = self.path.strip("/").split("/")
                    if len(parts) == 2 and parts[0] == "topics":
                        body = self._body()
                        broker.create_topic(
                            parts[1], int(body.get("numPartitions", 1)))
                        self._json(200, {"status": "created"})
                    elif (len(parts) == 3 and parts[0] == "topics"
                          and parts[2] == "produce"):
                        body = self._body()
                        off = broker.produce(
                            parts[1], int(body.get("partition", 0)),
                            body["records"])
                        self._json(200, {"nextOffset": off})
                    else:
                        self._json(404, {"error": "no such endpoint"})
                except KeyError as e:
                    self._json(404, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — HTTP boundary
                    self._json(500, {"error": str(e)[:200]})

            def do_GET(self):
                try:
                    url = urllib.parse.urlparse(self.path)
                    parts = url.path.strip("/").split("/")
                    q = urllib.parse.parse_qs(url.query)
                    if (len(parts) == 3 and parts[0] == "topics"
                            and parts[2] == "metadata"):
                        self._json(200, broker.metadata(parts[1]))
                    elif (len(parts) == 3 and parts[0] == "topics"
                          and parts[2] == "fetch"):
                        self._json(200, broker.fetch(
                            parts[1], int(q["partition"][0]),
                            int(q["offset"][0]),
                            int(q.get("max", ["5000"])[0])))
                    else:
                        self._json(404, {"error": "no such endpoint"})
                except KeyError as e:
                    self._json(404, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    self._json(500, {"error": str(e)[:200]})

        self._httpd = listen(ThreadingHTTPServer, ("0.0.0.0", port),
                             Handler)
        self.port = self._httpd.server_port
        self.url = f"http://localhost:{self.port}"
        self._thread: Optional[threading.Thread] = None

    # -- broker ops ----------------------------------------------------------
    def create_topic(self, topic: str, num_partitions: int = 1) -> None:
        """Create — or EXPAND — a topic. Re-creating with a larger count
        appends empty partitions (kafka alter-topic semantics: partition
        counts only grow; existing partitions and offsets are untouched,
        which is what lets consumers survive the expansion)."""
        with self._lock:
            t = self._topics.get(topic)
            if t is None:
                self._topics[topic] = _Topic(num_partitions)
                return
            with t.lock:
                while len(t.partitions) < num_partitions:
                    t.partitions.append([])

    def _topic(self, topic: str) -> _Topic:
        t = self._topics.get(topic)
        if t is None:
            raise KeyError(f"no such topic {topic!r}")
        return t

    def produce(self, topic: str, partition: int,
                records: List[Any]) -> int:
        t = self._topic(topic)
        with t.lock:
            log = t.partitions[partition]
            now = int(time.time() * 1000)
            for r in records:
                log.append({"payload": r, "ts": now})
            return len(log)

    def metadata(self, topic: str) -> Dict[str, Any]:
        t = self._topic(topic)
        with t.lock:
            return {"numPartitions": len(t.partitions),
                    "earliest": [0] * len(t.partitions),
                    "latest": [len(p) for p in t.partitions]}

    def fetch(self, topic: str, partition: int, offset: int,
              max_messages: int) -> Dict[str, Any]:
        t = self._topic(topic)
        with t.lock:
            log = t.partitions[partition]
            chunk = log[offset:offset + max_messages]
            return {"messages": [
                {"payload": m["payload"], "offset": offset + i,
                 "ts": m["ts"]} for i, m in enumerate(chunk)],
                "nextOffset": offset + len(chunk)}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "StreamBrokerServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="stream-broker")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


# --------------------------------------------------------------------------
# client plugin (the stream SPI implementation)
# --------------------------------------------------------------------------

def _get_json(url: str, timeout: float = 10.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def produce(broker_url: str, topic: str, records: List[Any],
            partition: int = 0, timeout: float = 10.0) -> int:
    """Producer-side helper (tests/quickstarts publish through this)."""
    body = json.dumps({"partition": partition,
                       "records": records}).encode()
    req = urllib.request.Request(
        f"{broker_url}/topics/{topic}/produce", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())["nextOffset"]


def create_topic(broker_url: str, topic: str, num_partitions: int = 1,
                 timeout: float = 10.0) -> None:
    body = json.dumps({"numPartitions": num_partitions}).encode()
    req = urllib.request.Request(
        f"{broker_url}/topics/{topic}", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        resp.read()


class SocketPartitionConsumer(PartitionLevelConsumer):
    """Ref: KafkaPartitionLevelConsumer.fetchMessages — offset-addressed
    fetch over the wire; resuming from a committed offset is just fetching
    from it."""

    def __init__(self, broker_url: str, topic: str, partition: int):
        self._base = (f"{broker_url}/topics/{topic}/fetch"
                      f"?partition={partition}")

    def fetch_messages(self, start: StreamOffset,
                       max_messages: int = 5000,
                       timeout_ms: int = 5000) -> MessageBatch:
        d = _get_json(f"{self._base}&offset={start.value}"
                      f"&max={max_messages}",
                      timeout=max(timeout_ms / 1000.0, 0.5))
        msgs = [StreamMessage(payload=m["payload"],
                              offset=StreamOffset(int(m["offset"])),
                              timestamp_ms=int(m.get("ts", 0)))
                for m in d["messages"]]
        return MessageBatch(msgs, StreamOffset(int(d["nextOffset"])))


class SocketStreamMetadataProvider(StreamMetadataProvider):
    """Ref: KafkaStreamMetadataProvider — partition discovery + offsets."""

    def __init__(self, broker_url: str, topic: str):
        self._url = f"{broker_url}/topics/{topic}/metadata"

    def _meta(self) -> Dict[str, Any]:
        return _get_json(self._url)

    def partition_count(self) -> int:
        return int(self._meta()["numPartitions"])

    def earliest_offset(self, partition: int) -> StreamOffset:
        return StreamOffset(int(self._meta()["earliest"][partition]))

    def latest_offset(self, partition: int) -> StreamOffset:
        return StreamOffset(int(self._meta()["latest"][partition]))


class SocketStreamConsumerFactory(StreamConsumerFactory):
    """``stream.type = "socket"`` (ref: KafkaConsumerFactory)."""

    def __init__(self, config: StreamIngestionConfig):
        super().__init__(config)
        url = config.properties.get(BROKER_URL_PROP)
        if not url:
            raise ValueError(
                f"socket stream needs {BROKER_URL_PROP!r} in properties")
        self._url = url.rstrip("/")

    def create_partition_consumer(self, partition: int) -> SocketPartitionConsumer:
        return SocketPartitionConsumer(self._url, self.config.topic,
                                       partition)

    def create_metadata_provider(self) -> SocketStreamMetadataProvider:
        return SocketStreamMetadataProvider(self._url, self.config.topic)


register_stream_type("socket", SocketStreamConsumerFactory)
