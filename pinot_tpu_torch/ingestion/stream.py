"""Stream SPI: partition consumers fetching message batches by offset.

Counterpart of ``pinot_tpu/ingestion/stream.py``: ``StreamOffset``
(an int64 offset), ``StreamMessage``, ``MessageBatch``, the consumer,
metadata provider and factory interfaces with a registry keyed by
``stream.type``, the decoder registry with ``JsonMessageDecoder``, and
``MemoryStream``, an in-process partitioned log with its consumer
(``stream.type = memory``, the topic from the stream config). The socket
stream (``socketstream.py``) and the Kafka wire stream (``kafkawire.py``)
register themselves when the ``ingestion`` package is imported.
"""

from __future__ import annotations

import json
import threading

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from pinot_tpu_torch.spi.table import StreamIngestionConfig


@dataclass(frozen=True, order=True)
class StreamOffset:
    value: int

    def __str__(self) -> str:
        return str(self.value)

    @classmethod
    def parse(cls, s: str) -> "StreamOffset":
        return cls(int(s))


@dataclass
class StreamMessage:
    payload: Any
    offset: StreamOffset
    key: Optional[Any] = None
    timestamp_ms: int = 0


@dataclass
class MessageBatch:
    """Messages and the offset to resume from."""

    messages: List[StreamMessage]
    next_offset: StreamOffset

    @property
    def message_count(self) -> int:
        return len(self.messages)


class PartitionLevelConsumer:
    """Fetches one partition's messages from an offset."""

    def fetch_messages(self, start: StreamOffset, max_messages: int = 5000,
                       timeout_ms: int = 5000) -> MessageBatch:
        raise NotImplementedError

    def close(self) -> None:
        pass


class StreamMetadataProvider:
    def partition_count(self) -> int:
        raise NotImplementedError

    def earliest_offset(self, partition: int) -> StreamOffset:
        raise NotImplementedError

    def latest_offset(self, partition: int) -> StreamOffset:
        raise NotImplementedError

    def close(self) -> None:
        pass


class StreamConsumerFactory:
    def __init__(self, config: StreamIngestionConfig):
        self.config = config

    def create_partition_consumer(self, partition: int
                                  ) -> PartitionLevelConsumer:
        raise NotImplementedError

    def create_metadata_provider(self) -> StreamMetadataProvider:
        raise NotImplementedError


class StreamMessageDecoder:
    """A message's payload -> a row dict, or None to drop it."""

    def decode(self, message: StreamMessage) -> Optional[Dict[str, Any]]:
        raise NotImplementedError


class JsonMessageDecoder(StreamMessageDecoder):
    """A JSON object (str or bytes) or a dict payload."""

    def decode(self, message: StreamMessage) -> Optional[Dict[str, Any]]:
        p = message.payload
        if isinstance(p, dict):
            return dict(p)
        if isinstance(p, bytes):
            p = p.decode("utf-8")
        try:
            v = json.loads(p)
        except (json.JSONDecodeError, TypeError):
            return None
        return v if isinstance(v, dict) else None


# -- registries ---------------------------------------------------------------

_FACTORIES: Dict[str, Callable[[StreamIngestionConfig],
                               StreamConsumerFactory]] = {}
_DECODERS: Dict[str, Callable[[], StreamMessageDecoder]] = {}


def register_stream_type(name: str, factory: Callable[
        [StreamIngestionConfig], StreamConsumerFactory]) -> None:
    _FACTORIES[name.lower()] = factory


def register_decoder(name: str,
                     ctor: Callable[[], StreamMessageDecoder]) -> None:
    _DECODERS[name.lower()] = ctor


def create_consumer_factory(config: StreamIngestionConfig
                            ) -> StreamConsumerFactory:
    f = _FACTORIES.get((config.stream_type or "").lower())
    if f is None:
        raise ValueError(f"unknown stream type {config.stream_type!r}; "
                         f"registered: {sorted(_FACTORIES)}")
    return f(config)


def create_decoder(name: Optional[str]) -> StreamMessageDecoder:
    if not name:
        return JsonMessageDecoder()
    d = _DECODERS.get(name.lower())
    if d is None:
        # a reference class name, '...JSONMessageDecoder'
        if "json" in name.lower():
            return JsonMessageDecoder()
        raise ValueError(f"unknown decoder {name!r}")
    return d()


# -- the in-memory stream -----------------------------------------------------

class MemoryStream:
    """An in-process partitioned log: producers append, consumers fetch by
    offset; topics are registered by name so a stream config names one as
    it would a Kafka topic."""

    _topics: Dict[str, "MemoryStream"] = {}
    _lock = threading.Lock()

    def __init__(self, topic: str, num_partitions: int = 1):
        self.topic = topic
        self.num_partitions = num_partitions
        self._partitions: List[List[StreamMessage]] = [
            [] for _ in range(num_partitions)]
        self._plock = threading.Lock()

    @classmethod
    def create(cls, topic: str, num_partitions: int = 1) -> "MemoryStream":
        with cls._lock:
            s = cls(topic, num_partitions)
            cls._topics[topic] = s
            return s

    @classmethod
    def get(cls, topic: str) -> "MemoryStream":
        with cls._lock:
            s = cls._topics.get(topic)
            if s is None:
                raise KeyError(f"no such topic {topic!r}")
            return s

    @classmethod
    def delete(cls, topic: str) -> None:
        with cls._lock:
            cls._topics.pop(topic, None)

    def produce(self, payload: Any, partition: Optional[int] = None,
                key: Optional[Any] = None,
                timestamp_ms: int = 0) -> StreamOffset:
        with self._plock:
            if partition is None:
                partition = ((hash(key) if key is not None else 0)
                             % self.num_partitions)
            log = self._partitions[partition]
            off = StreamOffset(len(log))
            log.append(StreamMessage(payload, off, key, timestamp_ms))
            return off

    def produce_many(self, payloads: List[Any], partition: int = 0
                     ) -> StreamOffset:
        """Append ``payloads`` to one partition in order; -> the offset
        after the last."""
        with self._plock:
            log = self._partitions[partition]
            base = len(log)
            log.extend(StreamMessage(p, StreamOffset(base + i))
                       for i, p in enumerate(payloads))
            return StreamOffset(len(log))

    def fetch(self, partition: int, start: StreamOffset,
              max_messages: int) -> MessageBatch:
        with self._plock:
            msgs = self._partitions[partition][
                start.value:start.value + max_messages]
            return MessageBatch(list(msgs),
                                StreamOffset(start.value + len(msgs)))

    def latest_offset(self, partition: int) -> StreamOffset:
        with self._plock:
            return StreamOffset(len(self._partitions[partition]))


class MemoryStreamConsumer(PartitionLevelConsumer):
    def __init__(self, stream: MemoryStream, partition: int):
        self._stream = stream
        self._partition = partition

    def fetch_messages(self, start: StreamOffset, max_messages: int = 5000,
                       timeout_ms: int = 5000) -> MessageBatch:
        return self._stream.fetch(self._partition, start, max_messages)


class MemoryStreamMetadataProvider(StreamMetadataProvider):
    def __init__(self, stream: MemoryStream):
        self._stream = stream

    def partition_count(self) -> int:
        return self._stream.num_partitions

    def earliest_offset(self, partition: int) -> StreamOffset:
        return StreamOffset(0)

    def latest_offset(self, partition: int) -> StreamOffset:
        return self._stream.latest_offset(partition)


class MemoryStreamConsumerFactory(StreamConsumerFactory):
    """``stream.type = memory``; the topic from the stream config."""

    def _stream(self) -> MemoryStream:
        return MemoryStream.get(self.config.topic)

    def create_partition_consumer(self, partition: int
                                  ) -> MemoryStreamConsumer:
        return MemoryStreamConsumer(self._stream(), partition)

    def create_metadata_provider(self) -> MemoryStreamMetadataProvider:
        return MemoryStreamMetadataProvider(self._stream())


register_stream_type("memory", MemoryStreamConsumerFactory)
