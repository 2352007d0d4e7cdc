"""Realtime consumption: the consume loop and the commit state machine.

Counterpart of ``pinot_tpu/ingestion/realtime.py``: a
``RealtimeSegmentDataManager`` drains one stream partition's message
batches into a ``MutableSegment`` (decode -> transform -> index),
tracks offsets, and at the flush threshold (rows, or age with at least
one row) negotiates the commit through the segment-completion protocol:
segmentConsumed -> HOLD / CATCHUP / COMMIT / KEEP / DISCARD, then the
split commit (commit start, build, upload, commit end).
``LocalCompletionProtocol`` always commits (one replica, no
controller).

The seal (``build_segment``) builds the consuming segment's rows into an
in-memory ``ImmutableSegment`` with the default star-tree stamped on
(unless the table configures trees) and the stream offsets and partition
in its metadata's ``custom``; it replaces the consuming segment
(``sealed_segment``, ``on_committed``), and the fused-scan kernel or its
star-tree serves it from its first query. The JAX package also writes
the segment directory to disk (the port has no on-disk format yet) and
records the seal's telemetry (ROADMAP item 5b).

``upsert_hook(row, doc_id)`` runs after each indexed row. A table whose
config enables upsert gets it from its upsert manager
(``segment/upsert.py`` ``table_upsert_manager``, or the one passed in:
in a cluster the server's table data manager's, so keys are shared
across a table's segments on that server): the hook is the partition
manager's ``add_record``, the consuming segment carries the live bitmap
view, and the sealed segment takes the bitmap over. In the JAX package
the server's table data manager does this wiring
(``pinot_tpu/server/data_manager.py:209-224``, ``:277-291``).

A server runs each consumer on its own thread (``start``, the
reference's PartitionConsumer): it steps the state machine, waits a tick
while HOLDing or while the stream has nothing new, and on a terminal
state calls ``on_terminal(mgr)`` once, unless it was stopped. ``stop``
joins the thread within a bounded wait and, unless the segment was
committed or discarded, tells the protocol that this replica stopped
consuming (``segment_stopped_consuming``), so it leaves the election.
"""

from __future__ import annotations

import enum
import logging
import threading
import time

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

from pinot_tpu_torch.common.telemetry import observe_ms
from pinot_tpu_torch.ingestion.stream import (
    StreamConsumerFactory,
    StreamMessageDecoder,
    StreamOffset,
    create_consumer_factory,
    create_decoder,
)
from pinot_tpu_torch.ingestion.transformers import CompositeTransformer
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.segment.metadata import SegmentMetadata
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.segment.upsert import (
    TableUpsertMetadataManager,
    _LiveValidDocs,
    attach_valid_docs,
    table_upsert_manager,
)
from pinot_tpu_torch.spi import filesystem
from pinot_tpu_torch.spi.data import Schema
from pinot_tpu_torch.spi.table import TableConfig

log = logging.getLogger(__name__)


class ConsumerState(enum.Enum):
    INITIAL_CONSUMING = "INITIAL_CONSUMING"
    CATCHING_UP = "CATCHING_UP"
    HOLDING = "HOLDING"
    COMMITTING = "COMMITTING"
    COMMITTED = "COMMITTED"
    RETAINING = "RETAINING"
    DISCARDED = "DISCARDED"
    ERROR = "ERROR"


_TERMINAL = (ConsumerState.COMMITTED, ConsumerState.RETAINING,
             ConsumerState.DISCARDED, ConsumerState.ERROR)


class CompletionResponse(enum.Enum):
    HOLD = "HOLD"
    CATCHUP = "CATCHUP"
    COMMIT = "COMMIT"
    KEEP = "KEEP"
    DISCARD = "DISCARD"
    NOT_LEADER = "NOT_LEADER"


@dataclass
class CompletionReply:
    response: CompletionResponse
    # CATCHUP: the offset to catch up to
    target_offset: Optional[StreamOffset] = None


class SegmentCompletionProtocol:
    """The consumer's side of the commit negotiation."""

    def segment_consumed(self, segment_name: str, instance: str,
                         offset: StreamOffset) -> CompletionReply:
        raise NotImplementedError

    def segment_commit_start(self, segment_name: str, instance: str,
                             offset: StreamOffset) -> CompletionReply:
        raise NotImplementedError

    def segment_commit_upload(self, segment_name: str, instance: str,
                              segment: ImmutableSegment) -> str:
        """Hand over the sealed segment; -> where it is kept."""
        raise NotImplementedError

    def segment_commit_end(self, segment_name: str, instance: str,
                           offset: StreamOffset, location: str,
                           metadata: SegmentMetadata) -> CompletionReply:
        raise NotImplementedError

    def segment_stopped_consuming(self, segment_name: str, instance: str,
                                  reason: str) -> None:
        """This replica stopped consuming the segment (unassigned, shut
        down, failed)."""


class LocalCompletionProtocol(SegmentCompletionProtocol):
    """One replica: the consumer always commits, and the sealed segment
    stays in memory; its location is the ``memory://`` one of the deep
    store (``spi/filesystem.py``), which keeps nothing for it."""

    def segment_consumed(self, segment_name, instance, offset):
        return CompletionReply(CompletionResponse.COMMIT)

    def segment_commit_start(self, segment_name, instance, offset):
        return CompletionReply(CompletionResponse.COMMIT)

    def segment_commit_upload(self, segment_name, instance, segment):
        return filesystem.segment_url(segment.metadata.table_name,
                                      segment_name)

    def segment_commit_end(self, segment_name, instance, offset, location,
                           metadata):
        return CompletionReply(CompletionResponse.COMMIT)


@dataclass
class ConsumptionResult:
    state: ConsumerState
    rows_indexed: int
    rows_dropped: int
    final_offset: StreamOffset
    segment: Optional[ImmutableSegment] = None
    metadata: Optional[SegmentMetadata] = None


class RealtimeSegmentDataManager:
    """One consuming segment of one stream partition, driven by its
    caller (``run_once``, ``consume_until_committed``) or by its own
    thread (``start`` / ``stop``)."""

    MAX_CONSUME_ERRORS = 100
    # the thread's wait while HOLDing or while the stream has nothing new
    TICK_S = 0.02
    # the longest ``stop`` waits for the thread to end
    STOP_JOIN_S = 10.0

    def __init__(self, segment_name: str, table_config: TableConfig,
                 schema: Schema, partition: int,
                 start_offset: StreamOffset,
                 protocol: Optional[SegmentCompletionProtocol] = None,
                 instance_id: str = "server_0",
                 consumer_factory: Optional[StreamConsumerFactory] = None,
                 on_committed: Optional[Callable[
                     ["RealtimeSegmentDataManager", SegmentMetadata,
                      ImmutableSegment], None]] = None,
                 upsert_manager: Optional[TableUpsertMetadataManager] = None,
                 on_terminal: Optional[Callable[
                     ["RealtimeSegmentDataManager"], None]] = None):
        sc = table_config.stream_config
        if sc is None:
            raise ValueError("table has no stream config")
        self.segment_name = segment_name
        self.table_config = table_config
        self.schema = schema
        self.partition = partition
        self.instance_id = instance_id
        self.protocol = protocol or LocalCompletionProtocol()
        self.on_committed = on_committed
        self.on_terminal = on_terminal

        factory = consumer_factory or create_consumer_factory(sc)
        self._consumer = factory.create_partition_consumer(partition)
        self._decoder: StreamMessageDecoder = create_decoder(sc.decoder)
        self._transformer = CompositeTransformer.for_table(table_config,
                                                           schema)
        self.segment = MutableSegment(
            schema, segment_name,
            capacity=max(sc.segment_flush_threshold_rows, 1),
            indexing_config=table_config.indexing_config)
        self.start_offset = start_offset
        self.current_offset = start_offset
        self.flush_threshold_rows = sc.segment_flush_threshold_rows
        self.flush_threshold_ms = sc.segment_flush_threshold_millis
        self._start_time_ms = int(time.time() * 1000)
        self.upsert_hook: Optional[Callable[[Any, int], None]] = None
        self.upsert_manager = upsert_manager or table_upsert_manager(
            table_config, schema)
        if self.upsert_manager is not None:
            pm = self.upsert_manager.partition(partition)

            def hook(row, doc_id, pm=pm):
                pm.add_record(segment_name, doc_id, pm.key_of_row(row),
                              row.get(pm.comparison_column))

            self.upsert_hook = hook
            attach_valid_docs(self.segment,
                              _LiveValidDocs(pm, segment_name))
        self.state = ConsumerState.INITIAL_CONSUMING
        self.rows_indexed = 0
        self.rows_dropped = 0
        self._catchup_target: Optional[StreamOffset] = None
        self._consecutive_errors = 0
        self._committed_metadata: Optional[SegmentMetadata] = None
        #: the sealed segment that replaces the consuming one
        self.sealed_segment: Optional[ImmutableSegment] = None
        #: wall ms of the last seal (build_segment)
        self.seal_wall_ms: Optional[float] = None
        #: monotonic s: the thread's start, and the flush threshold reached
        self.started_at: Optional[float] = None
        self.threshold_at: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- consume --------------------------------------------------------------
    def _index_batch(self, limit_offset: Optional[StreamOffset] = None
                     ) -> int:
        batch = self._consumer.fetch_messages(self.current_offset)
        n = 0
        for msg in batch.messages:
            if limit_offset is not None and msg.offset >= limit_offset:
                break
            row = self._decoder.decode(msg)
            if row is not None:
                row = self._transformer.transform(row)
            if row is None:
                self.rows_dropped += 1
            else:
                if not self.segment.index(row):
                    break
                self.rows_indexed += 1
                if self.upsert_hook is not None:
                    try:
                        self.upsert_hook(row, self.segment.num_docs - 1)
                    except Exception:
                        # the row is indexed: move past it before raising,
                        # or a retry would index it twice
                        self.current_offset = StreamOffset(
                            msg.offset.value + 1)
                        raise
            n += 1
            self.current_offset = StreamOffset(msg.offset.value + 1)
        return n

    def _threshold_reached(self) -> bool:
        if self.rows_indexed >= self.flush_threshold_rows:
            return True
        age = int(time.time() * 1000) - self._start_time_ms
        return age >= self.flush_threshold_ms and self.rows_indexed > 0

    def run_once(self) -> ConsumerState:
        """One step of the consume / commit state machine."""
        if self.state in (ConsumerState.INITIAL_CONSUMING,
                          ConsumerState.CATCHING_UP):
            catching_up = self.state is ConsumerState.CATCHING_UP
            self._index_batch(self._catchup_target if catching_up else None)
            if catching_up:
                if (self._catchup_target is not None
                        and self.current_offset >= self._catchup_target):
                    self.state = ConsumerState.HOLDING
            elif self._threshold_reached():
                self.state = ConsumerState.HOLDING
                self.threshold_at = time.monotonic()

        if self.state is ConsumerState.HOLDING:
            reply = self.protocol.segment_consumed(
                self.segment_name, self.instance_id, self.current_offset)
            if reply.response is CompletionResponse.COMMIT:
                self.state = ConsumerState.COMMITTING
            elif reply.response is CompletionResponse.CATCHUP:
                self._catchup_target = reply.target_offset
                self.state = ConsumerState.CATCHING_UP
            elif reply.response is CompletionResponse.KEEP:
                self.state = ConsumerState.RETAINING
            elif reply.response is CompletionResponse.DISCARD:
                self.state = ConsumerState.DISCARDED
            # HOLD: stay, ask again next step

        if self.state is ConsumerState.COMMITTING:
            self._commit()
        return self.state

    def _commit(self) -> None:
        """The split commit: start, build, upload, end."""
        try:
            reply = self.protocol.segment_commit_start(
                self.segment_name, self.instance_id, self.current_offset)
            if reply.response is not CompletionResponse.COMMIT:
                self.state = ConsumerState.HOLDING
                return
            sealed = self.build_segment()
            location = self.protocol.segment_commit_upload(
                self.segment_name, self.instance_id, sealed)
            end = self.protocol.segment_commit_end(
                self.segment_name, self.instance_id, self.current_offset,
                location, sealed.metadata)
            if end.response is CompletionResponse.COMMIT:
                self.state = ConsumerState.COMMITTED
                self._committed_metadata = sealed.metadata
                self.sealed_segment = sealed
                if self.on_committed is not None:
                    self.on_committed(self, sealed.metadata, sealed)
            else:
                self.state = ConsumerState.HOLDING
        except Exception:
            log.exception("commit failed for %s", self.segment_name)
            self.state = ConsumerState.ERROR

    def build_segment(self) -> ImmutableSegment:
        """The seal: the consuming rows as an in-memory immutable segment
        with the default star-tree (unless the table configures trees),
        the stream offsets and partition in ``metadata.custom``; its wall
        ms in ``seal_wall_ms``."""
        t0 = time.perf_counter()
        idx = self.segment.indexing
        if not idx.star_tree_index_configs \
                and not idx.enable_default_star_tree:
            idx = replace(idx, enable_default_star_tree=True)
        sealed = self.segment.build_immutable(indexing_config=idx)
        if self.upsert_manager is not None:
            # the same rows in the same order: the bitmap carries over
            pm = self.upsert_manager.partition(self.partition)
            pm.replace_segment(sealed)
            attach_valid_docs(sealed, _LiveValidDocs(pm, self.segment_name))
        sealed.metadata.custom.update({
            "segment.realtime.startOffset": str(self.start_offset),
            "segment.realtime.endOffset": str(self.current_offset),
            "segment.realtime.partition": self.partition,
        })
        self.seal_wall_ms = (time.perf_counter() - t0) * 1e3
        observe_ms(self.table_config.table_name, "seal", self.seal_wall_ms)
        return sealed

    def _run_once_resilient(self) -> ConsumerState:
        """``run_once``, a failing fetch or decode retried: offsets move
        only past indexed rows, so a retry indexes nothing twice; after
        ``MAX_CONSUME_ERRORS`` in a row the state is ERROR."""
        try:
            st = self.run_once()
            self._consecutive_errors = 0
            return st
        except Exception:
            self._consecutive_errors += 1
            log.exception("[%s] consume step failed (attempt %d)",
                          self.segment_name, self._consecutive_errors)
            if self._consecutive_errors >= self.MAX_CONSUME_ERRORS:
                self.state = ConsumerState.ERROR
            return self.state

    def consume_until_committed(self, max_iters: int = 10_000
                                ) -> ConsumptionResult:
        for _ in range(max_iters):
            st = self._run_once_resilient()
            if st in _TERMINAL:
                break
            if self._consecutive_errors > 0:
                time.sleep(min(0.01 * self._consecutive_errors, 0.1))
        return ConsumptionResult(self.state, self.rows_indexed,
                                 self.rows_dropped, self.current_offset,
                                 self.sealed_segment,
                                 self._committed_metadata)

    # -- the consumer thread --------------------------------------------------------
    def start(self) -> None:
        tick = self.TICK_S

        def loop():
            while not self._stop.is_set():
                st = self._run_once_resilient()
                if st in _TERMINAL:
                    break
                if self._consecutive_errors > 0:
                    # exponential backoff capped at 5 s: an outage shorter
                    # than the error budget resumes instead of ERROR
                    self._stop.wait(min(tick * 2 ** min(
                        self._consecutive_errors, 10), 5.0))
                elif st is ConsumerState.HOLDING \
                        or not self._has_new_data():
                    self._stop.wait(tick)
            self._consumer.close()
            if self.on_terminal is not None and not self._stop.is_set():
                try:
                    self.on_terminal(self)
                except Exception:
                    log.exception("on_terminal failed for %s",
                                  self.segment_name)

        self.started_at = time.monotonic()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"consumer-{self.segment_name}")
        self._thread.start()

    def _has_new_data(self) -> bool:
        try:
            return self._peek_new_data()
        except Exception:
            return False    # a failing fetch: wait a tick, try again

    def _peek_new_data(self) -> bool:
        batch = self._consumer.fetch_messages(self.current_offset,
                                              max_messages=1)
        return batch.message_count > 0

    def stop(self, reason: str = "shutdown") -> None:
        self._stop.set()
        if self._thread is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=self.STOP_JOIN_S)
        if self.state not in (ConsumerState.COMMITTED,
                              ConsumerState.DISCARDED):
            self.protocol.segment_stopped_consuming(
                self.segment_name, self.instance_id, reason)
