"""LLC realtime segment manager: the CONSUMING segment lifecycle.

Counterpart of ``pinot_tpu/controller/llc.py``
(``LLCRealtimeSegmentManager``, PinotLLCRealtimeSegmentManager): one
CONSUMING segment per stream partition when a table is set up, at the
partition's earliest offset (``setup_new_table``); on commit the segment
goes ONLINE on the same instances with its end offset, download URL and
doc count recorded, and sequence + 1 opens at the end offset
(``commit_segment``); ``ensure_all_partitions_consuming`` recreates a
partition's CONSUMING segment that died. Segment names are
``table__partition__sequence__seed`` (LLCSegmentName).

A committed segment's time range is the min and max of the table's time
column (``state.segment_time_range``), as for a pushed segment, where the
JAX manager takes its builder's range of the schema's time column; the
two agree where the schema's time column is the table's. The commit
records the seal's location as the completion protocol named it (its
``file://`` directory, or ``memory://`` for a seal kept in memory) and
the CRC of its columns (0 for a seal never written).
"""

from __future__ import annotations

import time

from typing import Dict, List, Optional

from pinot_tpu_torch.controller.assignment import (
    PartitionedReplicaGroupAssignment,
    assignment_for_table,
)
from pinot_tpu_torch.controller.state import (
    CONSUMING,
    ONLINE,
    ClusterStateStore,
    SegmentZKMetadata,
    segment_time_range,
)
from pinot_tpu_torch.ingestion.stream import (
    StreamOffset,
    create_consumer_factory,
)
from pinot_tpu_torch.segment.metadata import SegmentMetadata


def llc_segment_name(table_raw: str, partition: int, sequence: int,
                     seed: Optional[str] = None) -> str:
    seed = seed or time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    return f"{table_raw}__{partition}__{sequence}__{seed}"


def parse_llc_name(segment_name: str):
    """-> (table, partition, sequence)."""
    parts = segment_name.split("__")
    if len(parts) < 4:
        raise ValueError(f"not an LLC segment name: {segment_name!r}")
    return parts[0], int(parts[1]), int(parts[2])


class LLCRealtimeSegmentManager:
    """One per controller; ``seed`` fixes the names' last part."""

    def __init__(self, store: ClusterStateStore, seed: Optional[str] = None):
        self.store = store
        self._seed = seed

    # -- table setup ------------------------------------------------------------
    def setup_new_table(self, table_with_type: str) -> List[str]:
        cfg = self.store.get_table_config(table_with_type)
        if cfg is None or cfg.stream_config is None:
            raise ValueError(f"{table_with_type} is not a realtime table")
        meta = create_consumer_factory(
            cfg.stream_config).create_metadata_provider()
        try:
            return [self._create_consuming_segment(
                        table_with_type, p, 0, meta.earliest_offset(p))
                    for p in range(meta.partition_count())]
        finally:
            meta.close()

    def _create_consuming_segment(self, table: str, partition: int,
                                  sequence: int,
                                  start_offset: StreamOffset) -> str:
        cfg = self.store.get_table_config(table)
        name = llc_segment_name(cfg.table_name, partition, sequence,
                                self._seed)
        self.store.set_segment_metadata(SegmentZKMetadata(
            segment_name=name, table_name=table, status=CONSUMING,
            creation_time_ms=int(time.time() * 1000),
            start_offset=str(start_offset), partition=partition,
            sequence=sequence))

        servers, replication = assignment_for_table(self.store, table)
        strategy = PartitionedReplicaGroupAssignment(
            num_replica_groups=max(min(replication, len(servers)), 1))
        chosen = strategy.assign(name, self.store.get_ideal_state(table),
                                 servers, replication, partition=partition)

        def apply(ideal):
            ideal = ideal or {}
            ideal[name] = {inst: CONSUMING for inst in chosen}
            return ideal

        self.store.update_ideal_state(table, apply)
        return name

    # -- commit -------------------------------------------------------------------
    def commit_segment(self, table: str, segment_name: str,
                       end_offset: StreamOffset, download_url: str,
                       segment_metadata: Optional[SegmentMetadata] = None
                       ) -> str:
        """CONSUMING -> ONLINE on the same instances, the offset checkpoint
        recorded, the next CONSUMING sequence created; -> its name."""
        zk = self.store.get_segment_metadata(table, segment_name)
        if zk is None:
            raise KeyError(f"unknown segment {segment_name}")
        zk.status = ONLINE
        zk.end_offset = str(end_offset)
        zk.download_url = download_url
        zk.push_time_ms = int(time.time() * 1000)
        if segment_metadata is not None:
            cfg = self.store.get_table_config(table)
            zk.total_docs = segment_metadata.num_docs
            zk.crc = segment_metadata.crc
            zk.start_time, zk.end_time = segment_time_range(
                segment_metadata, cfg.validation_config.time_column_name)
        self.store.set_segment_metadata(zk)

        def apply(ideal):
            ideal = ideal or {}
            ideal[segment_name] = {inst: ONLINE
                                   for inst in ideal.get(segment_name, {})}
            return ideal

        self.store.update_ideal_state(table, apply)
        _, partition, sequence = parse_llc_name(segment_name)
        return self._create_consuming_segment(table, partition,
                                              sequence + 1, end_offset)

    # -- repair ---------------------------------------------------------------------
    def ensure_all_partitions_consuming(self, table: str) -> List[str]:
        """Each stream partition gets exactly one CONSUMING segment: one
        that died (committed without a successor, deleted, or never made
        after the partitions grew) is created again, after the
        partition's latest sequence at its end offset."""
        cfg = self.store.get_table_config(table)
        if cfg is None or cfg.stream_config is None:
            return []
        meta = create_consumer_factory(
            cfg.stream_config).create_metadata_provider()
        try:
            consuming: Dict[int, str] = {}
            latest: Dict[int, SegmentZKMetadata] = {}
            for md in self.store.segment_metadata_list(table):
                if md.partition is None:
                    continue
                if md.status == CONSUMING:
                    consuming[md.partition] = md.segment_name
                prev = latest.get(md.partition)
                if prev is None or (md.sequence or 0) > (prev.sequence or 0):
                    latest[md.partition] = md
            created = []
            for p in range(meta.partition_count()):
                if p in consuming:
                    continue
                last = latest.get(p)
                if last is None:
                    created.append(self._create_consuming_segment(
                        table, p, 0, meta.earliest_offset(p)))
                else:
                    start = StreamOffset.parse(last.end_offset
                                               or last.start_offset or "0")
                    created.append(self._create_consuming_segment(
                        table, p, (last.sequence or 0) + 1, start))
            return created
        finally:
            meta.close()
