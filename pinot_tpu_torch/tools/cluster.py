"""Embedded cluster: a controller, a broker and N servers in one process.

Counterpart of ``pinot_tpu/tools/cluster.py`` (``EmbeddedCluster``, the
reference's ClusterTest and Quickstart harness): every role runs against
one cluster state store, and the broker calls its servers in process.

With a ``data_dir`` (JAX's layout under it: ``built_segments/``,
``server_segments/``), segments live on disk and the deep store is
``file://``: ``upload_segment_dir(table, dir)`` pushes a segment directory
(JAX :86), ``upload_segment(table, segment)`` writes a segment built in
memory there first, ``ingest_rows`` builds and writes one, the servers
fetch and map the directories, a realtime seal is written under the
committing server's directory and fetched from there by its DISCARD
replicas, and ``shutdown`` removes what the cluster made there:
``data_dir`` itself where it did not exist, else the subdirectories it
made (those two and ``minion_work/``), so nothing a caller kept there is
lost. Without one, segments
are objects in the controller's in-memory deep store (``memory://``,
``spi/filesystem.py``), which ``shutdown`` empties, and seals stay in
memory. ``update_table`` then ``reload_table`` (the controller's) adds
the indexes a config gained to every replica's segments on disk.

A REALTIME table consumes its stream from ``create_table`` on: each
server negotiates its commits with the controller's completion FSM
(``controller.completion``), and ``llc_seed`` fixes the LLC segment
names. An OFFLINE and a REALTIME table of one name form a hybrid table,
which the broker splits at the time boundary. ``wait_for_docs`` waits
until a count reaches a number (one replica's view);
``wait_for_consumers`` waits until every consumer on every server has
reached its partition's end offset and no commit is under way, the point
at which every replica holds every row. ``shutdown`` stops every
consumer before the servers go.

The process telemetry (``common/telemetry.py`` ``TELEMETRY``) is shared by
the broker and the servers. Unless a flight-recorder directory is
configured, the cluster gives the recorder a temporary one of its own;
``shutdown`` removes it with any bundle in it, and stops the telemetry
sampler, so a cluster leaves no thread and no file behind.

``device`` (default ``"cuda"``) is where every server's executor and the
broker's reduce run; it raises without a card, and a CPU caller passes
``device="cpu"``.

``add_minion`` (JAX :68-79) starts a minion (``minion/worker.py``) whose
work directory is ``data_dir/minion_work``; a cluster without a
``data_dir`` refuses one, since the minion's executors read and write
segment directories. The controller's periodic tasks
(``controller.run_task_generation`` and the others, or
``controller.start_periodic_tasks``) generate its tasks, and the segments
it pushes are served like any other. ``shutdown`` stops the minions, then
the controller's periodic loop, before the servers go.

    cluster = EmbeddedCluster(num_servers=2, device="cuda",
                              data_dir="/path/to/cluster")
    cluster.create_table(TableConfig("sales"), schema)
    cluster.ingest_rows("sales_OFFLINE", schema, {"region": [...], ...})
    cluster.wait_for_ev_converged("sales_OFFLINE")
    cluster.query("SELECT region, sum(qty) FROM sales GROUP BY region")

    MemoryStream.create("events", 2)      # a realtime table's stream
    cluster.create_table(TableConfig("ev", TableType.REALTIME,
                                     stream_config=...), schema)
    MemoryStream.get("events").produce(row, partition=0)
    cluster.wait_for_consumers("ev_REALTIME")
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

from typing import Dict, List, Optional, Union

import torch

from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.common.response import BrokerResponse
from pinot_tpu_torch.common.telemetry import TELEMETRY
from pinot_tpu_torch.controller.controller import Controller
from pinot_tpu_torch.controller.state import CONSUMING, ClusterStateStore
from pinot_tpu_torch.device import resolve_device
from pinot_tpu_torch.engine.executor import ServerQueryExecutor
from pinot_tpu_torch.ingestion.realtime import ConsumerState
from pinot_tpu_torch.ingestion.stream import create_consumer_factory
from pinot_tpu_torch.minion.worker import MinionInstance
from pinot_tpu_torch.segment.creator import SegmentBuilder, write_segment
from pinot_tpu_torch.segment.metadata import METADATA_FILE, SegmentMetadata
from pinot_tpu_torch.server.data_manager import RealtimeTableDataManager
from pinot_tpu_torch.server.server import ServerInstance
from pinot_tpu_torch.spi.data import Schema
from pinot_tpu_torch.spi.filesystem import file_url
from pinot_tpu_torch.spi.table import TableConfig


# the broker's per-query timeout, the JAX EmbeddedCluster's default
QUERY_TIMEOUT_S = 120.0


class EmbeddedCluster:
    """A whole cluster in one process."""

    def __init__(self, num_servers: int = 1,
                 device_reduce: Optional[bool] = None,
                 device: Union[str, torch.device] = "cuda",
                 llc_seed: Optional[str] = None,
                 data_dir: Optional[str] = None):
        self.device = resolve_device(device)
        self.data_dir = None if data_dir is None else os.path.abspath(
            data_dir)
        #: what ``shutdown`` removes: ``data_dir`` where the cluster made
        #: it, else those of its two subdirectories the cluster made
        self._made_dirs: List[str] = []
        if data_dir is not None:
            subs = [os.path.join(self.data_dir, d)
                    for d in ("built_segments", "server_segments",
                              "minion_work")]
            self._made_dirs = ([p for p in subs if not os.path.exists(p)]
                               if os.path.exists(self.data_dir)
                               else [self.data_dir])
            os.makedirs(self.data_dir, exist_ok=True)
        recorder = TELEMETRY.recorder
        self._flight_dir: Optional[str] = None
        if recorder.out_dir is None:
            self._flight_dir = tempfile.mkdtemp(prefix="pinot_flight_")
            recorder.out_dir = self._flight_dir
        self.store = ClusterStateStore()
        self.controller = Controller(self.store, llc_seed=llc_seed)
        self.servers: Dict[str, ServerInstance] = {}
        self.minions: Dict[str, MinionInstance] = {}
        # the servers and the broker share this process, so the broker may
        # merge group-by partials on the device
        self.broker = BrokerRequestHandler(self.store,
                                           query_timeout_s=QUERY_TIMEOUT_S,
                                           device_reduce=device_reduce,
                                           device=self.device)
        for i in range(num_servers):
            self.add_server(f"server_{i}")

    # -- roles ---------------------------------------------------------------
    def add_server(self, instance_id: str) -> ServerInstance:
        server = ServerInstance(
            instance_id, self.store, self.controller.deep_store,
            completion_protocol=self.controller.completion,
            executor=ServerQueryExecutor(device=self.device),
            segment_dir=self.server_segment_dir)
        server.start()
        self.servers[instance_id] = server
        self.broker.register_server(instance_id, server)
        return server

    @property
    def server_segment_dir(self) -> Optional[str]:
        """Where servers write their seals (None without a data dir)."""
        return (None if self.data_dir is None
                else os.path.join(self.data_dir, "server_segments"))

    def stop_server(self, instance_id: str) -> None:
        server = self.servers.pop(instance_id, None)
        if server is not None:
            server.shutdown()

    def add_minion(self, instance_id: str = "minion_0",
                   start: bool = True) -> MinionInstance:
        """A minion over the cluster's state store, running the tasks the
        controller generates; ``start`` polls for them on its thread (else
        the caller runs ``minion.run_one_task()``)."""
        if self.data_dir is None:
            raise ValueError("a minion needs a cluster with a data_dir: its "
                             "tasks read and write segment directories")
        minion = MinionInstance(
            instance_id, self.controller,
            work_dir=os.path.join(self.data_dir, "minion_work"))
        if start:
            minion.start()
        self.minions[instance_id] = minion
        return minion

    # -- table / data operations (the controller API) ------------------------
    def create_table(self, table_config: TableConfig, schema: Schema) -> None:
        self.controller.add_schema(schema)
        self.controller.add_table(table_config)

    def upload_segment_dir(self, table_with_type: str, segment_dir: str
                           ) -> str:
        """Push a segment directory by its ``file://`` location; -> the
        location."""
        md = SegmentMetadata.load(os.path.join(segment_dir, METADATA_FILE))
        url = file_url(segment_dir)
        self.controller.add_segment(table_with_type, md, url)
        return url

    def _built_dir(self) -> str:
        out = os.path.join(self.data_dir, "built_segments")
        os.makedirs(out, exist_ok=True)
        return out

    def upload_segment(self, table_with_type: str, segment) -> str:
        """Push a segment built in memory; -> its location. With a data
        dir it is written there and pushed as a directory, else kept in
        the in-memory deep store."""
        if self.data_dir is not None:
            write_segment(segment, self._built_dir())
            return self.upload_segment_dir(
                table_with_type,
                os.path.join(self._built_dir(), segment.segment_name))
        url = self.controller.deep_store.put_segment(table_with_type,
                                                     segment)
        self.controller.add_segment(table_with_type, segment.metadata, url)
        return url

    def ingest_rows(self, table_with_type: str, schema: Schema,
                    rows_columnar: Dict[str, list],
                    segment_name: Optional[str] = None) -> str:
        """Offline batch ingest: build a segment from columnar data (on
        disk with a data dir) and push it."""
        name = segment_name or f"{schema.schema_name}_{int(time.time() * 1e3)}"
        cfg = self.store.get_table_config(table_with_type)
        builder = SegmentBuilder(schema, name, table_config=cfg)
        if self.data_dir is not None:
            builder.build(rows_columnar, self._built_dir())
            self.upload_segment_dir(
                table_with_type, os.path.join(self._built_dir(), name))
        else:
            self.upload_segment(table_with_type, builder.build(rows_columnar))
        return name

    # -- the query front door --------------------------------------------------
    def query(self, sql: str) -> BrokerResponse:
        return self.broker.handle_sql(sql)

    def query_rows(self, sql: str) -> List[list]:
        resp = self.query(sql)
        if resp.has_exceptions:
            raise RuntimeError(f"query failed: {resp.exceptions}")
        return resp.result_table.rows if resp.result_table else []

    def hosting_servers(self, table: str) -> List[str]:
        """Instances serving at least one segment of ``table`` by the
        ExternalView."""
        ev = self.store.get_external_view(table)
        return sorted({inst for m in ev.values() for inst in m})

    # -- convergence -------------------------------------------------------------
    def _ev_converged(self, table: str) -> bool:
        ideal = self.store.get_ideal_state(table)
        ev = self.store.get_external_view(table)
        return all(ev.get(seg, {}).get(inst) == st
                   for seg, m in ideal.items() for inst, st in m.items())

    def wait_for_ev_converged(self, table: str, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._ev_converged(table):
                return True
            time.sleep(0.02)
        return False

    def wait_for_docs(self, table_raw: str, expected: int,
                      timeout_s: float = 20.0) -> bool:
        """A realtime table's ``count(*)`` reaches ``expected`` (as the
        broker sees it: one replica a segment)."""
        deadline = time.monotonic() + timeout_s
        sql = f"SELECT count(*) FROM {table_raw}"
        while time.monotonic() < deadline:
            resp = self.query(sql)
            rows = resp.result_table.rows if resp.result_table else []
            if not resp.has_exceptions and rows and rows[0][0] >= expected:
                return True
            time.sleep(0.05)
        return False

    def consumers(self, table: str) -> list:
        """Every live consumer of ``table`` on every server."""
        out = []
        for server in self.servers.values():
            tdm = server.data_manager.get(table)
            if isinstance(tdm, RealtimeTableDataManager):
                out.extend(tdm.consumers())
        return out

    def wait_for_consumers(self, table: str, timeout_s: float = 60.0
                           ) -> bool:
        """Every consumer of the realtime ``table`` on every server has
        reached its partition's end offset below its flush threshold, no
        commit is under way, and the ExternalView has converged: each
        replica holds every row the stream has, and none is about to
        seal."""
        cfg = self.store.get_table_config(table)
        meta = create_consumer_factory(
            cfg.stream_config).create_metadata_provider()
        deadline = time.monotonic() + timeout_s
        try:
            while time.monotonic() < deadline:
                ideal = self.store.get_ideal_state(table)
                consumers = self.consumers(table)
                if (self._ev_converged(table)
                        and len(consumers) == sum(
                            st == CONSUMING for m in ideal.values()
                            for st in m.values())
                        and all(c.state is ConsumerState.INITIAL_CONSUMING
                                and c.rows_indexed < c.flush_threshold_rows
                                and c.current_offset
                                >= meta.latest_offset(c.partition)
                                for c in consumers)
                        and not self.controller.completion.busy()):
                    return True
                time.sleep(0.02)
            return False
        finally:
            meta.close()

    def shutdown(self) -> None:
        for m in list(self.minions.values()):
            m.shutdown()
        self.minions.clear()
        self.controller.stop()
        self.broker.shutdown()
        # consumers stop before any server goes, so none negotiates with a
        # peer that is already down
        for table in self.store.table_names():
            for c in self.consumers(table):
                c.stop()
        for s in list(self.servers.values()):
            s.shutdown()
        self.servers.clear()
        self.controller.deep_store.clear()
        for d in self._made_dirs:
            shutil.rmtree(d, ignore_errors=True)
        TELEMETRY.stop_sampler()
        if self._flight_dir is not None:
            if TELEMETRY.recorder.out_dir == self._flight_dir:
                TELEMETRY.recorder.out_dir = None
            shutil.rmtree(self._flight_dir, ignore_errors=True)
            self._flight_dir = None
