"""Embedded cluster: a controller, a broker and N servers in one process.

Counterpart of ``pinot_tpu/tools/cluster.py`` (``EmbeddedCluster``, the
reference's ClusterTest and Quickstart harness): every role runs against
one cluster state store, and the broker calls its servers in process.
Segments are kept in the controller's in-memory deep store
(``spi/filesystem.py``), which ``shutdown`` empties. ``upload_segment
(table, segment)`` is the ``memory://`` counterpart of the JAX
``upload_segment_dir``, and ``ingest_rows`` builds a segment in memory with
the port's ``SegmentBuilder`` and pushes it.

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

``device`` (default ``"cuda"``) is where every server's executor and the
broker's reduce run; it raises without a card, and a CPU caller passes
``device="cpu"``. Minions are not part of this module.

    cluster = EmbeddedCluster(num_servers=2, device="cuda")
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

import time

from typing import Dict, List, Optional, Union

import torch

from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.common.response import BrokerResponse
from pinot_tpu_torch.controller.controller import Controller
from pinot_tpu_torch.controller.state import CONSUMING, ClusterStateStore
from pinot_tpu_torch.device import resolve_device
from pinot_tpu_torch.engine.executor import ServerQueryExecutor
from pinot_tpu_torch.ingestion.realtime import ConsumerState
from pinot_tpu_torch.ingestion.stream import create_consumer_factory
from pinot_tpu_torch.segment.creator import SegmentBuilder
from pinot_tpu_torch.server.data_manager import RealtimeTableDataManager
from pinot_tpu_torch.server.server import ServerInstance
from pinot_tpu_torch.spi.data import Schema
from pinot_tpu_torch.spi.table import TableConfig


# the broker's per-query timeout, the JAX EmbeddedCluster's default
QUERY_TIMEOUT_S = 120.0


class EmbeddedCluster:
    """A whole cluster in one process."""

    def __init__(self, num_servers: int = 1,
                 device_reduce: Optional[bool] = None,
                 device: Union[str, torch.device] = "cuda",
                 llc_seed: Optional[str] = None):
        self.device = resolve_device(device)
        self.store = ClusterStateStore()
        self.controller = Controller(self.store, llc_seed=llc_seed)
        self.servers: Dict[str, ServerInstance] = {}
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
            executor=ServerQueryExecutor(device=self.device))
        server.start()
        self.servers[instance_id] = server
        self.broker.register_server(instance_id, server)
        return server

    def stop_server(self, instance_id: str) -> None:
        server = self.servers.pop(instance_id, None)
        if server is not None:
            server.shutdown()

    # -- table / data operations (the controller API) ------------------------
    def create_table(self, table_config: TableConfig, schema: Schema) -> None:
        self.controller.add_schema(schema)
        self.controller.add_table(table_config)

    def upload_segment(self, table_with_type: str, segment) -> str:
        """Keep ``segment`` in the deep store and push it; -> its
        location."""
        url = self.controller.deep_store.put_segment(table_with_type,
                                                     segment)
        self.controller.add_segment(table_with_type, segment.metadata, url)
        return url

    def ingest_rows(self, table_with_type: str, schema: Schema,
                    rows_columnar: Dict[str, list],
                    segment_name: Optional[str] = None) -> str:
        """Offline batch ingest: build a segment from columnar data and
        push it."""
        name = segment_name or f"{schema.schema_name}_{int(time.time() * 1e3)}"
        cfg = self.store.get_table_config(table_with_type)
        seg = SegmentBuilder(
            schema, name, indexing=cfg.indexing_config if cfg else None
        ).build(rows_columnar)
        self.upload_segment(table_with_type, seg)
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
