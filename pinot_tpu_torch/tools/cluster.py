"""Embedded cluster: a controller, a broker and N servers in one process.

Counterpart of ``pinot_tpu/tools/cluster.py`` (``EmbeddedCluster``, the
reference's ClusterTest and Quickstart harness), for offline tables: every
role runs against one cluster state store, and the broker calls its
servers in process. Segments are kept in the controller's in-memory deep
store (``spi/filesystem.py``), which ``shutdown`` empties. ``upload_segment
(table, segment)`` is the ``memory://`` counterpart of the JAX
``upload_segment_dir``, and ``ingest_rows`` builds a segment in memory with
the port's ``SegmentBuilder`` and pushes it.

``device`` (default ``"cuda"``) is where every server's executor and the
broker's reduce run; it raises without a card, and a CPU caller passes
``device="cpu"``. Minions and realtime tables are not part of this
module.

    cluster = EmbeddedCluster(num_servers=2, device="cuda")
    cluster.create_table(TableConfig("sales"), schema)
    cluster.ingest_rows("sales_OFFLINE", schema, {"region": [...], ...})
    cluster.wait_for_ev_converged("sales_OFFLINE")
    cluster.query("SELECT region, sum(qty) FROM sales GROUP BY region")
"""

from __future__ import annotations

import time

from typing import Dict, List, Optional, Union

import torch

from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.common.response import BrokerResponse
from pinot_tpu_torch.controller.controller import Controller
from pinot_tpu_torch.controller.state import ClusterStateStore
from pinot_tpu_torch.device import resolve_device
from pinot_tpu_torch.engine.executor import ServerQueryExecutor
from pinot_tpu_torch.segment.creator import SegmentBuilder
from pinot_tpu_torch.server.server import ServerInstance
from pinot_tpu_torch.spi.data import Schema
from pinot_tpu_torch.spi.table import TableConfig


# the broker's per-query timeout, the JAX EmbeddedCluster's default
QUERY_TIMEOUT_S = 120.0


class EmbeddedCluster:
    """A whole cluster in one process."""

    def __init__(self, num_servers: int = 1,
                 device_reduce: Optional[bool] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.store = ClusterStateStore()
        self.controller = Controller(self.store)
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
    def wait_for_ev_converged(self, table: str, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            ideal = self.store.get_ideal_state(table)
            ev = self.store.get_external_view(table)
            if all(ev.get(seg, {}).get(inst) == st
                   for seg, m in ideal.items() for inst, st in m.items()):
                return True
            time.sleep(0.02)
        return False

    def shutdown(self) -> None:
        self.broker.shutdown()
        for s in list(self.servers.values()):
            s.shutdown()
        self.servers.clear()
        self.controller.deep_store.clear()
