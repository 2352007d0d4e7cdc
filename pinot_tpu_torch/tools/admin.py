"""pinot-tpu admin CLI for the port.

Counterpart of ``pinot_tpu/tools/admin.py`` (the reference's
``PinotAdministrator.java:86`` subset): ``PostQuery`` posts SQL to a
running broker, ``StartCluster`` starts an ``EmbeddedCluster`` with its
controller and broker REST front doors, ``LaunchDataIngestionJob`` runs a
segment generation job spec (``ingestion/batchjob.py``; it builds the
segments and prints their directories, with no push), ``Quickstart``
builds a demo table and runs sample queries, or with ``-exampleDir`` a
directory in the reference's example layout (``*_schema.json``,
``*_offline_table_config.json``, ``ingestionJobSpec.yaml``) ingested
through its job. ``StartServer`` (the reference's
``StartServerCommand``; JAX's CLI has none) runs one server in a process
of its own: a replica of the cluster state from a state service
(``transport/state_service.py``), the server behind a gRPC front
(``GrpcQueryServer``) and its admin REST routes; it prints one JSON line
with its ports, serves until its standard input closes, and shuts down.
Invoke as ``python -m pinot_tpu_torch <command>``. The cluster and server
commands run on the card unless ``-device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

from typing import List, Optional


def _cmd_launch_ingestion_job(args) -> int:
    """Ref: LaunchDataIngestionJobCommand."""
    from pinot_tpu_torch.ingestion.batchjob import run_ingestion_job

    seg_dirs = run_ingestion_job(args.jobSpecFile)
    for d in seg_dirs:
        print(d)
    print(f"built {len(seg_dirs)} segment(s)", file=sys.stderr)
    return 0


def _cmd_post_query(args) -> int:
    """Ref: PostQueryCommand — POST /query/sql against a broker."""
    body = json.dumps({"sql": args.query}).encode()
    req = urllib.request.Request(
        f"http://{args.brokerHost}:{args.brokerPort}/query/sql",
        data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=args.timeout) as resp:
        print(resp.read().decode())
    return 0


def _cmd_quickstart(args) -> int:
    """Ref: Quickstart.java — an embedded cluster, a table and sample
    queries: the reference-layout example directory's table ingested
    through its job spec, else a generated demo table."""
    import glob
    import os

    import numpy as np

    from pinot_tpu_torch.spi.data import DataType, FieldSpec, FieldType, Schema
    from pinot_tpu_torch.spi.table import TableConfig
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster

    cluster = EmbeddedCluster(num_servers=1, data_dir=args.dataDir,
                              device=args.device)
    try:
        if args.exampleDir:
            from pinot_tpu_torch.ingestion.batchjob import run_ingestion_job

            ex = args.exampleDir
            schema = Schema.from_file(
                glob.glob(os.path.join(ex, "*_schema.json"))[0])
            table_config = TableConfig.from_file(glob.glob(os.path.join(
                ex, "*_offline_table_config.json"))[0])
            cluster.create_table(table_config, schema)
            job_files = glob.glob(os.path.join(ex, "ingestionJobSpec.yaml"))
            if job_files:
                run_ingestion_job(job_files[0], cluster=cluster,
                                  schema=schema, table_config=table_config)
            table = schema.schema_name
        else:
            rng = np.random.default_rng(7)
            n = 10_000
            schema = Schema("quickstart", [
                FieldSpec("city", DataType.STRING),
                FieldSpec("value", DataType.LONG, FieldType.METRIC)])
            cluster.create_table(TableConfig("quickstart"), schema)
            cluster.ingest_rows("quickstart_OFFLINE", schema, {
                "city": np.array(["sf", "nyc", "sea"])[rng.integers(0, 3, n)],
                "value": rng.integers(0, 1000, n).astype(np.int64)})
            table = "quickstart"
        for sql in (args.query or [f"SELECT count(*) FROM {table}"]):
            print(json.dumps(cluster.query(sql).to_dict(), default=str))
    finally:
        cluster.shutdown()
    return 0


def _cmd_start_cluster(args) -> int:
    """The controller, broker and servers in one process with the REST
    front doors (ref: QuickstartRunner + Start*Command)."""
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster
    from pinot_tpu_torch.transport.rest import serve_cluster

    cluster = EmbeddedCluster(num_servers=args.servers,
                              data_dir=args.dataDir, device=args.device)
    apis = serve_cluster(cluster, controller_port=args.controllerPort,
                         broker_port=args.brokerPort)
    print(f"controller http://localhost:{apis[0].port} | "
          f"broker http://localhost:{apis[1].port} "
          f"({args.servers} server(s) on {args.device}); ctrl-c to stop",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        for api in apis:
            api.stop()
        cluster.shutdown()
    return 0


def _cmd_start_server(args) -> int:
    """One server in this process over a remote cluster state: serves
    until standard input closes."""
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.server.server import ServerInstance
    from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration
    from pinot_tpu_torch.spi.filesystem import MemoryDeepStore
    from pinot_tpu_torch.transport.grpc_transport import GrpcQueryServer
    from pinot_tpu_torch.transport.rest import ServerAdminApi
    from pinot_tpu_torch.transport.state_service import (
        RemoteClusterStateStore,
    )

    cfg = PinotConfiguration(
        {CommonConstants.HBM_BUDGET_BYTES_KEY: args.budgetBytes}
        if args.budgetBytes else {})
    store = RemoteClusterStateStore(args.stateUrl)
    server = ServerInstance(
        args.instanceId, store, MemoryDeepStore(), config=cfg,
        executor=ServerQueryExecutor(device=args.device, config=cfg),
        segment_dir=args.segmentDir)
    grpc_front = admin = None
    try:
        server.start()
        grpc_front = GrpcQueryServer(server, port=args.grpcPort)
        grpc_front.start()
        admin = ServerAdminApi(server, port=args.adminPort)
        admin.start()
        print(json.dumps({"instanceId": args.instanceId,
                          "grpcPort": grpc_front.port,
                          "adminPort": admin.port}), flush=True)
        sys.stdin.read()    # until the parent closes the pipe
    finally:
        if admin is not None:
            admin.stop()
        if grpc_front is not None:
            grpc_front.stop(grace=1.0)
        server.shutdown()
        store.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pinot_tpu_torch",
        description="pinot-tpu administration on the port "
                    "(ref: PinotAdministrator)")
    sub = p.add_subparsers(dest="command", required=True)

    j = sub.add_parser("LaunchDataIngestionJob",
                       help="run a segment generation job spec (yaml)")
    j.add_argument("-jobSpecFile", required=True)
    j.set_defaults(fn=_cmd_launch_ingestion_job)

    q = sub.add_parser("PostQuery", help="POST sql to a running broker")
    q.add_argument("-query", required=True)
    q.add_argument("-brokerHost", default="localhost")
    q.add_argument("-brokerPort", type=int, default=8099)
    q.add_argument("-timeout", type=float, default=60.0)
    q.set_defaults(fn=_cmd_post_query)

    qs = sub.add_parser("Quickstart",
                        help="embedded cluster + data + sample queries")
    qs.add_argument("-exampleDir", default=None,
                    help="dir with *_schema.json, *_offline_table_config."
                         "json, ingestionJobSpec.yaml (reference layout)")
    qs.add_argument("-dataDir", default=None,
                    help="segment directory (default: segments in memory)")
    qs.add_argument("-query", action="append")
    qs.add_argument("-device", default="cuda")
    qs.set_defaults(fn=_cmd_quickstart)

    c = sub.add_parser("StartCluster",
                       help="embedded cluster with REST endpoints")
    c.add_argument("-servers", type=int, default=1)
    c.add_argument("-controllerPort", type=int, default=9000)
    c.add_argument("-brokerPort", type=int, default=8099)
    c.add_argument("-dataDir", default=None,
                   help="segment directory (default: segments in memory)")
    c.add_argument("-device", default="cuda")
    c.set_defaults(fn=_cmd_start_cluster)

    sv = sub.add_parser("StartServer",
                        help="one server over a remote cluster state, "
                             "with its gRPC and admin REST fronts")
    sv.add_argument("-stateUrl", required=True,
                    help="the state service (StateStoreApi) URL")
    sv.add_argument("-instanceId", required=True)
    sv.add_argument("-device", default="cuda")
    sv.add_argument("-segmentDir", default=None)
    sv.add_argument("-budgetBytes", type=int, default=0,
                    help="the residency budget on the card (0: the "
                         "config's)")
    sv.add_argument("-grpcPort", type=int, default=0)
    sv.add_argument("-adminPort", type=int, default=0)
    sv.set_defaults(fn=_cmd_start_server)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
