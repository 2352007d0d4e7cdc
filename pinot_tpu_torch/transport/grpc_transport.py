"""gRPC query transport: broker <-> server over the network.

Counterpart of ``pinot_tpu/transport/grpc_transport.py``:
``GrpcQueryServer`` (:54, unary ``Execute`` and streaming
``ExecuteStreaming``) in front of one ``ServerInstance``, and
``GrpcServerStub`` (:114), the broker's handle on a remote server with
the in-process server's ``execute_query`` surface. The request is JAX's
JSON-framed InstanceRequest byte for byte (``_encode_request`` :39: the
compiled ``QueryContext`` of ``query/serde.py``, the table and the
segment list) and the answer JAX's ``DataTable`` bytes, so a stub of
either package queries a server of the other. A server gives a decoded
context its canonical JSON as its ``sql`` (the wire carries no SQL), the
key of the executor's plan cache and of the scheduler's shapes.

This is the only module of the port that imports ``grpc``.

Re-design of the reference's query RPC layer (Netty + thrift
``InstanceRequest`` at ``transport/QueryServer.java:46`` /
``ServerChannels.java:55``, and the gRPC alternative
``transport/grpc/GrpcQueryServer.java:45`` with
``pinot-common/src/main/proto/server.proto``): generic bytes-in /
bytes-out method handlers keep the wire free of generated stubs; the
payload framing is the versioned contract.
"""

from __future__ import annotations

import json
import logging

from concurrent import futures
from typing import List, Optional

import grpc

from pinot_tpu_torch.common.datatable import DataTable
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.serde import context_from_dict, context_to_dict

log = logging.getLogger(__name__)

_SERVICE = "pinot_tpu.QueryServer"
_METHOD_EXECUTE = f"/{_SERVICE}/Execute"
_METHOD_EXECUTE_STREAMING = f"/{_SERVICE}/ExecuteStreaming"


def _encode_request(ctx: QueryContext, table: str,
                    segments: Optional[List[str]]) -> bytes:
    return json.dumps({
        "version": 1,
        "context": context_to_dict(ctx),
        "table": table,
        "segments": segments,
    }).encode("utf-8")


def _decode_request(raw: bytes):
    d = json.loads(raw.decode("utf-8"))
    ctx = context_from_dict(d["context"])
    ctx.sql = json.dumps(d["context"], sort_keys=True)
    return ctx, d["table"], d.get("segments")


class GrpcQueryServer:
    """Network front of one ServerInstance
    (ref: GrpcQueryServer.java:45 submit:84). ``Execute`` is the unary
    whole-result method; ``ExecuteStreaming`` streams per-segment blocks
    for selection queries (ref: the streaming operators under
    ``operator/streaming/*`` feeding GrpcQueryServer) so the broker can
    short-circuit LIMIT without waiting for every segment."""

    def __init__(self, server_instance, port: int = 0, max_workers: int = 8):
        self._instance = server_instance
        self._grpc = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        handler = grpc.method_handlers_generic_handler(_SERVICE, {
            "Execute": grpc.unary_unary_rpc_method_handler(
                self._execute,
                request_deserializer=None,
                response_serializer=None),
            "ExecuteStreaming": grpc.unary_stream_rpc_method_handler(
                self._execute_streaming,
                request_deserializer=None,
                response_serializer=None),
        })
        self._grpc.add_generic_rpc_handlers((handler,))
        self.port = self._grpc.add_insecure_port(f"[::]:{port}")

    def _execute(self, request: bytes, context) -> bytes:
        try:
            ctx, table, segments = _decode_request(request)
            table_result = self._instance.execute_query(ctx, table, segments)
        except Exception as e:  # errors travel in the DataTable
            log.debug("grpc execute failed", exc_info=True)
            table_result = DataTable.for_exception(repr(e))
        return table_result.to_bytes()

    def _execute_streaming(self, request: bytes, context):
        """Yield one DataTable per block: selection queries stream a block
        PER SEGMENT (each block carries its own stats — unlike the
        reference's trailing-metadata framing, StreamingResponseUtils);
        other query shapes degrade to a single block (their combine is a
        reduction — there is nothing incremental to ship)."""
        try:
            ctx, table, segments = _decode_request(request)
            if not ctx.is_selection:
                yield self._instance.execute_query(
                    ctx, table, segments).to_bytes()
                return
            for block in self._instance.execute_query_streaming(
                    ctx, table, segments):
                yield block.to_bytes()
        except Exception as e:  # noqa: BLE001 — errors travel in-band
            log.debug("grpc streaming execute failed", exc_info=True)
            yield DataTable.for_exception(repr(e)).to_bytes()

    def start(self) -> None:
        self._grpc.start()

    def stop(self, grace: float = 5.0) -> None:
        self._grpc.stop(grace)


class GrpcServerStub:
    """Broker-side remote server handle — same ``execute_query`` surface as
    an in-process ServerInstance, so it registers with
    BrokerRequestHandler.register_server unchanged
    (ref: ServerChannels per-server connection + GrpcQueryClient.java:27)."""

    def __init__(self, address: str, timeout_s: float = 60.0):
        self.address = address
        self._channel = grpc.insecure_channel(address)
        self._call = self._channel.unary_unary(
            _METHOD_EXECUTE, request_serializer=None,
            response_deserializer=None)
        self._call_streaming = self._channel.unary_stream(
            _METHOD_EXECUTE_STREAMING, request_serializer=None,
            response_deserializer=None)
        self.timeout_s = timeout_s

    def execute_query(self, ctx: QueryContext, table: str,
                      segments: Optional[List[str]] = None) -> DataTable:
        try:
            raw = self._call(_encode_request(ctx, table, segments),
                             timeout=self.timeout_s)
            return DataTable.from_bytes(raw)
        except grpc.RpcError as e:
            return DataTable.for_exception(
                f"rpc to {self.address} failed: {e.code().name}")

    def execute_query_streaming(self, ctx: QueryContext, table: str,
                                segments: Optional[List[str]] = None):
        """Yield DataTable blocks as the server produces them
        (ref: GrpcQueryClient.submit returning a response iterator)."""
        try:
            for raw in self._call_streaming(
                    _encode_request(ctx, table, segments),
                    timeout=self.timeout_s):
                yield DataTable.from_bytes(raw)
        except grpc.RpcError as e:
            yield DataTable.for_exception(
                f"rpc to {self.address} failed: {e.code().name}")

    def close(self) -> None:
        self._channel.close()
