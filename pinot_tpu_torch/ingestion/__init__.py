"""Ingestion: the stream SPI with its memory, socket and Kafka wire
streams, record transformers, realtime consumption, the input-format
readers and the batch segment generation job (``pinot_tpu/ingestion/``).
Importing the package registers ``stream.type`` ``socket`` and
``kafka``, as JAX's does (``pinot_tpu/ingestion/__init__.py:20-21``)."""

from pinot_tpu_torch.ingestion.realtime import (
    CompletionReply,
    CompletionResponse,
    ConsumerState,
    ConsumptionResult,
    LocalCompletionProtocol,
    RealtimeSegmentDataManager,
    SegmentCompletionProtocol,
)
from pinot_tpu_torch.ingestion.stream import (
    JsonMessageDecoder,
    MemoryStream,
    MessageBatch,
    StreamMessage,
    StreamOffset,
    create_consumer_factory,
    create_decoder,
    register_decoder,
    register_stream_type,
)
from pinot_tpu_torch.ingestion import socketstream  # noqa: F401, E402
from pinot_tpu_torch.ingestion import kafkawire  # noqa: F401, E402
from pinot_tpu_torch.ingestion.transformers import CompositeTransformer

__all__ = [
    "CompletionReply", "CompletionResponse", "ConsumerState",
    "ConsumptionResult", "LocalCompletionProtocol",
    "RealtimeSegmentDataManager", "SegmentCompletionProtocol",
    "JsonMessageDecoder", "MemoryStream", "MessageBatch", "StreamMessage",
    "StreamOffset", "create_consumer_factory", "create_decoder",
    "register_decoder", "register_stream_type", "CompositeTransformer",
]
