"""Ingestion: the stream SPI, record transformers and realtime
consumption (``pinot_tpu/ingestion/``, without the socket and Kafka
wire streams and the batch readers)."""

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
from pinot_tpu_torch.ingestion.transformers import CompositeTransformer

__all__ = [
    "CompletionReply", "CompletionResponse", "ConsumerState",
    "ConsumptionResult", "LocalCompletionProtocol",
    "RealtimeSegmentDataManager", "SegmentCompletionProtocol",
    "JsonMessageDecoder", "MemoryStream", "MessageBatch", "StreamMessage",
    "StreamOffset", "create_consumer_factory", "create_decoder",
    "register_decoder", "register_stream_type", "CompositeTransformer",
]
