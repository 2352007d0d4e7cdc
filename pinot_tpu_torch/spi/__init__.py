from pinot_tpu_torch.spi.data import DataType, FieldSpec, FieldType, Schema
from pinot_tpu_torch.spi.table import (
    IndexingConfig,
    IngestionConfig,
    StarTreeIndexConfig,
    StreamIngestionConfig,
    TableConfig,
    TableType,
    TransformConfig,
    UpsertConfig,
    UpsertMode,
)

__all__ = ["DataType", "FieldSpec", "FieldType", "Schema", "IndexingConfig",
           "IngestionConfig", "StarTreeIndexConfig", "StreamIngestionConfig",
           "TableConfig", "TableType", "TransformConfig", "UpsertConfig",
           "UpsertMode"]
