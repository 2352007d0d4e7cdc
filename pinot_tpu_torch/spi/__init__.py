from pinot_tpu_torch.spi.data import DataType, FieldSpec, FieldType, Schema
from pinot_tpu_torch.spi.table import IndexingConfig, StarTreeIndexConfig

__all__ = ["DataType", "FieldSpec", "FieldType", "Schema", "IndexingConfig",
           "StarTreeIndexConfig"]
