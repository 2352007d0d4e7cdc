from pinot_tpu_torch.spi.data import DataType, FieldSpec, FieldType, Schema

__all__ = ["DataType", "FieldSpec", "FieldType", "Schema"]
