from pinot_tpu_torch.query.context import QueryContext, compile_query
from pinot_tpu_torch.query.parser import SqlParseError, parse_sql

__all__ = ["QueryContext", "compile_query", "SqlParseError", "parse_sql"]
