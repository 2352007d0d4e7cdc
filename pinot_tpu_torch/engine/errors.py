"""Engine errors and decline reason codes.

``classify_decline`` maps a decline message to the same snake_case reason
code the JAX package records (``pinot_tpu/common/tracing.py``), restricted
to the messages this port can raise.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple


class QueryError(Exception):
    """A query that is wrong for the table (unknown column, bad literal)."""


class UnsupportedQueryError(QueryError):
    """A valid query shape this engine does not execute."""


class QueryRejectedError(QueryError):
    """Admission rejected the query: the bounded queue is full or the
    queue-wait bound expired (JAX ``pinot_tpu/engine/errors.py:17``).
    Retriable, with the queue depth seen at rejection so a client can back
    off in proportion; ``code`` is the JAX error's 429."""

    retriable = True
    code = 429

    def __init__(self, message: str, queue_depth: int = 0,
                 reason: str = "overload"):
        super().__init__(message)
        self.queue_depth = int(queue_depth)
        self.reason = reason


_DECLINE_RULES: Tuple[Tuple[str, str], ...] = (
    ("mutable segment", "mutable_segment"),
    # the star-tree node plan's (engine/plan.py plan_star_tree)
    ("star-tree group key space", "startree_group_space_over_limit"),
    ("no pre-agg pairs", "startree_no_preagg_pair"),
    ("group key space", "group_space_over_limit"),
    ("not device-supported", "agg_not_device_supported"),
    ("DISTINCTCOUNTHLL argument", "hll_arg_not_column"),
    ("DISTINCTCOUNTHLL needs", "hll_needs_sv_dict"),
    ("HLL register space", "hll_register_space_over_limit"),
    ("DISTINCTCOUNT argument", "distinctcount_arg_not_column"),
    ("DISTINCTCOUNT on raw", "distinctcount_raw_column"),
    ("DISTINCTCOUNT on MV", "distinctcount_mv_column"),
    ("DISTINCTCOUNT cardinality", "distinctcount_cardinality_over_limit"),
    ("MV aggregation argument", "mv_agg_arg_not_column"),
    ("needs a numeric MV column", "mv_agg_not_numeric"),
    ("group-by on virtual column", "group_virtual_column"),
    ("group-by on MV column", "group_mv_column"),
    ("raw int group-by span", "group_raw_span_over_limit"),
    ("group-by on raw float", "group_raw_float_column"),
    ("group-by expression span", "group_expression_span_over_limit"),
    ("group-by expression", "group_expression_unbounded"),
    ("expression predicate", "expression_predicate"),
    ("virtual column predicate", "virtual_column_predicate"),
    ("JSON_MATCH on MV", "json_match_mv_column"),
    ("on raw column -> host", "raw_predicate_unsupported"),
    ("raw MV column predicate", "raw_mv_predicate"),
    ("predicate", "predicate_unsupported"),
    ("non-numeric literal", "value_literal_non_numeric"),
    ("virtual column in value", "value_virtual_column"),
    ("in value expression", "value_column_not_numeric_sv"),
    ("transform", "transform_unsupported"),
    ("cannot compile value", "value_expression_uncompilable"),
    ("live groups exceed the compact cap", "compact_cap_overflow"),
    ("doc axis", "capacity_mesh_mismatch"),
    # fused-scan eligibility (engine/fused_scan.py _Ineligible messages)
    ("unpackable column", "pallas_unpackable_column"),
    ("lut with too many runs", "pallas_lut_too_many_runs"),
    ("raw group key", "pallas_raw_group_key"),
    ("non-numeric/MV agg value column", "pallas_value_not_numeric_sv"),
    ("no stats for int value bound", "pallas_no_int_stats"),
    ("i64 sum bound over i64", "pallas_i64_sum_bound_over_i64"),
    ("i64 column in float expression", "pallas_i64_in_float_expr"),
    ("missing agg value", "pallas_missing_agg_value"),
    ("int expr bound exceeds i32", "pallas_expression_bound_over_i32"),
    ("agg value", "pallas_agg_value_op_unsupported"),
    ("mv aggregation", "pallas_mv_aggregation"),
    ("int min/max not f32-exact", "pallas_minmax_not_f32_exact"),
)

_SANITIZE = re.compile(r"[^a-z0-9]+")
_DIGITS = re.compile(r"\d+")


def classify_decline(message: str) -> str:
    for needle, code in _DECLINE_RULES:
        if needle in message:
            return code
    code = _SANITIZE.sub("_", _DIGITS.sub("", message).lower()).strip("_")
    return code[:64] if code else "unknown"


class PlanError(UnsupportedQueryError):
    """A query shape the device plan does not cover; carries the reason
    code of the JAX package's ``PlanError`` for the same message."""

    def __init__(self, message: str, reason: Optional[str] = None):
        super().__init__(message)
        self.reason_code = reason or classify_decline(message)
