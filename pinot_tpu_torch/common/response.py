"""Broker response model.

Counterpart of ``pinot_tpu/common/response.py`` (``BrokerResponse``, the
reference's BrokerResponseNative): the result table, the exceptions and
the execution stats, in the reference's JSON layout (``to_dict``), with
the loud ``partialResult`` flag, and, for a traced query, ``traceInfo``
(JAX :27, :64-65): the flat ``entries`` and the ``spans`` tree under the
broker's root (``common/tracing.py`` ``build_broker_root``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.engine.results import QueryStats, ResultTable


@dataclass
class BrokerResponse:
    result_table: Optional[ResultTable] = None
    exceptions: List[Dict[str, Any]] = field(default_factory=list)
    stats: QueryStats = field(default_factory=QueryStats)
    num_servers_queried: int = 0
    num_servers_responded: int = 0
    time_used_ms: float = 0.0
    # broker-side phase timings (COMPILATION/ROUTING/SCATTER_GATHER/REDUCE);
    # server phases arrive merged inside stats.phase_ms
    phase_times_ms: Dict[str, float] = field(default_factory=dict)
    # a traced query's {"entries": [...], "spans": [broker root]}
    trace_info: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "exceptions": self.exceptions,
            "numServersQueried": self.num_servers_queried,
            "numServersResponded": self.num_servers_responded,
            # loud partial-result flag: true when a scattered-to server
            # returned no usable DataTable (the result stands on fewer
            # servers)
            "partialResult": (self.num_servers_responded
                              < self.num_servers_queried),
            "numSegmentsQueried": self.stats.num_segments_queried,
            "numSegmentsProcessed": self.stats.num_segments_processed,
            "numSegmentsMatched": self.stats.num_segments_matched,
            "numSegmentsPrunedByServer": self.stats.num_segments_pruned,
            "numDocsScanned": self.stats.num_docs_scanned,
            "totalDocs": self.stats.total_docs,
            "numGroupsLimitReached": self.stats.num_groups_limit_reached,
            "timeUsedMs": round(self.time_used_ms, 3),
            # broker + (summed) server phase timings in one map
            "phaseTimesMs": {
                **{k: round(v, 3) for k, v in self.phase_times_ms.items()},
                **{k: round(v, 3) for k, v in self.stats.phase_ms.items()},
            },
        }
        if self.stats.staging:
            # residency counters merged across servers (QueryStats.merge)
            d["staging"] = self.stats.staging
        if self.stats.decisions:
            # the path decisions: every decline of a faster rung this
            # query took, keyed "point:declined->chosen:reason", summed
            # across servers
            d["decisions"] = self.stats.decisions
        if self.result_table is not None:
            d["resultTable"] = self.result_table.to_dict()
        if self.trace_info:
            d["traceInfo"] = self.trace_info
        return d

    @property
    def has_exceptions(self) -> bool:
        return bool(self.exceptions)

    def add_exception(self, code: int, message: str) -> None:
        # the reference's QueryException error codes
        self.exceptions.append({"errorCode": code, "message": message})
