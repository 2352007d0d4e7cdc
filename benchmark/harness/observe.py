"""What a run observed, as the per-layer metric readers see it.

A reader (``metrics/<name>.py``) has one function, ``read(obs)``, that
returns the metric's value from an ``Observation``, or None where the run
holds nothing to read it from (the harness then leaves the metric out).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


@dataclass
class QueryRecord:
    client: int
    template: str
    variant: int
    t0_ns: int                      # submit (before the SQL is compiled)
    t1_ns: int                      # rows on the host
    tc_ns: int = 0                  # the SQL compiled
    error: Optional[str] = None
    rows: Any = None
    spans: List[Dict] = field(default_factory=list)
    launch: Dict = field(default_factory=dict)   # the port's launch record
    correct: bool = False           # rows equal to the reference's
    in_trace: bool = False          # finished inside the profiled window
    bytes: Optional[float] = None   # bytes the query must read (traced)

    @property
    def ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


@dataclass
class Observation:
    queries: List[QueryRecord]
    setup: Dict[str, float]
    profile: Any = None             # harness.profile.Profiler, traced run
    bandwidth: float = 0.0          # the card's peak bytes/s


def walk_spans(spans: List[Dict]) -> Iterator[Dict]:
    for s in spans:
        yield s
        yield from walk_spans(s.get("children", []))


def percentile(values: List[float], p: float) -> Optional[float]:
    """numpy's linear percentile, or None of no values."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), p))
