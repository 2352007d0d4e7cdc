"""Segment lineage: the atomic segment-replacement protocol.

Counterpart of ``pinot_tpu/controller/lineage.py`` (the reference's
``SegmentLineage`` + ``SegmentLineageUtils``), which minion tasks follow
so that no query sees both the inputs and the outputs of a merge: an entry
records ``segments_from -> segments_to`` with a state

    IN_PROGRESS  (start_replace: outputs uploading, hide them)
    COMPLETED    (end_replace:   outputs live, hide the inputs)
    REVERTED     (revert_replace: forget the outputs)

The entries are the JAX package's dicts at the same store path
(``lineage/<table>``), which the broker's routing reads
(``broker/routing.py``): it hides ``segments_to`` of an IN_PROGRESS or
REVERTED entry and ``segments_from`` of a COMPLETED one.
"""

from __future__ import annotations

import itertools
import time

from dataclasses import dataclass
from typing import Dict, List, Optional, Set

IN_PROGRESS = "IN_PROGRESS"
COMPLETED = "COMPLETED"
REVERTED = "REVERTED"

_counter = itertools.count()


@dataclass
class LineageEntry:
    entry_id: str
    segments_from: List[str]
    segments_to: List[str]
    state: str = IN_PROGRESS
    timestamp_ms: int = 0

    def to_dict(self) -> Dict:
        return {"id": self.entry_id, "segmentsFrom": self.segments_from,
                "segmentsTo": self.segments_to, "state": self.state,
                "timestampMs": self.timestamp_ms}

    @classmethod
    def from_dict(cls, d: Dict) -> "LineageEntry":
        return cls(d["id"], list(d["segmentsFrom"]), list(d["segmentsTo"]),
                   d.get("state", IN_PROGRESS), d.get("timestampMs", 0))


def lineage_path(table: str) -> str:
    return f"lineage/{table}"


class SegmentLineageManager:
    """The controller's lineage book-keeping over the state store."""

    def __init__(self, store):
        self.store = store  # race-ok: delegates_locking

    def _load(self, table: str) -> List[LineageEntry]:
        raw = self.store.get(lineage_path(table)) or []
        return [LineageEntry.from_dict(d) for d in raw]

    def _mutate(self, table: str, fn) -> None:
        """One atomic read-modify-write through the store's ``update``: a
        concurrent end_replace and cleanup never lose each other's
        flips."""

        def apply(raw):
            entries = [LineageEntry.from_dict(d) for d in (raw or [])]
            return [e.to_dict() for e in fn(entries)]

        self.store.update(lineage_path(table), apply, default=[])

    # -- the protocol ------------------------------------------------------
    def start_replace(self, table: str, segments_from: List[str],
                      segments_to: List[str]) -> str:
        """Open an IN_PROGRESS entry; raises where an input is already in
        an IN_PROGRESS replacement. -> the entry id."""
        now = int(time.time() * 1000)
        entry = LineageEntry(
            entry_id=f"lin_{now}_{next(_counter)}",
            segments_from=list(segments_from),
            segments_to=list(segments_to),
            state=IN_PROGRESS, timestamp_ms=now)

        def apply(entries):
            active: Set[str] = set()
            for e in entries:
                if e.state == IN_PROGRESS:
                    active.update(e.segments_from)
            overlap = active & set(segments_from)
            if overlap:
                raise ValueError(
                    f"segments already in an in-progress replacement: "
                    f"{sorted(overlap)}")
            return entries + [entry]

        self._mutate(table, apply)
        return entry.entry_id

    def end_replace(self, table: str, entry_id: str) -> None:
        self._set_state(table, entry_id, from_state=IN_PROGRESS,
                        to_state=COMPLETED)

    def revert_replace(self, table: str, entry_id: str) -> None:
        self._set_state(table, entry_id, from_state=IN_PROGRESS,
                        to_state=REVERTED)

    def _set_state(self, table: str, entry_id: str, from_state: str,
                   to_state: str) -> None:
        def apply(entries):
            for e in entries:
                if e.entry_id == entry_id:
                    if e.state != from_state:
                        raise ValueError(
                            f"lineage entry {entry_id} is {e.state}, "
                            f"not {from_state}")
                    e.state = to_state
                    return entries
            raise KeyError(f"no lineage entry {entry_id} for {table}")

        self._mutate(table, apply)

    def entries(self, table: str) -> List[LineageEntry]:
        return self._load(table)

    # -- cleanup (the retention manager runs it first) -----------------------
    def cleanup(self, table: str, max_age_ms: int = 24 * 3_600_000,
                now_ms: Optional[int] = None) -> List[str]:
        """Entries older than ``max_age_ms``: an IN_PROGRESS one is
        reverted (its minion died mid-replacement: the inputs are free for
        a retry, the half-uploaded outputs stay hidden); a COMPLETED one
        whose inputs are gone, or a REVERTED one whose outputs are gone,
        is dropped. -> the ids of the entries touched."""
        now = int(time.time() * 1000) if now_ms is None else now_ms
        # a cleanup with nothing to do writes nothing (every write drops
        # the brokers' lineage caches)
        if not any(now - e.timestamp_ms > max_age_ms
                   for e in self._load(table)):
            return []
        live = set(self.store.segment_names(table))
        touched: List[str] = []

        def apply(entries):
            touched.clear()
            kept: List[LineageEntry] = []
            for e in entries:
                if now - e.timestamp_ms <= max_age_ms:
                    kept.append(e)
                elif e.state == IN_PROGRESS:
                    e.state = REVERTED
                    touched.append(e.entry_id)
                    kept.append(e)
                elif e.state == COMPLETED \
                        and not (set(e.segments_from) & live):
                    touched.append(e.entry_id)
                elif e.state == REVERTED \
                        and not (set(e.segments_to) & live):
                    touched.append(e.entry_id)
                else:
                    kept.append(e)
            return kept

        self._mutate(table, apply)
        return list(touched)

    # -- visibility ----------------------------------------------------------
    def hidden_segments(self, table: str) -> Set[str]:
        return hidden_by_lineage(self.store.get(lineage_path(table)) or [])


def hidden_by_lineage(raw_entries) -> Set[str]:
    """The segments a table's lineage dicts hide from queries: a COMPLETED
    replacement hides its inputs, one in progress (or reverted) its
    outputs."""
    hidden: Set[str] = set()
    for e in raw_entries:
        if e.get("state") == COMPLETED:
            hidden.update(e["segmentsFrom"])
        else:
            hidden.update(e["segmentsTo"])
    return hidden
