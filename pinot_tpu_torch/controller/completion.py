"""The controller's segment-completion FSM: who commits a CONSUMING segment.

Counterpart of ``pinot_tpu/controller/completion.py``
(``SegmentCompletionManager``, the reference's SegmentCompletionManager):
the replicas of a CONSUMING segment report ``segment_consumed(offset)``;
the manager HOLDs them until every replica has reported or the hold
window has passed, elects the highest offset (ties to the highest
instance id) as the committer, tells laggards to CATCHUP to it, and lets
exactly one replica run the split commit. After the commit a replica at
the committed offset gets KEEP (it seals its own rows), any other DISCARD
(it fetches the committer's segment). A replica that stops consuming
leaves the election (``segment_stopped_consuming``), and a committer
silent past ``max_commit_time_s`` is replaced.

``segment_commit_upload`` keeps the committer's sealed segment in the
cluster's ``MemoryDeepStore`` (``spi/filesystem.py``) under
``memory://<table>/<segment>``, where a DISCARD replica or a server that
finds the segment ONLINE fetches it; the JAX manager hands on the
committer's build directory.
"""

from __future__ import annotations

import enum
import threading
import time

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from pinot_tpu_torch.ingestion.realtime import (
    CompletionReply,
    CompletionResponse,
    SegmentCompletionProtocol,
)
from pinot_tpu_torch.ingestion.stream import StreamOffset
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.spi.filesystem import MemoryDeepStore


class FsmState(enum.Enum):
    HOLDING = "HOLDING"
    COMMITTER_DECIDED = "COMMITTER_DECIDED"
    COMMITTER_NOTIFIED = "COMMITTER_NOTIFIED"
    COMMITTER_UPLOADING = "COMMITTER_UPLOADING"
    COMMITTING = "COMMITTING"
    COMMITTED = "COMMITTED"
    ABORTED = "ABORTED"


_ELECTED = (FsmState.COMMITTER_DECIDED, FsmState.COMMITTER_NOTIFIED,
            FsmState.COMMITTER_UPLOADING, FsmState.COMMITTING)


@dataclass
class _SegmentFsm:
    segment_name: str
    num_replicas: int
    state: FsmState = FsmState.HOLDING
    offsets: Dict[str, StreamOffset] = field(default_factory=dict)
    committer: Optional[str] = None
    committed_offset: Optional[StreamOffset] = None
    first_consumed_ms: float = 0.0
    committed_ms: float = 0.0
    elected_ms: float = 0.0
    winner_offset: Optional[StreamOffset] = None


class SegmentCompletionManager(SegmentCompletionProtocol):
    """One per controller; thread-safe (replicas report concurrently).

    ``commit_handler(segment_name, instance, offset, location, metadata)``
    flips the cluster metadata at the commit's end (the controller's
    ``_on_segment_commit``); ``table_of(segment_name)`` names the table a
    sealed segment is kept under in ``deep_store``. The times are
    monotonic seconds (the JAX fields keep their ``_ms`` names)."""

    # how long a COMMITTED FSM keeps answering late replicas KEEP / DISCARD
    COMMITTED_TTL_S = 300.0
    # the longest an elected committer may take before the election
    # re-opens, so a committer that dies silently cannot hold its peers
    MAX_COMMIT_TIME_S = 1800.0

    def __init__(self, num_replicas_provider: Optional[
                     Callable[[str], int]] = None,
                 hold_window_s: float = 0.2,
                 commit_handler=None,
                 max_commit_time_s: Optional[float] = None,
                 deep_store: Optional[MemoryDeepStore] = None,
                 table_of: Optional[Callable[[str], Optional[str]]] = None):
        self._fsms: Dict[str, _SegmentFsm] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._hold_window_s = hold_window_s
        self._max_commit_time_s = (self.MAX_COMMIT_TIME_S
                                   if max_commit_time_s is None
                                   else max_commit_time_s)
        self._num_replicas_provider = num_replicas_provider or (lambda s: 1)
        self._commit_handler = commit_handler
        self._deep_store = deep_store
        self._table_of = table_of

    def _fsm(self, segment_name: str) -> _SegmentFsm:
        fsm = self._fsms.get(segment_name)
        if fsm is None:
            self._prune_locked()
            fsm = _SegmentFsm(segment_name,
                              self._num_replicas_provider(segment_name))
            fsm.first_consumed_ms = time.monotonic()
            self._fsms[segment_name] = fsm
        return fsm

    def _prune_locked(self) -> None:
        now = time.monotonic()
        for name in [n for n, f in self._fsms.items()
                     if f.state is FsmState.COMMITTED
                     and now - f.committed_ms > self.COMMITTED_TTL_S]:
            del self._fsms[name]

    # -- the protocol -------------------------------------------------------------
    def segment_consumed(self, segment_name: str, instance: str,
                         offset: StreamOffset) -> CompletionReply:
        with self._lock:
            fsm = self._fsm(segment_name)
            fsm.offsets[instance] = offset

            if fsm.state is FsmState.COMMITTED:
                # same offset: seal locally; another: fetch the committer's
                return CompletionReply(
                    CompletionResponse.KEEP
                    if offset == fsm.committed_offset
                    else CompletionResponse.DISCARD)

            if fsm.state in _ELECTED:
                # a committer silent past the limit loses the election (its
                # own report proves it alive, so never on its own call)
                if (fsm.state is not FsmState.COMMITTING
                        and instance != fsm.committer
                        and time.monotonic() - fsm.elected_ms
                        > self._max_commit_time_s):
                    fsm.offsets.pop(fsm.committer, None)
                    fsm.state = FsmState.HOLDING
                    fsm.committer = None
                    fsm.winner_offset = None
                elif instance == fsm.committer:
                    return CompletionReply(CompletionResponse.COMMIT)
                elif offset < fsm.winner_offset:
                    return CompletionReply(CompletionResponse.CATCHUP,
                                           target_offset=fsm.winner_offset)
                else:
                    return CompletionReply(CompletionResponse.HOLD)

            # HOLDING: wait for every replica or the end of the window
            all_reported = len(fsm.offsets) >= fsm.num_replicas
            window_over = (time.monotonic() - fsm.first_consumed_ms
                           >= self._hold_window_s)
            if not (all_reported or window_over):
                return CompletionReply(CompletionResponse.HOLD)
            # the highest offset wins; a tie goes to the highest instance id
            winner = max(fsm.offsets.items(),
                         key=lambda kv: (kv[1].value, kv[0]))
            fsm.committer, fsm.winner_offset = winner
            fsm.state = FsmState.COMMITTER_DECIDED
            fsm.elected_ms = time.monotonic()
            if instance == fsm.committer:
                fsm.state = FsmState.COMMITTER_NOTIFIED
                return CompletionReply(CompletionResponse.COMMIT)
            if offset < fsm.winner_offset:
                return CompletionReply(CompletionResponse.CATCHUP,
                                       target_offset=fsm.winner_offset)
            return CompletionReply(CompletionResponse.HOLD)

    def segment_commit_start(self, segment_name: str, instance: str,
                             offset: StreamOffset) -> CompletionReply:
        with self._lock:
            fsm = self._fsms.get(segment_name)
            if fsm is None or fsm.committer != instance:
                return CompletionReply(CompletionResponse.HOLD)
            if fsm.state is FsmState.COMMITTED:
                return CompletionReply(CompletionResponse.KEEP)
            if offset != fsm.winner_offset:
                # the committer moved off its reported offset: elect again
                fsm.state = FsmState.HOLDING
                fsm.committer = None
                return CompletionReply(CompletionResponse.HOLD)
            fsm.state = FsmState.COMMITTER_UPLOADING
            return CompletionReply(CompletionResponse.COMMIT)

    def segment_commit_upload(self, segment_name: str, instance: str,
                              segment: ImmutableSegment) -> str:
        """Keep the sealed segment in the deep store; -> its location.
        Without a deep store (a manager driven alone) ``segment`` is
        already the location."""
        if self._deep_store is None:
            return segment
        table = self._table_of(segment_name) if self._table_of else None
        if table is None:
            raise KeyError(f"cannot resolve the table of {segment_name}")
        return self._deep_store.put_segment(table, segment)

    def segment_commit_end(self, segment_name: str, instance: str,
                           offset: StreamOffset, location: str,
                           metadata) -> CompletionReply:
        with self._lock:
            fsm = self._fsms.get(segment_name)
            if fsm is None or fsm.committer != instance:
                return CompletionReply(CompletionResponse.HOLD)
            fsm.state = FsmState.COMMITTING
        # the metadata flip runs outside the lock (it writes the store)
        if self._commit_handler is not None:
            self._commit_handler(segment_name, instance, offset, location,
                                 metadata)
        with self._lock:
            fsm.state = FsmState.COMMITTED
            fsm.committed_offset = offset
            fsm.committed_ms = time.monotonic()
        return CompletionReply(CompletionResponse.COMMIT)

    def segment_stopped_consuming(self, segment_name: str, instance: str,
                                  reason: str) -> None:
        with self._lock:
            fsm = self._fsms.get(segment_name)
            if fsm is None or fsm.state is FsmState.COMMITTED:
                return
            # a dead replica must not stay electable: drop its offset, and
            # re-open the election if it was, or would become, the winner
            fsm.offsets.pop(instance, None)
            if fsm.committer == instance or fsm.state is FsmState.HOLDING:
                fsm.state = FsmState.HOLDING
                fsm.committer = None
                fsm.winner_offset = None

    # -- introspection ----------------------------------------------------------
    def fsm_state(self, segment_name: str) -> Optional[FsmState]:
        with self._lock:
            fsm = self._fsms.get(segment_name)
            return fsm.state if fsm else None

    def busy(self) -> bool:
        """Whether an FSM is between its first report and COMMITTED."""
        with self._lock:
            return any(f.state is not FsmState.COMMITTED
                       for f in self._fsms.values())

    def forget(self, segment_name: str) -> None:
        with self._lock:
            self._fsms.pop(segment_name, None)
