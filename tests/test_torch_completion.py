"""The port's segment-completion FSM and partitioned assignment against the
JAX package's (``pinot_tpu_torch/controller/completion.py``,
``controller/assignment.py``).

Every step goes to the JAX ``SegmentCompletionManager`` and to the port's
in the same order; each reply (response and target offset) and each
``fsm_state`` must be equal. The cases are tests/test_controller.py
``TestCompletionFsm``'s and tests/test_completion_property.py's seeded
schedules. Time is a fake clock the schedule moves (the hold window, the
commit time limit), put in place of each module's ``time``, so nothing
here sleeps. ``PartitionedReplicaGroupAssignment`` is held to JAX's over
1-6 instances, 1-3 groups and 1-4 partitions. All values compared are
exact.
"""

import threading
import types

import numpy as np
import pytest

from pinot_tpu.controller import assignment as jassign
from pinot_tpu.controller import completion as jcompletion
from pinot_tpu.ingestion import realtime as jrt
from pinot_tpu.ingestion.stream import StreamOffset as JOffset
from pinot_tpu_torch.controller import assignment as tassign
from pinot_tpu_torch.controller import completion as tcompletion
from pinot_tpu_torch.ingestion import realtime as trt
from pinot_tpu_torch.ingestion.stream import StreamOffset as TOffset
from pinot_tpu_torch.segment import SegmentBuilder
from pinot_tpu_torch.spi import data as tdata
from pinot_tpu_torch.spi.filesystem import MemoryDeepStore


class _Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    fake = types.SimpleNamespace(monotonic=c.monotonic)
    monkeypatch.setattr(jcompletion, "time", fake)
    monkeypatch.setattr(tcompletion, "time", fake)
    return c


class _Pair:
    """A JAX and a port manager driven in lockstep."""

    def __init__(self, **kw):
        self.j = jcompletion.SegmentCompletionManager(**kw)
        self.t = tcompletion.SegmentCompletionManager(**kw)

    @staticmethod
    def _same(jr, tr, what):
        assert tr.response.value == jr.response.value, what
        j_off = None if jr.target_offset is None else jr.target_offset.value
        t_off = None if tr.target_offset is None else tr.target_offset.value
        assert t_off == j_off, what
        return tr

    def consumed(self, seg, inst, off):
        return self._same(
            self.j.segment_consumed(seg, inst, JOffset(off)),
            self.t.segment_consumed(seg, inst, TOffset(off)),
            ("consumed", seg, inst, off))

    def commit_start(self, seg, inst, off):
        return self._same(
            self.j.segment_commit_start(seg, inst, JOffset(off)),
            self.t.segment_commit_start(seg, inst, TOffset(off)),
            ("commit_start", seg, inst, off))

    def commit_end(self, seg, inst, off):
        return self._same(
            self.j.segment_commit_end(seg, inst, JOffset(off), "loc", None),
            self.t.segment_commit_end(seg, inst, TOffset(off), "loc", None),
            ("commit_end", seg, inst, off))

    def stopped(self, seg, inst):
        self.j.segment_stopped_consuming(seg, inst, "crash")
        self.t.segment_stopped_consuming(seg, inst, "crash")

    def state(self, seg):
        j, t = self.j.fsm_state(seg), self.t.fsm_state(seg)
        assert (t and t.value) == (j and j.value), seg
        return t


R = trt.CompletionResponse


def test_single_replica_commits(clock):
    p = _Pair(hold_window_s=0.0)
    assert p.consumed("seg", "s0", 100).response is R.COMMIT
    assert p.state("seg") is tcompletion.FsmState.COMMITTER_NOTIFIED
    assert p.commit_start("seg", "s0", 100).response is R.COMMIT
    assert p.state("seg") is tcompletion.FsmState.COMMITTER_UPLOADING
    assert p.commit_end("seg", "s0", 100).response is R.COMMIT
    assert p.state("seg") is tcompletion.FsmState.COMMITTED


def test_highest_offset_wins_and_laggard_catches_up(clock):
    p = _Pair(num_replicas_provider=lambda s: 2, hold_window_s=10.0)
    assert p.consumed("seg", "s0", 90).response is R.HOLD
    assert p.state("seg") is tcompletion.FsmState.HOLDING
    assert p.consumed("seg", "s1", 100).response is R.COMMIT
    r = p.consumed("seg", "s0", 90)
    assert r.response is R.CATCHUP and r.target_offset == TOffset(100)
    # the laggard at the winner's offset holds until the commit lands
    assert p.consumed("seg", "s0", 100).response is R.HOLD
    assert p.commit_start("seg", "s0", 100).response is R.HOLD
    assert p.commit_start("seg", "s1", 100).response is R.COMMIT
    assert p.commit_end("seg", "s1", 100).response is R.COMMIT
    assert p.consumed("seg", "s0", 100).response is R.KEEP


def test_hold_window_elects_without_every_replica(clock):
    p = _Pair(num_replicas_provider=lambda s: 3, hold_window_s=0.2)
    assert p.consumed("seg", "s0", 50).response is R.HOLD
    clock.now += 0.1
    assert p.consumed("seg", "s2", 70).response is R.HOLD
    clock.now += 0.1
    r = p.consumed("seg", "s0", 50)
    assert r.response is R.CATCHUP and r.target_offset == TOffset(70)
    assert p.consumed("seg", "s2", 70).response is R.COMMIT
    # a replica that never reported catches up to the winner
    r = p.consumed("seg", "s1", 10)
    assert r.response is R.CATCHUP and r.target_offset == TOffset(70)


@pytest.mark.parametrize("mod", [jcompletion, tcompletion])
def test_exactly_one_committer_under_concurrency(mod):
    offset = JOffset if mod is jcompletion else TOffset
    m = mod.SegmentCompletionManager(num_replicas_provider=lambda s: 4,
                                     hold_window_s=0.0)
    replies = {}
    barrier = threading.Barrier(4)

    def replica(i):
        barrier.wait()
        replies[i] = m.segment_consumed("seg", f"s{i}", offset(100))

    threads = [threading.Thread(target=replica, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(4):
        if replies[i].response.value == "HOLD":
            replies[i] = m.segment_consumed("seg", f"s{i}", offset(100))
    committers = [i for i, r in replies.items()
                  if r.response.value == "COMMIT"]
    assert len(committers) == 1


def test_non_winner_keep_after_commit_same_offset(clock):
    p = _Pair(num_replicas_provider=lambda s: 2, hold_window_s=0.0)
    assert p.consumed("seg", "s0", 100).response is R.COMMIT
    p.commit_start("seg", "s0", 100)
    p.commit_end("seg", "s0", 100)
    assert p.consumed("seg", "s1", 100).response is R.KEEP
    assert p.consumed("seg", "s2", 90).response is R.DISCARD
    assert p.consumed("seg", "s3", 110).response is R.DISCARD
    assert p.commit_start("seg", "s0", 100).response is R.KEEP


def test_dead_replica_during_holding_not_elected(clock):
    p = _Pair(num_replicas_provider=lambda s: 2, hold_window_s=10.0)
    assert p.consumed("seg", "s1", 100).response is R.HOLD
    p.stopped("seg", "s1")
    # s0 must not lose to the dead s1's stale offset: the window decides
    assert p.consumed("seg", "s0", 90).response is R.HOLD
    clock.now += 10.0
    assert p.consumed("seg", "s0", 90).response is R.COMMIT

    q = _Pair(num_replicas_provider=lambda s: 2, hold_window_s=0.0)
    q.consumed("seg", "s1", 100)
    q.stopped("seg", "s1")
    assert q.consumed("seg", "s0", 90).response is R.COMMIT


def test_committer_death_reopens_election(clock):
    p = _Pair(num_replicas_provider=lambda s: 2, hold_window_s=0.0)
    assert p.consumed("seg", "s0", 100).response is R.COMMIT
    p.stopped("seg", "s0")
    assert p.state("seg") is tcompletion.FsmState.HOLDING
    assert p.consumed("seg", "s1", 100).response is R.COMMIT
    assert p.t._fsms["seg"].committer == "s1"
    # a stop after the commit changes nothing
    p.commit_start("seg", "s1", 100)
    p.commit_end("seg", "s1", 100)
    p.stopped("seg", "s1")
    assert p.state("seg") is tcompletion.FsmState.COMMITTED


def test_committer_timeout_reelects_without_stopped_notification(clock):
    p = _Pair(num_replicas_provider=lambda s: 2, hold_window_s=0.0,
              max_commit_time_s=5.0)
    assert p.consumed("seg", "s0", 100).response is R.COMMIT
    # within the limit the peer holds; past it the peer takes over
    assert p.consumed("seg", "s1", 100).response is R.HOLD
    clock.now += 6.0
    assert p.consumed("seg", "s1", 100).response is R.COMMIT
    assert p.t._fsms["seg"].committer == "s1" == p.j._fsms["seg"].committer
    # the old committer's own report never re-elects
    clock.now += 6.0
    assert p.consumed("seg", "s1", 100).response is R.COMMIT


def test_committer_diverged_offset_reelects(clock):
    p = _Pair(num_replicas_provider=lambda s: 1, hold_window_s=0.0)
    assert p.consumed("seg", "s0", 100).response is R.COMMIT
    assert p.commit_start("seg", "s0", 120).response is R.HOLD
    assert p.state("seg") is tcompletion.FsmState.HOLDING
    assert p.commit_end("seg", "s0", 120).response is R.HOLD


def test_committed_fsms_pruned_after_ttl(clock):
    p = _Pair(hold_window_s=0.0)
    p.consumed("a", "s0", 1)
    p.commit_start("a", "s0", 1)
    p.commit_end("a", "s0", 1)
    clock.now += tcompletion.SegmentCompletionManager.COMMITTED_TTL_S + 1
    p.consumed("b", "s0", 1)        # a new FSM prunes expired ones
    assert p.state("a") is None
    p.j.forget("b")
    p.t.forget("b")
    assert p.state("b") is None


def _drive(p, clock, seg, replicas, offsets, rng, crash=None):
    """tests/test_completion_property.py's schedule on both managers:
    replicas report in a random order each round (the clock moves 0.002 s
    a round) until one commits; -> (committer, committed offset, log)."""
    log = []
    alive = [r for r in replicas if r != crash]
    for _ in range(200):
        clock.now += 0.002
        order = list(alive)
        rng.shuffle(order)
        for r in order:
            reply = p.consumed(seg, r, offsets[r])
            log.append((r, reply))
            if reply.response is R.CATCHUP:
                offsets[r] = reply.target_offset.value
            elif reply.response is R.COMMIT:
                if r == crash:
                    continue
                assert p.commit_start(seg, r, offsets[r]).response is R.COMMIT
                assert p.t.segment_commit_upload(seg, r, "dir") == "dir"
                assert p.commit_end(seg, r, offsets[r]).response is R.COMMIT
                return r, offsets[r], log
    raise AssertionError("no replica ever committed")


@pytest.mark.parametrize("seed", range(20))
def test_fsm_invariants_random_schedules(clock, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5))
    replicas = [f"srv{i}" for i in range(n)]
    p = _Pair(num_replicas_provider=lambda seg: n, hold_window_s=30.0)
    offsets = {r: int(rng.integers(50, 100)) for r in replicas}
    top = max(offsets.values())
    seg = f"seg_{seed}"
    committer, committed, log = _drive(p, clock, seg, replicas,
                                       dict(offsets), rng)
    assert committed == top                                         # P2
    assert all(reply.target_offset.value == top for _, reply in log
               if reply.response is R.CATCHUP)                      # P4
    for r in replicas:                                              # P1
        if r != committer:
            assert p.commit_start(seg, r, top).response is not R.COMMIT
    assert p.consumed(seg, "late_same", top).response is R.KEEP     # P3
    assert p.consumed(seg, "late_stale", 1).response is R.DISCARD


@pytest.mark.parametrize("seed", range(8))
def test_crashed_committer_reelection(clock, seed):
    """P5: the would-be winner crashes before its commit start; the
    window (0.05 s of schedule) and the commit limit (0) re-elect."""
    rng = np.random.default_rng(100 + seed)
    replicas = ["srv0", "srv1", "srv2"]
    p = _Pair(num_replicas_provider=lambda seg: 3, hold_window_s=0.05,
              max_commit_time_s=0.0)
    offsets = {r: int(rng.integers(50, 100)) for r in replicas}
    winner = max(offsets.items(), key=lambda kv: (kv[1], kv[0]))[0]
    committer, committed, _ = _drive(p, clock, f"cseg_{seed}", replicas,
                                     dict(offsets), rng, crash=winner)
    assert committer != winner
    assert committed >= max(o for r, o in offsets.items() if r != winner)


def test_commit_upload_keeps_the_seal_in_the_deep_store():
    """In a cluster the committer's sealed segment goes to the deep store
    under the segment's table; without a table the upload raises."""
    store = MemoryDeepStore()
    tables = {"rt__0__0__x": "rt_REALTIME"}
    m = tcompletion.SegmentCompletionManager(deep_store=store,
                                             table_of=tables.get)
    schema = tdata.Schema("rt", [tdata.FieldSpec("k", tdata.DataType.INT)])
    seg = SegmentBuilder(schema, "rt__0__0__x").build({"k": np.arange(5)})
    url = m.segment_commit_upload("rt__0__0__x", "s0", seg)
    assert url == "memory://rt_REALTIME/rt__0__0__x"
    assert store.fetch_segment(url) is seg
    with pytest.raises(KeyError):
        m.segment_commit_upload("other__0__0__x", "s0", seg)


def test_busy_until_committed(clock):
    m = tcompletion.SegmentCompletionManager(hold_window_s=0.0)
    assert not m.busy()
    m.segment_consumed("seg", "s0", TOffset(5))
    assert m.busy()
    m.segment_commit_start("seg", "s0", TOffset(5))
    m.segment_commit_end("seg", "s0", TOffset(5), "loc", None)
    assert not m.busy()


def test_protocol_stopped_consuming_is_a_no_op_by_default():
    for proto in (jrt.LocalCompletionProtocol(),
                  trt.LocalCompletionProtocol()):
        assert proto.segment_stopped_consuming("s", "i", "why") is None


@pytest.mark.parametrize("instances", range(1, 7))
@pytest.mark.parametrize("groups", [1, 2, 3])
def test_partitioned_assignment_equal(instances, groups):
    servers = [f"server_{i}" for i in (3, 0, 5, 1, 4, 2)[:instances]]
    for partition in range(4):
        for replication in (1, 2, 3):
            name = f"t__{partition}__0__x"
            j = jassign.PartitionedReplicaGroupAssignment(groups).assign(
                name, {}, servers, replication)
            t = tassign.PartitionedReplicaGroupAssignment(groups).assign(
                name, {}, servers, replication)
            assert t == j
            assert tassign.PartitionedReplicaGroupAssignment(groups).assign(
                "other", {}, servers, replication, partition=partition) == \
                jassign.PartitionedReplicaGroupAssignment(groups).assign(
                    "other", {}, servers, replication, partition=partition)
    assert tassign._partition_from_llc_name("t__3__0__x") == 3
    assert tassign._partition_from_llc_name("plain") == \
        jassign._partition_from_llc_name("plain") == 0
