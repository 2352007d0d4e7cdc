"""The port's query schedulers (``pinot_tpu_torch/server/scheduler.py``)
against the JAX package's (oracle: tests/test_scheduler_plugins.py
``TestPriorityScheduler``, ``TestSewfScheduler``).

Every case runs on both packages' schedulers. The victims are held on
events, and the shortest-expected-work-first cases read a fake clock
(the scheduler module's ``time``) with seeded latency EWMAs, so no case
depends on how long a sleep took.
"""

import threading
import time

import pytest

from pinot_tpu.server import scheduler as jsched
from pinot_tpu_torch.server import scheduler as tsched
from pinot_tpu_torch.server.server import ServerInstance
from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration

PKGS = pytest.mark.parametrize("sched", [jsched, tsched],
                               ids=["jax", "port"])


class _Clock:
    """The scheduler module's ``time`` with a hand-driven monotonic
    clock."""

    def __init__(self):
        self.now = 1000.0
        self.perf_counter = time.perf_counter
        self.sleep = time.sleep

    def monotonic(self):
        return self.now


def _blocked(s, shape="blocker"):
    """Park the scheduler's only worker; -> (the event that releases it,
    its future)."""
    gate, started = threading.Event(), threading.Event()

    def block():
        started.set()
        return gate.wait(30)

    fut = s.submit(block, shape=shape)
    assert started.wait(30)
    return gate, fut


def _recorder():
    order, lock = [], threading.Lock()

    def job(tag):
        with lock:
            order.append(tag)
        return tag

    return order, job


@PKGS
def test_fcfs_keeps_order_and_drains(sched):
    s = sched.make_scheduler("fcfs", num_workers=1)
    assert isinstance(s, sched.FcfsScheduler)
    gate, blocker = _blocked(s)
    order, job = _recorder()
    futs = [s.submit(lambda i=i: job(i), table="t") for i in range(10)]
    gate.set()
    assert [f.result(30) for f in futs] == list(range(10))
    assert order == list(range(10)) and blocker.result(30)
    s.shutdown(timeout_s=5)
    with pytest.raises(RuntimeError):
        s.submit(lambda: 1)


@PKGS
def test_token_bucket(sched, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(sched, "time", clock)
    s = sched.TokenBucketScheduler(num_workers=2, tokens_per_second=10.0,
                                   burst=2.0)
    assert s._take_token("t") == 0.0
    assert s._take_token("t") == 0.0
    assert s._take_token("t") == pytest.approx(0.1)     # one token's refill
    assert s._take_token("u") == 0.0                    # its own bucket
    clock.now += 1.0
    assert s._take_token("t") == 0.0
    monkeypatch.setattr(sched, "time", time)
    futs = [s.submit(lambda i=i: i * 2, table="x") for i in range(4)]
    assert sorted(f.result(30) for f in futs) == [0, 2, 4, 6]
    s.shutdown(timeout_s=5)


@PKGS
def test_priority_fairness_under_flood(sched):
    """One worker, a flood from one table queued first: the other table's
    query runs long before the flood drains."""
    s = sched.PriorityScheduler(num_workers=1)
    gate, blocker = _blocked(s)
    order, job = _recorder()
    flood = [s.submit(lambda i=i: job(("flood", i)), table="hot")
             for i in range(40)]
    late = s.submit(lambda: job(("late", 0)), table="cold")
    gate.set()
    late.result(30)
    for f in flood:
        f.result(30)
    assert order.index(("late", 0)) < 5
    blocker.result(30)
    s.shutdown(timeout_s=5)


@PKGS
def test_priority_weights_prefer_high(sched):
    s = sched.PriorityScheduler(num_workers=1,
                                table_priorities={"vip": 100.0, "low": 1.0})
    gate, blocker = _blocked(s, shape=None)
    order, job = _recorder()
    lows = [s.submit(lambda i=i: job(("low", i)), table="low")
            for i in range(20)]
    vips = [s.submit(lambda i=i: job(("vip", i)), table="vip")
            for i in range(20)]
    gate.set()
    for f in lows + vips:
        f.result(30)
    assert [t for t, _ in order[:20]].count("vip") > 10
    blocker.result(30)
    s.shutdown(timeout_s=5)


def _seed(s, shape, ms):
    with s._lock:
        s._ewma_ms[shape] = ms


@PKGS
def test_sewf_factory_and_snapshot(sched):
    s = sched.make_scheduler("sewf", num_workers=2)
    assert isinstance(s, sched.SewfScheduler)
    snap = s.stats_snapshot()
    assert snap["policy"] == "SewfScheduler"
    assert snap["workers"] == 2 and snap["queued"] == 0
    s.shutdown(timeout_s=2)


@PKGS
def test_sewf_short_shapes_overtake_long(sched, monkeypatch):
    monkeypatch.setattr(sched, "time", _Clock())
    s = sched.SewfScheduler(num_workers=1)
    _seed(s, "slow", 30.0)
    _seed(s, "fast", 1.0)
    gate, blocker = _blocked(s)
    order, job = _recorder()
    futs = [s.submit(lambda: job("slow1"), shape="slow"),
            s.submit(lambda: job("slow2"), shape="slow"),
            s.submit(lambda: job("fast1"), shape="fast")]
    gate.set()
    for f in futs:
        f.result(30)
    blocker.result(30)
    assert order == ["fast1", "slow1", "slow2"]
    s.shutdown(timeout_s=5)


@PKGS
def test_sewf_age_boost_prevents_starvation(sched, monkeypatch):
    """30 ms of expected work at an aging boost of 2 is cancelled by 15 ms
    of age: the slow entry, 50 ms older, runs first."""
    clock = _Clock()
    monkeypatch.setattr(sched, "time", clock)
    s = sched.SewfScheduler(num_workers=1, aging_boost=2.0)
    _seed(s, "slow", 30.0)
    _seed(s, "fast", 1.0)
    gate, blocker = _blocked(s)
    order, job = _recorder()
    slow = s.submit(lambda: job("slow"), shape="slow")
    clock.now += 0.05
    fast = s.submit(lambda: job("fast"), shape="fast")
    gate.set()
    slow.result(30)
    fast.result(30)
    blocker.result(30)
    assert order == ["slow", "fast"]
    s.shutdown(timeout_s=5)


@PKGS
def test_sewf_runs_drains_and_propagates_errors(sched):
    s = sched.SewfScheduler(num_workers=4)
    futs = [s.submit(lambda i=i: i * 3, shape=f"s{i % 5}")
            for i in range(40)]
    assert sorted(f.result(30) for f in futs) == sorted(
        i * 3 for i in range(40))

    def boom():
        raise ValueError("x")

    with pytest.raises(ValueError):
        s.submit(boom, shape="err").result(30)
    assert s.expected_ms("err") is not None
    s.shutdown(timeout_s=5)
    with pytest.raises(RuntimeError):
        s.submit(lambda: 1)


@pytest.mark.parametrize("policy,cls", [
    ("fcfs", "FcfsScheduler"), ("tokenbucket", "TokenBucketScheduler"),
    ("priority", "PriorityScheduler"), ("sewf", "SewfScheduler")])
def test_make_scheduler_from_config(policy, cls):
    cfg = PinotConfiguration({CommonConstants.RUNNER_THREADS_KEY: 3},
                             use_env=False)
    s = tsched.make_scheduler(policy, config=cfg)
    assert type(s).__name__ == cls and s.num_workers == 3
    s.shutdown(timeout_s=2)
    with pytest.raises(ValueError):
        tsched.make_scheduler("nope")


def test_server_defaults_to_sewf_with_eight_runners():
    """JAX's defaults (pinot_tpu/spi/config.py:187-188, :221-222), and the
    policy key read by the server."""
    assert (CommonConstants.DEFAULT_RUNNER_THREADS,
            CommonConstants.DEFAULT_SCHEDULER_POLICY) == (8, "sewf")
    from pinot_tpu.spi.config import CommonConstants as J

    assert (J.DEFAULT_RUNNER_THREADS, J.DEFAULT_SCHEDULER_POLICY) == (8,
                                                                      "sewf")
    from pinot_tpu_torch.controller.state import ClusterStateStore
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.spi.filesystem import MemoryDeepStore

    for cfg, want in ((None, ("SewfScheduler", 8)),
                      (PinotConfiguration(
                          {CommonConstants.SCHEDULER_POLICY_KEY: "fcfs",
                           CommonConstants.RUNNER_THREADS_KEY: 2},
                          use_env=False), ("FcfsScheduler", 2))):
        srv = ServerInstance("s", ClusterStateStore(), MemoryDeepStore(),
                             executor=ServerQueryExecutor(device="cpu"),
                             config=cfg)
        assert (type(srv.scheduler).__name__,
                srv.scheduler.num_workers) == want
        srv.scheduler.shutdown(timeout_s=2)


def test_worker_pool_still_maps_in_order():
    pool = tsched.WorkerPool(3)
    assert pool.map(lambda a, b: a * b, [1, 2, 3], [4, 5, 6]) == [4, 10, 18]
    pool.stop()
