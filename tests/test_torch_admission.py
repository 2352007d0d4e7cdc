"""The port's admission gate against the JAX package's.

``pinot_tpu_torch/server/admission.py`` is a copy of
``pinot_tpu/server/admission.py``'s ``AdmissionGate`` without the table
quota and the metrics binding (oracle: ``tests/test_admission.py``). Each
scenario runs against both gates, which must agree on the outcome: slot
and queue bounds, the wait bound, typed rejections with their
``queue_depth`` and ``reason``, ``configure`` at runtime, idempotent
release, the disabled gate, the counters. Then the port's executors: the
gate's keys from the config, a rejection before any lease, and the
ticket released when a query raises.
"""

import threading
import time

import pytest

from pinot_tpu.engine.errors import QueryRejectedError as JRejected
from pinot_tpu.server.admission import AdmissionGate as JGate
from pinot_tpu_torch.engine.errors import QueryError, QueryRejectedError
from pinot_tpu_torch.server.admission import AdmissionGate
from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration

GATES = {"jax": (JGate, JRejected), "port": (AdmissionGate,
                                             QueryRejectedError)}
# the counters both gates keep (the JAX gate adds its quota's)
COUNTERS = ("admitted", "rejectedQueueFull", "rejectedWaitExpired",
            "maxQueueDepth")


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.001)
    return cond()


def _queue_full(pkg):
    make, rejected = GATES[pkg]
    gate = make(max_concurrent=1, max_queue=1, max_wait_ms=5000)
    held = gate.admit("t")
    waiter_err = []

    def waiter():
        try:
            gate.release(gate.admit("t"))
        except rejected as e:
            waiter_err.append(e)

    w = threading.Thread(target=waiter)
    w.start()
    assert _wait_for(lambda: gate.snapshot()["queued"] == 1)
    t0 = time.monotonic()
    with pytest.raises(rejected) as ei:
        gate.admit("t")
    instant = time.monotonic() - t0 < 1.0
    gate.release(held)
    w.join(10)
    e = ei.value
    return {"instant": instant, "waiter_err": len(waiter_err),
            "reason": e.reason, "queue_depth": e.queue_depth,
            "code": e.code, "retriable": e.retriable,
            "counters": {k: gate.stats_snapshot()[k] for k in COUNTERS}}


def test_slots_and_queue_bounds_agree_with_jax():
    port, jax = _queue_full("port"), _queue_full("jax")
    assert port == jax
    assert port["instant"] and port["reason"] == "queue_full"
    assert port["queue_depth"] == 1 and port["code"] == 429
    assert port["counters"] == {"admitted": 2, "rejectedQueueFull": 1,
                                "rejectedWaitExpired": 0,
                                "maxQueueDepth": 1}


@pytest.mark.parametrize("pkg", sorted(GATES))
def test_rejection_is_a_typed_retriable_query_error(pkg):
    make, rejected = GATES[pkg]
    gate = make(max_concurrent=1, max_queue=-1, max_wait_ms=1000)
    held = gate.admit("t")
    with pytest.raises(rejected) as ei:
        gate.admit("t")
    gate.release(held)
    assert ei.value.retriable is True and ei.value.code == 429
    assert ei.value.reason == "queue_full" and ei.value.queue_depth == 0
    if pkg == "port":
        assert isinstance(ei.value, QueryError)


@pytest.mark.parametrize("pkg", sorted(GATES))
def test_wait_bound_rejects_the_queued_waiter(pkg):
    make, rejected = GATES[pkg]
    gate = make(max_concurrent=1, max_queue=4, max_wait_ms=100)
    held = gate.admit("t")
    t0 = time.monotonic()
    with pytest.raises(rejected) as ei:
        gate.admit("t")
    waited = time.monotonic() - t0
    assert 0.05 < waited < 2.0
    assert ei.value.reason == "wait_expired"
    assert ei.value.queue_depth == 1
    gate.release(held)
    gate.release(gate.admit("t"))
    snap = gate.stats_snapshot()
    assert (snap["rejectedWaitExpired"], snap["admitted"]) == (1, 2)
    assert snap["queueWaitMsMax"] >= 0.0


@pytest.mark.parametrize("pkg", sorted(GATES))
def test_release_is_idempotent_and_configure_wakes_waiters(pkg):
    make, _ = GATES[pkg]
    gate = make(max_concurrent=1, max_queue=4, max_wait_ms=5000)
    held = gate.admit("t")
    gate.release(held)
    gate.release(held)          # no phantom slot
    gate.release(None)
    a = gate.admit("t")
    assert gate.snapshot()["inflight"] == 1
    got = []

    def waiter():
        t = gate.admit("t")
        got.append(t)
        gate.release(t)

    w = threading.Thread(target=waiter)
    w.start()
    assert _wait_for(lambda: gate.snapshot()["queued"] == 1)
    gate.configure(max_concurrent=2)        # widened: the waiter admits
    w.join(10)
    assert got and got[0].wait_ms > 0.0
    gate.release(a)
    assert gate.snapshot()["inflight"] == 0


@pytest.mark.parametrize("pkg", sorted(GATES))
def test_disabled_gate_admits_everything(pkg):
    make, _ = GATES[pkg]
    gate = make(max_concurrent=-1, max_queue=0, max_wait_ms=1)
    tickets = [gate.admit("t") for _ in range(64)]
    assert gate.stats_snapshot()["admitted"] == 64
    assert not gate.enabled
    for t in tickets:
        gate.release(t)


def test_auto_bounds_and_snapshot_agree_with_jax():
    for kw in ({}, {"max_concurrent": 3}, {"max_concurrent": 3,
                                           "max_queue": -1},
               {"max_concurrent": 2, "max_queue": 5, "max_wait_ms": 250}):
        port, jax = AdmissionGate(**kw).snapshot(), JGate(**kw).snapshot()
        for k in ("enabled", "maxConcurrent", "maxQueue", "maxWaitMs",
                  "inflight", "queued"):
            assert port[k] == jax[k], (kw, k)


def test_hammer_never_exceeds_its_slots():
    """16 threads on 2 slots and 3 waiters: the slots are never exceeded,
    and every admission is either served or rejected with a code."""
    import sys

    gate = AdmissionGate(max_concurrent=2, max_queue=3, max_wait_ms=2000)
    lock = threading.Lock()
    state = {"inflight": 0, "peak": 0, "served": 0, "rejected": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker():
            for _ in range(20):
                try:
                    t = gate.admit("t")
                except QueryRejectedError as e:
                    assert e.reason in ("queue_full", "wait_expired")
                    with lock:
                        state["rejected"] += 1
                    continue
                try:
                    with lock:
                        state["inflight"] += 1
                        state["peak"] = max(state["peak"],
                                            state["inflight"])
                    time.sleep(0.0005)
                    with lock:
                        state["inflight"] -= 1
                        state["served"] += 1
                finally:
                    gate.release(t)

        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert state["peak"] <= 2
    assert state["served"] + state["rejected"] == 16 * 20
    snap = gate.stats_snapshot()
    assert snap["admitted"] == state["served"]
    assert snap["rejected"] == state["rejected"]


# -- the executors ---------------------------------------------------------

def _segment():
    import numpy as np

    from pinot_tpu_torch.segment import SegmentBuilder
    from pinot_tpu_torch.spi import DataType, FieldSpec, FieldType, Schema

    schema = Schema("s", [FieldSpec("k", DataType.STRING),
                          FieldSpec("v", DataType.LONG, FieldType.METRIC)])
    return SegmentBuilder(schema, "s_0").build(
        {"k": np.array(["a", "b"] * 256), "v": np.arange(512)})


@pytest.mark.parametrize("spelling", [
    {CommonConstants.ADMISSION_MAX_CONCURRENT_KEY: 3,
     CommonConstants.ADMISSION_MAX_QUEUE_KEY: 5,
     CommonConstants.ADMISSION_MAX_WAIT_MS_KEY: 250},
    {"PINOT_SERVER_QUERY_ADMISSION_MAX_CONCURRENT": "3",
     "pinot-server-query-admission-max-queue": "5",
     "pinot.server.query.admission.maxWaitMs": "250"}])
def test_executor_gate_from_the_config(spelling):
    from pinot_tpu_torch.parallel import ShardedQueryExecutor

    ex = ShardedQueryExecutor(device="cpu", config=PinotConfiguration(
        spelling, use_env=False))
    snap = ex.admission.snapshot()
    assert (snap["maxConcurrent"], snap["maxQueue"], snap["maxWaitMs"]) \
        == (3, 5, 250.0)


@pytest.mark.parametrize("entry", ["execute", "execute_instance"])
def test_rejection_comes_before_any_lease(entry):
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.query import compile_query

    seg = _segment()
    ex = ServerQueryExecutor(device="cpu")
    ctx = compile_query("SELECT sum(v) FROM s")
    ex.execute(ctx, [seg])
    before = ex.residency.snapshot()
    ex.admission.configure(max_concurrent=1, max_queue=-1, max_wait_ms=50)
    blocker = ex.admission.admit("hold")
    try:
        with pytest.raises(QueryRejectedError):
            getattr(ex, entry)(ctx, [seg])
    finally:
        ex.admission.release(blocker)
    after = ex.residency.snapshot()
    assert all(r["pins"] == 0 for r in after["stagedSegments"].values())
    assert after["stagedBytes"] == before["stagedBytes"]
    assert after["counters"] == before["counters"]
    table, _ = ex.execute(ctx, [seg])
    assert table.rows == [[float(sum(range(512)))]]


@pytest.mark.parametrize("entry", ["execute", "execute_instance"])
def test_ticket_released_when_the_query_raises(entry):
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.query import compile_query

    seg = _segment()
    ex = ServerQueryExecutor(device="cpu")
    ex.admission.configure(max_concurrent=1, max_queue=-1, max_wait_ms=50)
    for _ in range(3):
        with pytest.raises(QueryError, match="unknown column"):
            getattr(ex, entry)(compile_query("SELECT sum(w) FROM s"), [seg])
    assert ex.admission.snapshot()["inflight"] == 0
    ok = getattr(ex, entry)(compile_query("SELECT sum(v) FROM s"), [seg])
    assert ok is not None
    snap = ex.admission.stats_snapshot()
    assert (snap["admitted"], snap["rejected"]) == (4, 0)
