"""chip_smoke's phase 15 (scatter/gather on one card) at a small size on
the CPU: SSB at SF 0.02 in 8 segments and the user-events table at 8 x
5000 rows over 4 in-process servers, every check of the phase held
(``reducePath`` device in process and vectorized across the wire, the
rows of the single executor and of the numpy oracle, the sort rung on the
user-events groups, typed admission rejections, the query single-flight,
the worker pool at 1 and 8 threads, the borrower)."""

import chip_smoke
from pinot_tpu_torch.engine.executor import ServerQueryExecutor
from pinot_tpu_torch.query import compile_query
from pinot_tpu_torch.tools import ssb, usertable


def test_chip_smoke_phase_15_small():
    segs, frames = ssb.build_segments(0.02, num_segments=8, seed=3)
    ctxs = {q: compile_query(t + " LIMIT 100000")
            for q, t in ssb.QUERIES.items()}
    parts = {q: [ssb.numpy_answer(f, q) for f in frames] for q in ctxs}
    ex = ServerQueryExecutor(device="cpu")
    main = {"segs": segs, "ctxs": ctxs,
            "wants": {q: ssb.merge_answers(p) for q, p in parts.items()},
            "results": {q: ex.execute(c, segs)[0]
                        for q, c in ctxs.items()}}
    usegs, uframes = usertable.build_segments(8, 40_000, 42)
    run = chip_smoke.phase_scatter(main, {"segs": usegs, "frames": uframes},
                                   reps=1, device="cpu", iters=2)
    grouped = [q for q, f in run["flights"].items()
               if f["reduce_path"] == "device"]
    assert len(grouped) >= 9
    assert run["dense"]["rung"] == "dense"
    users = run["user_groups"]
    assert users["sort"]["rung"] == "sort"
    assert users["sort"]["space"] > 1 << 21
    assert users["groups"] == users["sort"]["groups"]
    assert sum(users["per_server"]) == users["sort"]["rows"]
    adm = run["admission"]
    assert adm["rejected"] > 0 and set(adm["reasons"]) <= {
        "queue_full", "wait_expired"}
    assert run["single_flight"]["runs"] < 8
    assert set(run["worker_pool"]["p50_ms"]) == {1, 8}
    assert run["borrow"]["borrows"] >= 1
