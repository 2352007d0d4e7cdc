"""chip_smoke's phase 21 (the wire) at a small size on the CPU: the REST
front doors with every /debug route and the client over an in-process
cluster, the preflight against the kernel's plain version and a
blocklist file, and 2 servers in processes of their own
(``python -m pinot_tpu_torch StartServer``) reached over gRPC on replicas
of a state service, one of them killed at the end. Every check of the
phase holds; the plain version counts no launch."""

import chip_smoke
from pinot_tpu_torch.common.telemetry import TELEMETRY
from pinot_tpu_torch.engine.executor import ServerQueryExecutor
from pinot_tpu_torch.query import compile_query
from pinot_tpu_torch.tools import ssb


def test_chip_smoke_phase_21_small():
    segs, frames = ssb.build_segments(0, num_segments=4, seed=3,
                                      rows=24_000)
    ctxs = {q: compile_query(t + " LIMIT 100000")
            for q, t in ssb.QUERIES.items()}
    ex = ServerQueryExecutor(device="cpu")
    main = {"segs": segs, "ctxs": ctxs,
            "wants": {q: ssb.merge_answers(
                [ssb.numpy_answer(f, q) for f in frames]) for q in ctxs},
            "results": {q: ex.execute(c, segs)[0] for q, c in ctxs.items()}}
    ex.close()
    try:
        run = chip_smoke.phase_wire(main, reps=1, device="cpu", rounds=1)
    finally:
        TELEMETRY.reset()
    rest, proc = run["rest"], run["processes"]
    assert set(rest["flights"]) == set(ssb.QUERIES) == set(proc["flights"])
    assert set(rest["clients"]) == {1, 8} == set(proc["clients"])
    assert len(rest["debug_routes"]) == 10
    assert sum(rest["debug_routes"].values()) == 6 + 4 * 9
    assert not run["preflight"]["max_abs_err"]
    assert run["preflight"]["blocked"]
    assert set(run["preflight"]["declined"].values()) == {
        "pallas_preflight_column_slots", "pallas_preflight_tile_align",
        "pallas_preflight_filter_stack", "pallas_preflight_value_stack",
        "pallas_preflight_accumulator_rows",
        "pallas_preflight_program_int32", "pallas_preflight_smem_budget"}
    assert proc["killed"]["exceptions"]
    assert 0 < proc["killed"]["rows"] < proc["killed"]["of"]
