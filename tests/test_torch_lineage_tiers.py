"""Segment lineage and tiers on both packages' state stores (oracle
tests/test_lineage_tiers.py's 12 cases).

Each case runs the same calls against the JAX package's modules and the
port's (``controller/lineage.py``, ``controller/tiers.py``,
``broker/routing.py``) over a fresh store each; what every step returns
(entry states, hidden sets, routed segments, relocations, IdealStates,
errors raised) is equal between the two, and equal to the JAX test's
expectation. The lineage entries are the same dicts at the same store
path, so the routing of each package reads the other's entries too.
"""

import types

import pytest

from pinot_tpu.broker import routing as jrouting
from pinot_tpu.controller import lineage as jlineage
from pinot_tpu.controller import state as jstate
from pinot_tpu.controller import tiers as jtiers
from pinot_tpu.spi import table as jtable
from pinot_tpu_torch.broker import routing as trouting
from pinot_tpu_torch.controller import lineage as tlineage
from pinot_tpu_torch.controller import state as tstate
from pinot_tpu_torch.controller import tiers as ttiers
from pinot_tpu_torch.spi import table as ttable

JAX = types.SimpleNamespace(lineage=jlineage, state=jstate, tiers=jtiers,
                            table=jtable, routing=jrouting, port=False)
PORT = types.SimpleNamespace(lineage=tlineage, state=tstate, tiers=ttiers,
                             table=ttable, routing=trouting, port=True)
TABLE = "t_OFFLINE"
DAY = 86_400_000


def _seed(ns, store, segments=("s0", "s1", "s2"), servers=("srv1", "srv2")):
    store.add_table_config(ns.table.TableConfig(table_name="t"))
    for s in servers:
        store.register_instance(ns.state.InstanceInfo(s, "SERVER"))
    ideal = {}
    for seg in segments:
        store.set_segment_metadata(ns.state.SegmentZKMetadata(
            seg, TABLE, status="ONLINE", push_time_ms=1_000_000))
        ideal[seg] = {servers[0]: "ONLINE"}
    store.set_ideal_state(TABLE, ideal)
    for seg in segments:
        for inst, st in ideal[seg].items():
            store.report_instance_state(TABLE, seg, inst, st)


def _routed(ns, rm):
    if ns.port:
        routing = rm.route(TABLE).routing
    else:
        routing, _ = rm.get_routing_table(TABLE)
    return sorted(sum(routing.values(), []))


def _raises(fn, exc):
    with pytest.raises(exc):
        fn()
    return exc.__name__


# -- the cases: each returns what it saw ------------------------------------------

def protocol_states(ns, store):
    lm = ns.lineage.SegmentLineageManager(store)
    eid = lm.start_replace(TABLE, ["s0", "s1"], ["m0"])
    seen = [lm.entries(TABLE)[0].state, lm.hidden_segments(TABLE)]
    lm.end_replace(TABLE, eid)
    return seen + [lm.entries(TABLE)[0].state, lm.hidden_segments(TABLE)]


def revert_hides_outputs(ns, store):
    lm = ns.lineage.SegmentLineageManager(store)
    eid = lm.start_replace(TABLE, ["s0"], ["m0"])
    lm.revert_replace(TABLE, eid)
    seen = [lm.hidden_segments(TABLE)]
    lm.start_replace(TABLE, ["s0"], ["m1"])     # inputs free again
    return seen + [[e.state for e in lm.entries(TABLE)]]


def conflicting_start(ns, store):
    lm = ns.lineage.SegmentLineageManager(store)
    lm.start_replace(TABLE, ["s0"], ["m0"])
    return [_raises(lambda: lm.start_replace(TABLE, ["s0", "s2"], ["m1"]),
                    ValueError), len(lm.entries(TABLE))]


def double_end(ns, store):
    lm = ns.lineage.SegmentLineageManager(store)
    eid = lm.start_replace(TABLE, ["s0"], ["m0"])
    lm.end_replace(TABLE, eid)
    return [_raises(lambda: lm.end_replace(TABLE, eid), ValueError),
            _raises(lambda: lm.revert_replace(TABLE, "nope"), KeyError)]


def routing_respects_lineage(ns, store):
    _seed(ns, store)
    rm = ns.routing.RoutingManager(store)
    seen = [_routed(ns, rm)]
    lm = ns.lineage.SegmentLineageManager(store)
    eid = lm.start_replace(TABLE, ["s0", "s1"], ["m0"])
    # m0 uploads mid-protocol: in the ExternalView but not routed
    store.set_segment_metadata(ns.state.SegmentZKMetadata(
        "m0", TABLE, status="ONLINE"))
    store.update_ideal_state(TABLE, lambda i: {**i, "m0": {"srv1": "ONLINE"}})
    store.report_instance_state(TABLE, "m0", "srv1", "ONLINE")
    seen.append(_routed(ns, rm))
    lm.end_replace(TABLE, eid)
    seen.append(_routed(ns, rm))
    return seen


def parse_age(ns, store):
    t = ns.tiers
    return [t.parse_age_ms("7d"), t.parse_age_ms("90m"), t.parse_age_ms("5s"),
            _raises(lambda: t.parse_age_ms("7 fortnights"), ValueError)]


def target_tier_most_specific(ns, store):
    t = ns.tiers
    tiers = [t.TierConfig("warm", "1d", "warm_tag"),
             t.TierConfig("cold", "30d", "cold_tag")]
    return [t.target_tier(tiers, t.parse_age_ms("2d")).name,
            t.target_tier(tiers, t.parse_age_ms("45d")).name,
            t.target_tier(tiers, 1000),
            t.TierConfig.from_dict(tiers[1].to_dict()) == tiers[1]]


def relocation_moves_aged(ns, store):
    store.add_table_config(ns.table.TableConfig(
        table_name="t", tier_configs=[{
            "name": "cold", "segmentAge": "30d", "serverTag": "cold_tag",
            "segmentSelectorType": "time"}]))
    for inst, tags in (("hot1", ["DefaultTenant"]), ("cold1", ["cold_tag"]),
                       ("cold2", ["cold_tag"])):
        store.register_instance(ns.state.InstanceInfo(inst, "SERVER",
                                                      tags=tags))
    now = 100 * DAY
    for seg, age in (("old", 40), ("older", 50), ("new", 1)):
        store.set_segment_metadata(ns.state.SegmentZKMetadata(
            seg, TABLE, status="ONLINE", push_time_ms=now - age * DAY))
    store.set_ideal_state(TABLE, {s: {"hot1": "ONLINE"}
                                  for s in ("old", "older", "new")})
    relocator = ns.tiers.SegmentRelocator(store)
    moved = relocator.relocate_table(TABLE, now_ms=now)
    return [sorted(moved), store.get_ideal_state(TABLE),
            relocator.relocate_table(TABLE, now_ms=now)]


def no_tagged_server(ns, store):
    store.add_table_config(ns.table.TableConfig(
        table_name="t", tier_configs=[{"name": "cold", "segmentAge": "1d",
                                       "serverTag": "nosuch_tag"}]))
    store.register_instance(ns.state.InstanceInfo("hot1", "SERVER"))
    now = 10 * DAY
    store.set_segment_metadata(ns.state.SegmentZKMetadata(
        "s", TABLE, status="ONLINE", push_time_ms=now - 5 * DAY))
    store.set_ideal_state(TABLE, {"s": {"hot1": "ONLINE"}})
    return [ns.tiers.SegmentRelocator(store).relocate_table(TABLE, now_ms=now),
            store.get_ideal_state(TABLE)]


def dead_tier_server_skipped(ns, store):
    """A tagged server that is not alive takes nothing."""
    store.add_table_config(ns.table.TableConfig(
        table_name="t", tier_configs=[{"name": "cold", "segmentAge": "1d",
                                       "serverTag": "cold_tag"}]))
    store.register_instance(ns.state.InstanceInfo("hot1", "SERVER"))
    store.register_instance(ns.state.InstanceInfo("cold1", "SERVER",
                                                  tags=["cold_tag"]))
    store.set_instance_alive("cold1", False)
    now = 10 * DAY
    store.set_segment_metadata(ns.state.SegmentZKMetadata(
        "s", TABLE, status="ONLINE", push_time_ms=now - 5 * DAY))
    store.set_ideal_state(TABLE, {"s": {"hot1": "ONLINE"}})
    return [ns.tiers.SegmentRelocator(store).relocate_table(TABLE, now_ms=now)]


def stale_in_progress_reverts(ns, store):
    lm = ns.lineage.SegmentLineageManager(store)
    eid = lm.start_replace(TABLE, ["s0"], ["m0"])
    ts = lm.entries(TABLE)[0].timestamp_ms
    seen = [lm.cleanup(TABLE, now_ms=ts + 1000) == []]
    seen.append(lm.cleanup(TABLE, now_ms=ts + 25 * 3_600_000) == [eid])
    seen += [lm.entries(TABLE)[0].state, lm.hidden_segments(TABLE)]
    lm.start_replace(TABLE, ["s0"], ["m1"])
    return seen


def terminal_entries_dropped(ns, store):
    lm = ns.lineage.SegmentLineageManager(store)
    eid = lm.start_replace(TABLE, ["gone0"], ["m0"])
    lm.end_replace(TABLE, eid)
    ts = lm.entries(TABLE)[0].timestamp_ms
    return [lm.cleanup(TABLE, now_ms=ts + 25 * 3_600_000) == [eid],
            lm.entries(TABLE)]


CASES = {
    "protocol_states": (protocol_states, [
        "IN_PROGRESS", {"m0"}, "COMPLETED", {"s0", "s1"}]),
    "revert_hides_outputs": (revert_hides_outputs, [
        {"m0"}, ["REVERTED", "IN_PROGRESS"]]),
    "conflicting_start": (conflicting_start, ["ValueError", 1]),
    "double_end": (double_end, ["ValueError", "KeyError"]),
    "routing_respects_lineage": (routing_respects_lineage, [
        ["s0", "s1", "s2"], ["s0", "s1", "s2"], ["m0", "s2"]]),
    "parse_age": (parse_age, [7 * DAY, 90 * 60_000, 5000, "ValueError"]),
    "target_tier_most_specific": (target_tier_most_specific, [
        "warm", "cold", None, True]),
    "relocation_moves_aged": (relocation_moves_aged, None),
    "no_tagged_server": (no_tagged_server, [[], {"s": {"hot1": "ONLINE"}}]),
    "dead_tier_server_skipped": (dead_tier_server_skipped, [[]]),
    "stale_in_progress_reverts": (stale_in_progress_reverts, [
        True, True, "REVERTED", {"m0"}]),
    "terminal_entries_dropped": (terminal_entries_dropped, [True, []]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_equal_on_both_stores(case):
    fn, want = CASES[case]
    got_j = fn(JAX, jstate.ClusterStateStore())
    got_t = fn(PORT, tstate.ClusterStateStore())
    assert got_t == got_j
    if want is not None:
        assert got_t == want


def test_relocation_round_robin():
    """The crc32-offset round robin over the tier's pool (replication 1):
    both aged segments reach the cold tier, spread as JAX spreads them."""
    got = relocation_moves_aged(PORT, tstate.ClusterStateStore())
    moved, ideal, again = got
    assert moved == ["old", "older"] and again == []
    assert all(set(ideal[s]) <= {"cold1", "cold2"} for s in moved)
    assert ideal["new"] == {"hot1": "ONLINE"}


def test_lineage_dicts_shared_across_packages():
    """The port's routing hides what JAX's lineage manager wrote, and the
    JAX manager reads the port's entries (same path, same dicts)."""
    store = tstate.ClusterStateStore()
    _seed(PORT, store)
    jlm = jlineage.SegmentLineageManager(store)
    eid = jlm.start_replace(TABLE, ["s0"], ["m0"])
    jlm.end_replace(TABLE, eid)
    rm = trouting.RoutingManager(store)
    assert _routed(PORT, rm) == ["s1", "s2"]
    tlm = tlineage.SegmentLineageManager(store)
    assert [e.state for e in tlm.entries(TABLE)] == ["COMPLETED"]
    jstore = jstate.ClusterStateStore()
    tlineage.SegmentLineageManager(jstore).start_replace(TABLE, ["a"], ["b"])
    assert jlineage.SegmentLineageManager(jstore).hidden_segments(
        TABLE) == {"b"}


def test_routing_snapshot_reads_lineage_and_view_together():
    """One routing snapshot holds the ExternalView and the lineage of one
    store version: a lineage write drops it, and the hidden set is the
    snapshot's."""
    store = tstate.ClusterStateStore()
    _seed(PORT, store)
    rm = trouting.RoutingManager(store)
    entry = rm._routing_entry(TABLE)
    assert entry.hidden == frozenset()
    tlineage.SegmentLineageManager(store).start_replace(TABLE, ["s0"], ["m9"])
    fresh = rm._routing_entry(TABLE)
    assert fresh is not entry and fresh.hidden == {"m9"}
    assert store.get_many(f"externalview/{TABLE}", f"lineage/{TABLE}")[1][0][
        "segmentsTo"] == ["m9"]
