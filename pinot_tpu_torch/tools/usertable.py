"""User-event table: the user-facing analytics workload.

Counterpart of ``pinot_tpu/tools/usertable.py`` (:36-200). Pinot's
signature deployment is user-facing analytics: a wide per-user event table
answering many small point-filter group-bys at strict latency limits. The
table holds one column of each kind a Pinot user meets:

- ``user_id``: Zipf-distributed (a few whales, a long tail), the
  point-filter column;
- ``tags``: a multi-value dimension, 1-3 tags a row;
- ``latency_ms``: a raw (no-dictionary) metric, gamma-distributed integer
  milliseconds, the ``BETWEEN`` column;
- ``revenue``, ``num_items``: dictionary-encoded metrics;
- ``country``, ``device``, ``event_type``: low-cardinality dimensions.

``user_indexing_config`` is the JAX table's indexes: inverted on the
point-filter dimensions (``user_id``, ``country``, ``event_type``,
``tags``), a range index on the raw ``latency_ms``; ``build_segments``
builds them when asked, and the index rung then serves a tail user's
point filter from its postings.

``generate_frame`` draws one segment's rows, independently seeded per
segment. Its ``tags`` are drawn in one call as a dense ``[n, 3]`` code
matrix plus a count per row, where the JAX generator draws a Python list
per row: the distribution is the same (counts uniform in 1-3, tags
uniform over 32 with replacement), the random stream is not, so this
generator's rows after ``user_id`` differ from the JAX generator's for the
same seed. ``user_id`` is the first draw of both, so ``tail_users``
agrees with the JAX package's. The CPU tests carry JAX-built segments
across and do not depend on this generator.

``index_queries`` are I1-I5, the index rung's shapes on the indexed
table (a tail user's point filter, an IN of users with a country, a
narrow ``latency_ms`` range, an MV tag with a user, an absent user), with
their oracle ``index_answer``.

``host_queries`` are three more the host engine and the device top-k
serve (an ordered ``SELECT *`` of a tail user on the card, a group-by on
the ``$segmentName`` virtual column and grouped MV aggregations), with
their oracle ``host_answers``.

As a realtime table (``realtime_table_config``) the same rows arrive as
JSON messages (``frame_rows``) on a stream; ``frame_prefix`` is the frame
of the rows indexed up to a watermark, ``latest_per_user`` the rows an
upsert keyed on ``user_id`` keeps live, and ``realtime_queries`` /
``realtime_answers`` add what the consuming and sealed segments answer
beside U1-U7: the star-tree's shapes (R1, R2) and an HLL (R3).

Frames hold codes into the pools below (``country`` is
``COUNTRIES[frame["country"]]``), so an oracle works on small integers;
``build_segments`` turns them into dictionary columns without sorting
strings.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.segment.convert import ColumnArrays, segment_from_arrays
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.spi.data import DataType, FieldSpec, FieldType, Schema
from pinot_tpu_torch.spi.table import (
    IndexingConfig,
    StreamIngestionConfig,
    TableConfig,
    TableType,
    UpsertConfig,
    UpsertMode,
)

# tail users hold a handful of rows each; whales hold thousands:
# rng.zipf(ZIPF_A) clipped to NUM_USERS gives both in one draw
NUM_USERS = 100_000
ZIPF_A = 1.3

COUNTRIES = ["US", "IN", "BR", "DE", "JP", "GB", "FR", "CA", "AU", "MX"]
DEVICES = ["ios", "android", "web", "tv"]
EVENT_TYPES = ["view", "click", "cart", "purchase", "refund"]
TAGS = [f"tag{i}" for i in range(32)]
MAX_TAGS = 3

# the string dimensions and their pools
POOLS = {"country": COUNTRIES, "device": DEVICES, "event_type": EVENT_TYPES,
         "tags": TAGS}
NO_DICTIONARY_COLUMNS = ["latency_ms"]


def user_schema(primary_key_columns: Optional[List[str]] = None) -> Schema:
    D, M = FieldType.DIMENSION, FieldType.METRIC
    I, S = DataType.INT, DataType.STRING
    return Schema("user_events", [
        FieldSpec("user_id", I, D),
        FieldSpec("country", S, D),
        FieldSpec("device", S, D),
        FieldSpec("event_type", S, D),
        FieldSpec("tags", S, D, single_value=False),
        FieldSpec("latency_ms", I, M),
        FieldSpec("revenue", I, M),
        FieldSpec("num_items", I, M),
    ], primary_key_columns)


def user_indexing_config() -> IndexingConfig:
    """Inverted on the point-filter dimensions, a range index on the raw
    latency column (``pinot_tpu/tools/usertable.py:64-75``); revenue and
    num_items stay dictionary-encoded metrics."""
    return IndexingConfig(
        inverted_index_columns=["user_id", "country", "event_type", "tags"],
        range_index_columns=["latency_ms"],
        no_dictionary_columns=list(NO_DICTIONARY_COLUMNS))


def _users(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.zipf(ZIPF_A, n).clip(1, NUM_USERS).astype(np.int64)


def generate_frame(i: int, num_segments: int, n: int,
                   seed: int = 7) -> Dict[str, object]:
    """Segment ``i``'s rows, independently seeded: int arrays, string
    dimensions as codes into ``POOLS``, ``tags`` as (codes [n, 3], counts
    [n])."""
    rng = np.random.default_rng(seed * 1_000_003 + i)
    user = _users(rng, n)
    counts = rng.integers(1, MAX_TAGS + 1, n).astype(np.int32)
    tags = rng.integers(0, len(TAGS), (n, MAX_TAGS)).astype(np.int8)
    return {
        "user_id": user,
        "country": rng.integers(0, len(COUNTRIES), n).astype(np.int8),
        "device": rng.integers(0, len(DEVICES), n).astype(np.int8),
        "event_type": rng.integers(0, len(EVENT_TYPES), n).astype(np.int8),
        "tags": (tags, counts),
        # long-tailed latency, integer ms
        "latency_ms": (rng.gamma(2.0, 40.0, n) + 1).astype(np.int64),
        "revenue": rng.integers(0, 500, n).astype(np.int64),
        "num_items": rng.integers(1, 10, n).astype(np.int64),
    }


def _coded(pool: List[str], codes: np.ndarray) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """Codes into ``pool`` -> (sorted dictionary of the values present,
    dictIds), without sorting the rows' strings."""
    order = np.argsort(np.asarray(pool))
    rank = np.empty(len(pool), dtype=np.int64)
    rank[order] = np.arange(len(pool))
    ranks = rank[codes]
    present = np.unique(ranks)
    return (np.asarray(pool)[order][present],
            np.searchsorted(present, ranks).astype(np.int32))


def columns_of_frame(frame: Dict[str, object]) -> Dict[str, ColumnArrays]:
    D, M = FieldType.DIMENSION, FieldType.METRIC
    out: Dict[str, ColumnArrays] = {}
    for fs in user_schema().field_specs:
        v = frame[fs.name]
        if fs.name == "tags":
            codes, counts = v
            valid = np.arange(codes.shape[1])[None, :] < counts[:, None]
            d, ids = _coded(TAGS, codes[valid])
            dense = np.zeros(codes.shape, dtype=np.int32)
            dense[valid] = ids
            out[fs.name] = ColumnArrays(fs.data_type, D, d, dense,
                                        mv_counts=counts)
        elif fs.name in POOLS:
            d, ids = _coded(POOLS[fs.name], v)
            out[fs.name] = ColumnArrays(fs.data_type, D, d, ids)
        elif fs.name in NO_DICTIONARY_COLUMNS:
            out[fs.name] = ColumnArrays(fs.data_type, M, values=v)
        else:
            d, ids = np.unique(v, return_inverse=True)
            out[fs.name] = ColumnArrays(fs.data_type, fs.field_type, d,
                                        ids.reshape(-1))
    return out


def segment_rows(num_segments: int, rows: int) -> List[int]:
    per = -(-rows // num_segments)
    return [min(per, rows - i * per) for i in range(num_segments)
            if rows - i * per > 0]


def build_segments(num_segments: int = 4, rows: int = 1_000_000,
                   seed: int = 7, indexing: Optional[IndexingConfig] = None
                   ) -> Tuple[List[ImmutableSegment],
                              List[Dict[str, object]]]:
    """(segments built in memory, with the indexes ``indexing`` names,
    the frames they were built from)."""
    segs, frames = [], []
    for i, n in enumerate(segment_rows(num_segments, rows)):
        frame = generate_frame(i, num_segments, n, seed)
        segs.append(segment_from_arrays(f"user_{i}", n,
                                        columns_of_frame(frame),
                                        table_name="user_events",
                                        indexing=indexing))
        frames.append(frame)
    return segs, frames


def tail_users(rows: int, num_segments: int = 4, seed: int = 7,
               count: int = 64, max_rows_frac: float = 0.001) -> List[int]:
    """Deterministic sample of user_ids whose total row count stays under
    ``max_rows_frac`` of the table: the selective point-filter targets
    (tail users, not whales). Equal to the JAX package's."""
    counts: Dict[int, int] = {}
    for i, n in enumerate(segment_rows(num_segments, rows)):
        user = _users(np.random.default_rng(seed * 1_000_003 + i), n)
        uniq, cnt = np.unique(user, return_counts=True)
        for u, c in zip(uniq.tolist(), cnt.tolist()):
            counts[u] = counts.get(u, 0) + c
    cap = max(1, int(rows * max_rows_frac))
    pool = sorted(u for u, c in counts.items() if 0 < c <= cap)
    if not pool:
        return []
    pick = np.random.default_rng(seed).choice(
        len(pool), size=min(count, len(pool)), replace=False)
    return [pool[int(j)] for j in sorted(pick)]


def queries(user: int) -> Dict[str, str]:
    """The query mix U1-U7 over one tail user: a point-filter group-by, a
    raw metric aggregated by the fused scan, a raw-value range, an MV
    equality, the exclusive MV semantics of NOT IN, a group-by on the raw
    column (ties in the count broken by the value, so the top 10 is one
    set), and an OR of a raw IN and an MV IN."""
    return {
        "U1": f"SELECT event_type, count(*), sum(revenue) FROM user_events "
              f"WHERE user_id = {user} GROUP BY event_type",
        "U2": "SELECT country, count(*), sum(latency_ms), min(latency_ms), "
              "max(latency_ms) FROM user_events "
              "WHERE event_type IN ('click', 'purchase') GROUP BY country",
        "U3": f"SELECT count(*), sum(revenue) FROM user_events "
              f"WHERE user_id = {user} AND latency_ms BETWEEN 10 AND 200",
        "U4": "SELECT device, count(*), avg(latency_ms) FROM user_events "
              "WHERE tags = 'tag7' GROUP BY device",
        "U5": "SELECT count(*) FROM user_events "
              "WHERE tags NOT IN ('tag1', 'tag2') AND country = 'US'",
        "U6": "SELECT latency_ms, count(*) FROM user_events "
              "WHERE country = 'DE' GROUP BY latency_ms "
              "ORDER BY count(*) DESC, latency_ms LIMIT 10",
        "U7": "SELECT count(*), sum(num_items) FROM user_events "
              "WHERE latency_ms IN (40, 41, 42) OR tags IN ('tag3')",
    }


# -- numpy oracle -------------------------------------------------------------

# queries whose rows come in the SQL's own order (U6's ORDER BY ... LIMIT
# 10); the others' rows are compared sorted
_ORDERED = {"U6"}


def _has_tag(frame: Dict[str, object], tag_codes: List[int]) -> np.ndarray:
    """Rows holding any of ``tag_codes`` among their first ``count`` tags."""
    codes, counts = frame["tags"]
    entry = np.arange(codes.shape[1])[None, :] < counts[:, None]
    return (np.isin(codes, tag_codes) & entry).any(axis=1)


def _group_rows(keys: np.ndarray, pool: List[str],
                values: Dict[str, np.ndarray]
                ) -> Dict[str, Dict[str, object]]:
    """{pool value: {"count": rows, name: the group's values}} of the
    codes in ``keys`` that occur."""
    out: Dict[str, Dict[str, object]] = {}
    cnt = np.bincount(keys, minlength=len(pool))
    for k in np.nonzero(cnt)[0].tolist():
        sel = keys == k
        row: Dict[str, object] = {"count": int(cnt[k])}
        for name, v in values.items():
            row[name] = v[sel]
        out[pool[k]] = row
    return out


def numpy_answer(frames: List[Dict[str, object]], qid: str, user: int
                 ) -> List[List]:
    """Rows of query ``qid`` (``queries(user)``) over the generator's frames,
    computed with numpy alone: group rows sorted by key (U6: in its ORDER BY
    and LIMIT), counts and sums as python ints, averages as floats."""
    tag = {t: i for i, t in enumerate(TAGS)}
    parts: Dict[object, List] = {}

    def add(key, *vals):
        got = parts.get(key)
        parts[key] = list(vals) if got is None else [
            _merge(a, b) for a, b in zip(got, vals)]

    for f in frames:
        lat, user_id = f["latency_ms"], f["user_id"]
        if qid == "U1":
            m = user_id == user
            for k, r in _group_rows(f["event_type"][m], EVENT_TYPES,
                                    {"rev": f["revenue"][m]}).items():
                add(k, r["count"], int(r["rev"].sum()))
        elif qid == "U2":
            m = np.isin(f["event_type"], [EVENT_TYPES.index("click"),
                                          EVENT_TYPES.index("purchase")])
            for k, r in _group_rows(f["country"][m], COUNTRIES,
                                    {"lat": lat[m]}).items():
                add(k, r["count"], int(r["lat"].sum()),
                    ("min", int(r["lat"].min())), ("max", int(r["lat"].max())))
        elif qid == "U3":
            m = (user_id == user) & (lat >= 10) & (lat <= 200)
            add((), int(m.sum()), int(f["revenue"][m].sum()))
        elif qid == "U4":
            m = _has_tag(f, [tag["tag7"]])
            for k, r in _group_rows(f["device"][m], DEVICES,
                                    {"lat": lat[m]}).items():
                add(k, r["count"], ("avg", int(r["lat"].sum()), r["count"]))
        elif qid == "U5":
            m = (~_has_tag(f, [tag["tag1"], tag["tag2"]])
                 & (f["country"] == COUNTRIES.index("US")))
            add((), int(m.sum()))
        elif qid == "U6":
            m = f["country"] == COUNTRIES.index("DE")
            cnt = np.bincount(lat[m])
            for v in np.nonzero(cnt)[0].tolist():
                add(v, int(cnt[v]))
        elif qid == "U7":
            m = np.isin(lat, [40, 41, 42]) | _has_tag(f, [tag["tag3"]])
            add((), int(m.sum()), int(f["num_items"][m].sum()))
        else:
            raise KeyError(qid)
    rows = [([] if k == () else [k]) + [_final(v) for v in vals]
            for k, vals in parts.items()]
    if qid == "U6":
        return sorted(rows, key=lambda r: (-r[1], r[0]))[:10]
    return sorted(rows)


def _merge(a, b):
    if isinstance(a, tuple):
        if a[0] == "avg":
            return ("avg", a[1] + b[1], a[2] + b[2])
        return (a[0], (min if a[0] == "min" else max)(a[1], b[1]))
    return a + b


def _final(v):
    if isinstance(v, tuple):
        return v[1] / v[2] if v[0] == "avg" else v[1]
    return v


def check_rows(qid: str, rows: List[List], want: List[List]) -> None:
    """Raise unless a result's rows equal ``numpy_answer``'s: keys, counts,
    sums, min and max exact, averages within rel 1e-12 (an exact integer
    sum over a count, in f64)."""
    got = [list(r) for r in rows]
    if qid not in _ORDERED:
        got = sorted(got)
    if len(got) != len(want):
        raise AssertionError(f"{qid}: {len(got)} rows, oracle {len(want)}")
    for g, w in zip(got, want):
        ok = len(g) == len(w) and all(
            (abs(a - b) <= 1e-12 * abs(b) if isinstance(b, float)
             else a == b) for a, b in zip(g, w))
        if not ok:
            raise AssertionError(f"{qid}: row {g} != oracle {w}")


# -- the index rung -------------------------------------------------------------

def absent_user(frames: List[Dict[str, object]]) -> int:
    """The smallest user_id in [1, NUM_USERS] no row holds: inside every
    segment's min/max, so no segment prunes, and matched by no doc."""
    seen = np.zeros(NUM_USERS + 2, dtype=bool)
    for f in frames:
        seen[f["user_id"]] = True
    return int(np.nonzero(~seen[1:NUM_USERS + 1])[0][0]) + 1


def index_queries(users: List[int], absent: int) -> Dict[str, str]:
    """I1-I5 on the indexed table: ``users[0]`` is the point-filter user
    (I1 is U1's shape), ``users[:5]`` the IN list, ``absent`` a user no row
    holds."""
    user = users[0]
    listed = ", ".join(str(u) for u in users[:5])
    return {
        "I1": queries(user)["U1"],
        "I2": f"SELECT count(*), sum(revenue) FROM user_events "
              f"WHERE user_id IN ({listed}) AND country = 'US'",
        "I3": "SELECT country, count(*), sum(revenue) FROM user_events "
              "WHERE latency_ms BETWEEN 300 AND 320 GROUP BY country",
        "I4": f"SELECT count(*) FROM user_events "
              f"WHERE tags = 'tag3' AND user_id = {user}",
        "I5": f"SELECT count(*), sum(revenue) FROM user_events "
              f"WHERE user_id = {absent}",
    }


def index_answer(frames: List[Dict[str, object]], qid: str,
                 users: List[int], absent: int) -> List[List]:
    """Rows of ``index_queries(users, absent)[qid]`` over the frames, with
    numpy alone (``check_rows`` compares them)."""
    if qid == "I1":
        return numpy_answer(frames, "U1", users[0])
    tag3 = TAGS.index("tag3")
    us = COUNTRIES.index("US")
    parts: Dict[object, List[int]] = {}
    for f in frames:
        uid, rev, lat = f["user_id"], f["revenue"], f["latency_ms"]
        if qid == "I3":
            m = (lat >= 300) & (lat <= 320)
            for k, r in _group_rows(f["country"][m], COUNTRIES,
                                    {"rev": rev[m]}).items():
                got = parts.setdefault(k, [0, 0])
                got[0] += r["count"]
                got[1] += int(r["rev"].sum())
            continue
        if qid == "I2":
            m = np.isin(uid, users[:5]) & (f["country"] == us)
        elif qid == "I4":
            m = (uid == users[0]) & _has_tag(f, [tag3])
        elif qid == "I5":
            m = uid == absent
        else:
            raise KeyError(qid)
        got = parts.setdefault((), [0, 0])
        got[0] += int(m.sum())
        got[1] += int(rev[m].sum())
    if qid == "I4":
        return [[parts[()][0]]]
    return sorted(([] if k == () else [k]) + v for k, v in parts.items())


# -- the host engine and the device top-k --------------------------------------

def host_queries(user: int) -> Dict[str, str]:
    """U8 an ordered ``SELECT *`` of one tail user by the raw latency_ms
    (the device top-k), U9 a group-by on a virtual column and U10 grouped
    MV aggregations (the host engine)."""
    return {
        "U8": f"SELECT * FROM user_events WHERE user_id = {user} "
              "ORDER BY latency_ms DESC LIMIT 10",
        "U9": "SELECT $segmentName, count(*) FROM user_events "
              "GROUP BY $segmentName ORDER BY $segmentName LIMIT 100",
        "U10": "SELECT country, distinctcountmv(tags), countmv(tags) "
               "FROM user_events GROUP BY country ORDER BY country "
               "LIMIT 100",
    }


def host_answers(frames: List[Dict[str, object]], user: int,
                 names: List[str]) -> Dict[str, List[List]]:
    """Rows of ``host_queries(user)`` over the frames of the segments
    ``names``, in the SQL's order: U8's ties in latency_ms in segment and
    doc order."""
    cand = []
    for si, f in enumerate(frames):
        for d in np.nonzero(f["user_id"] == user)[0].tolist():
            cand.append((-int(f["latency_ms"][d]), si, d))
    u8 = []
    for _, si, d in sorted(cand)[:10]:
        f = frames[si]
        codes, counts = f["tags"]
        row = []
        for fs in user_schema().field_specs:
            if fs.name == "tags":
                row.append([TAGS[c] for c in codes[d, :counts[d]].tolist()])
            elif fs.name in POOLS:
                row.append(POOLS[fs.name][int(f[fs.name][d])])
            else:
                row.append(int(f[fs.name][d]))
        u8.append(row)
    tags: Dict[str, set] = {}
    entries: Dict[str, int] = {}
    for f in frames:
        codes, counts = f["tags"]
        present = np.arange(codes.shape[1])[None, :] < counts[:, None]
        for k in np.unique(f["country"]).tolist():
            sel = f["country"] == k
            c = COUNTRIES[k]
            tags.setdefault(c, set()).update(
                codes[sel][present[sel]].tolist())
            entries[c] = entries.get(c, 0) + int(counts[sel].sum())
    return {
        "U8": u8,
        "U9": sorted([n, len(f["user_id"])] for n, f in zip(names, frames)),
        "U10": [[c, len(tags[c]), entries[c]] for c in sorted(tags)],
    }


# -- the realtime table ---------------------------------------------------------

def realtime_table_config(topic: str, flush_rows: int,
                          indexing: Optional[IndexingConfig] = None,
                          upsert: bool = False) -> TableConfig:
    """The table consumed from the in-memory stream ``topic``: one
    partition, JSON messages, a segment committed at ``flush_rows`` rows,
    the table's indexes (``user_indexing_config``) by default. ``upsert``:
    FULL upsert with no comparison column, so each key's latest arrival
    wins (the schema names the key: ``user_schema(["user_id"])``)."""
    return TableConfig(
        "user_events", TableType.REALTIME,
        indexing_config=indexing or user_indexing_config(),
        upsert_config=UpsertConfig(UpsertMode.FULL) if upsert else None,
        stream_config=StreamIngestionConfig(
            stream_type="memory", topic=topic,
            segment_flush_threshold_rows=flush_rows))


def frame_rows(frame: Dict[str, object], start: int = 0,
               stop: Optional[int] = None) -> List[Dict[str, object]]:
    """Rows ``[start, stop)`` of a frame as the row dicts a stream carries:
    strings for the coded dimensions, a list of tags."""
    n = len(frame["user_id"])
    stop = n if stop is None else min(stop, n)
    codes, counts = frame["tags"]
    cols = {name: (np.asarray(POOLS[name], dtype=object)[
                frame[name][start:stop]].tolist() if name in POOLS
                   else np.asarray(frame[name][start:stop]).tolist())
            for name in ("user_id", "country", "device", "event_type",
                         "latency_ms", "revenue", "num_items")}
    tag_names = np.asarray(TAGS, dtype=object)
    tags = [tag_names[c[:k]].tolist() for c, k in
            zip(codes[start:stop], counts[start:stop].tolist())]
    names = list(cols)
    return [dict(zip(names, vals), tags=t)
            for vals, t in zip(zip(*cols.values()), tags)]


def frame_messages(frame: Dict[str, object], start: int = 0,
                   stop: Optional[int] = None) -> List[str]:
    """``frame_rows(frame, start, stop)`` as JSON text, one message a row
    (formatted from the pools' quoted strings, without a dict a row)."""
    n = len(frame["user_id"])
    stop = n if stop is None else min(stop, n)
    quoted = {name: [json.dumps(v) for v in pool]
              for name, pool in POOLS.items()}
    cols = [np.asarray(quoted[name], dtype=object)[
                frame[name][start:stop]].tolist() if name in POOLS
            else np.asarray(frame[name][start:stop]).tolist()
            for name in ("user_id", "country", "device", "event_type",
                         "latency_ms", "revenue", "num_items")]
    tags = quoted["tags"]
    codes, counts = frame["tags"]
    tag_lists = [", ".join(tags[c] for c in row[:k]) for row, k in
                 zip(codes[start:stop].tolist(), counts[start:stop].tolist())]
    return [f'{{"user_id": {u}, "country": {c}, "device": {d}, '
            f'"event_type": {e}, "latency_ms": {lat}, "revenue": {r}, '
            f'"num_items": {k}, "tags": [{t}]}}'
            for u, c, d, e, lat, r, k, t in zip(*cols, tag_lists)]


def frame_prefix(frame: Dict[str, object], n: int) -> Dict[str, object]:
    """The frame of the first ``n`` rows."""
    return {k: ((v[0][:n], v[1][:n]) if isinstance(v, tuple) else v[:n])
            for k, v in frame.items()}


def latest_per_user(frame: Dict[str, object]) -> Dict[str, object]:
    """The rows an upsert keyed on ``user_id`` keeps, the latest arrival of
    each user, in arrival order."""
    user = np.asarray(frame["user_id"])
    rev = user[::-1]
    _, first = np.unique(rev, return_index=True)
    keep = np.sort(user.shape[0] - 1 - first)
    return {k: ((v[0][keep], v[1][keep]) if isinstance(v, tuple)
                else np.asarray(v)[keep]) for k, v in frame.items()}


def realtime_queries(user: int) -> Dict[str, str]:
    """U1-U7, then R1 and R2 (shapes the default star-tree of a sealed
    segment fits: dimensions of bounded cardinality, COUNT and SUM) and
    R3, an HLL of users by country (the consuming rung declines it)."""
    out = dict(queries(user))
    out.update({
        "R1": "SELECT country, count(*), sum(revenue) FROM user_events "
              "WHERE event_type = 'purchase' GROUP BY country",
        "R2": "SELECT device, count(*), sum(latency_ms), sum(num_items) "
              "FROM user_events GROUP BY device",
        "R3": "SELECT country, distinctcounthll(user_id) FROM user_events "
              "GROUP BY country",
    })
    return out


def _hll_estimate(values: np.ndarray, log2m: int = 8) -> int:
    """DISTINCTCOUNTHLL of integer ``values``, written apart from
    ``utils/hll.py`` so the oracle does not check the engine against
    itself; the same sketch by definition: each value's splitmix64 hash,
    its top ``log2m`` bits pick a register, which keeps the largest rank
    (the position of the first set bit of the other bits); the estimate
    is alpha m^2 / sum 2^-register, by linear counting while it is at most
    2.5 m and a register is empty."""
    x = np.unique(values).astype(np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    width = 64 - log2m
    reg = (x >> np.uint64(width)).astype(np.int64)
    rest = x & np.uint64((1 << width) - 1)
    # bit length of ``rest`` from two halves that a float holds exactly
    half = width // 2
    hi = (rest >> np.uint64(half)).astype(np.float64)
    lo = (rest & np.uint64((1 << half) - 1)).astype(np.float64)
    bits = np.where(hi > 0, np.frexp(hi)[1] + half, np.frexp(lo)[1])
    rank = width - bits + 1
    m = 1 << log2m
    registers = np.zeros(m, dtype=np.int64)
    np.maximum.at(registers, reg, rank)
    est = 0.7213 / (1 + 1.079 / m) * m * m / np.exp2(-registers).sum()
    zeros = int((registers == 0).sum())
    if est <= 2.5 * m and zeros:
        est = m * np.log(m / zeros)
    return int(round(est))


def realtime_answers(frame: Dict[str, object], user: int
                     ) -> Dict[str, List[List]]:
    """``realtime_queries(user)``'s rows over one frame, with numpy (R3
    through ``_hll_estimate`` of each country's user ids)."""
    out = {qid: numpy_answer([frame], qid, user) for qid in queries(user)}
    purchase = frame["event_type"] == EVENT_TYPES.index("purchase")
    out["R1"] = [[k, r["count"], int(r["rev"].sum())] for k, r in sorted(
        _group_rows(frame["country"][purchase], COUNTRIES,
                    {"rev": frame["revenue"][purchase]}).items())]
    out["R2"] = [[k, r["count"], int(r["lat"].sum()), int(r["items"].sum())]
                 for k, r in sorted(_group_rows(
                     frame["device"], DEVICES,
                     {"lat": frame["latency_ms"],
                      "items": frame["num_items"]}).items())]
    out["R3"] = [[k, _hll_estimate(np.asarray(r["user"]))]
                 for k, r in sorted(_group_rows(
                     frame["country"], COUNTRIES,
                     {"user": frame["user_id"]}).items())]
    return out
