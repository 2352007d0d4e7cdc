"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--sf 5] [--segments 8] [--seed 42] [--reps 5]
                          [--user-segments 8] [--user-rows 2500000]
                          [--startree-sf 0.25] [--startree-only]
                          [--out-dir DIR]

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build the fused-scan CUDA kernels from pinot_tpu_torch/engine/csrc
     (ptxas registers, stack frame and spills logged; the query axis's
     fused_scan_many_kernel asserted at a 0-byte stack frame and 0
     spills);
  3. hold the kernel against its plain PyTorch version on the same card and
     inputs: every bit width, a remainder tile, iv/ivs/not/or filters, int
     and float expressions, an i64 column, raw (no-dictionary) INT, LONG
     past 2^31 and FLOAT value columns, a scan that reads no packed column,
     every aggregation, 128 and 8192
     groups (shared-memory and global accumulators), the probe mode, a
     group key that is also a filter column, a filter at the deepest stack
     the kernel takes, tiles where every doc passes and tiles where none
     does, 56 bits of filter columns; then the same cases as one launch
     over a batch of 3 segments of different sizes plus one padded segment
     with no docs; (3c) the query axis over that batch: each case's scan
     and probe program with literal variants of its layout, Q = 1, 3, 8
     and 9 (two blocks on grid y), against the plain version and one solo
     launch a program, every packed width, IVS and NOT, scalar, shared
     and device-memory accumulators, the probe and a raw i64 column
     covered;
  4. the per-segment path: SSB at ``--sf`` in ``--segments`` time-bounded
     segments, the 13 flights ``--reps`` times through
     ServerQueryExecutor(device="cuda"), which prunes the segments no doc
     of can match, every launch counted, every answer held against the
     numpy oracle; then the graft-entry SQL on a 5-column segment;
  5. at the per-segment path's shapes (each flight's scan and probe on the
     first segment the pruner keeps for it): the kernel held against its
     plain version again, then timings of both beside the bound;
  6. the batch path: the same segments and flights through
     ShardedQueryExecutor(device="cuda"): an untimed pass stages the batch
     of each flight's kept segments, then ``--reps`` timed passes over
     the 13 flights in turn and ``--reps`` timed runs of each flight back
     to back stage none (asserted); one launch per flight
     over its batch (per segment where one is kept), every launch counted,
     every answer held against the oracle; then at the shapes of those
     batches (every flight and probe over its kept segments) the kernel
     against its plain version and timings of both beside the bound (the
     kernel alone and through its wrapper), and Q4.3's combine over its
     3 kept segments beside all of them;
  7. the general rung (engine/kernels.py, PyTorch ops on the card): (a) the
     13 flights through ServerQueryExecutor(device="cuda",
     use_fused_scan=False), 0 fused launches and one general-rung call per
     kept segment, every answer equal to phase 4's and the oracle, p50
     beside phase 4's; (b) the declined queries G1-G5 (tools/ssb.py) with the
     fused scan on, each with its planned decline and rung (G1's matched
     segment on the hash rung, G2's on the sort rung), held against the
     oracle;
  8. the user-events table (tools/usertable.py: raw ``latency_ms``, MV
     ``tags``), ``--user-segments`` segments of ``--user-rows`` rows: U1-U7
     ``--reps`` times through ServerQueryExecutor(device="cuda"), each held
     against the numpy oracle over the generator's arrays with its decline
     code and rung per segment (U1 and U2 on the fused scan, U2's raw
     column as a value column; U3-U7 on the general rung); U1 and U2 again
     through ShardedQueryExecutor, one launch over the batch (U3-U7 over
     the batch in phase 11a); (8b) on a 1 M-doc segment, IS NULL / IS NOT
     NULL on a nullable dictionary and raw column, the MV aggregations and
     an upsert valid-doc mask against numpy;
  9. the SQL slice: (9a) on phase 4's segments, S1-S7 of tools/ssb.py
     (LIKE, NOT LIKE, REGEXP_LIKE of 1, 9-64 and over 64 dictId runs,
     HAVING with OFFSET and OPTION, a count/min/max the segment metadata
     answers) per segment and over the batch against the numpy oracle,
     with each decline, rung and launch count asserted from the segments
     the pruner keeps, and the new filter shapes' kernels against their
     plain version and timed at the paths' shapes; (9b) time-bucket
     group-bys (toEpochDays, toEpochHours, a ts window the pruner cuts to
     its segments, timeConvert) over ``--user-segments`` time-ordered
     segments of ``--user-rows`` events with a raw epoch-ms ``ts``, on the
     general rung, and T1 (a dateTrunc key spanning the milliseconds) on
     the host engine per segment and over the batch; (9c) TEXT_MATCH and
     JSON_MATCH on a 1 M-doc segment;
 10. the host engine and the device top-k (min(--reps, 3) runs of each
     query, against numpy): on phase 4's segments H1-H7 of tools/ssb.py
     (percentile and mode, a grouped t-digest, a grouped DISTINCTCOUNT,
     SELECT DISTINCT, an unordered selection with OFFSET, an ordered one
     on the top-k, one ordered by an expression), on phase 8's U8-U10 of
     tools/usertable.py (SELECT * of a tail user ordered by the raw
     latency_ms on the top-k, a group-by on $segmentName, grouped MV
     aggregations), each with its decisions and 0 fused or general-rung
     launches asserted; the top-k's rows equal the host engine's on the
     same segments, and it is timed beside its byte bound;
 11. (11a) the jnp combine: every query phases 7-9 saw the fused scan
     decline that keeps several segments (G1-G3 and G5, U3-U7, S4,
     T1b-T4) through ShardedQueryExecutor over the batch of its kept
     segments, one combine call and no fused launch a query, the decline
     recorded once, rows equal to the oracle and to the per-segment path's,
     timed beside the per-segment p50, one call's device time, CUDA
     kernels, device-to-host copies and byte bound; (11b) the index rung:
     phase 8's rows built again with the table's indexes, I1-I5 of
     tools/usertable.py (a tail user's point filter grouped by event_type,
     an IN of users with a country, a narrow latency_ms range, an MV tag
     with a user, an absent user) per segment and through the batch
     executor on the index rung of every kept segment, equal to the oracle
     and to the scan rungs (OPTION(useIndexRung=false)), timed, with one
     gather call's device time and CUDA kernels beside its byte bound;
 12. the star-tree: SSB at ``--startree-sf`` in ``--segments`` segments
     with tools/ssb.py ``ssb_indexing_config()``'s five trees (built in a
     process pool): (12a) the 13 flights per segment and through
     ShardedQueryExecutor, every kept segment on the star-tree device rung
     from the JAX executor's tree (``FLIGHT_TREE``), one node-slice call
     per kept segment where the oracle matches rows and no other launch,
     rows equal to the oracle and to the scan rungs
     (``OPTION(useStarTree=false)``), timed beside them, the node-slice
     call of the segment with the most records timed beside its byte
     bound with the walk's host ms; (12b) ST1 on the host walker (a group
     space past the device's; its walks' host ms), ST2-ST4 declined with
     the JAX package's codes, ST5 opted out, on the scan rungs, equal to
     the oracle; build seconds, records and node bytes per tree.
     ``--startree-only`` runs phases 1, 12 and 13c alone, and prints no
     kernels line;
 13. residency, sliced execution and launch coalescing: (13a, after phase
     11, on phase 4's segments) an HBM budget of about 40% of the largest
     working set admission estimates (at least 1.25x the largest kept
     segment), the 13 flights ``--reps`` times through both executors:
     rows == oracle == phase 4's, each query sliced exactly when its
     working set is over the budget, none spilled, the staged bytes within
     the budget after each query, every segment back on the card after
     the first pass back by promotion; slices, demotions and promotions
     per flight, p50 beside the unbudgeted p50, the demote and promote
     GB/s, max_memory_allocated; then Q1.2 under a budget of half a
     segment on the host engine (single_segment_over_budget), == oracle;
     (13b) 8 client threads on one ShardedQueryExecutor: C1-C8 (Q2.1 with
     other literals), Q2.1 as written, then P1-P8 (Q3.2 for other
     nations, their probes at binding), each answer == its solo answer ==
     oracle, coalesced and saved launches asserted, QPS at 1 and 8
     threads, batch sizes, queue wait p50 / p99; the query-axis kernel
     (scan and probe) at the shapes that launched against its plain
     version and Q solo launches of the one-query kernel, timed beside
     them and beside its byte bound, and at the first 1, 2 and 4 of the
     programs; (13c, after
     phase 12) phase 12's trees under 1.5x one segment's largest tree:
     node arrays demoted and promoted across two passes of the 13
     flights, == oracle, then 8 concurrent identical queries
     (``execute_instance``, which no query flight fronts) sharing their
     node-slice launches;
 15. (after 13a-b, before 14) scatter/gather on one card: 4 in-process
     servers (ShardedQueryExecutor, 2 of the segments each) answer with
     ``execute_instance``'s DataTable and BrokerReduceService merges them:
     (15a) phase 4's 13 flights reduced in process with the device merge
     (reducePath "device" on every group-by flight) and through
     to_bytes / from_bytes (declined as reduce_device_cross_process, the
     vectorized path serving), both == phase 4's rows == oracle, the dense
     rung's merge timed beside the host merge and its byte bound; (15b)
     4 of phase 8's user-events segments, one a server, grouped by user,
     country and event type (hundreds of thousands of groups a server, served by each server's
     host engine; a composite space past the dense slots): the
     sort rung == the vectorized merge bit for bit == oracle, timed
     likewise; (15c) 8
     client threads against an admission gate of 2 slots and 2 waiters:
     typed QueryRejectedErrors counted, admitted answers == phase 4's;
     (15d) 8 threads sending one compiled query share runs; (15e) the
     flights per segment at worker.threads 1 and 8, p50s, equal rows;
     (15f) a one-segment query after a batch query borrows the batch's
     columns, stagedBytes with and without the borrow, equal rows;
 16. (after 15, before 14) the front door: an EmbeddedCluster
     (pinot_tpu_torch/tools/cluster.py: the controller, 4 servers with
     their SEWF schedulers and a residency budget of 0.75 of the card
     over 4 each, routing, the broker request handler with the device
     merge) over phase 4's segments pushed through memory:// at
     replication 2, push to queryable and each server's stagedBytes
     logged: (16a) the 13 flights through cluster.query ``--reps``
     times, clean and full, == phase 4's rows == oracle, reducePath
     device on every group-by, the fused-scan launches of phase 4's kept
     segments; p50 / p99 beside phase 4's, the broker phases' p50, the
     servers asked (1 for the time-pruned Q1.2 and Q3.4); (16c) C1-C8
     from 1 and 8 client threads at 8 and at 1 SEWF runner threads (QPS,
     p50, p99), then 8 threads sending Q2.1 coalesced by the broker's
     single flight; (16d) 20 queries at a 5-a-second quota, the 429s
     counted; (16e) the IN_SUBQUERY semijoin == numpy with the JAX
     cluster's decisions, EXPLAIN PLAN FOR Q2.1 with no launch; (16b,
     last) one server stopped, every flight answered in full by the
     replicas;
 17. (after 16, before 14) realtime and hybrid tables through the front
     door: phase 16's cluster again (4 servers, its residency budget, the
     device merge, phase 4's segments as ssb_lineorder_OFFLINE at
     replication 2), each server negotiating its commits with the
     controller's completion FSM, cluster.query the only entry point and
     every answer clean and full: (17a) the user-events table at its full
     width as a realtime table, JSON messages of 250 k rows on 2
     partitions consumed at replication 2 with a flush at 50 k rows (2
     seals and 25 k rows consuming a partition), U1-U7 and R1-R3 == the oracle, R1
     and R2 on the sealed segments' star-tree, the group-bys on
     mutable_device over the consuming segments, U2 opted out of the
     star-tree on the fused scan over the sealed ones; the ingest rate a
     consumer, flush threshold to swap, COMMIT / KEEP / DISCARD, swap ms
     and deep-store entries logged; (17b) 25 k more rows a partition seal
     each partition's third segment while 4 client threads send count(*)
     and U2: every count in [0.25 M, 0.3 M], no partial answer, both ==
     the oracle after, no sealed segment's mutable resident left on the
     card; (17c) the hybrid SSB table: ssb_lineorder_REALTIME carries 75
     k rows of a fresh frame over segment 7's months (1 partition,
     replication 2, flush 50 k), the time boundary the offline side's
     largest month less 1, the 13 flights == the oracle over the offline
     rows up to it and the realtime rows past it, every one
     hybrid_time_split, the fused launches of phase 4's kept segments and
     of the sealed realtime segment, p50 / p99 beside phase 16's; (17d)
     user_events again as an upsert table on user_id (110 k rows, flush
     25 k, 1 partition, replication 2): U1-U7 == the oracle over each
     user's latest row; then one sealed realtime segment's U2 scan against
     the kernel's plain version and timed; every query's launches read
     from its own stats;
 18. (after 17, on its cluster) tracing and telemetry through the front
     door: (18a) the 13 flights with OPTION(trace=true) ``--reps`` times
     == phase 4's rows, each response one broker root (Compile, Routing,
     ScatterGather, Reduce), every server's tree under ScatterGather
     tagged with its instance, every span closed, the fused-scan Kernel
     spans one a kept segment, their launches == the servers' per-query
     scanLaunches + probeLaunches == phase 16a's for the flight; an
     untraced run carries no traceInfo; per flight each span name's p50,
     the first pass's tree and the slowest later one's logged; (18b)
     C1-C8 traced from 8
     client threads, each query's launch counts == its solo counts;
     (18c) the broker's telemetry / SLO / freshness / flight-recorder
     snapshots and each server's debug views as JSON, the broker and
     server_exec histograms' counts == the queries sent, phase 17's
     realtime tables in the freshness view, the decision ledger's delta
     == the sum of the responses' decisions; the cluster's shutdown
     leaves no sampler thread and no recorder file;
 19. (after 18, before 14) phase 4's segments on disk: (19a) written by
     ``write_segment`` in the JAX package's layout, every CRC verified,
     loaded by ``load_segment``, the 13 flights per segment and over the
     batch with rows identical to phase 4's and launches equal to phases
     4 and 6's counts (bytes written, write, verify and load s, the first
     query's ms staging from the maps, p50 beside phase 4's); (19b)
     pushed by ``file://`` to an ``EmbeddedCluster(data_dir=...)`` of 4
     servers at replication 2: the flights == 19a's rows, ``table_size``
     == the bytes on disk; (19c) ``update_table`` adds inverted indexes
     and bloom filters and ``reload_table`` swaps every replica's
     segments (flags, CRC, Q2.1 and Q3.1 leaving ``index_missing_index``,
     rows unchanged), and phase 12's segments with their star-trees are
     written and loaded and serve the flights on the star-tree rung with
     0 fused launches; (19d) an upsert user-events table, 100 k rows
     flushed every 50 k at replication 2, every seal a directory, one
     replica of each told DISCARD and serving the committer's directory,
     U1-U7 == the oracle over each user's latest row;
 20. (after 19, before 14) the segment lifecycle: an
     EmbeddedCluster(data_dir=...) of 4 servers (phase 16's residency
     budget) at replication 2 with one minion, every answer through
     cluster.query == the numpy oracle over the rows the table holds at
     that step: (20a) 8 time-ordered segments of 1 M events (a DATE_TIME
     ts in epoch ms) merged by MergeRollup (CONCAT, 7-day buckets) behind
     segment lineage while 4 client threads send count / sum and sum by
     country, every answer == the oracle across the swaps (tasks, s a
     task, segments before and after, lineage entries, p50 before and
     after, fused launches on the merged segments > 0); (20b) 4
     overlapping segments of 1 M hour-granular rows rolled up (SUM):
     count(*) == the distinct keys, sum by country and day == the oracle;
     (20c) a hybrid table, 200 k JSON rows on 2 partitions (flush 50 k),
     RealtimeToOffline until the watermark passes the last committed
     window: the hybrid answers == the oracle before and after, the time
     boundary advances, the offline side on the fused scan; (20d) Purge
     of one country from one segment, ConvertToRaw of revenue on another
     (a refresh push under its name: every replica serves it with revenue
     a raw value column); (20e) retention expires the oldest segment, a
     fifth server tagged cold takes the aged segments, a sixth joins and
     rebalance_table spreads them make-before-break (stagedBytes per
     server after each step); (20f) 100 k WKT points over one city (H3,
     resolution 9): 5 ST_DISTANCE counts, 100 m to 5 km, with and without
     the geo index == a haversine oracle, on the host engine with 0 fused
     launches;
 21. (after 20, before 14) the wire on phase 4's segments written to
     disk: (21a) ``serve_cluster`` over an EmbeddedCluster of 4 servers
     (phase 16's budget) at replication 2, the schema, table and segments
     pushed through the controller's REST routes (``POST /segments``),
     the 13 flights through ``client.connect([broker]).execute(sql)`` ==
     the oracle, p50 beside phase 16's in-process ``cluster.query`` p50,
     QPS and p50 from 1 and 8 client threads; (21b) every broker and
     server ``/debug/*`` route answers 200 with JSON, the servers'
     ``/debug/launches`` sum the responses' launch counts (> 0 fused
     launches), ``/debug/memory`` stagedBytes == the residency
     manager's, ``/debug/pallas`` the preflight's verdicts (all 13
     flights pass); (21c) the preflight against the kernel: every
     fuzz-grid shape it passes compiles, launches and equals its plain
     version, every shape past a limit is declined by
     ``compile_program`` with its rule's code, and a blocklist file of
     the 13 flights' plans (each under one of the rules' codes) read by
     a new executor declines them with their codes while the general
     rung answers == the oracle; (21d) 2 servers in processes
     of their own (``python -m pinot_tpu_torch StartServer``, a
     residency budget of 0.75 of the card over 2 each) on replicas of the
     parent's state service, fetching their segments by ``file://``,
     reached by the parent's broker through gRPC: the 13 flights ==
     the oracle, p50 and QPS from 1 and 8 clients beside 21a's, each
     server's ``/tables/{t}/size`` and ``/debug/memory`` == the
     IdealState, then one server process killed: an answer with
     exceptions and the live server's rows;
 22. (after 21, before 14) batch and stream ingestion at SSB lineorder's
     full width (``phase_ingest``): (22a) SSB at SF0.25 in 8 parts
     written as CSV landing files by a spawned pool (setup), a YAML job
     spec at segmentCreationJobParallelism 8 through
     ``run_ingestion_job(..., cluster=)`` into an EmbeddedCluster on disk
     of 2 servers: every segment directory == the frame-built one file
     for file (times aside), the 13 flights == the oracle on the fused
     scan and the probe, no host-engine decision; the job at parallelism
     1 over one file and 8 timed, push to queryable, p50 beside phase
     16's; (22b) SegmentGenerationAndPush under a minion: 250 k rows as
     CSV and 250 k as JSON lines, then 100 k as Avro (the second task
     reads only that file), count and sum == the oracle after each, the
     store's processed set, ``GET /tasks/tasktypes``; (22c) 22a's
     segments put into an in-process MockS3Server by S3PinotFS and pushed
     as ``s3://`` to a second table, each server copying them into its
     segment directory: the flights == 22a's rows; one segment encrypted
     in a ``file://`` store fetched with a KeyedStreamCrypter: the local
     copy == the original, the store still encrypted, Q1.1 and Q3.2 on it
     == the oracle; (22d) a realtime user-events table fed over TCP by a
     KafkaBrokerSim of 2 partitions (100 k rows, flush 25 k), then by a
     StreamBrokerServer (50 k rows, flush 12.5 k): count and a group-by
     on event_type == numpy before the seals (the consuming rung) and
     after (the fused scan on every seal), rows/s a consumer and a seal's
     threshold to swap;
 23. (after 6) the combine mesh (``parallel/mesh.py``) on phase 6's
     segments, cells ``cuda:i % cards``: 1x1 (phase 6's executor), 8x1,
     4x2 and 2x2 ShardedQueryExecutor(mesh=...) (23a) the untimed passes
     of the three meshes at once, then ``--reps`` timed passes over the 13
     flights on each: every answer == the 1x1's (f64 sums within rel
     1e-9) == the oracle, one launch a cell a batch flight; Q2.1's scan
     and Q4.3's scan and probe over each mesh held to the plain version
     over the same cells, each cell's kernel timed alone and the fold on
     the root timed (a line a shape: pass p50, launches, per-cell kernel
     ms, fold ms); (23b) on 4x2 C1-C8 from 8 client threads (the query
     axis a cell, held to its plain version) and Q2.1 under 40% of its
     working set (sliced); (23c) the broker's merge over 4 cells, dense
     at 3 000 slots, the slice exchange at 300 000, the sort rung, each
     == the one-cell merge == numpy; its launches added to the kernels
     line;
 14. (after 22) a realtime user-events table: 500 k rows
     as JSON messages on a one-partition MemoryStream consumed by
     RealtimeSegmentDataManager into a consuming segment on the card
     (``engine/mutable_staging.py``): (14a) at 700, 1000 and 5000 rows and
     at 500 k, U1-U7 and R1-R3 of tools/usertable.py
     ``realtime_queries`` == the numpy oracle over the rows indexed so
     far, on ``mutable_device`` (U1 / U3 on its index gather, R3's HLL
     declined to the host engine), the bytes uploaded between two
     watermarks == the new rows' bytes, p50 / p99 and the ingest rate,
     one refresh timed under a query's live snapshot (copied on the
     device) and with none (in place); then 30 count queries under a writer that consumes the last 2% and
     commits (never backwards, no device copy, ingest-to-queryable
     latency); (14b) an
     upsert segment keyed on user_id == the oracle over each user's latest
     row, also after an invalidation at an unchanged watermark; (14c) the
     sealed segment (the default star-tree, the stream offsets): R1, R2 on
     the star-tree rung, U2, R1, R2 with OPTION(useStarTree=false) on the
     fused-scan kernel, every answer == the consuming segment's, the
     kernel against its plain version and timed at its shapes, its
     launches added to the kernels line.
 24. (last, after 12) the SSB tools: (24a) SSB at SF0.1 in 7 segments of
     one ``d_year`` each (``tools/ssb.py`` ``build_segments(...,
     out_dir=, partitioned=True)``: 17 columns, Modulo partition metadata
     on ``d_year``), written by a spawned pool and loaded back, pushed by
     ``file://`` to an ``EmbeddedCluster(data_dir=...)`` of 2 servers with
     the broker's partition pruner on: the 13 flights ``--reps`` times,
     each == ``tools/ssb_baseline.py`` (numpy alone) over the generator's
     frames, Q1.1 (``d_year = 1993``) on the one segment its partition
     keeps, the segments each flight kept and its p50 logged; (24b)
     ``tools/microbench.py``'s seven entries on the card, one line each;
     its launches added to the kernels line.
The tables of phases 4-11 carry no star-tree and those of phases 4-10 no
index: on them the index rung declines each filtered aggregation's
segments on the per-segment path (``index_missing_index`` and the other
JAX codes), which every phase asserts beside its other decisions.
Then a "rungs" line of the segments each rung served and the declines and
paths of phases 8-11, and one JSON line listing the kernels ("ms" is the
kernel alone, "launches" those of phases 4, 6, 8, 9, 14c, 16-21a, 22,
23, and of 13b and 23b for the query axis; the top-k, the jnp combine and the index gather are
PyTorch ops, not hand kernels).
Phases 4, 6, 7, 9, 10 and 11 assert launches
per query from the segments the pruner keeps, once those
equal the segments whose min/max (from the generator's arrays) admit the
query's conditions.
The last line is {"ok": true, "device": {...}}; any failure raises and
exits non-zero without it. Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM HBM3 rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 3: kernel against plain version -----------------------------------

def _synthetic_segment(n: int, seed: int, i: int = 0):
    """Columns with one of each packed width (1, 2, 4, 8, 16, 32 bits),
    int/float/i64 values, doc-correlated columns for the probe, and raw
    (no-dictionary) INT, LONG past 2^31 and FLOAT value columns."""
    from pinot_tpu_torch.segment import ColumnArrays, segment_from_arrays
    from pinot_tpu_torch.spi import DataType, FieldType

    rng = np.random.default_rng(seed)
    D, M = FieldType.DIMENSION, FieldType.METRIC

    def col(dt, ft, values):
        uniq, ids = np.unique(values, return_inverse=True)
        return ColumnArrays(dt, ft, uniq, ids.reshape(-1))

    doc = np.arange(n)
    return segment_from_arrays(f"synthetic_{i}", n, {
        "b1": col(DataType.INT, D, rng.integers(0, 2, n)),
        "b2": col(DataType.INT, D, rng.integers(0, 3, n)),
        "b4": col(DataType.STRING, D,
                  np.array([f"k{i:02d}" for i in range(11)])[
                      rng.integers(0, 11, n)]),
        "b8": col(DataType.INT, D, rng.integers(0, 200, n)),
        "b16": col(DataType.INT, D, doc // 41),
        "b32": col(DataType.INT, D, doc // 3),
        "qty": col(DataType.INT, M, rng.integers(-500, 1000, n)),
        "price": col(DataType.DOUBLE, M,
                     np.round(rng.normal(80.0, 30.0, n), 2)),
        "big": col(DataType.LONG, M,
                   rng.integers(0, 1 << 40, n) - (1 << 39)),
        "rint": ColumnArrays(DataType.INT, M,
                             values=rng.integers(-5000, 9000, n)),
        "rlong": ColumnArrays(DataType.LONG, M,
                              values=rng.integers(0, 1 << 36, n) + (1 << 33)),
        "rfloat": ColumnArrays(DataType.FLOAT, M, values=np.round(
            rng.gamma(2.0, 40.0, n), 3).astype(np.float32)),
    }, table_name="t")


def _deep_filter(depth: int) -> str:
    """A WHERE clause whose postfix filter program needs a stack of
    ``depth``: leaves nested right, AND and OR alternating (so nothing
    flattens)."""
    leaves = ["b1 = 1", "b2 != 2", "b8 < 150", "b4 != 'k03'", "b16 > 20",
              "b32 < 60000"]
    sql = leaves[(depth - 1) % len(leaves)]
    for d in range(depth - 2, -1, -1):
        sql = f"{leaves[d % len(leaves)]} {'AND' if d % 2 == 0 else 'OR'} " \
              f"({sql})"
    return sql


def _kernel_cases():
    from pinot_tpu_torch.engine.fused_scan import MAX_FILTER_STACK

    scattered = ", ".join(str(v) for v in range(100, 60000, 2500))
    return [
        ("scalar iv/not, every aggregation",
         "SELECT count(*), sum(qty), avg(price), min(price), max(qty), "
         "minmaxrange(qty) FROM t WHERE b1 = 1 AND b2 != 0"),
        ("or, int and float expressions, 128 groups",
         "SELECT b4, sum(qty * 3), sum(price * 2.5), sum(qty - 7), count(*) "
         "FROM t WHERE b8 BETWEEN 10 AND 150 OR b16 < 100 GROUP BY b4"),
        ("ivs (24 runs), i64 column",
         f"SELECT b8, sum(big), avg(big) FROM t WHERE b32 IN ({scattered}) "
         "GROUP BY b8"),
        ("8192 groups, 3 rows: accumulators in device memory (in shared "
         "memory they would leave one block per SM)",
         "SELECT b16, sum(qty), count(*), min(price) FROM t "
         "WHERE b32 > 1000 GROUP BY b16"),
        ("8192 groups, global accumulators",
         "SELECT b16, sum(qty), sum(price), sum(big), min(qty), max(price) "
         "FROM t WHERE NOT b2 IN (1) GROUP BY b16"),
        ("probe narrowing",
         "SELECT b16, b4, sum(qty), count(*) FROM t WHERE b32 < 2000 "
         "GROUP BY b16, b4"),
        ("group key that is also a filter column",
         "SELECT b8, sum(qty), max(price), count(*) FROM t "
         "WHERE b8 < 120 AND b2 = 1 GROUP BY b8"),
        (f"filter stack {MAX_FILTER_STACK} deep",
         f"SELECT b4, sum(qty), count(*) FROM t "
         f"WHERE {_deep_filter(MAX_FILTER_STACK)} GROUP BY b4"),
        ("tiles where every doc passes, tiles where none does",
         "SELECT b4, sum(qty), sum(price), min(qty), count(*) FROM t "
         "WHERE b32 < 4096 GROUP BY b4"),
        ("8192 groups, three filter columns of 56 bits in all",
         "SELECT b16, sum(qty), sum(price) FROM t "
         "WHERE b32 > 100 AND b16 < 7000 AND b8 < 190 GROUP BY b16"),
        ("raw INT, raw LONG past 2^31 and raw FLOAT value columns",
         "SELECT b4, sum(rint), min(rint), max(rfloat), sum(rlong), "
         "avg(rfloat), count(*) FROM t WHERE b8 < 100 OR b2 = 1 "
         "GROUP BY b4"),
        ("raw value columns and no packed column",
         "SELECT sum(rint), sum(rlong), sum(rfloat), min(rfloat), "
         "max(rint), count(*) FROM t"),
    ]


def _scan_args(staged, sql) -> dict:
    """{kernel name: (launch, inputs)} of ``sql`` over a staged segment or a
    staged batch, built by the executors' own ``scan_inputs``, which picks
    the wrappers (and so the counters) for the staged type: ``launch()``
    runs the wrapper, ``inputs`` are the plain version's (program, packed
    words, values, num_docs, tiles). The probe entry is there when the
    query probes first (the probe launches once here)."""
    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.engine.plan import plan_segment
    from pinot_tpu_torch.query import compile_query

    if " LIMIT " not in sql:
        sql += " LIMIT 100000"
    plan = plan_segment(compile_query(sql), staged.provider)
    reasons = []
    inp = fs.scan_inputs(plan, staged, on_decline=reasons.append)
    if inp is None:
        raise AssertionError(f"{sql}: declined {reasons}")
    k = inp.kernels
    args = {k.scan_counter.name: (
        inp.scan, (inp.prog, inp.words, inp.values, inp.num_docs,
                   inp.tiles))}
    if inp.probe is not None:
        prog, words = inp.probe
        args[k.probe_counter.name] = (
            lambda: k.probe(prog, words, inp.num_docs),
            (prog, words, [], inp.num_docs, inp.tiles))
    return args


def _acc_path(prog) -> str:
    """Where a program's accumulators live: a scalar scan's per-thread
    rows, a grouped scan's shared-memory or device-memory accumulators."""
    from pinot_tpu_torch.engine import fused_scan as fs

    return ("scalar" if prog.scalar else
            "shared" if fs.scan_layout(prog).acc_smem else "global")


def _check_paths(seen: set, depths: set, tiles: set, what: str) -> None:
    from pinot_tpu_torch.engine.fused_scan import MAX_FILTER_STACK

    want = {"scalar", "shared", "global"}
    if not want <= seen:
        raise AssertionError(f"{what}: cases missed kernel paths "
                             f"{sorted(want - seen)}")
    if MAX_FILTER_STACK not in depths:
        raise AssertionError(f"{what}: no filter {MAX_FILTER_STACK} deep")
    if not {"all", "none"} <= tiles:
        raise AssertionError(f"{what}: no full tile where every doc passes "
                             f"and one where none does: {sorted(tiles)}")


def _tile_kinds(prog, words, values, num_docs, tiles) -> set:
    """'all' if a full tile has every doc passing, 'none' if a full tile
    has none passing."""
    from pinot_tpu_torch.engine import fused_scan as fs

    valid, matched = fs.doc_masks(prog, words, num_docs, values, tiles)
    full = valid.view(-1, fs.TILE).all(dim=1)
    per_tile = matched.view(-1, fs.TILE).sum(dim=1)
    kinds = set()
    if bool((full & (per_tile == fs.TILE)).any()):
        kinds.add("all")
    if bool((full & (per_tile == 0)).any()):
        kinds.add("none")
    return kinds


def _kernel_vs_plain(args: dict, what: str, errs: dict) -> dict:
    """Run each program once through its kernel's wrapper and once through
    the plain version; fold the largest float difference into ``errs``.
    -> {kernel name: the kernel's outputs}."""
    from pinot_tpu_torch.engine import fused_scan as fs

    outs = {}
    for kind, (launch, a) in args.items():
        outs[kind] = launch()
        plain = fs.fused_scan_plain(*a)
        errs[kind] = max(errs[kind], _compare(outs[kind], plain,
                                              f"{what} ({kind})"))
    return outs


def _compare(kern, plain, what: str) -> float:
    """Exact for counts, int sums and min/max; floats within rel 1e-9 (both
    sides sum in f64, only the order of the atomics differs)."""
    import torch

    for name in ("cnt", "isum", "matched", "mm"):
        a, b = getattr(kern, name), getattr(plain, name)
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs\n{a}\n{b}")
    err = 0.0
    if plain.fsum.numel():
        diff = (kern.fsum - plain.fsum).abs()
        tol = 1e-9 * plain.fsum.abs() + 1e-9
        if bool((diff > tol).any()):
            raise AssertionError(f"{what}: fsum beyond rel 1e-9, max diff "
                                 f"{float(diff.max())}")
        err = float(diff.max())
    return err


# docs of the phase-3 batch's segments: different sizes, each ending in a
# remainder tile
BATCH_DOCS = (200_123, 150_001, 90_917)


def phase_kernels(n: int = 200_123, seed: int = 7) -> dict:
    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.engine.staging import StagedSegment

    seg = _synthetic_segment(n, seed)
    staged = StagedSegment(seg, device="cuda")
    bits_seen = set()
    errs = {"fused_scan": 0.0, "fused_scan_probe": 0.0}
    probed = False
    paths, depths, tiles = set(), set(), set()
    raw_values = set()
    for what, sql in _kernel_cases():
        args = _scan_args(staged, sql)
        prog = args["fused_scan"][1][0]
        bits_seen.update(prog.bits)
        probed |= "fused_scan_probe" in args
        paths.add(_acc_path(prog))
        depths.add(prog.filter_depth)
        tiles |= _tile_kinds(*args["fused_scan"][1])
        raw_values |= _raw_values(staged, sql)
        _kernel_vs_plain(args, what, errs)
        log(f"  kernel == plain: {what} (G={prog.G}, bits={prog.bits}, "
            f"{_acc_path(prog)} accumulators, filter depth "
            f"{prog.filter_depth})")
    _check_paths(paths, depths, tiles, "segment")
    if raw_values != {"rint", "rlong", "rfloat"}:
        raise AssertionError(f"raw value columns covered: {raw_values}")
    missing = {1, 2, 4, 8, 16, 32} - bits_seen
    if missing:
        raise AssertionError(f"bit widths not covered: {sorted(missing)}")
    if not probed:
        raise AssertionError("no case ran the probe mode")
    if seg.num_docs % fs.TILE == 0:
        raise AssertionError("the synthetic segment must end in a "
                             "remainder tile")
    staged = _synthetic_batch(seed, "cuda")
    errs.update(phase_batch_kernels(staged))
    log("phase 3c: the query axis over phase 3's batch")
    errs.update(phase_query_axis_kernels(staged))
    return errs


def _synthetic_batch(seed: int, device: str):
    """Phase 3's batch: 3 synthetic segments of BATCH_DOCS docs with their
    own dictionaries (unified by the batch), staged with one padded
    segment with no docs."""
    from pinot_tpu_torch.engine.staging import TILE
    from pinot_tpu_torch.parallel.batch import SegmentBatch, StagedBatch

    segs = [_synthetic_segment(n, seed + i, i)
            for i, n in enumerate(BATCH_DOCS)]
    if any(n % TILE == 0 for n in BATCH_DOCS):
        raise AssertionError("every batch segment must end in a remainder "
                             "tile")
    return StagedBatch(SegmentBatch(segs), device=device,
                       num_segs=len(segs) + 1)


def phase_batch_kernels(staged) -> dict:
    """The phase-3 cases as one launch over the batch ``staged``
    (``_synthetic_batch``), whose padded segment's matched count must
    stay 0."""
    from pinot_tpu_torch.engine import fused_scan as fs

    segs = staged.batch.segments
    errs = {"sharded_fused_scan": 0.0, "sharded_fused_scan_probe": 0.0}
    paths, depths, tiles = set(), set(), set()
    probed = False
    raw_values = set()
    for what, sql in _kernel_cases():
        args = _scan_args(staged, sql)
        prog = args["sharded_fused_scan"][1][0]
        probed |= "sharded_fused_scan_probe" in args
        paths.add(_acc_path(prog))
        depths.add(prog.filter_depth)
        tiles |= _tile_kinds(*args["sharded_fused_scan"][1])
        raw_values |= _raw_values(staged, sql)
        outs = _kernel_vs_plain(args, f"batch: {what}", errs)
        matched = outs["sharded_fused_scan"].to_host().matched
        if int(matched[-1]) != 0:
            raise AssertionError(f"batch: {what}: the padded segment "
                                 f"matched {int(matched[-1])} docs")
        log(f"  batch kernel == plain: {what} (S={len(segs)}+1 padded, "
            f"G={prog.G}, {_acc_path(prog)} accumulators, per-segment "
            f"matched {matched.tolist()})")
    if not probed:
        raise AssertionError("no batch case ran the probe mode")
    _check_paths(paths, depths, tiles, "batch")
    if raw_values != {"rint", "rlong", "rfloat"}:
        raise AssertionError(f"batch raw value columns covered: "
                             f"{raw_values}")
    return errs


# programs of one query-axis launch in phase 3c
QUERY_AXIS_Q = (1, 3, 8, 9)


def _literal_variants(prog, q: int, seed: int) -> list:
    """``q`` programs of ``prog``'s layout: ``prog``, then variants whose
    literal words alone differ (what ``ScanProgram.layout_key`` leaves
    out): each interval bound moved by -3..3 (empty, negative and
    past-the-width intervals included), each LITC operand moved by the
    variant's index, each LITF operand scaled, each group stride moved
    by 0 or 1 (keys past the group space are dropped, in the kernel as in
    the plain version)."""
    import dataclasses

    from pinot_tpu_torch.engine import fused_scan as fs

    rng = np.random.default_rng(seed)
    out = [prog]
    for k in range(1, q):
        w = prog.prog.astype(np.int64)
        w[prog.iv_off:] += rng.integers(-3, 4, w.size - prog.iv_off)
        for i in range(prog.vops_off, prog.expr_off, 4):
            if w[i] == fs.V_LITC:
                w[i + 1] += k
            elif w[i] == fs.V_LITF:
                f = np.array([w[i + 1]], np.int32).view(np.float32)
                w[i + 1] = int((f * np.float32(1 + k / 8)).view(np.int32)[0])
        w[prog.group_off + 1:prog.iv_off:2] += rng.integers(
            0, 2, prog.n_group)
        v = dataclasses.replace(prog, prog=w.astype(np.int32), _on={},
                                _argv={})
        if v.layout_key() != prog.layout_key():
            raise AssertionError("a literal variant changed the layout")
        out.append(v)
    return out


def _filter_ops(prog) -> set:
    return {int(prog.prog[prog.filter_off + 4 * i])
            for i in range(prog.filter_n)}


def phase_query_axis_kernels(staged) -> dict:
    """3c: the query-axis kernel (``sharded_fused_scan_many``,
    ``sharded_fused_scan_probe_many``) over phase 3's batch: each case's
    scan (and probe) program with its literal variants, Q in
    QUERY_AXIS_Q (9 spans two blocks on grid y), held to the plain version
    and to one solo launch a program (exact counts, int sums, min/max and
    matched counts; floats rel 1e-9), the padded segment matching 0."""
    import torch

    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.parallel import combine

    errs = {"sharded_fused_scan_many": 0.0,
            "sharded_fused_scan_probe_many": 0.0}
    bits, ops, paths, raw_values = set(), set(), set(), set()
    tables = set()   # log2 widths of the leaves that took a table
    stream = torch.cuda.current_stream()
    for c, (what, sql) in enumerate(_kernel_cases()):
        args = _scan_args(staged, sql)
        raw_values |= _raw_values(staged, sql)
        for kind, (_launch, (prog, words, values, nd, tiles)) in args.items():
            probe = prog.probe
            name = ("sharded_fused_scan_probe_many" if probe
                    else "sharded_fused_scan_many")
            progs = _literal_variants(prog, max(QUERY_AXIS_Q), 1000 + c)
            bits.update(prog.bits)
            ops |= _filter_ops(prog)
            plain = [fs.fused_scan_plain(p, words, values, nd, tiles)
                     for p in progs]
            solo = []
            for p in progs:
                argv, out = fs.prepare_launch(p, words, values, nd, tiles)
                fs.enqueue(argv, stream)
                solo.append(out)
            for q in QUERY_AXIS_Q:
                qg, groups = fs.query_group(prog, q)
                tables.update(fs.lut_leaves(prog, qg))
                paths.add(("probe " if probe else "")
                          + _acc_path_many(prog, qg))
                got = (combine.sharded_fused_scan_probe_many(
                           progs[:q], words, nd) if probe
                       else combine.sharded_fused_scan_many(
                           progs[:q], words, values, nd, tiles))
                for i, g in enumerate(got):
                    at = f"3c {what} ({kind}) Q={q} program {i}"
                    errs[name] = max(errs[name],
                                     _compare(g, plain[i], f"{at} (plain)"),
                                     _compare(g, solo[i], f"{at} (solo)"))
                    matched = g.to_host().matched
                    if int(matched[-1]) != 0:
                        raise AssertionError(f"{at}: the padded segment "
                                             f"matched {int(matched[-1])}")
            log(f"  query axis == plain == solo: {what} ({kind}; Q "
                f"{list(QUERY_AXIS_Q)}, {fs.query_group(prog, 9)[0]} a "
                f"block, {_acc_path_many(prog, fs.query_group(prog, 8)[0])}"
                f" accumulators at Q=8; matched of program 1 at Q=9 "
                f"{got[1].to_host().matched.tolist()})")
    missing = {1, 2, 4, 8, 16, 32} - bits
    if missing:
        raise AssertionError(f"3c: bit widths not covered: {sorted(missing)}")
    if not {fs.F_IVS, fs.F_NOT} <= ops:
        raise AssertionError("3c: no IVS or no NOT filter op")
    if tables != {2, 3}:
        raise AssertionError(f"3c: leaf tables over 4- and 8-bit dictIds "
                             f"not both covered: {sorted(tables)}")
    want = {"scalar", "shared", "global", "probe scalar"}
    if not want <= paths:
        raise AssertionError(f"3c: paths not covered: {sorted(want - paths)}")
    if "rlong" not in raw_values:
        raise AssertionError("3c: no raw i64 value column")
    if any(n % fs.TILE == 0 for n in BATCH_DOCS):
        raise AssertionError("3c: every segment must end in a remainder "
                             "tile")
    return errs


def _acc_path_many(prog, qg: int) -> str:
    """``_acc_path`` of a query-axis block serving ``qg`` programs."""
    from pinot_tpu_torch.engine import fused_scan as fs

    return ("scalar" if prog.scalar else
            "shared" if fs.scan_layout_many(prog, qg).acc_smem else "global")


def _raw_values(staged, sql) -> set:
    """The raw (no-dictionary) columns the scan of ``sql`` reads as value
    columns, each checked to be staged in its own type (i64 past 2^31)."""
    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.engine.plan import plan_segment
    from pinot_tpu_torch.query import compile_query

    pp = fs.extract_plan(plan_segment(compile_query(sql + " LIMIT 100000"),
                                      staged.provider), staged.provider,
                         unchecked_groups=True)
    raw = {n for n in pp.value_names
           if not staged.provider.metadata.column(n).has_dictionary}
    if "rlong" in raw and staged.value_column("rlong").dtype.itemsize != 8:
        raise AssertionError("raw LONG past 2^31 not staged as i64")
    return raw


# -- phase 4: main path --------------------------------------------------------

def _check_flight(qid: str, table, want) -> None:
    if isinstance(want, int):
        got = table.rows[0][0]
        if got != float(want):
            raise AssertionError(f"{qid}: {got!r} != {want}")
        return
    got = {tuple(r[:-1]): r[-1] for r in table.rows}
    if set(got) != set(want):
        raise AssertionError(f"{qid}: group sets differ: "
                             f"{len(got)} vs {len(want)} groups")
    bad = [k for k, v in want.items() if got[k] != float(v)]
    if bad:
        raise AssertionError(f"{qid}: {len(bad)} sums differ, e.g. {bad[0]}: "
                             f"{got[bad[0]]!r} != {want[bad[0]]}")


def _graft_entry_check() -> None:
    """The graft-entry SQL on a port-built 5-column segment, against a
    numpy answer over the same frame."""
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.segment import SegmentBuilder
    from pinot_tpu_torch.spi import DataType, FieldSpec, FieldType, Schema

    rng = np.random.default_rng(7)
    n = 2048
    frame = {
        "region": np.array(["east", "west", "north", "south"])[
            rng.integers(0, 4, n)],
        "kind": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "year": rng.integers(2015, 2024, n),
        "qty": rng.integers(1, 50, n),
        "price": np.round(rng.normal(100.0, 25.0, n), 2),
    }
    schema = Schema("sales", [
        FieldSpec("region", DataType.STRING), FieldSpec("kind", DataType.STRING),
        FieldSpec("year", DataType.INT),
        FieldSpec("qty", DataType.LONG, FieldType.METRIC),
        FieldSpec("price", DataType.DOUBLE, FieldType.METRIC)])
    seg = SegmentBuilder(schema, "sales_0").build(frame)
    sql = ("SELECT region, sum(qty), count(*), avg(price) FROM sales "
           "WHERE year BETWEEN 2017 AND 2022 AND kind != 'c' "
           "GROUP BY region ORDER BY region")
    table, _ = ServerQueryExecutor(device="cuda").execute(
        compile_query(sql), [seg])
    m = (frame["year"] >= 2017) & (frame["year"] <= 2022) & (frame["kind"] != "c")
    # float columns are staged as f32 (as the JAX package stages them)
    price = frame["price"].astype(np.float32).astype(np.float64)
    want = []
    for r in sorted(set(frame["region"][m].tolist())):
        g = m & (frame["region"] == r)
        want.append([r, float(frame["qty"][g].sum()), int(g.sum()),
                     float(price[g].sum() / g.sum())])
    if len(table.rows) != len(want):
        raise AssertionError(f"graft SQL: {table.rows} vs {want}")
    for got, exp in zip(table.rows, want):
        if got[:3] != exp[:3] or abs(got[3] - exp[3]) > 1e-9 * abs(exp[3]):
            raise AssertionError(f"graft SQL row {got} != {exp}")
    log(f"  graft-entry SQL: {len(table.rows)} rows match numpy")


def _run_flights(ex, ctxs: dict, segs, reps: int, per_segment: dict
                 ) -> tuple:
    """The flights ``reps`` times through ``ex``: -> ({flight: [ms]},
    {flight: last table}); every run must record no decision but the index
    rung's declines on the ``per_segment[flight]`` segments it runs on per
    segment (``_scan_decisions``)."""
    import torch

    lat = {qid: [] for qid in ctxs}
    results = {}
    for _ in range(reps):
        for qid, ctx in ctxs.items():
            t0 = time.perf_counter()
            table, stats = ex.execute(ctx, segs)
            if ex.device.type == "cuda":
                torch.cuda.synchronize()
            lat[qid].append((time.perf_counter() - t0) * 1e3)
            results[qid] = table
            if _scan_decisions(stats, per_segment[qid], qid):
                raise AssertionError(f"{qid}: decisions {stats.decisions}")
    return lat, results


def _latencies(lat: dict, rows: int, beside: dict = None,
               beside_label: str = "per segment") -> dict:
    per_flight = {}
    for qid, ms in lat.items():
        p50 = float(np.percentile(ms, 50))
        p99 = float(np.percentile(ms, 99))
        per_flight[qid] = {"p50_ms": p50, "p99_ms": p99,
                           "rows_per_s": rows / (p50 / 1e3)}
        other = ""
        if beside is not None:
            other = (f"  ({beside_label}: p50 {beside[qid]['p50_ms']:.3f} "
                     f"ms, p99 {beside[qid]['p99_ms']:.3f} ms)")
        log(f"  {qid}: p50 {p50:.3f} ms  p99 {p99:.3f} ms  "
            f"{rows / (p50 / 1e3):.4g} rows/s{other}")
    return per_flight


def _kept_segments(ctxs: dict, segs, frames: list, parts: dict = None
                   ) -> dict:
    """{query: the segments the pruner keeps}: the engine's pruner held to
    an oracle of its own, each frame's per-column min/max against the
    query's conditions (``ssb.bounds_may_match``), and each pruned segment
    checked to hold no row the numpy oracle matches (``parts``)."""
    from pinot_tpu_torch.engine.pruner import prune_segments
    from pinot_tpu_torch.tools import ssb

    kept = {}
    for qid, ctx in ctxs.items():
        got = prune_segments(ctx, segs)
        want = [s for s, f in zip(segs, frames)
                if ssb.bounds_may_match(f, qid)]
        if [s.segment_name for s in got] != [s.segment_name for s in want]:
            raise AssertionError(
                f"{qid}: the pruner keeps {[s.segment_name for s in got]}, "
                f"the frames' min/max {[s.segment_name for s in want]}")
        names = {s.segment_name for s in got}
        for seg, part in zip(segs, (parts or {}).get(qid, ())):
            if seg.segment_name not in names and part not in (0, {}):
                raise AssertionError(f"{qid}: {seg.segment_name} pruned but "
                                     "the oracle matches rows there")
        kept[qid] = got
    log(f"  segments the pruner keeps (== the frames' min/max): "
        f"{ {q: len(v) for q, v in kept.items()} }")
    return kept


def _reset(counters: dict) -> None:
    for c in counters.values():
        c.reset()


def phase_main(sf: float, segments: int, seed: int, reps: int) -> dict:
    import torch

    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb

    t0 = time.perf_counter()
    segs, frames = ssb.build_segments(sf, num_segments=segments, seed=seed)
    rows = sum(s.num_docs for s in segs)
    log(f"  generate SSB SF{sf}: {rows} rows in {len(segs)} segments, "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    parts = {qid: [ssb.numpy_answer(f, qid) for f in frames]
             for qid in ssb.QUERIES}
    wants = {qid: ssb.merge_answers(p) for qid, p in parts.items()}
    wants.update({gid: ssb.declined_answer(frames, gid)
                  for gid in ssb.DECLINED_QUERIES})
    sql_texts, sql_wants = ssb.sql_queries(frames)
    variant_texts = {**ssb.COALESCE_QUERIES, **ssb.PROBE_QUERIES}
    variant_wants = {vid: ssb.merge_answers(
        [ssb.numpy_answer(f, vid) for f in frames]) for vid in variant_texts}
    log(f"  numpy oracle, 13 flights, {len(ssb.DECLINED_QUERIES)} declined "
        f"and {len(sql_texts)} SQL-slice queries, {len(variant_texts)} "
        f"variants of Q2.1 and Q3.2: {time.perf_counter() - t0:.1f} s")

    ctxs = {qid: compile_query(q + " LIMIT 100000")
            for qid, q in ssb.QUERIES.items()}
    kept_segs = _kept_segments(ctxs, segs, frames, parts)
    kept = {qid: len(v) for qid, v in kept_segs.items()}
    sql_kept = _kept_segments(
        {sid: compile_query(q) for sid, q in sql_texts.items()}, segs, frames)
    t0 = time.perf_counter()
    host_texts, host_wants = ssb.host_queries(frames)
    host_kept = _kept_segments(
        {hid: compile_query(q) for hid, q in host_texts.items()}, segs,
        frames)
    log(f"  numpy oracle of phase 10's {len(host_texts)} queries: "
        f"{time.perf_counter() - t0:.1f} s")
    del frames
    ex = ServerQueryExecutor(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for ctx in ctxs.values():   # untimed pass: stages what the flights read
        ex.execute(ctx, segs)
    torch.cuda.synchronize()
    resident = sum(ex.stage(s).nbytes() for s in segs)
    log(f"  stage on cuda + one untimed pass: {resident} bytes resident "
        f"({resident / rows:.2f} B/row), {time.perf_counter() - t0:.1f} s")

    counters = scan_counters()
    _reset(counters)
    lat, results = _run_flights(ex, ctxs, segs, reps, kept)
    launches = {name: c.launches for name, c in counters.items()}
    # one scan per segment the pruner keeps; Q3.2 and Q4.3 probe first
    expect = {"fused_scan": sum(kept.values()) * reps,
              "fused_scan_probe": (kept["Q3.2"] + kept["Q4.3"]) * reps,
              "sharded_fused_scan": 0, "sharded_fused_scan_probe": 0}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    log(f"  launches on the per-segment path: {launches}; 0 fused-scan "
        "declines (the index rung declines each kept segment: no index)")
    for qid, table in results.items():
        _check_flight(qid, table, wants[qid])
    log("  13 flights == numpy oracle (group sets and int sums exact)")
    per_flight = _latencies(lat, rows)
    log(f"  torch.cuda.max_memory_allocated: "
        f"{torch.cuda.max_memory_allocated()} bytes")
    _graft_entry_check()
    return {"segs": segs, "ex": ex, "launches": launches, "ctxs": ctxs,
            "wants": wants, "parts": parts, "seed": seed,
            "per_flight": per_flight, "rows": rows,
            "results": results, "kept": kept, "kept_segs": kept_segs,
            "sql_texts": sql_texts, "sql_wants": sql_wants,
            "sql_kept": sql_kept, "host_texts": host_texts,
            "host_wants": host_wants, "host_kept": host_kept,
            "variant_texts": variant_texts, "variant_wants": variant_wants}


# -- phase 5: kernel timings at the per-segment path's shapes -----------------

def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


SECTOR = 32   # bytes the card's memory moves per access


def _sectors(need, per_sector: int) -> int:
    """32-byte sectors holding at least one needed element: ``need`` is a
    bool [..., n] mask, ``per_sector`` elements per sector."""
    return int(need.reshape(-1, per_sector).any(dim=1).sum())


def _needed_bytes(prog, words, values, num_docs, tiles) -> int:
    """Bytes this scan must move, from this run's data: the filter's
    packed columns on every sector holding a doc (every doc's filter is
    evaluated), group-key and value columns only on sectors holding a doc
    that passed the filter, ``num_docs`` read once, every output (per-group
    rows, per-segment matched counts) written once."""
    from pinot_tpu_torch.engine import fused_scan as fs

    valid, matched = fs.doc_masks(prog, words, num_docs, values, tiles)
    total = 0
    for c, w in enumerate(words):
        S, T, W = w.shape
        need = valid if c in prog.early else matched
        # doc j of a tile sits in word j % W of the tile (planar layout)
        per_word = need.view(S * T, fs.TILE // W, W).any(dim=1)
        total += SECTOR * _sectors(per_word, SECTOR // 4)
    for v in values:
        total += SECTOR * _sectors(matched, SECTOR // v.element_size())
    outs = (prog.G * (8 * (1 + prog.n_isum + prog.n_fsum) + 4 * prog.n_mm)
            + 8 * num_docs.numel())
    return total + 8 * num_docs.numel() + outs


def _kernel_ms(args, iters: int) -> float:
    """The kernel alone: one prepared launch enqueued ``iters`` times back
    to back, so the wrapper's host work is not in the time (the outputs add
    up; only the time is read)."""
    import torch

    from pinot_tpu_torch.engine import fused_scan as fs

    argv, _out = fs.prepare_launch(*args)
    stream = torch.cuda.current_stream()
    return _time_ms(lambda: fs.enqueue(argv, stream), iters)


def _time_kernels(cases: dict, errs: dict, iters: int) -> list:
    """Each query's scan (and probe) at its shape, ``cases``: {query:
    (staged segment or batch, its docs, SQL)}: held against the plain
    version at these shapes (folded into ``errs``), then timed beside the
    bound from the bytes this run's data needs: the kernel alone, and the
    wrapper (the kernel with its host work, as the path launches it)."""
    from pinot_tpu_torch.engine import fused_scan as fs

    rows = []
    for qid, (staged, docs, q) in cases.items():
        scan_args = _scan_args(staged, q)
        _kernel_vs_plain(scan_args, qid, errs)
        for kind, (launch, args) in scan_args.items():
            prog, num_docs, tiles = args[0], args[3], args[4]
            nbytes = _needed_bytes(*args)
            full = _full_bytes(*args)
            lay = fs.scan_layout(prog)
            grid = min(num_docs.numel() * tiles, fs.launch_grid(lay.smem))
            k_ms = _kernel_ms(args, iters)
            w_ms = _time_ms(launch, iters)
            p_ms = _time_ms(lambda: fs.fused_scan_plain(*args), 3)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            rows.append({"flight": qid, "kernel": kind, "docs": docs,
                         "segments": int(num_docs.numel()),
                         "groups": prog.G, "bytes": nbytes,
                         "all_column_bytes": full, "ms": k_ms,
                         "wrapper_ms": w_ms, "plain_ms": p_ms,
                         "bound_ms": bound, "acc_smem": lay.acc_smem,
                         "smem": lay.smem, "grid": grid})
            log(f"  {qid} {kind} ({docs} docs): {k_ms:.4f} ms/launch "
                f"({k_ms / bound:.1f}x bound {bound:.4f} ms, {nbytes} B "
                f"needed of {full} B in its columns; {prog.G} groups, "
                f"{lay.smem} B smem, grid {grid}); wrapper {w_ms:.4f} ms, "
                f"plain {p_ms:.3f} ms")
    return rows


def _full_bytes(prog, words, values, num_docs, tiles) -> int:
    """Bytes of every column the scan reads, in full: the most any data
    could need (logged beside the bound, not used for it)."""
    return (sum(w.numel() * 4 for w in words)
            + sum(v.numel() * v.element_size() for v in values))


def phase_timing(main: dict, errs: dict, iters: int = 20) -> list:
    """Every flight's scan (and probe) on the first segment the pruner
    keeps for it, as the per-segment path launches it."""
    from pinot_tpu_torch.tools import ssb

    ex = main["ex"]
    return _time_kernels(
        {qid: (ex.stage(kept[0]), kept[0].num_docs, ssb.QUERIES[qid])
         for qid, kept in main["kept_segs"].items()}, errs, iters)


# -- phase 6: the batch path ----------------------------------------------------

def phase_batch(main: dict, reps: int, errs: dict, iters: int = 20) -> dict:
    """The main path's segments and flights through ShardedQueryExecutor:
    an untimed pass (staging the batch of each flight's kept segments,
    binding), then ``reps`` timed passes over the 13 flights in turn, as
    mixed traffic arrives, with no batch staged in them: one launch per
    flight over its batch, the probe once per probed flight (at binding),
    one kept segment on the per-segment path. Then each batch scan against
    its plain version and timed at the shapes those launches had."""
    import torch

    from pinot_tpu_torch.parallel import ShardedQueryExecutor
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.tools import ssb

    segs, ctxs, rows = main["segs"], main["ctxs"], main["rows"]
    kept, kept_segs = main["kept"], main["kept_segs"]
    counters = scan_counters()
    _reset(counters)
    ex = ShardedQueryExecutor(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for ctx in ctxs.values():
        ex.execute(ctx, segs)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    staged = ex.batches_staged
    # one kept segment runs per segment, where the index rung declines it
    single_kept = {q: k if k == 1 else 0 for q, k in kept.items()}
    lat, results = _run_flights(ex, ctxs, segs, reps, single_kept)
    # the same runs flight by flight, each flight's repetitions back to
    # back: what the order of the traffic costs
    by_flight = {}
    for qid, ctx in ctxs.items():
        by_flight[qid] = _run_flights(ex, {qid: ctx}, segs, reps,
                                      single_kept)[0][qid]
    if ex.batches_staged != staged:
        raise AssertionError(f"the timed passes staged "
                             f"{ex.batches_staged - staged} batches")
    batches = {k: st.nbytes() for k, (_b, st) in ex._batches.items()}
    resident = sum(batches.values())
    log(f"  untimed pass: {staged} batches staged (one per kept set of "
        f"several segments) and every flight bound, {setup_ms:.1f} ms; "
        f"the timed passes staged none; {resident} bytes resident in "
        f"them ({resident / rows:.2f} B/row), budget "
        f"{ex.residency.budget_bytes} bytes")
    launches = {name: c.launches for name, c in counters.items()}
    # a flight that keeps several segments runs as one launch over their
    # batch (its first run binds: Q3.2 and Q4.3 probe there); one kept
    # segment takes the per-segment path
    multi = [q for q in ctxs if kept[q] > 1]
    single = [q for q in ctxs if kept[q] == 1]
    probing = ("Q3.2", "Q4.3")
    runs = 2 * reps + 1
    expect = {"fused_scan": len(single) * runs,
              "fused_scan_probe": runs * len(
                  [q for q in single if q in probing]),
              "sharded_fused_scan": len(multi) * runs,
              "sharded_fused_scan_probe": len(
                  [q for q in multi if q in probing])}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    log(f"  launches on the batch path: {launches}; 0 declines")
    for qid, table in results.items():
        _check_flight(qid, table, main["wants"][qid])
    log("  13 flights == numpy oracle (group sets and int sums exact)")
    per_flight = _latencies(lat, rows, beside=main["per_flight"])
    log("  the same flights timed flight by flight:")
    per_flight_by_flight = _latencies(by_flight, rows, beside=per_flight,
                                      beside_label="in turn")
    peak = torch.cuda.max_memory_allocated()
    log(f"  torch.cuda.max_memory_allocated: {peak} bytes")
    log("  batch kernel against plain version and timings at the batch "
        "path's shapes (each flight's batch of its kept segments)")
    timing = _time_kernels(
        {q: (ex.batch_for(kept_segs[q])[1],
             sum(s.num_docs for s in kept_segs[q]), ssb.QUERIES[q])
         for q in multi}, errs, iters)
    if ex.batches_staged != staged:
        raise AssertionError("the timed shapes are not the main path's: "
                             "a batch was staged for them")
    diag = _combine_over(ex, ctxs["Q4.3"], {
        "kept": kept_segs["Q4.3"], "all": segs}, reps, errs)
    return {"launches": launches, "per_flight": per_flight,
            "per_flight_by_flight": per_flight_by_flight,
            "resident_bytes": resident, "batch_bytes": {
                ",".join(k): n for k, n in batches.items()},
            "max_memory_allocated": peak, "setup_ms": setup_ms,
            "timing": timing, "q43_combine": diag, "ex": ex}


def _combine_over(ex, ctx, sets: dict, reps: int, errs: dict) -> dict:
    """Q4.3's combine (the launch over the batch and the decode of its
    groups, no pruning, no reduce) over its kept segments and over all of
    them, p50 of ``reps`` runs each, and the batch scan's kernel alone at
    both shapes: where a batch's time goes as it grows. A diagnostic: the
    batch of all segments is not this flight's main-path shape."""
    import torch

    from pinot_tpu_torch.engine.aggregates import resolve_agg
    from pinot_tpu_torch.engine.results import QueryStats
    from pinot_tpu_torch.tools import ssb

    aggs = [resolve_agg(f) for f in ctx.aggregations]
    out = {}
    for name, group in sets.items():
        ex._execute_group_by(ctx, aggs, group, QueryStats())  # binds
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            ex._execute_group_by(ctx, aggs, group, QueryStats())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        kernel = _time_kernels({"Q4.3": (
            ex.batch_for(group)[1], sum(s.num_docs for s in group),
            ssb.QUERIES["Q4.3"])}, errs, 20)
        out[name] = {"segments": len(group),
                     "combine_p50_ms": float(np.percentile(ms, 50)),
                     "kernel_ms": {r["kernel"]: r["ms"] for r in kernel},
                     "groups": kernel[0]["groups"]}
        log(f"  Q4.3 combine over {len(group)} segments ({name}): p50 "
            f"{out[name]['combine_p50_ms']:.3f} ms, kernels "
            f"{out[name]['kernel_ms']}, {out[name]['groups']} groups")
    return out


# -- phase 23: the combine mesh ---------------------------------------------------

# mesh shapes of phase 23 (seg x doc) on cells cuda:i % cards
MESH_SHAPES = ((1, 1), (8, 1), (4, 2), (2, 2))
# broker merges of 23c over 4 cells: (rung, rows, composite space)
MESH_MERGES = (("dense", 200_000, 3_000), ("slices", 400_000, 300_000),
               ("sort", 400_000, 1 << 40))


def _mesh_cells(n: int, device: str) -> list:
    import torch

    if device == "cpu":
        return ["cpu"] * n
    return [torch.device("cuda", i % torch.cuda.device_count())
            for i in range(n)]


def _mesh_kernel_rows(shape: str, staged, sql: str, errs: dict,
                      iters: int) -> list:
    """Each scan (and probe) of ``sql`` over a mesh's staged batch: held to
    its plain version over the same cells (folded into ``errs``), then one
    cell's launch timed alone on every cell (the kernel, CUDA events), and
    the fold of the cells' outputs on the root."""
    import torch

    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.parallel import combine
    from pinot_tpu_torch.parallel.mesh import Cells

    rows = []
    stream = torch.cuda.current_stream()
    for kind, (launch, args) in _scan_args(staged, sql).items():
        prog, words, values, nd, tiles = args
        got = launch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = combine.sharded_fused_scan_plain(*args)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        errs[kind] = max(errs[kind], _compare(got, plain,
                                              f"23 {shape} {kind}"))
        m = nd.mesh if isinstance(nd, Cells) else None
        cells = ([args] if m is None else
                 [(prog, [w[c] for w in words], [v[c] for v in values],
                   nd[c], tiles // m.n_doc) for c in range(m.size)])
        cell_ms, outs, nbytes = [], [], 0
        for a in cells:
            cell_ms.append(_kernel_ms(a, iters))
            argv, o = fs.prepare_launch(*a)
            fs.enqueue(argv, stream)
            outs.append(o)
            nbytes += _needed_bytes(*a)
        fold_ms = (0.0 if m is None else _time_ms(
            lambda: combine.fold_outputs(prog, outs, m), iters))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"shape": shape, "flight": sql[:40], "kernel": kind,
                     "cells": len(cells), "cell_ms": cell_ms,
                     "ms": float(sum(cell_ms)), "fold_ms": fold_ms,
                     "plain_ms": p_ms, "bound_ms": bound, "bytes": nbytes})
    return rows


# flights whose kernels phase 23 holds to the plain version and times on
# every shape: a scan, and a scan with its probe
MESH_KERNEL_FLIGHTS = ("Q2.1", "Q4.3")


def phase_mesh(main: dict, one, reps: int, errs: dict, device: str = "cuda",
               iters: int = 10, merges: tuple = MESH_MERGES) -> dict:
    """23: phase 6's segments and flights over combine meshes of cells
    ``cuda:i % cards``: 1x1 (``one``, phase 6's executor), 8x1, 4x2 and
    2x2. (23a) each mesh's untimed pass (every shape at once, one thread
    a shape), then ``reps`` timed passes over the 13 flights: every answer
    == the 1x1's (f64 sums within rel 1e-9) == the oracle, one launch a
    cell a flight; each multi-segment flight's scan and probe held to the
    plain version over the same cells, the kernel timed a cell and the
    fold on the root. (23b) on 4x2: C1-C8 from 8 client threads on the
    query axis (one launch a cell for each coalesced group, == the
    oracle, the query axis held to its plain version) and Q2.1 under 40%
    of its working set (sliced, == the oracle). (23c) the broker's merge
    over 4 cells: dense under 4096 slots, the slice exchange above, the
    sort rung, each == the one-cell merge == numpy."""
    import threading

    import torch

    from pinot_tpu_torch.parallel import (
        ShardedQueryExecutor,
        make_combine_mesh,
    )
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.tools import ssb

    segs, ctxs, kept = main["segs"], main["ctxs"], main["kept"]
    single_kept = {q: k if k == 1 else 0 for q, k in kept.items()}
    multi = [q for q in ctxs if kept[q] > 1]
    counters = scan_counters()
    launches = {k: 0 for k in counters}
    want = {q: one.execute(ctx, segs)[0].rows for q, ctx in ctxs.items()}
    exs = {"1x1": one}
    for n_seg, n_doc in MESH_SHAPES[1:]:
        exs[f"{n_seg}x{n_doc}"] = ShardedQueryExecutor(
            mesh=make_combine_mesh(_mesh_cells(n_seg * n_doc, device),
                                   doc_shards=n_doc))
    t0 = time.perf_counter()
    failed = []

    def untimed(ex):
        try:
            for ctx in ctxs.values():
                ex.execute(ctx, segs)
        except BaseException as e:  # noqa: BLE001 - raised below
            failed.append(e)

    pool = [threading.Thread(target=untimed, args=(ex,))
            for s, ex in exs.items() if s != "1x1"]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    if failed:
        raise failed[0]
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"  23a untimed passes of {len(pool)} meshes at once: "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"shapes": {}}
    for shape, ex in exs.items():
        m = ex.mesh
        staged = ex.batches_staged
        _reset(counters)
        lat, results = _run_flights(ex, ctxs, segs, reps, single_kept)
        got = {name: c.launches for name, c in counters.items()}
        for k in launches:
            launches[k] += got[k]
        expect = len(multi) * reps * m.size
        if device == "cuda" and got["sharded_fused_scan"] != expect:
            raise AssertionError(f"23a {shape}: {got} launches, want "
                                 f"{expect} sharded_fused_scan")
        if ex.batches_staged != staged:
            raise AssertionError(f"23a {shape}: the timed passes staged")
        for qid, table in results.items():
            _check_flight(qid, table, main["wants"][qid])
            _rows_within(table.rows, want[qid], f"23a {shape} {qid}")
        krows = []
        if device == "cuda":
            for q in MESH_KERNEL_FLIGHTS:
                krows += _mesh_kernel_rows(
                    shape, ex.batch_for(main["kept_segs"][q])[1],
                    ssb.QUERIES[q], errs, iters)
        p50 = {q: float(np.percentile(v, 50)) for q, v in lat.items()}
        scans = [r for r in krows if r["kernel"] == "sharded_fused_scan"]
        row = {"cells": [str(c) for c in m.cells], "p50_ms": p50,
               "pass_p50_ms": float(sum(p50.values())), "launches": got,
               "cell_ms": float(np.mean([np.mean(r["cell_ms"])
                                         for r in scans])) if scans else None,
               "fold_ms": float(np.mean([r["fold_ms"] for r in scans]))
               if scans else None,
               "kernels": krows}
        out["shapes"][shape] = row
        cell = "n/a" if row["cell_ms"] is None else f"{row['cell_ms']:.4f}"
        fold = "n/a" if row["fold_ms"] is None else f"{row['fold_ms']:.4f}"
        log(f"  23a mesh {shape}: pass p50 {row['pass_p50_ms']:.3f} ms over "
            f"13 flights, launches {got}, per-cell kernel {cell} ms, fold "
            f"{fold} ms; == 1x1 == oracle")
    out.update(_mesh_query_axis(main, exs["4x2"], errs, device))
    out["sliced"] = _mesh_sliced(main, exs["4x2"].mesh, device)
    out["merge"] = _mesh_merges(device, merges)
    for k, v in out.pop("axis_launches").items():
        launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    for shape, ex in exs.items():
        if shape != "1x1":
            ex.close()
    return out


def _rows_within(got: list, want: list, what: str) -> None:
    """Equal rows; f64 cells within rel 1e-9 (the folds add in another
    order)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows vs {len(want)}")
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                if abs(a - b) > 1e-9 * abs(b):
                    raise AssertionError(f"{what}: {g} vs {w}")
            elif a != b:
                raise AssertionError(f"{what}: {g} vs {w}")


def _mesh_query_axis(main: dict, ex, errs: dict, device: str) -> dict:
    """23b: C1-C8 from 8 client threads on a 4x2 mesh's query axis."""
    import threading

    from pinot_tpu_torch.parallel import combine
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb

    segs = main["segs"]
    cids = list(ssb.COALESCE_QUERIES)
    ctxs = {v: compile_query(main["variant_texts"][v]) for v in cids}
    for v in cids:
        _check_flight(v, ex.execute(ctxs[v], segs)[0],
                      main["variant_wants"][v])
    counters = {c.name: c for c in (combine.SHARDED_SCAN_COUNTER,
                                    combine.SHARDED_SCAN_MANY_COUNTER)}
    _reset(counters)
    mark = ex.launcher.stats_snapshot()
    errors, barrier = [], threading.Barrier(len(cids))

    def client(t: int) -> None:
        try:
            own = {v: compile_query(c.sql) for v, c in ctxs.items()}
            barrier.wait(60)
            for i in range(len(cids)):
                v = cids[(t + i) % len(cids)]
                _check_flight(v, ex.execute(own[v], segs)[0],
                              main["variant_wants"][v])
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
            barrier.abort()

    pool = [threading.Thread(target=client, args=(t,))
            for t in range(len(cids))]
    for th in pool:
        th.start()
    for th in pool:
        th.join(300)
    if errors or any(th.is_alive() for th in pool):
        raise AssertionError(f"23b: clients failed: {errors[:3]}")
    got = {name: c.launches for name, c in counters.items()}
    snap = ex.launcher.stats_snapshot()
    saved = snap["launchesSaved"] - mark["launchesSaved"]
    cells = ex.mesh.size
    if device == "cuda" and (got["sharded_fused_scan_many"] % cells
                             or got["sharded_fused_scan"] % cells):
        raise AssertionError(f"23b: launches {got} not a multiple of "
                             f"{cells} cells")
    row = {"launches": got, "launches_saved": saved}
    if device == "cuda":
        bounds = [next(b for k, b in ex._param_cache.items()
                       if k[0] == ctxs[v].sql) for v in cids]
        inp = bounds[0].inputs
        progs = [b.params for b in bounds]
        many = combine.sharded_fused_scan_many(progs, inp.words, inp.values,
                                               inp.num_docs, inp.tiles)
        plain = combine.sharded_fused_scan_many_plain(
            progs, inp.words, inp.values, inp.num_docs, inp.tiles)
        err = 0.0
        for q, (g, p) in enumerate(zip(many, plain)):
            err = max(err, _compare(g, p, f"23b query {q}"))
        errs["sharded_fused_scan_many"] = max(
            errs.get("sharded_fused_scan_many", 0.0), err)
        m = inp.num_docs.mesh
        row["cell_ms"] = [_time_ms(lambda c=c: combine.counted_scan_many(
            progs, [w[c] for w in inp.words], [v[c] for v in inp.values],
            inp.num_docs[c], combine.SHARDED_SCAN_MANY_COUNTER,
            inp.tiles // m.n_doc), 5) for c in range(m.size)]
        row["max_abs_err"] = err
    log(f"  23b 4x2 query axis, 8 clients x C1-C8: == oracle; launches "
        f"{got}, launches saved {saved}"
        + (f", per-cell Q=8 launch {np.mean(row['cell_ms']):.4f} ms"
           if "cell_ms" in row else ""))
    return {"query_axis": row,
            "axis_launches": {"sharded_fused_scan_many":
                              got["sharded_fused_scan_many"]}}


def _mesh_sliced(main: dict, mesh, device: str) -> dict:
    """23b: Q2.1 on a 4x2 mesh under 40% of its working set."""
    from pinot_tpu_torch.engine.residency import estimate_segment_bytes
    from pinot_tpu_torch.parallel import ShardedQueryExecutor

    segs, ctx = main["segs"], main["ctxs"]["Q2.1"]
    cols = ctx.referenced_columns()
    ws = sum(estimate_segment_bytes(s, cols) for s in segs)
    ex = ShardedQueryExecutor(mesh=mesh, hbm_budget_bytes=int(0.4 * ws))
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        table, stats = ex.execute(ctx, segs)
        ms.append((time.perf_counter() - t0) * 1e3)
        _check_flight("Q2.1", table, main["wants"]["Q2.1"])
    snap = ex.residency.stats_snapshot()
    if snap["slicedQueries"] < 2 or snap["spills"]:
        raise AssertionError(f"23b sliced Q2.1: {snap}")
    out = {"budget_bytes": int(0.4 * ws), "ms": ms,
           "slices": stats.staging.get("slices"),
           "demotions": snap["demotions"], "promotions": snap["promotions"]}
    log(f"  23b sliced Q2.1 on 4x2 under {out['budget_bytes']} B: == "
        f"oracle, {out['slices']} slices, {snap['demotions']} demotions, "
        f"{snap['promotions']} promotions, {ms[-1]:.1f} ms")
    ex.close()
    return out


def _mesh_merges(device: str, merges: tuple) -> dict:
    """23c: the broker's merge over 4 cells on each rung and flavor
    (``merges``), == the one-cell merge == numpy."""
    from pinot_tpu_torch.parallel import reduce_device as rdev

    cells = _mesh_cells(4, device)
    out = {}
    rng = np.random.default_rng(23)
    for rung, n, space in merges:
        comp = rng.integers(0, space, n).astype(np.int64)
        vals = [rng.integers(-50, 50, n).astype(np.int64),
                rng.integers(-1000, 1000, n).astype(np.float64)]
        ops = ["sum", "max"]
        if rdev.merge_rung(space) != ("sort" if rung == "sort" else "dense"):
            raise AssertionError(f"23c {rung}: rung {rdev.merge_rung(space)}")
        if rung != "sort" and (rung == "slices") != (space
                                                     > rdev._PSUM_SLOTS):
            raise AssertionError(f"23c {rung}: {space} slots")
        first, folded = rdev.device_group_merge(comp, space, vals, ops, cells)
        one = rdev.device_group_merge(comp, space, vals, ops, cells[0])
        keys, inv = np.unique(comp, return_inverse=True)
        s = np.zeros(len(keys), np.int64)
        np.add.at(s, inv, vals[0])
        mx = np.full(len(keys), -np.inf)
        np.maximum.at(mx, inv, vals[1])
        fi = np.full(len(keys), n, np.int64)
        np.minimum.at(fi, inv, np.arange(n))
        for a, b, what in ((first, one[0], "first"), (first, fi, "first"),
                           (folded[0], s, "sum"), (folded[1], mx, "max"),
                           (folded[0], one[1][0], "sum"),
                           (folded[1], one[1][1], "max")):
            if not np.array_equal(a, b):
                raise AssertionError(f"23c {rung}: {what} differs")
        t0 = time.perf_counter()
        for _ in range(3):
            rdev.device_group_merge(comp, space, vals, ops, cells)
        ms = (time.perf_counter() - t0) / 3 * 1e3
        t0 = time.perf_counter()
        for _ in range(3):
            rdev.device_group_merge(comp, space, vals, ops, cells[0])
        one_ms = (time.perf_counter() - t0) / 3 * 1e3
        out[rung] = {"rows": n, "space": space, "groups": len(keys),
                     "ms": ms, "one_cell_ms": one_ms}
        log(f"  23c merge {rung} over 4 cells ({n} rows, {len(keys)} "
            f"groups, {space} slots): == one cell == numpy; {ms:.2f} ms "
            f"(one cell {one_ms:.2f} ms)")
    return out


# -- phase 7: the general rung ---------------------------------------------------

# the rung each declined query's segments with matched docs take at SF5 in
# 8 segments (G4 is scalar); the others are served by the fused scan once
# the probe narrows their empty key space
DECLINED_RUNG = {"G1": "hash", "G2": "sort", "G3": "dense", "G4": None,
                 "G5": "dense"}


def _check_on_card(ex) -> None:
    """Every array the general rung read lies on the card: the staged
    columns and every cached plan's params."""
    for _name, staged in ex.residency.residents():
        for name, col in staged._columns.items():
            for t in col.tree().values():
                if t.device.type != "cuda":
                    raise AssertionError(f"column {name} on {t.device}")
    for _seg, plan in ex._plans.values():
        if any(d.type != "cuda" for d in plan.device_params):
            raise AssertionError(f"plan params on {list(plan.device_params)}")


def _check_declined(gid: str, table, wants: dict) -> None:
    from pinot_tpu_torch.tools import ssb

    got = ssb.declined_rows(gid, table.rows)
    if got != wants[gid]:
        raise AssertionError(f"{gid}: rows differ from the oracle "
                             f"({len(got)} vs {len(wants[gid])} groups)")


def phase_general(main: dict, reps: int) -> dict:
    import torch

    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb

    segs, ctxs, rows = main["segs"], main["ctxs"], main["rows"]
    counters = {**scan_counters(), "general_rung": kernels.RUNG_COUNTER}

    # (a) the flights with the fused scan off
    ex = ServerQueryExecutor(device="cuda", use_fused_scan=False)
    t0 = time.perf_counter()
    for ctx in ctxs.values():   # untimed pass: stages the rung's columns
        ex.execute(ctx, segs)
    torch.cuda.synchronize()
    log(f"  staged for the general rung + one untimed pass: "
        f"{sum(ex.stage(s).nbytes() for s in segs)} bytes resident, "
        f"{time.perf_counter() - t0:.1f} s")
    _reset(counters)
    lat = {qid: [] for qid in ctxs}
    rungs = {}
    kept = main["kept"]
    for _ in range(reps):
        for qid, ctx in ctxs.items():
            t0 = time.perf_counter()
            table, stats = ex.execute(ctx, segs)
            torch.cuda.synchronize()
            lat[qid].append((time.perf_counter() - t0) * 1e3)
            if (sorted(map(tuple, table.rows))
                    != sorted(map(tuple, main["results"][qid].rows))):
                raise AssertionError(f"{qid}: general rung rows differ from "
                                     "the fused scan's")
            _check_flight(qid, table, main["wants"][qid])
            off = {_decline_key("pallas_disabled_on_backend"): kept[qid]}
            if (_scan_decisions(stats, kept[qid], qid) != off
                    or stats.general_launches != kept[qid]):
                raise AssertionError(f"{qid}: decisions {stats.decisions}, "
                                     f"{stats.general_launches} rung calls")
            rungs[qid] = stats.rung_segments
    launches = {name: c.launches for name, c in counters.items()}
    expect = {name: 0 for name in counters}
    expect["general_rung"] = sum(kept.values()) * reps
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    log(f"  (a) launches with the fused scan off: {launches} (one per kept "
        "segment); 13 flights == phase 4 == numpy oracle")
    for qid in ("Q3.2", "Q4.3"):
        if "hash" not in rungs[qid]:
            raise AssertionError(f"{qid}: no segment on the hash rung: "
                                 f"{rungs[qid]}")
    per_flight = _latencies(lat, rows, beside=main["per_flight"],
                            beside_label="fused scan, phase 4")
    _check_on_card(ex)

    # (b) the declined queries with the fused scan on; those that keep
    # several segments run over their batch in phase 11a
    ex_on = ServerQueryExecutor(device="cuda")
    declined, jobs = {}, []
    for gid, sql in ssb.DECLINED_QUERIES.items():
        ctx = compile_query(sql)
        ex_on.execute(ctx, segs)   # untimed: stages and plans
        ms = []
        for _ in range(reps):
            _reset(counters)
            t0 = time.perf_counter()
            table, stats = ex_on.execute(ctx, segs)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        _check_declined(gid, table, main["wants"])
        reason = ssb.DECLINED_REASONS[gid]
        want_key = f"pallas:pallas_kernel->jnp_kernel:{reason}"
        decisions = _scan_decisions(
            stats, stats.num_segments_processed if ctx.filter else 0, gid)
        if set(decisions) != {want_key}:
            raise AssertionError(f"{gid}: decisions {stats.decisions}")
        n_general = decisions[want_key]
        if (stats.general_launches != n_general
                or counters["general_rung"].launches != n_general):
            raise AssertionError(f"{gid}: {n_general} declines but "
                                 f"{stats.general_launches} rung calls")
        rung = DECLINED_RUNG[gid]
        if rung is not None and stats.rung_segments.get(rung, 0) < 1:
            raise AssertionError(f"{gid}: no segment on the {rung} rung: "
                                 f"{stats.rung_segments}")
        declined[gid] = {
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "reason": reason, "rung_segments": stats.rung_segments,
            "general_calls": n_general,
            "launches": {k: c.launches for k, c in counters.items()}}
        log(f"  (b) {gid}: p50 {declined[gid]['p50_ms']:.3f} ms  p99 "
            f"{declined[gid]['p99_ms']:.3f} ms; declined {reason} on "
            f"{n_general} segments, rungs {stats.rung_segments}, launches "
            f"{declined[gid]['launches']}; == numpy oracle")
        if stats.num_segments_processed > 1:
            jobs.append(_combine_job(
                gid, "ssb", ctx, segs, stats.num_segments_processed, reason,
                lambda t, gid=gid: _check_declined(gid, t, main["wants"]),
                table.rows, declined[gid]["p50_ms"]))
    _check_on_card(ex_on)
    return {"per_flight": per_flight, "rungs": rungs, "declined": declined,
            "launches": launches, "combine_jobs": jobs}


# -- phase 8: the user-events table ------------------------------------------

# per query: the fused scan's decline code (None: the fused scan serves
# every segment) and the group-by rung of each segment (None: scalar)
USER_PATH = {"U1": (None, "dense"), "U2": (None, "dense"),
             "U3": ("pallas_vrange", None), "U4": ("pallas_mv_eq", "dense"),
             "U5": ("pallas_mv_lut", None),
             "U6": ("pallas_raw_group_key", "dense"),
             "U7": ("pallas_vin", None)}
# the queries the fused scan serves: one launch over the batch; the others
# run over the batch on the jnp combine in phase 11a
USER_BATCH = ("U1", "U2")
# the query whose value column is the raw latency_ms
USER_RAW_FUSED = "U2"


def _decline_key(code: str) -> str:
    return f"pallas:pallas_kernel->jnp_kernel:{code}"


_INDEX_DECLINE = "index:index_gather->scan:"


def _scan_decisions(stats, index_segments: int, what: str) -> dict:
    """The query's decisions but the index rung's. The tables of phases
    4-10 carry no index: the rung must decline each of the
    ``index_segments`` segments a filtered aggregation ran on per segment
    (as the JAX executor records it) and serve none."""
    idx = {k: v for k, v in stats.decisions.items() if k.startswith("index:")}
    if (any(not k.startswith(_INDEX_DECLINE) for k in idx)
            or sum(idx.values()) != index_segments):
        raise AssertionError(f"{what}: index decisions {idx}, expected "
                             f"{index_segments} declines")
    return {k: v for k, v in stats.decisions.items()
            if not k.startswith("index:")}


def _check_user_path(qid: str, stats, n_segs: int, path: dict,
                     index_segments: int) -> None:
    """The query's declines, general-rung calls and rungs per segment."""
    code, rung = path[qid]
    want = {_decline_key(code): n_segs} if code else {}
    if _scan_decisions(stats, index_segments, qid) != want:
        raise AssertionError(f"{qid}: decisions {stats.decisions} != {want}")
    if stats.general_launches != (n_segs if code else 0):
        raise AssertionError(f"{qid}: {stats.general_launches} general-rung "
                             f"calls over {n_segs} segments")
    want_rungs = {rung: n_segs} if rung else {}
    if stats.rung_segments != want_rungs:
        raise AssertionError(f"{qid}: rungs {stats.rung_segments} != "
                             f"{want_rungs}")


def _timed(ex, ctx, segs, reps: int, check) -> list:
    """``reps`` timed runs of ``ctx``, each result passed to ``check``."""
    import torch

    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        table, stats = ex.execute(ctx, segs)
        if ex.device.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(table, stats)
    return ms


def _counted(counters: dict, device) -> dict:
    """The counters' launches: the wrappers count only the launches of
    their kernels on the card (on the CPU they run the plain version)."""
    return ({name: c.launches for name, c in counters.items()}
            if device.type == "cuda" else None)


def phase_users(seed: int, reps: int, segments: int = 8,
                rows_per_segment: int = 2_500_000, device: str = "cuda",
                errs: dict = None) -> dict:
    """U1-U7 (``tools/usertable.py``) on the user-events table, each
    ``reps`` times through ServerQueryExecutor, held against the numpy
    oracle over the generator's arrays, with its decline code and rung per
    segment; U1 and U2 (the fused ones) also through ShardedQueryExecutor
    in one launch over the batch (U3-U7 run over the batch in phase 11a,
    from the ``combine_jobs`` returned). On the card, U1's and U2's scans
    are then held against the plain version and timed at these shapes
    (segment 0, and the batch), folded into ``errs``."""
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.parallel import ShardedQueryExecutor
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import usertable

    rows = segments * rows_per_segment
    t0 = time.perf_counter()
    segs, frames = usertable.build_segments(segments, rows, seed)
    users = usertable.tail_users(rows, segments, seed)
    user = users[len(users) // 2]
    sqls = usertable.queries(user)
    wants = {qid: usertable.numpy_answer(frames, qid, user) for qid in sqls}
    host_wants = usertable.host_answers(frames, user,
                                        [s.segment_name for s in segs])
    lat_cm = segs[0].metadata.column("latency_ms")
    log(f"  generate {rows} rows in {len(segs)} segments and the numpy "
        f"oracle: {time.perf_counter() - t0:.1f} s; tail user {user}; "
        f"latency_ms raw, segment 0 span {lat_cm.min_value}.."
        f"{lat_cm.max_value}")

    ctxs = {qid: compile_query(sql) for qid, sql in sqls.items()}
    counters = {**scan_counters(), "general_rung": kernels.RUNG_COUNTER}
    ex = ServerQueryExecutor(device=device)
    t0 = time.perf_counter()
    for ctx in ctxs.values():   # untimed pass: stages and plans
        ex.execute(ctx, segs)
    log(f"  staged + one untimed pass: "
        f"{sum(ex.stage(s).nbytes() for s in segs)} bytes resident, "
        f"{time.perf_counter() - t0:.1f} s")

    # fused launches per query and path, from each run's stats
    fused = {"fused_scan": {}, "sharded_fused_scan": {}}

    last = {}

    def checker(qid, path, index_segments):
        def check(table, stats):
            usertable.check_rows(qid, table.rows, wants[qid])
            last[qid] = table.rows
            _check_user_path(qid, stats, len(segs), path, index_segments)
            for name, n in (("fused_scan", stats.scan_launches),
                            ("sharded_fused_scan",
                             stats.sharded_scan_launches)):
                fused[name][qid] = fused[name].get(qid, 0) + n
        return check

    _reset(counters)
    lat = {qid: _timed(ex, ctx, segs, reps,
                       checker(qid, USER_PATH, len(segs)))
           for qid, ctx in ctxs.items()}
    launches = _counted(counters, ex.device)
    if launches is not None:
        expect = {name: 0 for name in counters}
        expect["fused_scan"] = len(segs) * reps * len(USER_BATCH)
        expect["general_rung"] = len(segs) * reps * (len(ctxs)
                                                    - len(USER_BATCH))
        if launches != expect:
            raise AssertionError(f"launch counts {launches} != {expect}")
    log(f"  per segment: launches {launches}; U1-U7 == numpy oracle, "
        "declines and rungs as planned")
    per_query = _latencies(lat, rows)
    rungs = {qid: {"decline": USER_PATH[qid][0],
                   "rung_per_segment": USER_PATH[qid][1]} for qid in ctxs}

    bex = ShardedQueryExecutor(device=device)
    batch_path = {qid: (None, None) for qid in USER_BATCH}
    for qid in USER_BATCH:      # untimed: stages the batch and binds
        bex.execute(ctxs[qid], segs)
    _reset(counters)
    batch_lat = {}
    for qid in USER_BATCH:
        batch_lat[qid] = _timed(bex, ctxs[qid], segs, reps,
                                checker(qid, batch_path, 0))
    batch_launches = _counted(counters, bex.device)
    jobs = [_combine_job(qid, "user_events", ctxs[qid], segs, len(segs),
                         USER_PATH[qid][0],
                         lambda t, qid=qid: usertable.check_rows(
                             qid, t.rows, wants[qid]),
                         last[qid], per_query[qid]["p50_ms"])
            for qid in ctxs if qid not in USER_BATCH]
    if batch_launches is not None:
        expect = {name: 0 for name in counters}
        expect["sharded_fused_scan"] = reps * len(USER_BATCH)
        if batch_launches != expect or _counted(counters,
                                                bex.device) != expect:
            raise AssertionError(f"batch launch counts {batch_launches} != "
                                 f"{expect}")
    log(f"  batch: launches {batch_launches}; U1, U2 == numpy oracle "
        "(U3-U7 over the batch: phase 11a)")
    batch_per_query = _latencies(batch_lat, rows, beside=per_query)
    raw_fused = {name: by_query.get(USER_RAW_FUSED, 0)
                 for name, by_query in fused.items()}
    if ex.device.type == "cuda" and raw_fused != {
            "fused_scan": len(segs) * reps, "sharded_fused_scan": reps}:
        raise AssertionError(f"{USER_RAW_FUSED}: fused launches {raw_fused}")
    log(f"  fused launches reading the raw latency_ms ({USER_RAW_FUSED}): "
        f"{raw_fused}")
    timing = []
    if ex.device.type == "cuda":
        fused_sqls = {qid: sqls[qid] for qid in USER_BATCH}
        log("  U1, U2 kernel against plain version and timings: segment 0, "
            "then the batch")
        # every segment is kept (the per-segment launches above): segment
        # 0 and the batch of all are the paths' shapes
        seg0, batch = ex.stage(segs[0]), bex.batch_for(segs)[1]
        timing = (_time_kernels({q: (seg0, segs[0].num_docs, sql)
                                 for q, sql in fused_sqls.items()}, errs, 20)
                  + _time_kernels({q: (batch, rows, sql)
                                   for q, sql in fused_sqls.items()},
                                  errs, 20))
    return {"rows": rows, "segments": len(segs), "user": user,
            "per_query": per_query, "batch_per_query": batch_per_query,
            "paths": rungs, "launches": launches,
            "batch_launches": batch_launches, "raw_fused_launches": raw_fused,
            "timing": timing, "segs": segs, "host_wants": host_wants,
            "frames": frames, "users": users, "combine_jobs": jobs}


def _columns_segment(n: int, seed: int, valid_doc_ids=None):
    """(segment, its arrays): a nullable STRING dictionary column ``dim``
    (null rows hold the default "null"), a nullable raw LONG ``rawm``
    (null rows hold 0), an INT multi-value dictionary column ``nums`` (1-4
    values a row) and an INT ``grp``; an upsert-managed segment when
    ``valid_doc_ids`` is given."""
    from pinot_tpu_torch.segment import ColumnArrays, segment_from_arrays
    from pinot_tpu_torch.spi import DataType, FieldType

    rng = np.random.default_rng(seed)
    D, M = FieldType.DIMENSION, FieldType.METRIC
    dim_null = rng.random(n) < 0.1
    dim = np.array(["d0", "d1", "d2", "d3", "d4", "d5"])[
        rng.integers(0, 6, n)]
    dim[dim_null] = "null"
    raw_null = rng.random(n) < 0.07
    rawm = np.where(raw_null, 0, rng.integers(-1000, 100_000, n))
    counts = rng.integers(1, 5, n).astype(np.int32)
    nums = rng.integers(0, 1000, (n, 4)).astype(np.int64)
    entry = np.arange(4)[None, :] < counts[:, None]
    uniq, inv = np.unique(nums[entry], return_inverse=True)
    ids = np.zeros((n, 4), dtype=np.int32)
    ids[entry] = inv.reshape(-1)
    d_uniq, d_ids = np.unique(dim, return_inverse=True)
    g_uniq, g_ids = np.unique(rng.integers(0, 50, n), return_inverse=True)
    seg = segment_from_arrays(
        "columns_0" if valid_doc_ids is None else "columns_upsert", n, {
            "dim": ColumnArrays(DataType.STRING, D, d_uniq,
                                d_ids.reshape(-1), null=dim_null),
            "rawm": ColumnArrays(DataType.LONG, M, values=rawm,
                                 null=raw_null),
            "nums": ColumnArrays(DataType.INT, D, uniq, ids,
                                 mv_counts=counts),
            "grp": ColumnArrays(DataType.INT, D, g_uniq, g_ids.reshape(-1)),
        }, table_name="cols", valid_doc_ids=valid_doc_ids)
    return seg, {"dim": dim, "dim_null": dim_null, "rawm": rawm,
                 "raw_null": raw_null, "nums": nums, "counts": counts,
                 "entry": entry, "grp": g_uniq[g_ids]}


def _columns_answers(a: dict, live) -> dict:
    """numpy rows of phase 8b's queries over the arrays' ``live`` docs."""
    dim, rawm, grp = a["dim"], a["rawm"], a["grp"]
    out = {}
    m = a["dim_null"] & live
    out["N1"] = [[int(m.sum()), int(rawm[m].sum())]]
    m = ~a["raw_null"] & live
    out["N2"] = sorted([d, int((m & (dim == d)).sum()),
                        int(rawm[m & (dim == d)].sum()),
                        int(rawm[m & (dim == d)].min()),
                        int(rawm[m & (dim == d)].max())]
                       for d in np.unique(dim[m]).tolist())
    m = (dim == "d3") & live
    e = a["entry"] & m[:, None]
    vals = a["nums"][e]
    out["M1"] = [[int(e.sum()), int(vals.sum()), int(vals.min()),
                  int(vals.max()), float(vals.sum()) / int(e.sum())]]
    m = (grp < 20) & live
    out["V1"] = sorted([d, int((m & (dim == d)).sum()),
                        int(rawm[m & (dim == d)].sum())]
                       for d in np.unique(dim[m]).tolist())
    return out


# phase 8b's queries: (sql, the fused scan's decline code, the rung)
COLUMN_QUERIES = {
    "N1": ("SELECT count(*), sum(rawm) FROM cols WHERE dim IS NULL",
           "pallas_isnull", None),
    "N2": ("SELECT dim, count(*), sum(rawm), min(rawm), max(rawm) FROM cols "
           "WHERE rawm IS NOT NULL GROUP BY dim ORDER BY dim",
           "pallas_isnotnull", "dense"),
    "M1": ("SELECT countmv(nums), summv(nums), minmv(nums), maxmv(nums), "
           "avgmv(nums) FROM cols WHERE dim = 'd3'", "pallas_mv_aggregation",
           None),
    "V1": ("SELECT dim, count(*), sum(rawm) FROM cols WHERE grp < 20 "
           "GROUP BY dim ORDER BY dim", "pallas_validdocs", "dense"),
}


def phase_columns(seed: int, reps: int, n: int = 1_000_000,
                  device: str = "cuda") -> dict:
    """Null bitmaps (SV dictionary and raw), a numeric MV column's MV
    aggregations and an upsert valid-doc mask on one segment of ``n`` docs,
    each query ``reps`` times on the general rung against numpy; V1 runs
    on the upsert-managed copy (a random 60% of docs live), then again
    after 1000 more docs are invalidated."""
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools.usertable import check_rows

    rng = np.random.default_rng(seed + 1)
    valid = rng.random(n) < 0.6
    seg, arrays = _columns_segment(n, seed)
    useg, _ = _columns_segment(n, seed, valid_doc_ids=valid.copy())
    wants = _columns_answers(arrays, np.ones(n, dtype=bool))
    wants["V1"] = _columns_answers(arrays, valid)["V1"]
    path = {qid: (code, rung) for qid, (_, code, rung)
            in COLUMN_QUERIES.items()}
    ex = ServerQueryExecutor(device=device)
    lat = {}
    for qid, (sql, _, _) in COLUMN_QUERIES.items():
        on = [useg if qid == "V1" else seg]
        ctx = compile_query(sql)
        ex.execute(ctx, on)     # untimed: stages and plans

        def check(table, stats, qid=qid, ctx=ctx):
            check_rows(qid, table.rows, wants[qid])
            _check_user_path(qid, stats, 1, path,
                             1 if ctx.filter is not None else 0)
        lat[qid] = _timed(ex, ctx, on, reps, check)
    # the snapshot follows the bitmap: invalidate 1000 live docs
    gone = np.nonzero(useg.valid_doc_ids)[0][:1000]
    useg.valid_doc_ids[gone] = False
    valid[gone] = False
    want = _columns_answers(arrays, valid)["V1"]
    table, _ = ex.execute(compile_query(COLUMN_QUERIES["V1"][0]), [useg])
    check_rows("V1", table.rows, want)
    log(f"  8b: IS NULL / IS NOT NULL (SV dictionary and raw), the MV "
        f"aggregations, the upsert mask ({int(valid.sum())} live docs after "
        "1000 invalidated) == numpy, each on the general rung")
    return {"docs": n, "per_query": _latencies(lat, n),
            "paths": {q: {"decline": c, "rung": r}
                      for q, (c, r) in path.items()}}


# -- phase 9: the SQL slice (patterns, time transforms, text and JSON) -------

# per SSB query of phase 9a: the fused scan's decline code on every kept
# segment (None: it serves them) and the rung of each kept segment (None:
# scalar)
SQL_PATH = {"S1": (None, "dense"), "S2": (None, "dense"),
            "S3": (None, "dense"), "S4": ("pallas_lut_too_many_runs", "dense"),
            "S5": (None, "dense"), "S6": (None, None), "S7": (None, "dense")}
# the fused scans whose kernel is held against its plain version and timed
SQL_TIMED = ("S1", "S2", "S3", "S5", "S7")


def _lut_runs(plan) -> list:
    """dictId runs of each lut / mv_lut leaf of a plan's filter."""
    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.engine.plan import _FILTER_PARAMS

    runs, slot = [], 0

    def walk(node):
        nonlocal slot
        if node[0] in ("and", "or", "not"):
            for c in node[1]:
                walk(c)
            return
        if node[0] in ("lut", "mv_lut"):
            runs.append(len(fs._lut_runs(plan.params[slot], 1 << 30)))
        slot += _FILTER_PARAMS[node[0]]
    walk(plan.spec[0])
    return runs


def _check_sql_rows(sid: str, table, want) -> None:
    if isinstance(want, list):
        if table.rows != want:
            raise AssertionError(f"{sid}: {table.rows} != {want}")
        return
    _check_flight(sid, table, want)


def _path_launches(counters: dict, device, expect: dict, what: str):
    """The counters after a run, held to ``expect`` on the card (None on
    the CPU, where the wrappers run the plain versions)."""
    launches = _counted(counters, device)
    if launches is not None:
        want = {name: 0 for name in counters}
        want.update(expect)
        if launches != want:
            raise AssertionError(f"{what}: launch counts {launches} != "
                                 f"{want}")
    return launches


def _add(total: dict, launches) -> None:
    for k, v in (launches or {}).items():
        total[k] = total.get(k, 0) + v


def phase_sql(segs, sqls: dict, wants: dict, kept: dict, ex, bex,
              reps: int, errs: dict = None, q33_rows=None) -> dict:
    """9a: S1-S7 (``tools/ssb.py`` ``sql_queries``) ``reps`` times per
    segment through ``ex`` and over the batch through ``bex``, each held
    against the numpy oracle, with its decline code, rung and launches per
    path asserted from the segments the pruner keeps (a query the fused
    scan declines runs over the batch in phase 11a, from the
    ``combine_jobs`` returned); S2's rows equal Q3.3's (``q33_rows``). On
    the card the fused queries' kernels are then held against the plain
    version and timed at segment 0 and the batch."""
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.engine.plan import plan_segment
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.query import compile_query

    counters = {**scan_counters(), "general_rung": kernels.RUNG_COUNTER}
    rows = sum(s.num_docs for s in segs)
    per, batch, paths, last, jobs = {}, {}, {}, {}, []
    launches = {"per_segment": {}, "batch": {}}
    for sid, sql in sqls.items():
        ctx = compile_query(sql)
        code, rung = SQL_PATH[sid]
        k = len(kept[sid])
        runs = _lut_runs(plan_segment(ctx, kept[sid][0]))
        ex.execute(ctx, segs)       # untimed: stages and plans

        def check(table, stats, sid=sid, code=code, rung=rung, k=k,
                  ctx=ctx):
            _check_sql_rows(sid, table, wants[sid])
            last[sid] = table.rows
            want = {_decline_key(code): k} if code else {}
            if _scan_decisions(stats, k if ctx.filter else 0, sid) != want:
                raise AssertionError(f"{sid}: decisions {stats.decisions}")
            if stats.rung_segments != ({rung: k} if rung else {}):
                raise AssertionError(f"{sid}: rungs {stats.rung_segments}")
            if sid == "S6" and (stats.num_docs_scanned, stats.total_docs) \
                    != (0, rows):
                raise AssertionError(f"S6: {stats.num_docs_scanned} docs "
                                     "scanned: no metadata answer")
        _reset(counters)
        per[sid] = _timed(ex, ctx, segs, reps, check)
        fused = 0 if code or sid == "S6" else k * reps
        _add(launches["per_segment"], _path_launches(counters, ex.device, {
            "fused_scan": fused, "general_rung": k * reps if code else 0},
            f"{sid} per segment"))
        paths[sid] = {"kept_segments": k, "lut_runs": runs,
                      "decline": code, "rung": rung}
        if code:
            jobs.append(_combine_job(
                sid, "ssb", ctx, segs, k, code,
                lambda t, sid=sid: _check_sql_rows(sid, t, wants[sid]),
                last[sid], float(np.percentile(per[sid], 50))))
        else:
            bex.execute(ctx, segs)  # untimed: stages the batch and binds

            def bcheck(table, stats, sid=sid, k=k, ctx=ctx):
                _check_sql_rows(sid, table, wants[sid])
                if _scan_decisions(stats, 1 if k == 1 and ctx.filter else 0,
                                   f"batch {sid}"):
                    raise AssertionError(f"batch {sid}: {stats.decisions}")
                if sid == "S6" and stats.num_docs_scanned != rows:
                    raise AssertionError("S6: the batch path scans")
            _reset(counters)
            batch[sid] = _timed(bex, ctx, segs, reps, bcheck)
            _add(launches["batch"], _path_launches(counters, bex.device, {
                "sharded_fused_scan": reps if k > 1 else 0,
                "fused_scan": reps if k == 1 else 0}, f"{sid} batch"))
        log(f"  9a {sid}: {k} of {len(segs)} segments kept, lut runs "
            f"{runs}, decline {code}, rung {rung}; == numpy oracle"
            + ("; over the batch in phase 11a" if code else ""))
    if q33_rows is not None:
        got, _ = ex.execute(compile_query(sqls["S2"]), segs)
        if sorted(map(tuple, got.rows)) != sorted(map(tuple, q33_rows)):
            raise AssertionError("S2's rows differ from Q3.3's")
        log("  9a S2's rows == Q3.3's")
    out = {"per_query": _latencies(per, rows), "paths": paths,
           "launches": launches, "timing": [], "combine_jobs": jobs}
    out["batch_per_query"] = _latencies(batch, rows,
                                        beside=out["per_query"])
    if ex.device.type == "cuda" and errs is not None:
        log("  9a kernels against plain version and timings at the paths' "
            "shapes: the first kept segment, then the batch of the kept "
            "segments")
        staged = bex.batches_staged
        out["timing"] = (
            _time_kernels({sid: (ex.stage(kept[sid][0]),
                                 kept[sid][0].num_docs, sqls[sid])
                           for sid in SQL_TIMED}, errs, 20)
            + _time_kernels({sid: (bex.batch_for(kept[sid])[1],
                                   sum(s.num_docs for s in kept[sid]),
                                   sqls[sid])
                             for sid in SQL_TIMED if len(kept[sid]) > 1},
                            errs, 20))
        if bex.batches_staged != staged:
            raise AssertionError("9a: a batch was staged for the timings")
    return out


DAY_MS = 86_400_000
# a UTC midnight: the events table's first millisecond
EVENTS_T0 = 1_700_006_400_000
COUNTRIES = ["AR", "BR", "CN", "DE", "FR", "GB", "IN", "JP", "MX", "US"]
EVENT_TYPES = ["click", "purchase", "scroll", "share", "view"]


def _events_table(seed: int, segments: int, rows_per_segment: int):
    """(segments, arrays): ``segments`` time-ordered segments over 28 days
    of events, each a contiguous window, as a realtime table seals them;
    ``ts`` raw (no dictionary) epoch milliseconds."""
    from pinot_tpu_torch.segment import ColumnArrays, segment_from_arrays
    from pinot_tpu_torch.spi import DataType, FieldType

    rng = np.random.default_rng(seed + 9)
    window = 28 * DAY_MS // segments
    D, M = FieldType.DIMENSION, FieldType.METRIC
    segs, arrays = [], []
    for i in range(segments):
        n = rows_per_segment
        ts = np.sort(EVENTS_T0 + i * window + rng.integers(0, window, n))
        country = rng.integers(0, len(COUNTRIES), n)
        etype = rng.integers(0, len(EVENT_TYPES), n)
        revenue = rng.integers(0, 500, n)
        r_uniq, r_ids = np.unique(revenue, return_inverse=True)
        segs.append(segment_from_arrays(f"events_{i}", n, {
            "ts": ColumnArrays(DataType.LONG, D, values=ts),
            "country": ColumnArrays(DataType.STRING, D,
                                    np.array(COUNTRIES), country),
            "event_type": ColumnArrays(DataType.STRING, D,
                                       np.array(EVENT_TYPES), etype),
            "revenue": ColumnArrays(DataType.INT, M, r_uniq,
                                    r_ids.reshape(-1)),
        }, table_name="events"))
        arrays.append({"ts": ts, "country": country, "revenue": revenue})
    return segs, {k: np.concatenate([a[k] for a in arrays])
                  for k in arrays[0]}


def _time_queries(lo: int, hi: int) -> dict:
    return {
        # dateTrunc's key spans the milliseconds: the JAX planner sends it
        # to its host engine, and so does the port, with the same code
        "T1": "SELECT dateTrunc('DAY', ts), count(*), sum(revenue) "
              "FROM events GROUP BY dateTrunc('DAY', ts)",
        "T1b": "SELECT toEpochDays(ts), min(dateTrunc('DAY', ts)), "
               "count(*), sum(revenue) FROM events GROUP BY toEpochDays(ts) "
               "ORDER BY toEpochDays(ts) LIMIT 100",
        "T2": "SELECT toEpochHours(ts), country, count(*), sum(revenue) "
              "FROM events GROUP BY toEpochHours(ts), country LIMIT 100000",
        "T3": "SELECT toEpochDays(ts), count(*), sum(revenue) FROM events "
              f"WHERE ts BETWEEN {lo} AND {hi} "
              "GROUP BY toEpochDays(ts) ORDER BY toEpochDays(ts)",
        "T4": "SELECT sum(timeConvert(ts, 'MILLISECONDS', 'SECONDS')), "
              "count(*) FROM events",
    }


# per query: (the fused scan's decline code, the rung per segment) or, for
# a query the planner sends to the host engine, (its code, "host")
TIME_PATH = {"T1": ("group_expression_span_over_limit", "host"),
             "T1b": ("pallas_raw_group_key", "dense"),
             "T2": ("pallas_raw_group_key", "dense"),
             "T3": ("pallas_vrange", "dense"),
             "T4": ("pallas_agg_value_op_unsupported", None)}


def _grouped(keys: list, value: np.ndarray) -> list:
    """[key..., count, int sum of ``value``] per distinct key, sorted: the
    keys (small integer spans) composed row-major into one bin each."""
    bins = np.zeros(value.shape[0], dtype=np.int64)
    spans = []
    for k in keys:
        lo, hi = int(k.min()), int(k.max())
        spans.append((lo, hi - lo + 1))
        bins = bins * (hi - lo + 1) + (k - lo)
    size = int(np.prod([n for _, n in spans]))
    cnt = np.bincount(bins, minlength=size)
    # exact: every sum here stays far below 2^53
    sums = np.bincount(bins, weights=value.astype(np.float64),
                       minlength=size)
    out = []
    for b in np.nonzero(cnt)[0].tolist():
        row, rest = [], b
        for lo, n in reversed(spans):
            row.append(lo + rest % n)
            rest //= n
        out.append(row[::-1] + [int(cnt[b]), int(sums[b])])
    return out


def _time_answers(a: dict, lo: int, hi: int) -> dict:
    ts, rev = a["ts"], a["revenue"]
    days = ts // DAY_MS
    m = (ts >= lo) & (ts <= hi)
    return {
        # no ORDER BY: the first 10 days in the order segments meet them
        "T1": [[d * DAY_MS, c, float(s)]
               for d, c, s in _grouped([days], rev)][:10],
        "T1b": [[d, float(d * DAY_MS), c, float(s)]
                for d, c, s in _grouped([days], rev)],
        "T2": sorted([h, COUNTRIES[c], n, float(s)] for h, c, n, s in
                     _grouped([ts // 3_600_000, a["country"]], rev)),
        "T3": [[d, c, float(s)] for d, c, s in _grouped([days[m]], rev[m])],
        "T4": [[float((ts // 1000).sum()), int(ts.size)]],
    }


def phase_time(seed: int, reps: int, segments: int = 8,
               rows_per_segment: int = 2_500_000,
               device: str = "cuda") -> dict:
    """9b: time-bucket group-bys over ``segments`` x ``rows_per_segment``
    events, each query ``reps`` times per segment against numpy, with its
    decline code, rung and general-rung calls asserted (the fused scan
    declines floordiv / mod keys and values, as the JAX kernel does); those
    run over the batch in phase 11a (the ``combine_jobs`` returned). T1's
    key spans the milliseconds: the planner sends it to the host engine
    per segment, on both paths, with no launch."""
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.engine.pruner import prune_segments
    from pinot_tpu_torch.parallel import ShardedQueryExecutor
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools.usertable import check_rows

    t0 = time.perf_counter()
    segs, arrays = _events_table(seed, segments, rows_per_segment)
    lo = EVENTS_T0 + 10 * DAY_MS
    hi = lo + 2 * DAY_MS - 1
    sqls = _time_queries(lo, hi)
    wants = _time_answers(arrays, lo, hi)
    rows = sum(s.num_docs for s in segs)
    log(f"  9b: {rows} events in {len(segs)} segments of "
        f"{28 / len(segs):g} days each and the numpy oracle: "
        f"{time.perf_counter() - t0:.1f} s")
    counters = {**scan_counters(), "general_rung": kernels.RUNG_COUNTER}
    ex = ServerQueryExecutor(device=device)
    bex = ShardedQueryExecutor(device=device)
    lat, paths, total, last, jobs = {}, {}, {}, {}, []
    for tid, sql in sqls.items():
        ctx = compile_query(sql)
        code, rung = TIME_PATH[tid]
        if rung == "host":
            lat[tid], paths[tid] = _time_host_query(
                tid, ctx, segs, ex, bex, counters, reps, wants[tid], code)
            continue
        k = len(prune_segments(ctx, segs))
        # the pruner against the segments' own ts bounds: only T3 filters
        ts = arrays["ts"].reshape(len(segs), -1)
        want = (int(((ts.min(axis=1) <= hi) & (ts.max(axis=1) >= lo)).sum())
                if tid == "T3" else len(segs))
        if k != want:
            raise AssertionError(f"{tid}: the pruner keeps {k} segments, "
                                 f"the ts bounds {want}")
        ex.execute(ctx, segs)       # untimed: stages and plans

        def check(table, stats, tid=tid, code=code, rung=rung, k=k,
                  ctx=ctx):
            got = [list(r) for r in table.rows]
            check_rows(tid, sorted(got) if tid == "T2" else got, wants[tid])
            last[tid] = table.rows
            if _scan_decisions(stats, k if ctx.filter else 0, tid) \
                    != {_decline_key(code): k}:
                raise AssertionError(f"{tid}: decisions {stats.decisions}")
            if stats.rung_segments != ({rung: k} if rung else {}):
                raise AssertionError(f"{tid}: rungs {stats.rung_segments}")
        _reset(counters)
        lat[tid] = _timed(ex, ctx, segs, reps, check)
        _add(total, _path_launches(counters, ex.device,
                                   {"general_rung": k * reps}, tid))
        jobs.append(_combine_job(
            tid, "events", ctx, segs, k, code,
            lambda t, tid=tid: check_rows(
                tid, sorted(map(list, t.rows)) if tid == "T2"
                else [list(r) for r in t.rows], wants[tid]),
            last[tid], float(np.percentile(lat[tid], 50))))
        paths[tid] = {"kept_segments": k, "decline": code, "rung": rung}
        log(f"  9b {tid}: {k} of {len(segs)} segments kept, decline {code}, "
            f"rung {rung}; == numpy oracle; over the batch in phase 11a")
    return {"rows": rows, "per_query": _latencies(lat, rows),
            "paths": paths, "launches": total, "combine_jobs": jobs}


def _time_host_query(tid, ctx, segs, ex, bex, counters, reps, want,
                     code) -> tuple:
    """A 9b query the planner sends to the host engine: ``reps`` runs per
    segment against numpy, each segment's decision asserted and no launch
    made, then one run over the batch (which meets the same code and takes
    the per-segment path). -> (latencies, path)."""
    from pinot_tpu_torch.tools.usertable import check_rows

    key = f"plan:device_kernel->host_engine:{code}"

    def check(table, stats):
        check_rows(tid, [list(r) for r in table.rows], want)
        if stats.decisions != {key: len(segs)} \
                or stats.rung_segments != {"host": len(segs)}:
            raise AssertionError(f"{tid}: {stats.decisions}, rungs "
                                 f"{stats.rung_segments}")
    _reset(counters)
    ms = _timed(ex, ctx, segs, reps, check)
    _path_launches(counters, ex.device, {}, tid)
    table, stats = bex.execute(ctx, segs)
    check_rows(tid, [list(r) for r in table.rows], want)
    if stats.decisions.get(key) != len(segs):
        raise AssertionError(f"batch {tid}: {stats.decisions}")
    _path_launches(counters, ex.device, {}, f"batch {tid}")
    log(f"  9b {tid}: the host engine on all {len(segs)} segments "
        f"({code}), 0 launches, == numpy oracle, per segment and over the "
        "batch (host CPU time)")
    return ms, {"host_engine": code}


def _text_segment(seed: int, n: int, distinct: int = 4096):
    """(segment, arrays): ``title`` (3-8 words of a 200-word vocabulary)
    and ``attrs`` (JSON: os, ver, a tags array), ``distinct`` values each,
    ``kind`` (5 values) and ``v`` (0-999)."""
    import json

    from pinot_tpu_torch.segment import ColumnArrays, segment_from_arrays
    from pinot_tpu_torch.spi import DataType, FieldType

    rng = np.random.default_rng(seed + 11)
    vocab = [f"w{i:03d}" for i in range(200)]
    titles = set()
    while len(titles) < distinct:
        titles.add(" ".join(rng.choice(vocab, int(rng.integers(3, 9)))))
    attrs = set()
    while len(attrs) < distinct:
        attrs.add(json.dumps({
            "os": ["android", "ios", "web"][int(rng.integers(0, 3))],
            "ver": int(rng.integers(1, 40)),
            "tags": sorted({f"t{j}" for j in rng.integers(
                0, 8, int(rng.integers(0, 4)))})}))
    titles, attrs = np.array(sorted(titles)), np.array(sorted(attrs))
    t_ids = rng.integers(0, distinct, n)
    a_ids = rng.integers(0, distinct, n)
    kind = rng.integers(0, 5, n)
    v = rng.integers(0, 1000, n)
    D, M = FieldType.DIMENSION, FieldType.METRIC
    v_uniq, v_ids = np.unique(v, return_inverse=True)
    seg = segment_from_arrays("docs_0", n, {
        "title": ColumnArrays(DataType.STRING, D, titles, t_ids),
        "attrs": ColumnArrays(DataType.STRING, D, attrs, a_ids),
        "kind": ColumnArrays(DataType.STRING, D,
                             np.array(["k0", "k1", "k2", "k3", "k4"]), kind),
        "v": ColumnArrays(DataType.INT, M, v_uniq, v_ids.reshape(-1)),
    }, table_name="docs")
    return seg, {"titles": titles, "attrs": attrs, "t_ids": t_ids,
                 "a_ids": a_ids, "kind": kind, "v": v}


# the dialects of tests/test_text_index.py and tests/test_json_range_index.py
TEXT_QUERIES = {
    "X1": "SELECT count(*), sum(v) FROM docs "
          "WHERE TEXT_MATCH(title, 'w007 AND w042')",
    "X2": "SELECT kind, count(*) FROM docs "
          "WHERE TEXT_MATCH(title, '\"w001 w002\" OR w19*') "
          "GROUP BY kind ORDER BY kind",
    "X3": "SELECT kind, sum(v) FROM docs WHERE JSON_MATCH(attrs, "
          "'\"$.os\" = ''ios'' AND \"$.tags[*]\" = ''t3''') "
          "GROUP BY kind ORDER BY kind",
}


def _text_luts(a: dict) -> dict:
    """Per query, which distinct values match, written out directly:
    whole-word sets, the adjacent pair, the prefix, parsed JSON."""
    import json

    words = [t.split() for t in a["titles"]]
    docs = [json.loads(s) for s in a["attrs"]]
    return {
        "X1": np.array([{"w007", "w042"} <= set(w) for w in words]),
        "X2": np.array([any(w[i:i + 2] == ["w001", "w002"]
                            for i in range(len(w) - 1))
                        or any(x.startswith("w19") for x in w)
                        for w in words]),
        "X3": np.array([d["os"] == "ios" and "t3" in d["tags"]
                        for d in docs]),
    }


def phase_text(seed: int, reps: int, n: int = 1_000_000,
               device: str = "cuda") -> dict:
    """9c: TEXT_MATCH and JSON_MATCH on one ``n``-doc segment, each query
    ``reps`` times against numpy; its lookup table's runs decide the path
    (up to 64 runs the fused scan, more the general rung)."""
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.engine.fused_scan import DEFAULT_LUT_RUN_CAP
    from pinot_tpu_torch.engine.fused_scan import _lut_runs as runs_of
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools.usertable import check_rows

    seg, a = _text_segment(seed, n)
    luts = _text_luts(a)
    kinds = ["k0", "k1", "k2", "k3", "k4"]
    m1 = luts["X1"][a["t_ids"]]
    m2 = luts["X2"][a["t_ids"]]
    m3 = luts["X3"][a["a_ids"]]
    wants = {
        "X1": [[int(m1.sum()), float(a["v"][m1].sum())]],
        "X2": [[kinds[k], int((m2 & (a["kind"] == k)).sum())]
               for k in range(5) if (m2 & (a["kind"] == k)).any()],
        "X3": [[kinds[k], float(a["v"][m3 & (a["kind"] == k)].sum())]
               for k in range(5) if (m3 & (a["kind"] == k)).any()],
    }
    counters = {**scan_counters(), "general_rung": kernels.RUNG_COUNTER}
    ex = ServerQueryExecutor(device=device)
    lat, paths, total = {}, {}, {}
    for xid, sql in TEXT_QUERIES.items():
        ctx = compile_query(sql)
        runs = len(runs_of(luts[xid], 1 << 30))
        code = ("pallas_lut_too_many_runs" if runs > DEFAULT_LUT_RUN_CAP
                else None)
        rung = None if xid == "X1" else "dense"
        ex.execute(ctx, [seg])      # untimed: stages and plans

        def check(table, stats, xid=xid, code=code, rung=rung):
            check_rows(xid, table.rows, wants[xid])
            if _scan_decisions(stats, 1, xid) != (
                    {_decline_key(code): 1} if code else {}):
                raise AssertionError(f"{xid}: decisions {stats.decisions}")
            if stats.rung_segments != ({rung: 1} if rung else {}):
                raise AssertionError(f"{xid}: rungs {stats.rung_segments}")
        _reset(counters)
        lat[xid] = _timed(ex, ctx, [seg], reps, check)
        _add(total, _path_launches(counters, ex.device, {
            "general_rung" if code else "fused_scan": reps}, xid))
        paths[xid] = {"lut_runs": runs, "decline": code, "rung": rung}
        log(f"  9c {xid}: lookup table of {int(luts[xid].sum())} values in "
            f"{runs} runs, decline {code}, rung {rung}; == numpy oracle")
    return {"docs": n, "per_query": _latencies(lat, n), "paths": paths,
            "launches": total}


# -- phase 10: the host engine and the device top-k ---------------------------

_HOST = "plan:device_kernel->host_engine:"
# per query: the path ("host": the host engine; "topk": the device top-k
# on every kept segment), the decision recorded and how often ("segment":
# once per kept segment; "query": once)
HOST_PATH = {
    "H1": ("host", _HOST + "agg_not_device_supported", "segment"),
    "H2": ("host", _HOST + "agg_not_device_supported", "segment"),
    "H3": ("host", _HOST + "agg_not_device_supported", "segment"),
    "H4": ("host", _HOST + "distinct_host_only", "query"),
    "H5": ("host", None, None),
    "H6": ("topk", None, None),
    "H7": ("host", "selection:device_topk->host_engine:"
                   "selection_not_device_eligible", "query"),
    "U8": ("topk", None, None),
    "U9": ("host", _HOST + "group_virtual_column", "segment"),
    "U10": ("host", _HOST + "agg_not_device_supported", "segment"),
}


def _filter_columns(spec, out: set) -> set:
    """The columns a compiled filter reads."""
    if spec[0] in ("and", "or", "not"):
        for c in spec[1]:
            _filter_columns(c, out)
    elif len(spec) > 1 and isinstance(spec[1], str):
        out.add(spec[1])
    return out


def _profile_calls(fn, iters: int):
    """(device ms per call, CUDA kernels per call) of ``fn`` from a
    ``torch.profiler`` trace, or (None, None) when the trace holds no
    device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None, None
    kernels = [e for e in events
               if not e.name.startswith(("Memcpy", "Memset"))]
    return (sum(e.time_range.elapsed_us() for e in events) / iters / 1e3,
            len(kernels) / iters)


def _time_topk(ctx, kept, ex, iters: int = 20) -> dict:
    """The top-k's segment call at its path's shape (the kept segment with
    the most matching docs): held to the host engine's order of the same
    docs, then timed beside its byte bound (the filter's columns on every
    doc, the order keys, the doc ids out, at 3.35 TB/s)."""
    from pinot_tpu_torch.engine import host_engine
    from pinot_tpu_torch.engine import selection_device as sd

    calls = [sd.topk_args(ctx, seg, ex,
                          sd.segment_plan(ctx, seg, ex.selection_cache))
             for seg in kept]
    outs = [sd.topk_docs(*args).cpu().numpy() for args in calls]
    i = int(np.argmax([out[-1] for out in outs]))
    seg, args, got = kept[i], calls[i], outs[i]
    del calls, outs
    spec, cols, _params, _n, cap, keys, _asc, k = args[:8]
    want = host_engine.execute_selection(ctx, [seg])
    n = int(got[-1])
    docs = got[:min(n, k)]
    rows = host_engine._gather_rows(
        [seg], host_engine._expand_select(ctx, seg.metadata.schema),
        np.zeros(len(docs), dtype=np.int64), docs)
    need = ctx.offset + ctx.limit
    if rows[ctx.offset:need] != want.rows:
        raise AssertionError(f"top-k on {seg.segment_name}: rows differ "
                             "from the host engine's")
    nbytes = (sum(cols.fwd(c).numel() * cols.fwd(c).element_size()
                  for c in _filter_columns(spec, set()))
              + sum(t.numel() * t.element_size() for t in keys)
              + 8 * (k + 1))
    ms = _time_ms(lambda: sd.topk_docs(*args), iters)
    device_ms, kernels = _profile_calls(lambda: sd.topk_docs(*args), iters)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"segment": seg.segment_name, "docs": seg.num_docs,
            "capacity": cap, "k": k, "matched": n, "bytes": nbytes,
            "ms": ms, "device_ms": device_ms, "cuda_kernels": kernels,
            "bound_ms": bound}


def phase_host(main: dict, users: dict, bex, reps: int,
               card: str = "") -> dict:
    """H1-H7 (``tools/ssb.py`` ``host_queries``) on phase 4's segments and
    U8-U10 (``tools/usertable.py``) on phase 8's, each ``reps`` times per
    segment through ``main["ex"]`` after one untimed run, against the
    numpy oracle, with its decisions and launches asserted: 0 fused-scan
    and general-rung launches, top-k calls on every kept segment of H6
    and U8 only. H6 and U8 also equal the host engine's
    ``execute_selection`` on the same segments (the top-k's plain
    version), and H6 runs through the batch executor too; each top-k is
    then timed on the kept segment with the most matches beside its
    bound, on ``card`` (its name and power limit). Host-engine times are
    host CPU time on the card's machine."""
    from pinot_tpu_torch.engine import host_engine, kernels
    from pinot_tpu_torch.engine.pruner import prune_segments
    from pinot_tpu_torch.engine.selection_device import TOPK_COUNTER
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb, usertable

    ex = main["ex"]
    user_segs = users["segs"]
    user = users["user"]
    queries = {qid: (sql, main["segs"], main["host_kept"][qid],
                     main["host_wants"][qid])
               for qid, sql in main["host_texts"].items()}
    for qid, sql in usertable.host_queries(user).items():
        ctx = compile_query(sql)
        queries[qid] = (sql, user_segs, prune_segments(ctx, user_segs),
                        users["host_wants"][qid])
    counters = {**scan_counters(), "general_rung": kernels.RUNG_COUNTER}
    lat, paths, topk = {}, {}, []
    for qid, (sql, segs, kept, want) in queries.items():
        ctx = compile_query(sql)
        path, key, per = HOST_PATH[qid]
        k = len(kept)
        expect = ({} if key is None
                  else {key: k if per == "segment" else 1})

        # a filtered aggregation meets the index rung on each kept segment
        aggregated = not (ctx.is_selection or ctx.distinct)
        indexed = k if aggregated and ctx.filter is not None else 0

        def check(table, stats, qid=qid, want=want, expect=expect,
                  on_card=path == "topk", k=k, indexed=indexed):
            if qid.startswith("H"):
                ssb.check_host_rows(qid, table.rows, want)
            elif [list(r) for r in table.rows] != want:
                raise AssertionError(f"{qid}: rows differ from the oracle")
            if _scan_decisions(stats, indexed, qid) != expect:
                raise AssertionError(f"{qid}: decisions {stats.decisions}")
            if stats.topk_launches != (k if on_card else 0) \
                    or stats.scan_launches or stats.general_launches:
                raise AssertionError(f"{qid}: top-k {stats.topk_launches}, "
                                     f"scans {stats.scan_launches}, general "
                                     f"{stats.general_launches}")
        table, stats = ex.execute(ctx, segs)    # untimed: stages the keys
        check(table, stats)
        _reset(counters)
        TOPK_COUNTER.reset()
        lat[qid] = _timed(ex, ctx, segs, reps, check)
        _path_launches(counters, ex.device, {}, qid)
        if TOPK_COUNTER.launches != (k * reps if path == "topk" else 0):
            raise AssertionError(f"{qid}: {TOPK_COUNTER.launches} top-k "
                                 "calls")
        paths[qid] = {"path": path, "decision": key, "kept_segments": k,
                      "topk_calls": TOPK_COUNTER.launches}
        where = ("the device top-k" if path == "topk"
                 else "the host engine (host CPU time)")
        log(f"  10 {qid}: {k} of {len(segs)} segments kept, {where}, "
            f"decisions {stats.decisions}, 0 fused or general launches; "
            "== numpy oracle")
        if path == "topk":
            plain = host_engine.execute_selection(ctx, kept)
            if [list(r) for r in plain.rows] != [list(r)
                                                for r in table.rows]:
                raise AssertionError(f"{qid}: the top-k's rows differ from "
                                     "the host engine's")
            if qid == "H6":
                btable, bstats = bex.execute(ctx, segs)
                if btable.rows != table.rows or bstats.topk_launches != k:
                    raise AssertionError("H6 over the batch executor")
            if ex.device.type != "cuda":
                continue
            row = {"query": qid, **_time_topk(ctx, kept, ex)}
            topk.append(row)
            log(f"  10 {qid} top-k == host engine's execute_selection, "
                f"ties included; on {row['segment']} ({row['docs']} docs, "
                f"k {row['k']}, {row['matched']} matched): "
                f"{row['ms']:.4f} ms/call (CUDA events), device "
                f"{row['device_ms']} ms in {row['cuda_kernels']} CUDA "
                f"kernels/call (torch.profiler), bound "
                f"{row['bound_ms']:.4f} ms ({row['bytes']} B); {card}")
    per_query = _latencies({q: v for q, v in lat.items()
                            if q.startswith("H")},
                           sum(s.num_docs for s in main["segs"]))
    per_query.update(_latencies({q: v for q, v in lat.items()
                                 if q.startswith("U")},
                                sum(s.num_docs for s in user_segs)))
    return {"per_query": per_query, "paths": paths, "topk": topk}


# -- phase 11: the jnp combine over a batch, and the index rung ---------------

_COMBINE_DECLINE = "pallas:pallas_combine->jnp_combine:"
_INDEX_SERVED = "index:scan->index_gather:index_served"


def _combine_job(name: str, table: str, ctx, segs, kept: int, code: str,
                 check, rows, per_segment_p50: float) -> dict:
    """A query the fused scan declines, for phase 11a: ``check(table)``
    holds its rows to the oracle, ``rows`` are the per-segment path's."""
    return {"name": name, "table": table, "ctx": ctx, "segs": segs,
            "kept": kept, "code": code, "check": check, "rows": rows,
            "per_segment_p50_ms": per_segment_p50}


def _tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if tree is not None else 0


def _dtoh_copies(fn):
    """Device-to-host copies of one call of ``fn`` (torch.profiler), or
    None when the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    return sum(1 for e in events if "DtoH" in e.name)


def phase_combine(jobs: list, reps: int, device: str = "cuda",
                  card: str = "") -> dict:
    """11a: every query earlier phases saw the fused scan decline, over
    the batch of the segments the pruner keeps through
    ShardedQueryExecutor: the decline recorded once at binding, one call
    of the jnp combine a query (``batch_general``) and no fused launch,
    rows equal to the oracle and to the per-segment path's; ``reps`` timed
    runs beside the per-segment p50. On the card, one combine call's
    device time and CUDA kernels (torch.profiler), its device-to-host
    copies per query, and its byte bound (every staged array it reads,
    its params and its packed output, once, at 3.35 TB/s), on ``card``.
    A query whose pruner keeps one segment runs per segment there."""
    import torch

    from pinot_tpu_torch.engine.kernels import output_layout
    from pinot_tpu_torch.parallel import ShardedQueryExecutor
    from pinot_tpu_torch.parallel.executor import (
        rung_counters,
        scan_counters,
    )

    counters = {**scan_counters(), **rung_counters()}
    out, launches = {}, {name: 0 for name in counters}
    tables = []
    for job in jobs:
        if job["table"] not in tables:
            tables.append(job["table"])
    for tname in tables:
        bex = ShardedQueryExecutor(device=device)
        for job in (j for j in jobs if j["table"] == tname):
            name, ctx, segs, k = (job["name"], job["ctx"], job["segs"],
                                  job["kept"])
            want_rows = sorted(map(tuple, job["rows"]))
            table, stats = bex.execute(ctx, segs)   # binds
            job["check"](table)
            index_segs = k if k == 1 and ctx.filter is not None else 0
            bound = _scan_decisions(stats, index_segs, f"11a {name}")
            want = ({_COMBINE_DECLINE + job["code"]: 1} if k > 1
                    else {_decline_key(job["code"]): 1})
            if bound != want:
                raise AssertionError(f"11a {name}: decisions {bound}")

            def check(t, st, name=name, k=k, index_segs=index_segs):
                job["check"](t)
                if sorted(map(tuple, t.rows)) != want_rows:
                    raise AssertionError(f"11a {name}: rows differ from "
                                         "the per-segment path's")
                if k > 1 and (st.batch_general_launches != 1
                              or _scan_decisions(st, 0, name)):
                    raise AssertionError(f"11a {name}: {st.decisions}, "
                                         f"{st.batch_general_launches} "
                                         "combine calls")
            _reset(counters)
            ms = _timed(bex, ctx, segs, reps, check)
            got = _counted(counters, bex.device)
            if got is not None:
                expect = {n: 0 for n in counters}
                expect["batch_general" if k > 1 else "general_rung"] = \
                    reps * (1 if k > 1 else k)
                if got != expect:
                    raise AssertionError(f"11a {name}: launches {got} != "
                                         f"{expect}")
                for n, v in got.items():
                    launches[n] += v
            row = {"table": tname, "kept_segments": k,
                   "decline": job["code"],
                   "p50_ms": float(np.percentile(ms, 50)),
                   "p99_ms": float(np.percentile(ms, 99)),
                   "per_segment_p50_ms": job["per_segment_p50_ms"],
                   "rung": stats.group_by_rung}
            if bex.device.type == "cuda" and k > 1:
                inp = next(reversed(bex._param_cache.values())).inputs
                row["device_ms"], row["cuda_kernels"] = _profile_calls(
                    inp.run, 10)
                row["dtoh_copies"] = _dtoh_copies(
                    lambda: bex.execute(ctx, segs))
                if (row["dtoh_copies"] or 0) > 2:
                    raise AssertionError(f"11a {name}: "
                                         f"{row['dtoh_copies']} copies")
                row["bytes"] = (_tensor_bytes(inp.cols)
                                + _tensor_bytes(inp.params)
                                + 8 * sum(n for _, n in output_layout(
                                    inp.plan.spec, inp.num_docs.shape[0])))
                row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
            out[name] = row
            log(f"  11a {name}: {k} kept segments, "
                + (f"one jnp-combine call over the batch (rung "
                   f"{row['rung']})" if k > 1 else "per segment")
                + f"; p50 {row['p50_ms']:.3f} ms  p99 {row['p99_ms']:.3f} ms "
                f"(per segment p50 {row['per_segment_p50_ms']:.3f} ms); "
                "== numpy oracle and the per-segment rows"
                + (f"; one call: device {row['device_ms']} ms in "
                   f"{row['cuda_kernels']} CUDA kernels (torch.profiler), "
                   f"{row['dtoh_copies']} device-to-host copies a query, "
                   f"bound {row['bound_ms']:.4f} ms ({row['bytes']} B); "
                   f"{card}" if "bound_ms" in row else ""))
        del bex
        if device == "cuda":
            torch.cuda.empty_cache()
    return {"queries": out, "launches": launches}


def phase_index(users: dict, reps: int, device: str = "cuda",
                card: str = "") -> dict:
    """11b: phase 8's rows built a second time with
    ``usertable.user_indexing_config()`` (inverted user_id, country,
    event_type, tags; a range index on latency_ms), and I1-I5 of
    ``usertable.index_queries`` per segment (ServerQueryExecutor) and
    through ShardedQueryExecutor, each on the index rung on every kept
    segment (``index_served`` once per segment, one gather a segment, no
    scan), equal to the numpy oracle and to the same SQL with
    ``OPTION(useIndexRung=false)`` (the scan rungs); ``reps`` timed runs of
    all three. On the card, the gather call of the kept segment with the
    most matches: device time and CUDA kernels (torch.profiler) beside its
    byte bound (the docIds, the gathered rows of every column it reads,
    the dictionaries, the packed output), on ``card``."""
    from pinot_tpu_torch.engine import index_exec
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.engine.kernels import output_layout
    from pinot_tpu_torch.engine.pruner import prune_segments
    from pinot_tpu_torch.parallel import ShardedQueryExecutor
    from pinot_tpu_torch.parallel.executor import (
        rung_counters,
        scan_counters,
    )
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.segment import columns_of, segment_from_arrays
    from pinot_tpu_torch.tools import usertable

    t0 = time.perf_counter()
    cfg = usertable.user_indexing_config()
    segs = [segment_from_arrays(s.segment_name, s.num_docs, columns_of(s),
                                table_name="user_events", indexing=cfg)
            for s in users["segs"]]
    frames = users["frames"]
    tail = [users["user"]] + [u for u in users["users"] if u != users["user"]]
    absent = usertable.absent_user(frames)
    sqls = usertable.index_queries(tail, absent)
    wants = {qid: usertable.index_answer(frames, qid, tail, absent)
             for qid in sqls}
    log(f"  11b: phase 8's {sum(s.num_docs for s in segs)} rows in "
        f"{len(segs)} segments built again with their indexes and the "
        f"numpy oracle: {time.perf_counter() - t0:.1f} s; absent user "
        f"{absent}")
    counters = {**scan_counters(), **rung_counters()}
    ex = ServerQueryExecutor(device=device)
    bex = ShardedQueryExecutor(device=device)
    out, launches = {}, {name: 0 for name in counters}
    for qid, sql in sqls.items():
        ctx = compile_query(sql)
        scan_ctx = compile_query(sql + " OPTION(useIndexRung=false)")
        kept = prune_segments(ctx, segs)
        k = len(kept)
        scan_rows = None

        def check(table, stats, qid=qid, k=k):
            usertable.check_rows(qid, table.rows, wants[qid])
            if stats.decisions != {_INDEX_SERVED: k} \
                    or stats.index_launches != k:
                raise AssertionError(f"11b {qid}: {stats.decisions}, "
                                     f"{stats.index_launches} gathers")

        def scan_check(table, stats, qid=qid):
            nonlocal scan_rows
            usertable.check_rows(qid, table.rows, wants[qid])
            scan_rows = sorted(map(tuple, table.rows))
            if any(d.startswith("index:") for d in stats.decisions) \
                    or stats.index_launches:
                raise AssertionError(f"11b {qid} opted out: "
                                     f"{stats.decisions}")
        for e in (ex, bex):     # untimed: stages the columns and docIds
            check(*e.execute(ctx, segs))
        scan_check(*ex.execute(scan_ctx, segs))
        _reset(counters)
        lat = {"index": _timed(ex, ctx, segs, reps, check),
               "batch_executor": _timed(bex, ctx, segs, reps, check)}
        got = _counted(counters, ex.device)
        if got is not None:
            expect = {n: 0 for n in counters}
            expect["index_gather"] = 2 * reps * k
            if got != expect:
                raise AssertionError(f"11b {qid}: launches {got}")
            for n, v in got.items():
                launches[n] += v
        lat["scan"] = _timed(ex, scan_ctx, segs, reps, scan_check)
        table, _ = ex.execute(ctx, segs)
        if sorted(map(tuple, table.rows)) != scan_rows:
            raise AssertionError(f"11b {qid}: rows differ from the scan "
                                 "rungs'")
        row = {"kept_segments": k,
               **{f"{p}_p50_ms": float(np.percentile(v, 50))
                  for p, v in lat.items()},
               **{f"{p}_p99_ms": float(np.percentile(v, 99))
                  for p, v in lat.items()}}
        if ex.device.type == "cuda":
            preds = index_exec._flatten_and(ctx.filter)
            found = [(index_exec.resolve_doc_ids(
                s, preds, s.num_docs, s.num_docs), s) for s in kept]
            idx, seg = max(found, key=lambda f: f[0].size)
            plan, cols, idx_dev, params = index_exec.gather_inputs(
                ex, ctx, seg, idx)
            n = int(idx.size)

            def gather():
                return index_exec.index_gather(plan.spec, cols, idx_dev,
                                               params, n).cpu()
            row["gather_ms"] = _time_ms(gather, 20)
            row["device_ms"], row["cuda_kernels"] = _profile_calls(gather,
                                                                   10)
            rows_b = sum(t.element_size() * (t[0].numel() if t.dim() > 1
                                             else 1) * n
                         for tree in cols.values()
                         for key, t in tree.items() if key != "dictvals")
            dict_b = sum(t.numel() * t.element_size()
                         for tree in cols.values()
                         for key, t in tree.items() if key == "dictvals")
            out_b = 8 * sum(sz for _, sz in output_layout(plan.spec, 0))
            row.update({"segment": seg.segment_name, "matched": n,
                        "bytes": 4 * n + rows_b + dict_b + out_b})
            row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        out[qid] = row
        log(f"  11b {qid}: index rung on all {k} kept segments "
            f"(index_served x{k}), == numpy oracle == the scan rungs; p50 "
            f"{row['index_p50_ms']:.3f} ms per segment, "
            f"{row['batch_executor_p50_ms']:.3f} ms through the batch "
            f"executor, scan rungs {row['scan_p50_ms']:.3f} ms"
            + (f"; gather on {row['segment']} ({row['matched']} docs): "
               f"{row['gather_ms']:.4f} ms/call (CUDA events), device "
               f"{row['device_ms']} ms in {row['cuda_kernels']} CUDA "
               f"kernels/call (torch.profiler), bound "
               f"{row['bound_ms']:.3g} ms ({row['bytes']} B); {card}"
               if "bound_ms" in row else ""))
    return {"queries": out, "launches": launches}


# -- phase 13: residency, sliced execution, launch coalescing -----------------

_SLICED = ("residency:resident_device->sliced_device:"
           "working_set_over_budget_sliceable")
_SPILLED = "residency:device->host_engine:single_segment_over_budget"


def _budget_decisions(stats) -> dict:
    return {k: v for k, v in stats.decisions.items()
            if k.split(":")[0] in ("residency", "sharded_combine")}


def _promotion_rate(ex, segs, ctx, sync) -> dict:
    """Demote ``segs``' residents (staged with ``ctx``'s columns on an
    executor with room for them) to the host tier and bring them back: GB/s
    of each way, host clock around work that ends in ``sync``."""
    def touch(st):
        for name in ctx.referenced_columns():
            if st.packed_column(name) is None:
                st.column(name)
            st.value_column(name)

    for s in segs:
        touch(ex.stage(s))
    sync()
    nbytes = sum(ex.residency.resident_nbytes(s.segment_name) for s in segs)
    t0 = time.perf_counter()
    for s in segs:
        if not ex.residency.demote(s.segment_name):
            raise AssertionError(f"13a: {s.segment_name} did not demote")
    demote_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    promoted = 0
    for s in segs:
        st = ex.stage(s)
        touch(st)
        promoted += st.promoted_bytes
    sync()
    promote_s = time.perf_counter() - t0
    if promoted != nbytes:
        raise AssertionError(f"13a: promoted {promoted} of {nbytes} bytes")
    return {"bytes": nbytes, "demote_gb_s": nbytes / demote_s / 1e9,
            "promote_gb_s": nbytes / promote_s / 1e9}


def phase_budget(main: dict, batch_flights: dict, reps: int,
                 device: str = "cuda") -> dict:
    """13a: the 13 flights ``reps`` times through both executors under an
    HBM budget of about 40% of the largest working set admission
    estimates (and 1.25x the largest kept segment's estimate, so no
    segment spills): every answer equal to the oracle and to phase 4's
    rows; each query sliced exactly when its estimated working set is
    over the budget, never spilled; the staged bytes after each query
    within the budget; from the second pass on, every segment that comes
    back onto the device comes back by promotion. Then a budget under one
    segment sends Q1.2 to the host engine with single_segment_over_budget,
    rows equal to the oracle."""
    import torch

    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.engine.residency import estimate_segment_bytes
    from pinot_tpu_torch.parallel import ShardedQueryExecutor
    from pinot_tpu_torch.tools import ssb

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    segs, ctxs, kept_segs = main["segs"], main["ctxs"], main["kept_segs"]
    est = {q: sum(estimate_segment_bytes(s, ctx.referenced_columns())
                  for s in kept_segs[q]) for q, ctx in ctxs.items()}
    seg_max = max(estimate_segment_bytes(s, ctx.referenced_columns())
                  for q, ctx in ctxs.items() for s in kept_segs[q])
    budget = max(int(0.4 * max(est.values())), int(1.25 * seg_max))
    log(f"  budget {budget} B: 40% of the largest estimated working set "
        f"({max(est.values())} B, {max(est, key=est.get)}), the largest "
        f"kept segment {seg_max} B; over it: "
        f"{sorted(q for q in est if est[q] > budget)}")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out = {"budget_bytes": budget, "estimates": est, "executors": {}}
    for label, cls in (("per_segment", ServerQueryExecutor),
                       ("batch", ShardedQueryExecutor)):
        ex = cls(device=device, hbm_budget_bytes=budget)
        lat = {q: [] for q in ctxs}
        per_flight = {q: {"sliced": 0, "slices": 0, "demotions": 0,
                          "promotions": 0, "misses": 0} for q in ctxs}
        seen, built_new = set(), 0
        for p in range(reps):
            for qid, ctx in ctxs.items():
                cols = ctx.referenced_columns()
                ws, single, pinned = ex.residency.working_set(
                    kept_segs[qid], cols)
                t0 = time.perf_counter()
                table, stats = ex.execute(ctx, segs)
                sync()
                lat[qid].append((time.perf_counter() - t0) * 1e3)
                _check_flight(qid, table, main["wants"][qid])
                if table.rows != main["results"][qid].rows:
                    raise AssertionError(f"13a {label} {qid}: rows differ "
                                         "from phase 4's")
                dec = _budget_decisions(stats)
                over = ws + pinned > budget
                if dec.get(_SLICED, 0) != int(over) or _SPILLED in dec \
                        or stats.staging["spills"]:
                    raise AssertionError(
                        f"13a {label} {qid}: working set {ws} B (+{pinned} "
                        f"pinned) against {budget} B, decisions {dec}, "
                        f"staging {stats.staging}")
                staged = ex.residency.staged_bytes()
                if staged > budget:
                    raise AssertionError(f"13a {label} {qid}: {staged} B "
                                         f"staged past the budget")
                # a resident staged again after the first pass comes back
                # from the host tier; only one never staged before (a
                # batch of another slice's segments) is built
                st = stats.staging
                names = (set(ex.residency.resident_names())
                         | set(ex.residency.host_entry_names()))
                new = len(names - seen)
                seen |= names
                if p and st["misses"] != st["promotions"] + new:
                    raise AssertionError(
                        f"13a {label} {qid} pass {p + 1}: {st['misses']} "
                        f"residents staged, {st['promotions']} promoted, "
                        f"{new} new")
                built_new += new if p else 0
                row = per_flight[qid]
                row["sliced"] += int(over)
                for k in ("slices", "demotions", "promotions", "misses"):
                    row[k] += st[k]
        for qid, row in per_flight.items():
            row["p50_ms"] = float(np.percentile(lat[qid], 50))
            row["p99_ms"] = float(np.percentile(lat[qid], 99))
            row["unbudgeted_p50_ms"] = (batch_flights if label == "batch"
                                        else main["per_flight"])[qid][
                                            "p50_ms"]
            log(f"  13a {label} {qid}: sliced {row['sliced']}/{reps}, "
                f"{row['slices']} slices, {row['demotions']} demotions, "
                f"{row['promotions']} promotions; p50 {row['p50_ms']:.3f} ms "
                f"p99 {row['p99_ms']:.3f} ms (no budget: p50 "
                f"{row['unbudgeted_p50_ms']:.3f} ms)")
        snap = ex.residency.stats_snapshot()
        rec = {"flights": per_flight, "snapshot": snap,
               "new_residents_after_pass_1": built_new}
        if label == "per_segment":
            rec["transfer"] = _promotion_rate(
                ServerQueryExecutor(device=device), kept_segs["Q2.1"],
                ctxs["Q2.1"], sync)
            log(f"  13a promotion of Q2.1's {len(kept_segs['Q2.1'])} "
                f"segments ({rec['transfer']['bytes']} B): demote "
                f"{rec['transfer']['demote_gb_s']:.2f} GB/s, promote "
                f"{rec['transfer']['promote_gb_s']:.2f} GB/s (host clock)")
        else:
            rec["batches_staged"] = ex.batches_staged
            rec["batches_adopted"] = ex.batches_adopted
        log(f"  13a {label}: every answer == oracle == phase 4; staged "
            f"<= budget after each query; promotions {snap['promotions']}, "
            f"demotions {snap['demotions']}, sliced queries "
            f"{snap['slicedQueries']}, peak staged {snap['peakBytes']} B, "
            f"host tier peak {snap['hostPeakBytes']} B, residents new "
            f"after pass 1 (batches of other slices): {built_new}")
        out["executors"][label] = rec
        del ex
    if on_card:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"  13a torch.cuda.max_memory_allocated "
            f"{out['max_memory_allocated']} B (budget {budget} B)")

    qid = "Q1.2"
    small = estimate_segment_bytes(kept_segs[qid][0],
                                   ctxs[qid].referenced_columns()) // 2
    for cls in (ServerQueryExecutor, ShardedQueryExecutor):
        ex = cls(device=device, hbm_budget_bytes=small)
        t0 = time.perf_counter()
        table, stats = ex.execute(ctxs[qid], segs)
        ms = (time.perf_counter() - t0) * 1e3
        _check_flight(qid, table, main["wants"][qid])
        launched = (stats.scan_launches + stats.probe_launches
                    + stats.general_launches + stats.sharded_scan_launches
                    + stats.index_launches)
        if _budget_decisions(stats) != {_SPILLED: 1} or launched \
                or ex.residency.staged_bytes():
            raise AssertionError(f"13a {qid} at {small} B: "
                                 f"{stats.decisions}, {launched} launches")
        log(f"  13a {qid} under one segment ({small} B, {cls.__name__}): "
            f"host engine, {_SPILLED}, == numpy oracle, {ms:.1f} ms")
    out["spill"] = {"query": qid, "budget_bytes": small}
    return out


def _needed_bytes_many(progs, words, values, num_docs, tiles) -> int:
    """``_needed_bytes`` of one query-axis launch: each input byte read
    once for all its programs (a late column's sectors where a doc passes
    any program's filter), every program's outputs written."""
    import torch

    from pinot_tpu_torch.engine import fused_scan as fs

    masks = [fs.doc_masks(p, words, num_docs, values, tiles) for p in progs]
    valid = masks[0][0]
    matched = torch.stack([m for _, m in masks]).any(dim=0)
    early = set().union(*(p.early for p in progs))
    total = 0
    for c, w in enumerate(words):
        S, T, W = w.shape
        need = valid if c in early else matched
        per_word = need.view(S * T, fs.TILE // W, W).any(dim=1)
        total += SECTOR * _sectors(per_word, SECTOR // 4)
    for v in values:
        total += SECTOR * _sectors(matched, SECTOR // v.element_size())
    p = progs[0]
    outs = len(progs) * (p.G * (8 * (1 + p.n_isum + p.n_fsum) + 4 * p.n_mm)
                         + 8 * num_docs.numel())
    return total + 8 * num_docs.numel() + outs


def _query_axis_kernel(name: str, progs, words, values, num_docs, tiles,
                       iters: int = 20) -> dict:
    """The query-axis launch over ``progs`` at its path's shape: held to
    its plain version and to one solo launch a program (exact counts, int
    sums and min/max, floats rel 1e-9), then timed (CUDA events, one
    prepared launch enqueued back to back) beside Q solo launches of the
    one-query kernel, the plain version and its byte bound, and at the
    first 1, 2 and 4 of the programs (how the time grows with Q)."""
    import torch

    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.parallel import combine

    many = (combine.sharded_fused_scan_many if not progs[0].probe
            else lambda ps, w, v, nd, t: combine.sharded_fused_scan_probe_many(
                ps, w, nd))
    got = many(progs, words, values, num_docs, tiles)
    plain = combine.sharded_fused_scan_many_plain(progs, words, values,
                                                  num_docs, tiles)
    err = 0.0
    for q, (g, p) in enumerate(zip(got, plain)):
        err = max(err, _compare(g, p, f"13b {name} query {q} (plain)"))
        solo_argv, solo = fs.prepare_launch(progs[q], words, values,
                                            num_docs, tiles)
        fs.enqueue(solo_argv, torch.cuda.current_stream())
        err = max(err, _compare(g, solo, f"13b {name} query {q} (solo)"))
    stream = torch.cuda.current_stream()
    ms_by_q = {}
    for q in sorted({1, 2, 4, len(progs)}):
        argv, _ = fs.prepare_launch_many(progs[:q], words, values, num_docs,
                                         tiles)
        ms_by_q[q] = _time_ms(lambda: fs.enqueue(argv, stream, many=True),
                              iters)
    ms = ms_by_q[len(progs)]
    qg, groups = fs.query_group(progs[0], len(progs))
    lay = fs.scan_layout_many(progs[0], qg)
    grid = min(fs.launch_grid(lay.smem, many=True),
               int(num_docs.numel()) * tiles)
    solo_argvs = [fs.prepare_launch(p, words, values, num_docs, tiles)[0]
                  for p in progs]

    def solos():
        for a in solo_argvs:
            fs.enqueue(a, stream)
    solo_ms = _time_ms(solos, iters)
    plain_ms = _time_ms(lambda: combine.sharded_fused_scan_many_plain(
        progs, words, values, num_docs, tiles), 2)
    nbytes = _needed_bytes_many(progs, words, values, num_docs, tiles)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"kernel": name, "Q": len(progs), "ms": ms, "solo_ms": solo_ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bytes": nbytes,
           "max_abs_err": err, "grid": [grid, groups], "programs_a_block": qg,
           "smem": lay.smem, "acc_smem": lay.acc_smem,
           "leaf_tables": fs.lut_leaves(progs[0], qg),
           "ms_by_q": {str(q): t for q, t in ms_by_q.items()}}
    log(f"  13b {name} over {int(num_docs.numel())} segments, Q={len(progs)}"
        f": == plain == {len(progs)} solo launches; {ms:.4f} ms/launch "
        f"(grid {grid} x {groups}, {qg} programs a block, {lay.smem} B "
        f"smem, accumulators in {'shared' if lay.acc_smem else 'device'} "
        f"memory, leaf tables of log2 widths {row['leaf_tables']}), "
        f"{len(progs)} solo launches {solo_ms:.4f} ms, {ms / bound:.1f}x "
        f"bound {bound:.4f} ms ({nbytes} B), plain {plain_ms:.2f} ms; ms at "
        f"Q = " + ", ".join(f"{q}: {t:.4f}" for q, t in ms_by_q.items()))
    return row


def _bound_query(bex, ctx, segs):
    """The batch executor's bound query of ``ctx`` over ``segs`` (its
    param tier's entry)."""
    from pinot_tpu_torch.query.context import filter_fingerprint

    batch, staged = bex.batch_for(segs)
    return bex._param_cache[(ctx.sql, batch.segment_name, staged.num_segs,
                             filter_fingerprint(ctx), bex.mesh.key)]


def phase_coalesce(main: dict, device: str = "cuda", threads: int = 8
                   ) -> dict:
    """13b: ``threads`` client threads on one ShardedQueryExecutor. Each
    runs C1-C8 (Q2.1 with other categories and supplier regions, every
    variant over all 8 segments, one program layout), then Q2.1 as
    written; then each binds one of P1-P8 (Q3.2 for another nation: the
    probes at binding share a layout). Every answer equal to its solo
    answer and the oracle; coalesced launches and saved launches counted
    by the scheduler; QPS at 1 and ``threads`` threads, the batch sizes
    and queue waits. The query-axis kernels (scan and probe) at the
    shapes that launched: against their plain version and Q solo
    launches, timed beside them and their byte bound."""
    import threading

    import torch

    from pinot_tpu_torch.parallel import ShardedQueryExecutor, combine
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb

    segs, wants = main["segs"], main["variant_wants"]
    cids = list(ssb.COALESCE_QUERIES)
    pids = list(ssb.PROBE_QUERIES)
    ctxs = {v: compile_query(t) for v, t in main["variant_texts"].items()}
    ctxs["Q2.1"] = main["ctxs"]["Q2.1"]
    wants = {**wants, "Q2.1": main["wants"]["Q2.1"]}
    bex = ShardedQueryExecutor(device=device)
    solo = {}
    for v in cids + ["Q2.1"]:
        table, _ = bex.execute(ctxs[v], segs)     # binds
        _check_flight(v, table, wants[v])
        solo[v] = table.rows
    keys = {_bound_query(bex, ctxs[v], segs).launch_key for v in cids}
    if len(keys) != 1:
        raise AssertionError(f"13b: C1-C8 bound to {len(keys)} launch keys")
    reps1 = 3
    t0 = time.perf_counter()
    for _ in range(reps1):
        for v in cids:
            bex.execute(ctxs[v], segs)
    qps1 = reps1 * len(cids) / (time.perf_counter() - t0)

    counters = {c.name: c for c in (combine.SHARDED_SCAN_MANY_COUNTER,
                                    combine.SHARDED_PROBE_MANY_COUNTER)}
    _reset(counters)
    mark = bex.launcher.stats_snapshot()
    records, errors = [], []
    barrier = threading.Barrier(threads)
    phase_t = {}

    def client(t: int) -> None:
        try:
            # each client compiles its own queries, as separate requests
            # do: one compiled context from several threads would share
            # one run (the executor's query flight) before the launcher
            own = {v: compile_query(c.sql) for v, c in ctxs.items()}
            barrier.wait(60)
            if t == 0:
                phase_t["c0"] = time.perf_counter()
            for i in range(len(cids)):
                v = cids[(t + i) % len(cids)]
                table, stats = bex.execute(own[v], segs)
                if table.rows != solo[v]:
                    raise AssertionError(f"13b {v}: rows differ from solo")
                records.append((v, stats.launch))
            barrier.wait(60)
            if t == 0:
                phase_t["c1"] = time.perf_counter()
            table, stats = bex.execute(own["Q2.1"], segs)
            if table.rows != solo["Q2.1"]:
                raise AssertionError("13b Q2.1: rows differ from solo")
            records.append(("Q2.1", stats.launch))
            if t == 0:
                # a longer window while the P variants bind: their probes
                # arrive over the binding's host work
                bex.launcher.set_window(max_ms=5.0, hot_ms=20.0)
            barrier.wait(60)
            v = pids[t % len(pids)]
            table, stats = bex.execute(own[v], segs)
            _check_flight(v, table, wants[v])
            records.append((v, stats.launch))
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
            barrier.abort()

    pool = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(300)
    bex.launcher.set_window(max_ms=1.0, hot_ms=2.0)
    if errors or any(th.is_alive() for th in pool):
        raise AssertionError(f"13b: clients failed: {errors[:3]}")
    launches = {name: c.launches for name, c in counters.items()}
    snap = bex.launcher.stats_snapshot()
    delta = {k: snap[k] - mark[k] for k in ("requests", "launches",
                                            "coalescedLaunches",
                                            "launchesSaved",
                                            "dedupedRequests",
                                            "batchedRequests")}
    qps8 = threads * len(cids) / (phase_t["c1"] - phase_t["c0"])
    sizes = [r["batchSize"] for _, r in records]
    waits = [r["queueWaitMs"] for _, r in records]
    if delta["coalescedLaunches"] <= 0 or delta["launchesSaved"] <= 0:
        raise AssertionError(f"13b: no launch coalesced: {delta}")
    if device == "cuda" and not all(launches.values()):
        raise AssertionError(f"13b: a query-axis kernel never launched: "
                             f"{launches}")
    out = {"qps_1": qps1, f"qps_{threads}": qps8, "scheduler": delta,
           "launches": launches,
           "batch_sizes": {str(n): sizes.count(n) for n in sorted(set(sizes))},
           "queue_wait_p50_ms": float(np.percentile(waits, 50)),
           "queue_wait_p99_ms": float(np.percentile(waits, 99))}
    log(f"  13b {threads} threads x C1-C8, then Q2.1, then P1-P8: every "
        f"answer == its solo answer == numpy oracle; QPS {qps1:.1f} at 1 "
        f"thread, {qps8:.1f} at {threads}; scheduler {delta}; query-axis "
        f"launches {launches}; batch sizes {out['batch_sizes']}; queue wait "
        f"p50 {out['queue_wait_p50_ms']:.3f} ms p99 "
        f"{out['queue_wait_p99_ms']:.3f} ms")

    if device != "cuda":
        return out
    bounds = [_bound_query(bex, ctxs[v], segs) for v in cids]
    inp = bounds[0].inputs
    rows = [_query_axis_kernel(
        "sharded_fused_scan_many", [b.params for b in bounds], inp.words,
        inp.values, inp.num_docs, inp.tiles)]
    probes = []
    for v in pids:
        b = next(b for k, b in bex._param_cache.items() if k[0] == ctxs[v].sql)
        probes.append(b)
    layouts = {b.probe[0].layout_key() for b in probes}
    if len(layouts) != 1:
        raise AssertionError(f"13b: P1-P8 probes in {len(layouts)} layouts")
    pin = probes[0].inputs
    rows.append(_query_axis_kernel(
        "sharded_fused_scan_probe_many", [b.probe[0] for b in probes],
        probes[0].probe[1], [], pin.num_docs, pin.tiles))
    out["kernels"] = rows
    del bex
    torch.cuda.empty_cache()
    return out


def phase_startree_budget(segs, ctxs: dict, wants: dict, kept_segs: dict,
                          device: str = "cuda", threads: int = 8) -> dict:
    """13c: phase 12's trees under a budget of 1.5x one segment's largest
    tree: the 13 flights twice through ServerQueryExecutor on the
    star-tree device rung, node arrays demoted to the host tier after the
    queries that staged them and promoted when the next query needs them
    (every segment that comes back in the second pass comes back by
    promotion), rows equal to the oracle, the staged bytes within the
    budget after each query; then ``threads`` concurrent identical
    queries share node-slice launches (the kernel flight's hits). They go
    through ``execute_instance``, which no query flight fronts: identical
    ``execute`` calls would share the whole run before any node slice
    (phase 15d holds that flight)."""
    import threading

    import torch

    from pinot_tpu_torch.broker.reduce import BrokerReduceService
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.tools import ssb

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    per_seg = max(t.nbytes() for s in segs for t in s.star_trees)
    budget = int(1.5 * per_seg)
    ex = ServerQueryExecutor(device=device, hbm_budget_bytes=budget)
    out = {"budget_bytes": budget, "passes": []}
    for p in range(2):
        snap0 = ex.residency.stats_snapshot()
        t0 = time.perf_counter()
        for qid in ssb.QUERIES:
            table, stats = ex.execute(ctxs[qid], segs)
            sync()
            _check_flight(qid, table, wants[qid])
            # admission may slice (a lease over the columns' estimate);
            # the node arrays of a slice go out after it
            st = stats.staging
            if (_SPILLED in _budget_decisions(stats) or st["spills"]
                    or (ctxs[qid].group_by
                        and stats.group_by_rung != "startree_device")):
                raise AssertionError(f"13c {qid}: {stats.decisions}, rung "
                                     f"{stats.group_by_rung}")
            if ex.residency.staged_bytes() > budget:
                raise AssertionError(f"13c {qid}: staged past the budget")
            if p and st["misses"] != st["promotions"]:
                raise AssertionError(f"13c {qid} pass 2: {st['misses']} "
                                     f"staged, {st['promotions']} promoted")
        snap = ex.residency.stats_snapshot()
        row = {k: snap[k] - snap0[k] for k in (
            "demotions", "promotions", "misses", "demotedBytes",
            "promotedBytes")}
        row["seconds"] = time.perf_counter() - t0
        out["passes"].append(row)
        log(f"  13c pass {p + 1} under {budget} B (1.5x one segment's "
            f"largest tree): 13 flights == numpy oracle on the star-tree "
            f"rung; {row}")
    if not (out["passes"][1]["demotions"] and out["passes"][1]["promotions"]):
        raise AssertionError(f"13c: no node array demoted and promoted: "
                             f"{out['passes']}")
    qid = "Q2.1"
    ctx = ctxs[qid]
    ex.execute(ctx, segs)
    broker = BrokerReduceService(device=device)
    hits = 0
    for rnd in range(5):
        h0 = ex.kernel_flight.hits
        q0 = ex.query_flight.hits
        barrier = threading.Barrier(threads)
        errors = []

        def client():
            try:
                barrier.wait(60)
                answer = ex.execute_instance(ctx, segs)
                table, _, exc = broker.reduce(ctx, [answer])
                if exc:
                    raise AssertionError(f"13c {qid}: {exc}")
                _check_flight(qid, table, wants[qid])
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        pool = [threading.Thread(target=client) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(120)
        if errors:
            raise AssertionError(f"13c: {errors[:3]}")
        if ex.query_flight.hits != q0:
            raise AssertionError("13c: execute_instance shared a whole run")
        hits = ex.kernel_flight.hits - h0
        if hits:
            break
    if not hits:
        raise AssertionError("13c: no concurrent node slice was shared")
    out["flight_hits"] = hits
    out["flight_rounds"] = rnd + 1
    log(f"  13c {threads} concurrent {qid}s (execute_instance): {hits} "
        f"node-slice launches shared (the kernel flight's hits), round "
        f"{rnd + 1}; == numpy oracle")
    return out


# -- phase 12: the star-tree -----------------------------------------------------

# the tree the JAX executor serves each flight from on SSB with
# ssb_indexing_config()'s trees (BENCH_r06.json's startree_tree_index; held
# to the JAX executor on the same segments in tests/test_torch_startree.py)
FLIGHT_TREE = {"Q1.1": 1, "Q1.2": 1, "Q1.3": 1, "Q2.1": 0, "Q2.2": 0,
               "Q2.3": 0, "Q3.1": 2, "Q3.2": 2, "Q3.3": 2, "Q3.4": 2,
               "Q4.1": 3, "Q4.2": 3, "Q4.3": 4}
_TREE_SERVED = "startree:scan->startree_device:tree{}"
_TREE_DECLINED = "startree:startree->scan:{}"
_TREE_WALKER = ("startree:startree_device->startree_host:"
                "startree_group_space_over_limit")


def _startree_keys(stats) -> dict:
    return {k: v for k, v in stats.decisions.items()
            if k.startswith("startree:")}


def _walks(ctx, kept) -> list:
    """Per kept segment: (records its walk selects, segment, pick,
    matches, the walk's host ms, the indices)."""
    from pinot_tpu_torch.engine import startree_exec
    from pinot_tpu_torch.engine.aggregates import resolve_agg

    aggs = [resolve_agg(f) for f in ctx.aggregations]
    group_cols = [e.name for e in ctx.group_by]
    out = []
    for seg in kept:
        pick = startree_exec.pick_star_tree(ctx, aggs, seg)
        matches = startree_exec.resolve_matches(seg, pick.preds)
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            idx = pick.tree.select_records(matches, group_cols)
            ms.append((time.perf_counter() - t0) * 1e3)
        out.append((int(idx.size), seg, pick, matches,
                    float(np.median(ms)), idx))
    return out


def _node_slice_call(ex, ctx, walk) -> dict:
    """One node-slice call at its path's shape: time (CUDA events), device
    time and CUDA kernels (torch.profiler), and its byte bound (the
    gathered rows of every node column it reads, the indices, the packed
    output, once, at 3.35 TB/s)."""
    from pinot_tpu_torch.engine.kernels import output_layout
    from pinot_tpu_torch.engine.plan import plan_star_tree
    from pinot_tpu_torch.engine.startree_device import (
        build_startree_kernel,
        node_slice_inputs,
    )

    n, seg, pick, matches, walk_ms, idx = walk
    plan = plan_star_tree(ctx, seg, pick.tree, matches, n)
    cols, idx_dev, params = node_slice_inputs(ex, plan, seg, pick.index, idx)
    kernel = ex.kernels.get(plan.spec, build_startree_kernel)

    def call():
        return kernel(cols, idx_dev, params, n).cpu()

    row = {"segment": seg.segment_name, "records": n, "walk_ms": walk_ms,
           "call_ms": _time_ms(call, 20)}
    row["device_ms"], row["cuda_kernels"] = _profile_calls(call, 10)
    row["bytes"] = (n * sum(t.element_size() for tree in cols.values()
                            for t in tree.values())
                    + 4 * n + 8 * sum(sz for _, sz
                                      in output_layout(plan.spec, 0)))
    row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
    return row


def phase_startree(sf: float, segments: int, seed: int, reps: int,
                   device: str = "cuda", card: str = "",
                   on_disk: bool = False) -> dict:
    """12: SSB at ``sf`` in ``segments`` segments with
    ``ssb.ssb_indexing_config()``'s five trees (built in a process pool,
    one worker per segment up to the host's cores).
    (12a) the 13 flights per segment (ServerQueryExecutor) and through
    ShardedQueryExecutor: every kept segment served by the star-tree
    device rung from the JAX executor's tree (``FLIGHT_TREE``), one
    node-slice call per kept segment where the oracle matches rows, no
    fused, general, combine or index launch; rows equal to the numpy oracle and
    to the scan rungs (``OPTION(useStarTree=false)``); ``reps`` timed runs
    of all three; on the card, the node-slice call of the kept segment
    with the most selected records timed beside its byte bound, with the
    walk's host ms. (12b) ST1-ST5 of ``ssb.STARTREE_QUERIES``: the host
    walker past the device's group space, three declines with the JAX
    package's codes and the opt-out, on the scan rungs, equal to the
    oracle. Build seconds, records and node bytes per tree. ``on_disk``:
    then phase 19c's part on these segments (``phase_startree_disk``)."""
    import torch

    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.parallel import ShardedQueryExecutor
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb

    t0 = time.perf_counter()
    segs, frames = ssb.build_segments(sf, num_segments=segments, seed=seed,
                                      star_tree=True)
    build_s = time.perf_counter() - t0
    rows = sum(s.num_docs for s in segs)
    trees = {}
    for ti in range(len(segs[0].star_trees)):
        ts = [s.star_trees[ti] for s in segs]
        trees[f"tree{ti}"] = {
            "dims": len(ts[0].config.dimensions_split_order),
            "build_s": sum(s.metadata.star_tree_build_s[ti] for s in segs),
            "build_s_max": max(s.metadata.star_tree_build_s[ti]
                               for s in segs),
            "records": sum(t.num_records for t in ts),
            "node_bytes": sum(t.nbytes() for t in ts)}
    import resource

    log(f"  SSB SF{sf}: {rows} rows in {len(segs)} segments with 5 trees "
        f"each, {build_s:.1f} s (trees built in a process pool); this "
        f"process's peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB")
    for name, t in trees.items():
        log(f"  {name}: {t['dims']} dims, {t['records']} records, "
            f"{t['node_bytes']} node bytes, build {t['build_s']:.2f} s "
            f"summed over segments (max {t['build_s_max']:.2f} s)")

    t0 = time.perf_counter()
    texts = {**{q: s + " LIMIT 100000" for q, s in ssb.QUERIES.items()},
             **ssb.STARTREE_QUERIES}
    ctxs = {qid: compile_query(t) for qid, t in texts.items()}
    parts = {qid: [ssb.numpy_answer(f, qid) for f in frames]
             for qid in texts}
    wants = {qid: ssb.merge_answers(p) for qid, p in parts.items()}
    kept_segs = _kept_segments(ctxs, segs, frames, parts)
    del frames
    log(f"  numpy oracle of {len(texts)} queries: "
        f"{time.perf_counter() - t0:.1f} s")

    ex = ServerQueryExecutor(device=device)
    bex = ShardedQueryExecutor(device=device)
    on_card = ex.device.type == "cuda"
    flights = {}
    for qid in ssb.QUERIES:
        ctx, kept = ctxs[qid], kept_segs[qid]
        k, ti = len(kept), FLIGHT_TREE[qid]
        scan_ctx = compile_query(texts[qid] + " OPTION(useStarTree=false)")
        walks = _walks(ctx, kept)
        # one node slice per kept segment whose frame the oracle matches
        # rows in (a Q1 partial is a sum of positive products: each Q1
        # filter holds lo_discount >= 1)
        names = {s.segment_name for s in kept}
        launched = sum(1 for s, p in zip(segs, parts[qid])
                       if s.segment_name in names and p not in (0, {}))
        scan_rows = None

        def check(table, stats, qid=qid, ctx=ctx, k=k, ti=ti,
                  launched=launched):
            _check_flight(qid, table, wants[qid])
            other = (stats.scan_launches + stats.probe_launches
                     + stats.sharded_scan_launches
                     + stats.sharded_probe_launches + stats.general_launches
                     + stats.batch_general_launches + stats.index_launches)
            if (stats.decisions != {_TREE_SERVED.format(ti): k}
                    or stats.startree_tree_index != ti
                    or stats.startree_launches != launched or other
                    or (ctx.group_by
                        and stats.group_by_rung != "startree_device")):
                raise AssertionError(
                    f"12a {qid}: {stats.decisions}, tree "
                    f"{stats.startree_tree_index}, "
                    f"{stats.startree_launches} node slices (want "
                    f"{launched}), {other} other launches, rung "
                    f"{stats.group_by_rung}")

        def scan_check(table, stats, qid=qid):
            nonlocal scan_rows
            _check_flight(qid, table, wants[qid])
            scan_rows = sorted(map(tuple, table.rows))
            if _startree_keys(stats) or stats.startree_launches:
                raise AssertionError(f"12a {qid} opted out: "
                                     f"{stats.decisions}")

        for e in (ex, bex):     # untimed: stages the node columns
            check(*e.execute(ctx, segs))
        scan_check(*ex.execute(scan_ctx, segs))
        lat = {"startree": _timed(ex, ctx, segs, reps, check),
               "batch_executor": _timed(bex, ctx, segs, reps, check),
               "scan": _timed(ex, scan_ctx, segs, reps, scan_check)}
        table, _ = ex.execute(ctx, segs)
        if sorted(map(tuple, table.rows)) != scan_rows:
            raise AssertionError(f"12a {qid}: rows differ from the scan "
                                 "rungs'")
        row = {"tree": ti, "kept_segments": k, "node_slices": launched,
               "records": sum(w[0] for w in walks),
               "walk_ms_total": sum(w[4] for w in walks),
               **{f"{p}_p50_ms": float(np.percentile(v, 50))
                  for p, v in lat.items()},
               **{f"{p}_p99_ms": float(np.percentile(v, 99))
                  for p, v in lat.items()}}
        most = max(walks, key=lambda w: w[0])
        if on_card and most[0]:
            row["call"] = _node_slice_call(ex, ctx, most)
        flights[qid] = row
        c = row.get("call")
        log(f"  12a {qid}: tree {ti} on all {k} kept segments "
            f"({launched} node slices, {row['records']} records), "
            f"== numpy oracle == scan rungs; p50/p99 "
            f"{row['startree_p50_ms']:.3f}/{row['startree_p99_ms']:.3f} ms "
            f"per segment, {row['batch_executor_p50_ms']:.3f}/"
            f"{row['batch_executor_p99_ms']:.3f} ms batch executor, scan "
            f"rungs {row['scan_p50_ms']:.3f}/{row['scan_p99_ms']:.3f} ms; "
            f"walks {row['walk_ms_total']:.3f} ms host"
            + (f"; call on {c['segment']} ({c['records']} records, walk "
               f"{c['walk_ms']:.3f} ms): {c['call_ms']:.4f} ms/call (CUDA "
               f"events), device {c['device_ms']} ms in "
               f"{c['cuda_kernels']} CUDA kernels/call (torch.profiler), "
               f"bound {c['bound_ms']:.3g} ms ({c['bytes']} B); {card}"
               if c else ""))

    routes = {}
    for qid, route in ssb.STARTREE_ROUTE.items():
        ctx, k = ctxs[qid], len(kept_segs[qid])
        if route == "walker":
            tree = FLIGHT_TREE["Q4.3"]
            expect = {_TREE_WALKER: k,
                      f"startree:scan->startree:tree{tree}": k}
        else:
            expect = {_TREE_DECLINED.format(route): k} if route else {}

        def check(table, stats, qid=qid, expect=expect, route=route):
            _check_flight(qid, table, wants[qid])
            if _startree_keys(stats) != expect or stats.startree_launches:
                raise AssertionError(f"12b {qid}: {stats.decisions}, "
                                     f"{stats.startree_launches} slices")
            if route == "walker" and stats.group_by_rung != "startree":
                raise AssertionError(f"12b {qid}: rung "
                                     f"{stats.group_by_rung}")

        def batch_check(table, stats, qid=qid, expect=expect, route=route,
                        k=k):
            # the batch path records no star-tree decline: a fit leaves
            # the batch (the walker's query), as does one kept segment
            _check_flight(qid, table, wants[qid])
            if _startree_keys(stats) != (expect if route == "walker"
                                         or k < 2 else {}):
                raise AssertionError(f"12b {qid} batch: {stats.decisions}")

        check(*ex.execute(ctx, segs))
        batch_check(*bex.execute(ctx, segs))
        n = min(reps, 3)
        lat = {"per_segment": _timed(ex, ctx, segs, n, check),
               "batch_executor": _timed(bex, ctx, segs, n, batch_check)}
        routes[qid] = {"route": route or "opted_out", "kept_segments": k,
                       **{f"{p}_p50_ms": float(np.percentile(v, 50))
                          for p, v in lat.items()}}
        walked = ""
        if route == "walker":   # the walker's share: the walk alone
            walks = _walks(ctx, kept_segs[qid])
            routes[qid]["records"] = sum(w[0] for w in walks)
            routes[qid]["walk_ms_total"] = sum(w[4] for w in walks)
            walked = (f"; walks {routes[qid]['walk_ms_total']:.3f} ms host "
                      f"for {routes[qid]['records']} records")
        log(f"  12b {qid}: {route or 'useStarTree=false'} on {k} kept "
            f"segments ({expect or 'no star-tree decision'}), == numpy "
            f"oracle; p50 {routes[qid]['per_segment_p50_ms']:.3f} ms per "
            f"segment, {routes[qid]['batch_executor_p50_ms']:.3f} ms batch "
            f"executor" + walked)
    staged = sum(sum(ex.stage(s).startree_nbytes().values()) for s in segs)
    log(f"  node columns staged: {staged} bytes"
        + (f"; torch.cuda.max_memory_allocated "
           f"{torch.cuda.max_memory_allocated()} bytes" if on_card else ""))
    del ex, bex
    log("phase 13c: the star-tree's node arrays under a budget")
    budget_run = phase_startree_budget(segs, ctxs, wants, kept_segs,
                                       device=device)
    out = {"sf": sf, "rows": rows, "build_s": build_s, "trees": trees,
           "flights": flights, "routes": routes, "staged_bytes": staged,
           "budget": budget_run}
    if on_disk:
        log("phase 19c (with phase 12): its star-trees written and loaded")
        out["disk"] = phase_startree_disk(segs, ctxs, wants, kept_segs,
                                          device=device)
    return out


# -- phase 14: a realtime user-events table -------------------------------------

# 2.5 M until phase 18 joined the script, 1.5 M until phase 20 did, 1 M
# until phase 21 did: the script must end within 1200 s on a slow host
# too (PERF.md section 4)
REALTIME_ROWS = 500_000
# watermarks of 14a before the bulk: below the chunk floor (1024 rows), in
# the same chunk, and one that regrows the chunks (to 8192 rows)
REALTIME_STEPS = (700, 1000, 5000)
_MUTABLE_SERVED = "index:mutable_device->index_gather:mutable_index_served"
_MUTABLE_HLL = "mutable:mutable_device->host_engine:mutable_hll_lut_unstable"
_MUTABLE_UPSERT = ("index:index_gather->mutable_device:"
                   "mutable_index_unsupported_shape")
_STARTREE_SERVED = "startree:scan->startree_device:tree0"
# the queries of realtime_queries a consuming segment serves on the index
# gather (a tail user's point filter), and the one it declines (HLL)
REALTIME_GATHERED = ("U1", "U3")
REALTIME_HLL = "R3"
# on the sealed segment: the default star-tree's shapes, and the queries
# the fused scan serves with OPTION(useStarTree=false)
SEALED_STARTREE = ("R1", "R2")
SEALED_FUSED = ("U2", "R1", "R2")


def _h2d_row_bytes(seg) -> int:
    """Bytes one row adds to a consuming segment's staged columns: int32
    dictIds (an MV row its padded width and a count), a null flag where
    the column has nulls."""
    total = 0
    for col in seg._cols.values():
        if col.mv_offsets is None:
            total += 4
        else:
            width = 1
            while width < max(col.max_mv, 1):
                width *= 2
            total += 4 * width + 4
        total += 1 if col.has_nulls else 0
    return total


def _dict_cards(seg) -> dict:
    """Values of each numeric dictionary (staged as 4-byte values: the
    table's numeric columns are INT)."""
    return {name: len(col.dictionary) for name, col in seg._cols.items()
            if col.fs.data_type.is_numeric}


def _consume_to(mgr, stream, messages, target: int) -> float:
    """Produce the messages up to ``target`` and consume them: -> the
    consumer's seconds."""
    from pinot_tpu_torch.ingestion import ConsumerState

    produced = stream.latest_offset(0).value
    if target > produced:
        stream.produce_many(messages[produced:target])
    t0 = time.perf_counter()
    while mgr.current_offset.value < target \
            and mgr.state is ConsumerState.INITIAL_CONSUMING:
        mgr.run_once()
    return time.perf_counter() - t0


def _realtime_check(qid: str, ctx, table, stats, want, what: str,
                    upsert: bool = False) -> None:
    """Rows == the oracle; on the consuming rung: the group-bys on
    ``mutable_device``, U1 / U3 on its index gather (declined on an
    upsert segment), R3 (HLL) on the host engine, no fused launch."""
    from pinot_tpu_torch.tools import usertable

    usertable.check_rows(qid, table.rows, want)
    gathered = qid in REALTIME_GATHERED and not upsert
    if qid == REALTIME_HLL:
        rung, key, general = "host", _MUTABLE_HLL, 0
    else:
        rung = "mutable_device" if ctx.is_group_by else None
        key = (_MUTABLE_SERVED if gathered else _MUTABLE_UPSERT
               if qid in REALTIME_GATHERED else None)
        general = 0 if gathered else 1
    if stats.group_by_rung != rung \
            or (key is not None and stats.decisions.get(key) != 1) \
            or stats.index_launches != int(gathered) \
            or stats.general_launches != general \
            or stats.scan_launches or stats.probe_launches:
        raise AssertionError(
            f"{what} {qid}: rung {stats.group_by_rung}, decisions "
            f"{stats.decisions}, launches general {stats.general_launches} "
            f"gather {stats.index_launches} fused {stats.scan_launches}")


def _same_rows(qid: str, got, want, what: str) -> None:
    """Rows of two paths: group rows as a set (a consuming segment's
    dictionary is arrival-ordered), U6 in its ORDER BY."""
    a, b = [list(r) for r in got], [list(r) for r in want]
    if qid != "U6":
        a, b = sorted(a), sorted(b)
    if a != b:
        raise AssertionError(f"{what} {qid}: {a} != {b}")


def phase_realtime(seed: int, reps: int, rows: int = REALTIME_ROWS,
                   device: str = "cuda") -> dict:
    """14: the user-events table as a realtime table: JSON messages on a
    one-partition MemoryStream, consumed by RealtimeSegmentDataManager with
    LocalCompletionProtocol into a consuming segment.

    (14a) At the watermarks of ``REALTIME_STEPS`` and at ``rows``, U1-U7
    and R1-R3 of ``usertable.realtime_queries`` through ServerQueryExecutor
    == the numpy oracle over the rows indexed so far (group-bys as sets),
    the group-bys on ``mutable_device``, U1 and U3 (a tail user) on the
    index gather, R3 (HLL) declined with ``mutable_hll_lut_unstable``; the
    bytes uploaded between two watermarks == the new rows' and dictionary
    values' bytes (no history sent again); per-query p50/p99 at ``rows``,
    the ingest rate; one refresh of a few rows past ``rows`` timed under a
    live snapshot (every chunk copied on the device) and with none (in
    place). Then a writer thread consumes the last rows and
    commits while 30 count queries run: counts never go backwards, the
    last == ``num_docs``; each row's ingest-to-queryable latency (its
    append to the end of the first query that counted it).
    (14b) The first ``rows // 5`` messages into an upsert segment keyed on
    ``user_id`` (the table config's FULL ``UpsertConfig``, the latest
    arrival wins, through ``upsert_hook`` and ``_LiveValidDocs``): == the
    oracle over the latest row per user at two watermarks and after an
    invalidation at an unchanged watermark.
    (14c) The committed segment, sealed with the default star-tree and the
    stream offsets: R1, R2 on the star-tree rung, U2, R1, R2 with
    ``OPTION(useStarTree=false)`` on the fused-scan kernel, every query ==
    the consuming segment's answer at the final watermark; on the card the
    kernel against its plain version (``max_abs_err`` 0.0) and timed at
    the sealed segment's shapes. -> the report, with ``timing`` rows,
    ``errs`` and the fused launches of 14c (``launches``)."""
    import threading

    import torch

    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.engine.mutable_staging import resident_name
    from pinot_tpu_torch.ingestion import (
        ConsumerState,
        MemoryStream,
        RealtimeSegmentDataManager,
        StreamOffset,
    )
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import usertable

    tail = max(rows // 50, 2000)
    total = rows + tail
    t0 = time.perf_counter()
    frame = usertable.generate_frame(0, 1, total, seed)
    users = usertable.tail_users(total, 1, seed)
    user = users[len(users) // 2]
    messages = usertable.frame_messages(frame)
    ctxs = {qid: compile_query(sql)
            for qid, sql in usertable.realtime_queries(user).items()}
    topic = f"user_events_rt_{seed}"
    stream = MemoryStream.create(topic, 1)
    mgr = RealtimeSegmentDataManager(
        "user_events__0__0", usertable.realtime_table_config(topic, total),
        usertable.user_schema(), 0, StreamOffset(0))
    seg = mgr.segment
    log(f"  14a: {total} rows as JSON messages ({rows}, then {tail} under "
        f"queries), tail user {user}: {time.perf_counter() - t0:.1f} s")
    ex = ServerQueryExecutor(device=device)
    sync = (torch.cuda.synchronize if ex.device.type == "cuda"
            else (lambda: None))
    steps, h2d = [], []
    prev = None
    for wm in [s for s in REALTIME_STEPS if s < rows] + [rows]:
        consume_s = _consume_to(mgr, stream, messages, wm)
        if seg.num_docs != wm:
            raise AssertionError(f"14a: {seg.num_docs} rows indexed, not "
                                 f"{wm}")
        wants = usertable.realtime_answers(
            usertable.frame_prefix(frame, wm), user)
        for qid, ctx in ctxs.items():
            table, stats = ex.execute(ctx, [seg])
            sync()
            _realtime_check(qid, ctx, table, stats, wants[qid],
                            f"14a at {wm}")
        resident = ex.residency._entries[
            resident_name(seg.segment_name)].resident
        cards = _dict_cards(seg)
        if prev is not None:
            pwm, pcards, pbytes = prev
            want = ((wm - pwm) * _h2d_row_bytes(seg)
                    + 4 * sum(cards[c] - pcards[c] for c in cards))
            got = resident.h2d_bytes - pbytes
            if got != want:
                raise AssertionError(f"14a {pwm} -> {wm}: {got} bytes "
                                     f"uploaded, the new rows hold {want}")
            h2d.append({"from": pwm, "to": wm, "bytes": got})
        prev = (wm, cards, resident.h2d_bytes)
        cap = resident._cursor["cap"]
        steps.append({"watermark": wm, "capacity": cap,
                      "consume_s": consume_s})
        log(f"  14a at {wm} rows (chunk capacity {cap}"
            + (f", {h2d[-1]['bytes']} bytes uploaded since {h2d[-1]['from']}"
               " == the new rows' and dictionary values'" if h2d else "")
            + f"): {len(ctxs)} queries == numpy oracle, group-bys on "
            "mutable_device, U1/U3 gathered, R3 on the host engine")
    bulk = rows - steps[-2]["watermark"] if len(steps) > 1 else rows
    ingest = bulk / steps[-1]["consume_s"]
    log(f"  14a ingest: {bulk} rows in {steps[-1]['consume_s']:.1f} s, "
        f"{ingest:.0f} rows/s (JSON decode, transform, index)")
    wants = usertable.realtime_answers(usertable.frame_prefix(frame, rows),
                                       user)
    lat = {qid: _timed(ex, ctx, [seg], reps,
                       lambda t, s, qid=qid, ctx=ctx: _realtime_check(
                           qid, ctx, t, s, wants[qid], f"14a at {rows}"))
           for qid, ctx in ctxs.items()}
    consuming = _latencies(lat, rows)

    # one refresh past ``rows``: with a query's snapshot in flight every
    # chunk is copied on the device before the new rows land; with none,
    # they land in place
    step = max(1, min(1000, (resident._cursor["cap"] - rows) // 2,
                      tail // 4))
    refresh = {}
    for how, wm in (("copy", rows + step), ("in_place", rows + 2 * step)):
        held = resident.snapshot() if how == "copy" else None
        _consume_to(mgr, stream, messages, wm)
        copied = resident.copied_bytes
        sync()
        t = time.perf_counter()
        snap = resident.snapshot()
        sync()
        refresh[how] = {"rows": step, "watermark": wm,
                        "ms": (time.perf_counter() - t) * 1e3,
                        "copied_bytes": resident.copied_bytes - copied}
        del held, snap
    if refresh["in_place"]["copied_bytes"] \
            or not refresh["copy"]["copied_bytes"]:
        raise AssertionError(f"14a refresh: {refresh}")
    log(f"  14a refresh of {step} rows at {rows}: "
        f"{refresh['copy']['ms']:.3f} ms under a live snapshot "
        f"({refresh['copy']['copied_bytes']} bytes copied on the device), "
        f"{refresh['in_place']['ms']:.3f} ms in place")
    start = rows + 2 * step

    # the last rows arrive while queries run; the writer commits and seals
    stream.produce_many(messages[start:total])
    count = compile_query("SELECT count(*) FROM user_events")
    errors = []

    def writer():
        try:
            while mgr.state not in (ConsumerState.COMMITTED,
                                    ConsumerState.ERROR):
                mgr.run_once()
        except Exception as e:   # raised again below
            errors.append(e)

    thread = threading.Thread(target=writer, name="realtime-writer")
    counts, ends = [], []
    copied = resident.copied_bytes
    thread.start()
    try:
        for _ in range(30):
            counts.append(ex.execute(count, [seg])[0].rows[0][0])
            sync()
            ends.append(time.monotonic())
    finally:
        thread.join()
    if errors:
        raise errors[0]
    if mgr.state is not ConsumerState.COMMITTED:
        raise AssertionError(f"14a: the consumer ended {mgr.state}")
    if resident.copied_bytes != copied:
        raise AssertionError("14a: one query at a time, yet a refresh "
                             f"copied {resident.copied_bytes - copied} "
                             "bytes")
    final = ex.execute(count, [seg])[0].rows[0][0]
    if any(b < a for a, b in zip(counts, counts[1:])) \
            or final != seg.num_docs or seg.num_docs != total:
        raise AssertionError(f"14a counts under a writer: {counts}, final "
                             f"{final}, num_docs {seg.num_docs} of {total}")
    # ingest to queryable: a row's append to the end of the first query
    # that counted it (an upper bound: the snapshot is taken inside it)
    ts = seg._append_ts.view(total)
    fresh, seen = [], start
    for c, end in zip(counts, ends):
        if c > seen:
            fresh.append(end - ts[seen:c])
            seen = c
    fresh = np.concatenate(fresh) * 1e3 if fresh else np.zeros(0)
    freshness = ({"p50_ms": float(np.percentile(fresh, 50)),
                  "p99_ms": float(np.percentile(fresh, 99)),
                  "max_ms": float(fresh.max()), "rows": int(fresh.size)}
                 if fresh.size else None)
    log(f"  14a writer: 30 counts {counts[0]}..{counts[-1]}, never "
        f"backwards, final {final} == num_docs; ingest to queryable "
        + (f"p50 {freshness['p50_ms']:.1f} ms, p99 {freshness['p99_ms']:.1f}"
           f" ms over {freshness['rows']} rows" if freshness
           else "not seen: the writer ended before a count"))
    final_wants = usertable.realtime_answers(frame, user)
    final_rows = {}
    for qid, ctx in ctxs.items():
        table, stats = ex.execute(ctx, [seg])
        _realtime_check(qid, ctx, table, stats, final_wants[qid],
                        f"14a at {total}")
        final_rows[qid] = table.rows
    del ex

    upsert = _phase_realtime_upsert(frame, messages, ctxs, user,
                                    max(rows // 5, 2000), reps, device)
    sealed = _phase_realtime_sealed(mgr, ctxs, final_rows, total, reps,
                                    device)
    MemoryStream.delete(topic)
    return {"rows": total, "consuming_rows": rows, "tail_rows": tail,
            "user": user, "steps": steps, "h2d": h2d,
            "ingest_rows_per_s": ingest, "consuming": consuming,
            "refresh": refresh, "writer_counts": counts,
            "final_count": final, "ingest_to_queryable": freshness,
            "upsert": upsert, **sealed}


def _phase_realtime_upsert(frame, messages, ctxs, user: int, n: int,
                           reps: int, device: str) -> dict:
    """14b: ``n`` messages into a consuming upsert segment (see
    ``phase_realtime``)."""
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.ingestion import (
        MemoryStream,
        RealtimeSegmentDataManager,
        StreamOffset,
    )
    from pinot_tpu_torch.tools import usertable

    topic = "user_events_upsert"
    stream = MemoryStream.create(topic, 1)
    # FULL upsert keyed on user_id from the table config; no comparison
    # column, so the latest arrival wins
    mgr = RealtimeSegmentDataManager(
        "user_events__1__0",
        usertable.realtime_table_config(topic, n + 1, upsert=True),
        usertable.user_schema(["user_id"]), 0, StreamOffset(0))
    seg = mgr.segment
    pm = mgr.upsert_manager.partition(0)
    ex = ServerQueryExecutor(device=device)
    for wm in (n // 2, n):
        _consume_to(mgr, stream, messages, wm)
        latest = usertable.latest_per_user(usertable.frame_prefix(frame, wm))
        wants = usertable.realtime_answers(latest, user)
        for qid, ctx in ctxs.items():
            table, stats = ex.execute(ctx, [seg])
            _realtime_check(qid, ctx, table, stats, wants[qid],
                            f"14b at {wm}", upsert=True)
    live = len(latest["user_id"])
    # a newer record of one user in another segment: its doc here goes
    # invalid, the watermark stays
    gone = int(latest["user_id"][0])
    pm.add_record("user_events__1__1", 0, (gone,), n + 1)
    keep = latest["user_id"] != gone
    after = usertable.realtime_answers(
        {k: ((v[0][keep], v[1][keep]) if isinstance(v, tuple) else v[keep])
         for k, v in latest.items()}, user)
    lat = {qid: _timed(ex, ctx, [seg], reps,
                       lambda t, s, qid=qid, ctx=ctx: _realtime_check(
                           qid, ctx, t, s, after[qid], "14b invalidated",
                           upsert=True))
           for qid, ctx in ctxs.items()}
    if seg.num_docs != n:
        raise AssertionError(f"14b: the watermark moved to {seg.num_docs}")
    log(f"  14b upsert: {n} rows, {live} users live == the oracle over the "
        f"latest row per user at {n // 2} and {n} rows; user {gone} "
        "invalidated at an unchanged watermark == the oracle")
    MemoryStream.delete(topic)
    return {"rows": n, "live_users": live, "invalidated_user": gone,
            "per_query": _latencies(lat, n)}


def _phase_realtime_sealed(mgr, ctxs, final_rows: dict, total: int,
                           reps: int, device: str) -> dict:
    """14c: the sealed segment (see ``phase_realtime``)."""
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import usertable

    sealed = mgr.sealed_segment
    custom = sealed.metadata.custom
    want_custom = {"segment.realtime.startOffset": "0",
                   "segment.realtime.endOffset": str(total),
                   "segment.realtime.partition": 0}
    if sealed.num_docs != total or custom != want_custom \
            or len(sealed.star_trees) != 1:
        raise AssertionError(f"14c: sealed {sealed.num_docs} docs, custom "
                             f"{custom}, {len(sealed.star_trees)} trees")
    tree = sealed.star_trees[0]
    log(f"  14c seal: {total} rows in {mgr.seal_wall_ms:.1f} ms (wall), the "
        f"default star-tree over {tree.config.dimensions_split_order} "
        f"({tree.num_records} records), {custom}")
    ex = ServerQueryExecutor(device=device)
    on_card = ex.device.type == "cuda"
    sqls = usertable.realtime_queries(0)
    opt_out = {qid: compile_query(ctx.sql + " OPTION(useStarTree=false)")
               for qid, ctx in ctxs.items()}
    launches = {"fused_scan": 0, "fused_scan_probe": 0}

    def check(qid, fused_path):
        def run(table, stats):
            _same_rows(qid, table.rows, final_rows[qid], "14c")
            if fused_path and qid in SEALED_STARTREE and (
                    stats.decisions.get(_STARTREE_SERVED) != 1
                    or stats.startree_launches != 1 or stats.scan_launches):
                raise AssertionError(f"14c {qid}: {stats.decisions}")
            if not fused_path and qid in SEALED_FUSED:
                if stats.general_launches or stats.index_launches \
                        or stats.startree_launches \
                        or stats.scan_launches != int(on_card) \
                        or any(k.startswith("pallas:")
                               for k in stats.decisions):
                    raise AssertionError(f"14c {qid} opted out: "
                                         f"{stats.decisions}")
                launches["fused_scan"] += stats.scan_launches
                launches["fused_scan_probe"] += stats.probe_launches
        return run

    startree = {qid: _timed(ex, ctxs[qid], [sealed], reps, check(qid, True))
                for qid in ctxs}
    scan = {qid: _timed(ex, opt_out[qid], [sealed], reps, check(qid, False))
            for qid in ctxs}
    log("  14c: every query == the consuming answer at the final watermark; "
        f"R1, R2 on the star-tree rung (p50 "
        + ", ".join(f"{q} {np.percentile(startree[q], 50):.3f}"
                    for q in SEALED_STARTREE)
        + " ms), U2, R1, R2 opted out on the fused scan (p50 "
        + ", ".join(f"{q} {np.percentile(scan[q], 50):.3f}"
                    for q in SEALED_FUSED) + " ms)")
    timing, errs = [], {"fused_scan": 0.0, "fused_scan_probe": 0.0}
    if on_card:
        staged = ex.stage(sealed)
        timing = _time_kernels({f"{q} sealed": (staged, total, sqls[q])
                                for q in SEALED_FUSED}, errs, 20)
        if any(v != 0.0 for v in errs.values()):
            raise AssertionError(f"14c: kernel against plain {errs}")
    return {"seal_wall_ms": mgr.seal_wall_ms, "custom": custom,
            "startree_records": tree.num_records,
            "sealed_startree": _latencies(
                {q: startree[q] for q in SEALED_STARTREE}, total),
            "sealed_fused": _latencies({q: scan[q] for q in SEALED_FUSED},
                                       total),
            "timing": timing, "errs": errs, "launches": launches}


# -- phase 15: scatter/gather on one card --------------------------------------

# in-process servers of phase 15, each a ShardedQueryExecutor over its share
# of the segments
SERVERS = 4
# 15b: every (user, country, event type) group of the first
# USER_GROUPS_SEGMENTS of the user-events table's segments, one a server
# (cut from all 8 to keep the script inside its time limit): hundreds of
# thousands of groups a server, each server's past the general rung's
# compact cap (8192), so its host engine serves them; the composite space
# (about 100 k users x 10 x 5) is past the device merge's dense slots, so
# the merge takes the sort rung
USER_GROUPS_SQL = ("SELECT user_id, country, event_type, count(*), "
                   "sum(revenue), max(latency_ms) FROM user_events "
                   "GROUP BY user_id, country, event_type LIMIT 10000000")
# the servers' and the broker's numGroupsLimit in 15b: above the group
# count, so no trim cuts the answer the oracle is compared with
SCATTER_GROUPS_LIMIT = 10_000_000
USER_GROUPS_SEGMENTS = SERVERS
# 15c: the admission gate's bounds under 8 client threads
ADMISSION_SLOTS = 2
ADMISSION_QUEUE = 2


def _split(segs: list, n: int) -> list:
    """``segs`` in ``n`` contiguous shares, one a server."""
    per = -(-len(segs) // n)
    return [segs[i:i + per] for i in range(0, len(segs), per)]


def _scatter(servers: list, ctx) -> list:
    """Each server's mergeable answer (``execute_instance``)."""
    return [ex.execute_instance(ctx, part) for ex, part in servers]


def _wire(tables: list) -> list:
    """The tables as a broker in another process holds them."""
    from pinot_tpu_torch.common.datatable import DataTable

    return [DataTable.from_bytes(t.to_bytes()) for t in tables]


def _device_declines(stats) -> dict:
    return {k: v for k, v in stats.decisions.items()
            if k.startswith("reduce:device->host:")}


def _identical_rows(what: str, got: list, want: list) -> None:
    """Rows equal cell for cell, types included (bit-identical)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows != {len(want)}")
    for g, w in zip(got, want):
        if g != w or [type(x) for x in g] != [type(x) for x in w]:
            raise AssertionError(f"{what}: row {g} != {w}")


def _merge_cost(svc, ctx, tables: list, device: str, iters: int) -> dict:
    """The device merge (``device_group_merge``) and the vectorized host
    merge (``host_group_merge``) of the same tables' group-by block: their
    outputs equal bit for bit; the host merge's ms; on the card, the device
    merge's ms (CUDA events over ``iters`` calls, its copies to and from
    the card included), device ms and CUDA kernels a call
    (``torch.profiler``), beside its byte bound (the keys and states read
    once, the groups' first rows and states written once)."""
    from pinot_tpu_torch.broker.reduce import DEVICE_OPS, host_group_merge
    from pinot_tpu_torch.engine.aggregates import resolve_agg
    from pinot_tpu_torch.parallel import reduce_device as rdev

    acc = svc.accumulator(ctx)
    for t in tables:
        acc.add(t)
    keys, entries, n = acc.group_block()
    aggs = [resolve_agg(f) for f in ctx.aggregations]
    comp, space = rdev.encode_composite_keys(keys)
    vals = [a for _, a in entries]
    ops = [DEVICE_OPS[a.base] for a in aggs]

    def device_merge():
        return rdev.device_group_merge(comp, space, vals, ops, device)

    first, folded = device_merge()
    hfirst, hfolded = host_group_merge(keys, entries, n, aggs)
    # each lists the groups in its own order: compare by first row
    pd = np.argsort(first, kind="stable")
    ph = np.argsort(hfirst, kind="stable")
    if not np.array_equal(first[pd], hfirst[ph]):
        raise AssertionError("15: the device merge's groups differ")
    for a, (d, h) in enumerate(zip(folded, hfolded)):
        if d.dtype != h.dtype or not np.array_equal(d[pd], h[ph]):
            raise AssertionError(f"15: the device merge's state {a} "
                                 "differs from the host's")
    t0 = time.perf_counter()
    for _ in range(iters):
        host_group_merge(keys, entries, n, aggs)
    out = {"rows": n, "groups": int(first.shape[0]), "space": space,
           "rung": rdev.merge_rung(space),
           "host_ms": (time.perf_counter() - t0) * 1e3 / iters,
           "bound_ms": (comp.nbytes + sum(v.nbytes for v in vals)
                        + first.nbytes + sum(f.nbytes for f in folded))
           / HBM_BYTES_PER_S * 1e3}
    if device == "cuda":
        out["device_ms"] = _time_ms(device_merge, iters)
        out["device_kernel_ms"], out["cuda_kernels"] = _profile_calls(
            device_merge, 3)
    return out


def _user_groups_answer(frames: list) -> dict:
    """``USER_GROUPS_SQL``'s (user, country, event type) -> (count,
    revenue sum, latency max) over the generator's arrays."""
    from pinot_tpu_torch.tools import usertable

    user = np.concatenate([f["user_id"] for f in frames]).astype(np.int64)
    country = np.concatenate([f["country"] for f in frames]).astype(
        np.int64)
    event = np.concatenate([f["event_type"] for f in frames]).astype(
        np.int64)
    key = (user * len(usertable.COUNTRIES) + country) \
        * len(usertable.EVENT_TYPES) + event
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.concatenate(([0], np.flatnonzero(ks[1:] != ks[:-1]) + 1))
    counts = np.diff(np.append(starts, ks.shape[0]))
    rev = np.concatenate([f["revenue"] for f in frames])[order]
    lat = np.concatenate([f["latency_ms"] for f in frames])[order]
    sums = np.add.reduceat(rev, starts)
    maxs = np.maximum.reduceat(lat, starts)
    first = order[starts]
    return {(int(user[i]), usertable.COUNTRIES[country[i]],
             usertable.EVENT_TYPES[event[i]]): (int(c), float(s), float(m))
            for i, c, s, m in zip(first, counts, sums, maxs)}


def _threads(n: int, fn) -> list:
    """``fn(i)`` on ``n`` threads released together; -> the errors."""
    import threading

    barrier = threading.Barrier(n)
    errors = []

    def run(i: int) -> None:
        try:
            barrier.wait(60)
            fn(i)
        except BaseException as e:  # noqa: BLE001 - returned
            errors.append(e)

    pool = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(300)
    if any(th.is_alive() for th in pool):
        raise AssertionError("15: client threads hung")
    return errors


def phase_scatter(main: dict, users: dict, reps: int,
                  device: str = "cuda", iters: int = 10) -> dict:
    """Phase 15: Pinot's scatter/gather on one card. ``SERVERS`` in-process
    servers (ShardedQueryExecutor, each over its share of the segments)
    answer with ``execute_instance``'s DataTable and
    ``BrokerReduceService`` merges them.

    (15a) phase 4's segments: the 13 flights reduced in process with the
    device route (``reducePath`` "device" on every group-by flight with
    groups) and through ``to_bytes`` / ``from_bytes`` (the device route
    declines ``reduce_device_cross_process``, the vectorized path
    serves); both == phase 4's rows == the oracle; the dense rung's merge
    cost on the flight with the most rows. (15b) ``USER_GROUPS_SEGMENTS``
    of phase 8's user-events segments, one a server, ``USER_GROUPS_SQL`` with the servers' and the broker's
    ``numGroupsLimit`` above its group count: the device merge on its
    sort rung == the vectorized merge, bit for bit == the numpy oracle,
    with its cost.
    (15c) 8 client threads against an admission gate of
    ``ADMISSION_SLOTS`` slots and ``ADMISSION_QUEUE`` waiters: typed
    rejections counted, every admitted answer == phase 4's. (15d) 8
    threads sending one compiled Q2.1: fewer runs than calls, identical
    rows. (15e) the flights per segment at worker.threads 1 and 8: p50s,
    equal rows. (15f) a segment's column borrowed from a resident batch
    after a batch query: borrows, stagedBytes with and without the
    borrow, equal rows."""
    import torch

    from pinot_tpu_torch.broker.reduce import BrokerReduceService
    from pinot_tpu_torch.engine.errors import QueryRejectedError
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.parallel import ShardedQueryExecutor
    from pinot_tpu_torch.parallel import reduce_device as rdev
    from pinot_tpu_torch.query import compile_query

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    segs, ctxs, wants = main["segs"], main["ctxs"], main["wants"]
    results = main["results"]
    out: dict = {"servers": SERVERS}

    # 15a
    t0 = time.perf_counter()
    servers = [(ShardedQueryExecutor(device=device), part)
               for part in _split(segs, SERVERS)]
    dev_svc = BrokerReduceService(device=device, device_reduce=True)
    for ctx in ctxs.values():       # untimed pass: stages the batches
        _scatter(servers, ctx)
    sync()
    rdev.MERGE_COUNTER.reset()
    flights, served, biggest = {}, 0, None
    for qid, ctx in ctxs.items():
        t1 = time.perf_counter()
        tables = _scatter(servers, ctx)
        t2 = time.perf_counter()
        res, st, exc = dev_svc.reduce(ctx, tables)
        t3 = time.perf_counter()
        wire = [t.to_bytes() for t in tables]
        wres, wst, _ = dev_svc.reduce(ctx, _wire(tables))
        grouped = ctx.is_group_by and any(t.num_rows() for t in tables)
        want_path = "device" if grouped else "vectorized"
        if exc or st.reduce_path != want_path or _device_declines(st):
            raise AssertionError(f"15a {qid}: in process, reducePath "
                                 f"{st.reduce_path} (want {want_path}), "
                                 f"{st.decisions}, {exc}")
        cross = "reduce:device->host:reduce_device_cross_process"
        if wst.reduce_path != "vectorized" \
                or _device_declines(wst) != ({cross: 1} if grouped else {}):
            raise AssertionError(f"15a {qid}: across the wire, reducePath "
                                 f"{wst.reduce_path}, {wst.decisions}")
        _check_flight(qid, res, wants[qid])
        _identical_rows(f"15a {qid} in process", res.rows, results[qid].rows)
        _identical_rows(f"15a {qid} across the wire", wres.rows, res.rows)
        if st.num_docs_scanned != wst.num_docs_scanned:
            raise AssertionError(f"15a {qid}: stats differ across the wire")
        served += grouped
        n = sum(t.num_rows() for t in tables)
        flights[qid] = {"scatter_ms": (t2 - t1) * 1e3,
                        "reduce_ms": (t3 - t2) * 1e3,
                        "reduce_path": st.reduce_path,
                        "wire_bytes": sum(len(b) for b in wire),
                        "rows": n, "groups": len(res.rows)}
        if grouped and (biggest is None or n > biggest[0]):
            biggest = (n, qid, tables)
    if rdev.MERGE_COUNTER.launches != served:
        raise AssertionError(f"15a: {rdev.MERGE_COUNTER.launches} device "
                             f"merges for {served} group-by flights")
    out["flights"] = flights
    out["dense"] = _merge_cost(dev_svc, ctxs[biggest[1]], biggest[2],
                               device, iters)
    out["dense"]["flight"] = biggest[1]
    if out["dense"]["rung"] != "dense":
        raise AssertionError(f"15a: {biggest[1]}'s merge took "
                             f"{out['dense']['rung']}")
    del servers
    log(f"  15a: {len(flights)} flights over {SERVERS} servers, "
        f"reducePath device on {served} group-by flights (the device merge "
        f"called {served} times), vectorized across the wire "
        f"(reduce_device_cross_process); == phase 4 == oracle "
        f"({time.perf_counter() - t0:.1f} s)")
    log("  15a dense rung " + json.dumps(out["dense"]))

    # 15b
    t0 = time.perf_counter()
    useg = users["segs"][:USER_GROUPS_SEGMENTS]
    servers = [(ShardedQueryExecutor(
        device=device, num_groups_limit=SCATTER_GROUPS_LIMIT), part)
        for part in _split(useg, SERVERS)]
    ctx = compile_query(USER_GROUPS_SQL)
    t1 = time.perf_counter()
    tables = _scatter(servers, ctx)
    scatter_ms = (time.perf_counter() - t1) * 1e3
    del servers
    per_server = [t.num_rows() for t in tables]
    rdev.MERGE_COUNTER.reset()
    acc = BrokerReduceService(
        device=device, device_reduce=True,
        num_groups_limit=SCATTER_GROUPS_LIMIT).accumulator(ctx)
    for t in tables:
        acc.add(t)
    t1 = time.perf_counter()
    res, st, _ = acc.finish()
    reduce_ms = (time.perf_counter() - t1) * 1e3
    if st.reduce_path != "device" or acc.merge_rung != "sort" \
            or rdev.MERGE_COUNTER.launches != 1:
        raise AssertionError(f"15b: reducePath {st.reduce_path}, rung "
                             f"{acc.merge_rung}, {st.decisions}")
    vsvc = BrokerReduceService(device=device,
                               num_groups_limit=SCATTER_GROUPS_LIMIT)
    t1 = time.perf_counter()
    vres, vst, _ = vsvc.reduce(ctx, tables)
    vreduce_ms = (time.perf_counter() - t1) * 1e3
    if vst.reduce_path != "vectorized":
        raise AssertionError(f"15b: host reducePath {vst.reduce_path}")
    _identical_rows("15b device vs vectorized", res.rows, vres.rows)
    want = _user_groups_answer(users["frames"][:USER_GROUPS_SEGMENTS])
    got = {(r[0], r[1], r[2]): (r[3], r[4], r[5]) for r in res.rows}
    if got != want:
        bad = [k for k in want if got.get(k) != want[k]][:3]
        raise AssertionError(f"15b: {len(got)} groups vs the oracle's "
                             f"{len(want)}, e.g. {bad}")
    out["user_groups"] = {
        "groups": len(res.rows), "per_server": per_server,
        "scatter_ms": scatter_ms, "reduce_ms": reduce_ms,
        "vectorized_reduce_ms": vreduce_ms,
        "sort": _merge_cost(vsvc, ctx, tables, device, max(1, iters // 5))}
    del tables
    log(f"  15b: {len(res.rows)} groups (servers {per_server}) on the sort "
        f"rung == vectorized == oracle; scatter {scatter_ms:.1f} ms, reduce "
        f"{reduce_ms:.1f} ms (vectorized {vreduce_ms:.1f} ms) "
        f"({time.perf_counter() - t0:.1f} s)")
    log("  15b sort rung " + json.dumps(out["user_groups"]["sort"]))

    # 15c
    ex = ShardedQueryExecutor(device=device)
    ex.admission.configure(max_concurrent=ADMISSION_SLOTS,
                           max_queue=ADMISSION_QUEUE, max_wait_ms=10_000)
    qid = "Q2.1"
    ex.execute(ctxs[qid], segs)
    mark = ex.admission.stats_snapshot()
    rejected, admitted = [], []

    def client(i: int) -> None:
        c = compile_query(ctxs[qid].sql)
        try:
            table, _ = ex.execute(c, segs)
        except QueryRejectedError as e:
            rejected.append((e.reason, e.queue_depth))
            return
        _identical_rows(f"15c {qid}", table.rows, results[qid].rows)
        admitted.append(i)

    for rnd in range(5):
        errors = _threads(8, client)
        if errors:
            raise AssertionError(f"15c: {errors[:3]}")
        if rejected:
            break
    snap = ex.admission.stats_snapshot()
    if not rejected or len(rejected) + len(admitted) != 8 * (rnd + 1) \
            or snap["rejected"] - mark["rejected"] != len(rejected):
        raise AssertionError(f"15c: {len(rejected)} rejected, "
                             f"{len(admitted)} admitted, {snap}")
    out["admission"] = {
        "rounds": rnd + 1, "admitted": len(admitted),
        "rejected": len(rejected),
        "reasons": sorted({r for r, _ in rejected}),
        "queue_depths": sorted({d for _, d in rejected}),
        "max_queue_depth": snap["maxQueueDepth"],
        "queue_wait_ms_max": snap["queueWaitMsMax"]}
    log(f"  15c: 8 threads x {rnd + 1} rounds, {ADMISSION_SLOTS} slots, "
        f"{ADMISSION_QUEUE} queued: {len(admitted)} admitted (== phase 4), "
        f"{len(rejected)} QueryRejectedError "
        + json.dumps(out["admission"]))

    # 15d
    ctx = ctxs[qid]
    got_rows = []
    ex.admission.configure(max_concurrent=-1)
    for rnd in range(5):
        l0, h0 = ex.query_flight.leaders, ex.query_flight.hits
        got_rows.clear()
        errors = _threads(8, lambda i: got_rows.append(
            ex.execute(ctx, segs)[0].rows))
        if errors:
            raise AssertionError(f"15d: {errors[:3]}")
        runs = ex.query_flight.leaders - l0
        if runs < 8:
            break
    if runs >= 8:
        raise AssertionError("15d: no concurrent identical query shared")
    for rows in got_rows:
        _identical_rows(f"15d {qid}", rows, results[qid].rows)
    out["single_flight"] = {"calls": 8, "runs": runs,
                            "shared": ex.query_flight.hits - h0,
                            "rounds": rnd + 1}
    log(f"  15d: 8 identical {qid} calls ran {runs} times "
        + json.dumps(out["single_flight"]))
    del ex

    # 15e
    t0 = time.perf_counter()
    ex = ServerQueryExecutor(device=device)
    pool = {}
    for threads in (1, 8):
        ex.close()
        ex.worker_threads = threads
        for c in ctxs.values():
            ex.execute(c, segs)
        lat = {q: [] for q in ctxs}
        for _ in range(reps):
            for q, c in ctxs.items():
                t1 = time.perf_counter()
                table, _ = ex.execute(c, segs)
                sync()
                lat[q].append((time.perf_counter() - t1) * 1e3)
                _identical_rows(f"15e {q} at {threads} threads", table.rows,
                           results[q].rows)
        pool[threads] = {q: float(np.percentile(v, 50))
                         for q, v in lat.items()}
    ex.close()
    del ex
    out["worker_pool"] = {"p50_ms": pool}
    log("  15e per-segment p50 ms at worker.threads 1 / 8: " + ", ".join(
        f"{q} {pool[1][q]:.3f} / {pool[8][q]:.3f}" for q in ctxs)
        + f"; rows equal ({time.perf_counter() - t0:.1f} s)")

    # 15f
    ctx = ctxs["Q2.1"]
    seg = max(segs, key=lambda s: s.padded_capacity)
    ex = ShardedQueryExecutor(device=device, use_fused_scan=False)
    ex.execute(ctx, segs)       # the batch's jnp-combine columns
    b0 = ex.residency.stats_snapshot()["borrows"]
    table, _ = ex.execute(ctx, [seg])
    snap = ex.residency.stats_snapshot()
    own = ShardedQueryExecutor(device=device, use_fused_scan=False)
    otable, _ = own.execute(ctx, [seg])
    osnap = own.residency.stats_snapshot()
    borrows = snap["borrows"] - b0
    if borrows < 1:
        raise AssertionError("15f: the per-segment query borrowed nothing")
    _identical_rows("15f", table.rows, otable.rows)
    name = seg.segment_name
    out["borrow"] = {
        "borrows": borrows,
        "staged_bytes_with_borrow": snap["stagedBytes"],
        "staged_bytes_without": osnap["stagedBytes"],
        "segment_bytes_with_borrow": ex.residency.resident_nbytes(name),
        "segment_bytes_without": own.residency.resident_nbytes(name)}
    del ex, own
    log("  15f: after the batch query, the one-segment query borrowed "
        f"{borrows} columns; rows equal " + json.dumps(out["borrow"]))
    return out


# -- phase 16: the front door on one card --------------------------------------

# 16: in-process servers of the embedded cluster, each hosting about
# replication / FRONT_SERVERS of phase 4's segments, with a residency budget
# of its share of 0.75 of the card
FRONT_SERVERS = 4
FRONT_REPLICATION = 2
FRONT_TABLE = "ssb_lineorder_OFFLINE"
# 16c: passes of C1-C8 the clients send at each setting: 256 queries, some
# 7 s at the 35-45 QPS of the card's host, so that each setting's QPS and
# p99 rest on hundreds of answers
FRONT_ROUNDS = 32
# 16d: the quota table's queries a second, and the queries sent
QUOTA_QPS = 5
QUOTA_QUERIES = 20
# 16e: tests/test_cluster.py:235's semijoin tables (100 users, 2000 events)
SEMIJOIN_USERS = 100
SEMIJOIN_EVENTS = 2000
SEMIJOIN_SQL = ("SELECT sum(amount) FROM events2 WHERE "
                "inSubquery(uid, 'SELECT idset(uid) FROM users2 "
                "WHERE vip = ''y''') = 1")
# the JAX cluster's decisions for SEMIJOIN_SQL (held to it in
# tests/test_torch_cluster.py): the rewritten filter's left side is a
# function, so the plan sends it to the host engine
SEMIJOIN_DECISIONS = {
    "index:index_gather->scan:index_filter_shape": 1,
    "plan:device_kernel->host_engine:expression_predicate": 1,
    "hybrid:time_split->direct:hybrid_single_table": 1,
}
BROKER_PHASES = ("COMPILATION", "ROUTING", "SCATTER_GATHER", "REDUCE")


def _front_cluster(segs, device: str, servers: int,
                   data_dir: str = None, segment_dirs: list = None):
    """An EmbeddedCluster with ``servers`` servers, each built as
    ``add_server`` builds one but with ``pinot.server.query.hbm.budget
    .bytes`` at 0.75 of the card over the servers; phase 4's segments
    pushed through ``memory://``, or with a ``data_dir`` their
    ``segment_dirs`` pushed through ``file://``. -> (cluster, push to
    queryable s, each server's stagedBytes)."""
    import torch

    from pinot_tpu_torch.spi.table import SegmentsValidationConfig, TableConfig
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster

    cluster = EmbeddedCluster(num_servers=0, device=device,
                              device_reduce=True, data_dir=data_dir)
    for i in range(servers):
        _budget_server(cluster, f"server_{i}", device, servers)
    cluster.create_table(TableConfig(
        FRONT_TABLE, validation_config=SegmentsValidationConfig(
            time_column_name="d_yearmonthnum",
            replication=FRONT_REPLICATION)), segs[0].metadata.schema)
    t0 = time.perf_counter()
    if segment_dirs is not None:
        for d in segment_dirs:
            cluster.upload_segment_dir(FRONT_TABLE, d)
    else:
        for seg in segs:
            cluster.upload_segment(FRONT_TABLE, seg)
    if not cluster.wait_for_ev_converged(FRONT_TABLE, timeout_s=300):
        raise AssertionError("16: the ExternalView did not converge")
    for srv in cluster.servers.values():
        srv.executor.residency.drain_prefetch()
    if device == "cuda":
        torch.cuda.synchronize()
    push_s = time.perf_counter() - t0
    staged = {sid: s.executor.residency.staged_bytes()
              for sid, s in cluster.servers.items()}
    if not all(staged.values()):
        raise AssertionError(f"16: a server staged nothing: {staged}")
    return cluster, push_s, staged


def _budget_server(cluster, sid: str, device: str, budget_servers: int):
    """A server as ``add_server`` builds one but with
    ``pinot.server.query.hbm.budget.bytes`` at 0.75 of the card over
    ``budget_servers`` (phase 16's residency budget)."""
    import torch

    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.server.server import ServerInstance
    from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration

    cfg = None
    if device == "cuda":
        card = torch.cuda.get_device_properties(0).total_memory
        cfg = PinotConfiguration({CommonConstants.HBM_BUDGET_BYTES_KEY:
                                  int(0.75 * card / budget_servers)})
    srv = ServerInstance(sid, cluster.store, cluster.controller.deep_store,
                         completion_protocol=cluster.controller.completion,
                         config=cfg,
                         executor=ServerQueryExecutor(device=device,
                                                      config=cfg),
                         segment_dir=cluster.server_segment_dir)
    srv.start()
    cluster.servers[sid] = srv
    cluster.broker.register_server(sid, srv)
    return srv


def _front_check(what: str, resp, want, phase4=None,
                 device_path: bool = False) -> None:
    """A clean, full answer equal to the oracle (and to phase 4's rows);
    ``device_path``: a group-by with groups merged on the device route."""
    if resp.exceptions or resp.result_table is None \
            or resp.num_servers_responded != resp.num_servers_queried:
        raise AssertionError(f"{what}: {resp.exceptions}, "
                             f"{resp.num_servers_responded} of "
                             f"{resp.num_servers_queried} servers")
    _check_flight(what, resp.result_table, want)
    if phase4 is not None:
        _identical_rows(what, resp.result_table.rows, phase4)
    if device_path and resp.stats.reduce_path != "device":
        raise AssertionError(f"{what}: reducePath {resp.stats.reduce_path}, "
                             f"{resp.stats.decisions}")


def _clients(cluster, sqls: dict, wants: dict, clients: int,
             rounds: int) -> dict:
    """``clients`` threads released together, client i sending C(i+1),
    C(i+2), ... ``rounds`` passes over the ``sqls`` between them; every
    answer checked. -> QPS and latency p50 / p99."""
    ids = sorted(sqls)
    lat = []

    def client(i: int) -> None:
        for k in range(rounds * len(ids) // clients):
            qid = ids[(i + k) % len(ids)]
            t0 = time.perf_counter()
            resp = cluster.query(sqls[qid])
            lat.append((time.perf_counter() - t0) * 1e3)
            _front_check(f"16c {qid}", resp, wants[qid])

    t0 = time.perf_counter()
    errors = _threads(clients, client)
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"16c: {errors[:3]}")
    return {"queries": len(lat), "qps": len(lat) / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def _semijoin_tables(cluster, seed: int) -> dict:
    """users2 / events2 of tests/test_cluster.py:235 and a copy of events2
    under a quota of ``QUOTA_QPS``; -> the numpy answers."""
    from pinot_tpu_torch.spi import DataType, FieldSpec, FieldType, Schema
    from pinot_tpu_torch.spi.table import QuotaConfig, TableConfig

    rng = np.random.default_rng(seed)
    users = {"uid": np.arange(SEMIJOIN_USERS, dtype=np.int64),
             "vip": np.array(["y" if i % 10 == 0 else "n"
                              for i in range(SEMIJOIN_USERS)])}
    events = {"uid": rng.integers(0, SEMIJOIN_USERS, SEMIJOIN_EVENTS),
              "amount": rng.integers(1, 50, SEMIJOIN_EVENTS)}
    user_schema = Schema("users2", [FieldSpec("uid", DataType.LONG),
                                    FieldSpec("vip", DataType.STRING)])
    for name, quota in (("events2", None), ("events_quota", QUOTA_QPS)):
        schema = Schema(name, [FieldSpec("uid", DataType.LONG),
                               FieldSpec("amount", DataType.LONG,
                                         FieldType.METRIC)])
        cluster.create_table(TableConfig(name, quota_config=QuotaConfig(
            max_queries_per_second=quota)), schema)
        cluster.ingest_rows(f"{name}_OFFLINE", schema, events, f"{name}_0")
    cluster.create_table(TableConfig("users2"), user_schema)
    cluster.ingest_rows("users2_OFFLINE", user_schema, users, "users2_0")
    for t in ("users2_OFFLINE", "events2_OFFLINE", "events_quota_OFFLINE"):
        if not cluster.wait_for_ev_converged(t, timeout_s=60):
            raise AssertionError(f"16: {t} did not converge")
    vip = users["uid"][users["vip"] == "y"]
    return {"sum": float(events["amount"].sum()),
            "semijoin": float(events["amount"][
                np.isin(events["uid"], vip)].sum())}


def phase_front_door(main: dict, reps: int, device: str = "cuda",
                     servers: int = FRONT_SERVERS,
                     rounds: int = FRONT_ROUNDS, seed: int = 7) -> dict:
    """Phase 16: the user's entry point on the card. An ``EmbeddedCluster``
    (``pinot_tpu_torch/tools/cluster.py``: controller, ``servers``
    servers with their SEWF schedulers and residency, routing, the broker
    request handler with the device merge) over phase 4's segments pushed
    through ``memory://`` at replication 2.

    (16a) the 13 flights through ``cluster.query(sql)`` ``reps`` times:
    every response clean and full, rows == phase 4's == the oracle,
    reducePath "device" on every group-by with groups, the fused-scan
    launches those of phase 4's kept segments; p50 / p99 and the broker
    phases' p50 per flight, the servers asked (the time-pruned Q1.2 and
    Q3.4: one). (16c) 8 and 1 client threads sending C1-C8, at the
    default 8 SEWF runner threads and at 1: QPS, p50, p99; then 8 threads
    sending one Q2.1 until the broker's single flight coalesces a call,
    rows identical. (16d) 20 queries back to back at a table whose quota
    is 5 a second: 429s counted, admitted answers == numpy. (16e) the
    IN_SUBQUERY semijoin == numpy with the JAX cluster's decisions;
    EXPLAIN PLAN FOR Q2.1: the explain columns, no server asked, no
    launch. (16b, last) one server stopped: routing avoids it and every
    flight is answered in full by the replicas, == oracle."""
    import torch

    from pinot_tpu_torch.parallel.executor import rung_counters, scan_counters
    from pinot_tpu_torch.server.scheduler import make_scheduler
    from pinot_tpu_torch.spi.metrics import BrokerMeter
    from pinot_tpu_torch.tools import ssb

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    segs, ctxs, wants = main["segs"], main["ctxs"], main["wants"]
    results, kept = main["results"], main["kept"]
    sqls = {qid: ctx.sql for qid, ctx in ctxs.items()}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out: dict = {"servers": servers, "replication": FRONT_REPLICATION}
    cluster, push_s, staged = _front_cluster(segs, device, servers)
    out.update(push_to_queryable_s=push_s, staged_bytes=staged)
    log(f"  push to queryable: {len(segs)} segments x {FRONT_REPLICATION} "
        f"replicas on {servers} servers in {push_s:.2f} s, stagedBytes "
        + json.dumps(staged))

    def grouped(qid, resp):
        return ctxs[qid].is_group_by and bool(resp.result_table.rows)

    # 16a
    t0 = time.perf_counter()
    # two untimed passes: the balanced selector alternates between the
    # replicas of a segment with the request id, and 13 flights a pass
    # turn its parity, so each replica plans its flights once
    for _ in range(2):
        for qid, sql in sqls.items():
            _front_check(f"16a {qid}", cluster.query(sql), wants[qid])
    counters = scan_counters()
    _reset(counters)
    lat = {qid: [] for qid in sqls}
    phases = {qid: {p: [] for p in BROKER_PHASES} for qid in sqls}
    queried = {}
    for _ in range(reps):
        for qid, sql in sqls.items():
            t1 = time.perf_counter()
            resp = cluster.query(sql)
            sync()
            lat[qid].append((time.perf_counter() - t1) * 1e3)
            _front_check(f"16a {qid}", resp, wants[qid],
                         results[qid].rows, grouped(qid, resp))
            for p in BROKER_PHASES:
                phases[qid][p].append(resp.phase_times_ms.get(p, 0.0))
            queried[qid] = resp.num_servers_queried
    launches = {name: c.launches for name, c in counters.items()}
    expect = {"fused_scan": sum(kept.values()) * reps,
              "fused_scan_probe": (kept["Q3.2"] + kept["Q4.3"]) * reps,
              "sharded_fused_scan": 0, "sharded_fused_scan_probe": 0}
    if device != "cuda":    # the plain version counts no launch
        expect = {k: 0 for k in expect}
    if launches != expect:
        raise AssertionError(f"16a: launches {launches} != {expect}")
    if queried["Q1.2"] != 1 or queried["Q3.4"] != 1:
        raise AssertionError(f"16a: the time-pruned flights asked "
                             f"{queried['Q1.2']} / {queried['Q3.4']} servers")
    flights = {}
    for qid in sqls:
        flights[qid] = {
            "p50_ms": float(np.percentile(lat[qid], 50)),
            "p99_ms": float(np.percentile(lat[qid], 99)),
            "phase4_p50_ms": main["per_flight"][qid]["p50_ms"],
            "servers_queried": queried[qid],
            "broker_p50_ms": {p: float(np.percentile(v, 50))
                              for p, v in phases[qid].items()}}
        f = flights[qid]
        log(f"  16a {qid}: p50 {f['p50_ms']:.3f} ms  p99 {f['p99_ms']:.3f} "
            f"ms (phase 4: {f['phase4_p50_ms']:.3f}), {queried[qid]} "
            "servers, broker p50 " + ", ".join(
                f"{p} {v:.3f}" for p, v in f["broker_p50_ms"].items()))
    out["flights"] = flights
    out["launches"] = launches
    log(f"  16a: 13 flights x {reps} through cluster.query == phase 4 == "
        f"oracle, clean and full, device reduce on every group-by; "
        f"launches {launches} ({time.perf_counter() - t0:.1f} s)")

    # 16c
    t0 = time.perf_counter()
    variants = {c: main["variant_texts"][c] for c in ssb.COALESCE_QUERIES}
    vwants = {c: main["variant_wants"][c] for c in variants}
    for shift in range(2):      # untimed, on both replicas (as in 16a)
        if shift:   # one more routed query turns the request-id parity
            cluster.query("SELECT count(*) FROM ssb_lineorder")
        for cid, sql in variants.items():
            _front_check(f"16c {cid}", cluster.query(sql), vwants[cid])
    conc = {}
    for runners in (8, 1):
        if runners != 8:
            for srv in cluster.servers.values():
                old, srv.scheduler = srv.scheduler, make_scheduler(
                    "sewf", num_workers=runners)
                old.shutdown()
        for clients in (1, 8):
            r = _clients(cluster, variants, vwants, clients, rounds)
            conc[f"runners{runners}_clients{clients}"] = r
            log(f"  16c {runners} runner threads, {clients} clients: "
                f"{r['queries']} queries, QPS {r['qps']:.1f}, p50 "
                f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms")
    for srv in cluster.servers.values():    # back to the defaults
        old, srv.scheduler = srv.scheduler, make_scheduler("sewf")
        old.shutdown()
    meter = cluster.broker.metrics.meter(BrokerMeter.QUERIES_COALESCED)
    qid = "Q2.1"
    for rnd in range(5):
        c0 = meter.count
        got = []
        errors = _threads(8, lambda i: got.append(cluster.query(sqls[qid])))
        if errors:
            raise AssertionError(f"16c: {errors[:3]}")
        for resp in got:
            _front_check(f"16c {qid}", resp, wants[qid], results[qid].rows)
        if meter.count > c0:
            break
    if meter.count <= c0:
        raise AssertionError("16c: the broker coalesced no identical call")
    conc["single_flight"] = {"calls": 8, "coalesced": meter.count - c0,
                             "rounds": rnd + 1}
    out["concurrency"] = conc
    log(f"  16c: 8 identical {qid} calls, {meter.count - c0} coalesced by "
        f"the broker (round {rnd + 1}); ({time.perf_counter() - t0:.1f} s)")

    # 16d, 16e
    t0 = time.perf_counter()
    answers = _semijoin_tables(cluster, seed)
    codes = []
    for _ in range(QUOTA_QUERIES):
        resp = cluster.query("SELECT sum(amount) FROM events_quota")
        if resp.exceptions:
            codes.append(resp.exceptions[0]["errorCode"])
        elif resp.result_table.rows != [[answers["sum"]]]:
            raise AssertionError(f"16d: {resp.result_table.rows} != "
                                 f"{answers['sum']}")
    if not codes or set(codes) != {429}:
        raise AssertionError(f"16d: rejections {codes}")
    out["quota"] = {"sent": QUOTA_QUERIES, "rejected_429": len(codes),
                    "admitted": QUOTA_QUERIES - len(codes),
                    "qps_quota": QUOTA_QPS}
    log(f"  16d: {QUOTA_QUERIES} queries at a {QUOTA_QPS}/s quota: "
        f"{len(codes)} rejected with 429, {QUOTA_QUERIES - len(codes)} "
        "admitted == numpy")
    resp = cluster.query(SEMIJOIN_SQL)
    if resp.exceptions or resp.num_servers_responded != 1 \
            or resp.result_table.rows != [[answers["semijoin"]]] \
            or resp.stats.decisions != SEMIJOIN_DECISIONS:
        raise AssertionError(f"16e: {resp.exceptions}, "
                             f"{resp.result_table and resp.result_table.rows}"
                             f" != {answers['semijoin']}, "
                             f"{resp.stats.decisions}")
    every = {**scan_counters(), **rung_counters()}
    _reset(every)
    resp = cluster.query("EXPLAIN PLAN FOR " + sqls["Q2.1"])
    spent = {n: c.launches for n, c in every.items() if c.launches}
    if resp.exceptions or resp.num_servers_queried or spent \
            or resp.result_table.schema.column_names != [
                "Operator", "Operator_Id", "Parent_Id"]:
        raise AssertionError(f"16e: EXPLAIN {resp.exceptions}, "
                             f"{resp.num_servers_queried} servers, {spent}")
    out["semijoin"] = {"answer": answers["semijoin"],
                       "decisions": SEMIJOIN_DECISIONS}
    out["explain_rows"] = resp.result_table.rows
    log(f"  16e: the semijoin == numpy ({answers['semijoin']}) with the JAX "
        f"cluster's decisions; EXPLAIN of Q2.1: {len(resp.result_table.rows)}"
        f" operator rows, no server, no launch "
        f"({time.perf_counter() - t0:.1f} s)")

    # 16b
    t0 = time.perf_counter()
    victim = sorted(cluster.servers)[1]
    cluster.stop_server(victim)
    route = cluster.broker.routing.route(FRONT_TABLE)
    if victim in route.routing or route.unavailable:
        raise AssertionError(f"16b: routing still sends to {victim}, "
                             f"unavailable {route.unavailable}")
    lost = {}
    for qid, sql in sqls.items():
        resp = cluster.query(sql)
        _front_check(f"16b {qid}", resp, wants[qid], results[qid].rows)
        lost[qid] = resp.num_servers_queried
    out["server_lost"] = {"stopped": victim, "servers_queried": lost}
    log(f"  16b: {victim} stopped: every flight == oracle, in full from the "
        f"replicas ({time.perf_counter() - t0:.1f} s)")

    if device == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"  16: torch.cuda.max_memory_allocated "
            f"{out['max_memory_allocated']} bytes")
    cluster.shutdown()
    return out


# -- phase 17: realtime and hybrid tables through the front door ---------------

# 17a: the user-events table as a 2-partition realtime table at replication
# 2 (Pinot's default flush is 5 M rows a segment; cut because four replicas
# index rows one at a time in Python under one GIL; halved with 17b and 17c
# when phase 21 joined the script)
RT_USER_ROWS = 250_000
RT_USER_FLUSH = 50_000
# 17b: rows added a partition under 4 client threads (each partition's
# third segment seals)
RT_MORE_ROWS = 25_000
RT_CLIENTS = 4
# 17c: the hybrid SSB table's realtime side, over segment 7's months
RT_SSB_ROWS = 75_000
RT_SSB_FLUSH = 50_000
# 17d: an upsert table keyed on user_id, one partition
RT_UPSERT_ROWS = 110_000
RT_UPSERT_FLUSH = 25_000
RT_WAIT_S = 300.0
_RT_TABLE = "user_events_REALTIME"
_SSB_RT_TABLE = "ssb_lineorder_REALTIME"


def _full(what: str, resp) -> None:
    """A clean answer every server queried gave."""
    if resp.exceptions or resp.result_table is None \
            or resp.num_servers_responded != resp.num_servers_queried:
        raise AssertionError(f"{what}: {resp.exceptions}, "
                             f"{resp.num_servers_responded} of "
                             f"{resp.num_servers_queried} servers")


def _settled(cluster, table: str, what: str) -> float:
    """Wait until every consumer of ``table`` on every server is at its
    stream's end and no commit is under way; -> the seconds waited."""
    t0 = time.perf_counter()
    if not cluster.wait_for_consumers(table, timeout_s=RT_WAIT_S):
        states = {c.segment_name: (c.state.value, c.current_offset.value)
                  for c in cluster.consumers(table)}
        raise AssertionError(f"{what}: consumers never settled: {states}")
    return time.perf_counter() - t0


def _realtime_table(config, replication: int):
    from pinot_tpu_torch.spi.table import SegmentsValidationConfig

    config.validation_config = SegmentsValidationConfig(
        time_column_name=config.validation_config.time_column_name,
        replication=replication)
    return config


def _seal_report(cluster, table: str) -> dict:
    """Each server's seals of ``table``: the committer (its hosted object
    is the deep store's), KEEP (its own seal), DISCARD or a fetch; swap
    ms, flush threshold to swap s, each replaced consumer's ingest
    rate."""
    from pinot_tpu_torch.spi.filesystem import segment_url

    kinds = {"COMMIT": 0, "KEEP": 0, "DISCARD_OR_FETCH": 0}
    swap_ms, commit_s, rates = [], [], []
    for server in cluster.servers.values():
        tdm = server.data_manager.get(table)
        if tdm is None:
            continue
        for e in tdm.seals:
            if e["fetched"]:
                kinds["DISCARD_OR_FETCH"] += 1
            else:
                held = tdm._segments.get(e["segment"])
                kept = cluster.controller.deep_store.fetch_segment(
                    segment_url(table, e["segment"]))
                kinds["COMMIT" if held is not None and held.segment is kept
                      else "KEEP"] += 1
            swap_ms.append(e["swap_ms"])
            if "consume_s" in e:
                commit_s.append(e["threshold_to_swap_s"])
                rates.append(e["rows"] / max(e["consume_s"], 1e-9))
    return {"replies": kinds, "seals": len(swap_ms),
            "swap_ms": {"p50": float(np.percentile(swap_ms, 50)),
                        "max": float(max(swap_ms))} if swap_ms else None,
            "threshold_to_swap_s": {"p50": float(np.percentile(commit_s, 50)),
                                    "max": float(max(commit_s))}
            if commit_s else None,
            "ingest_rows_per_s": {"min": float(min(rates)),
                                  "p50": float(np.percentile(rates, 50)),
                                  "max": float(max(rates))}
            if rates else None}


def _deep_entries(cluster, table: str) -> int:
    """The deep store's segments of ``table`` (every ONLINE segment's)."""
    n = 0
    for md in cluster.store.segment_metadata_list(table):
        if md.status == "ONLINE":
            cluster.controller.deep_store.fetch_segment(md.download_url)
            n += 1
    return n


def _log_seals(what: str, rep: dict, deep: int) -> None:
    r = rep["ingest_rows_per_s"] or {}
    s = rep["swap_ms"] or {}
    c = rep["threshold_to_swap_s"] or {}
    log(f"  {what}: {rep['seals']} seals, replies {rep['replies']}; ingest "
        f"{r.get('min', 0):.0f}-{r.get('max', 0):.0f} rows/s a consumer; "
        f"threshold to swap p50 {c.get('p50', 0):.3f} s (max "
        f"{c.get('max', 0):.3f}); swap p50 {s.get('p50', 0):.3f} ms; "
        f"{deep} deep-store entries")


def _segment_counts(cluster, table: str) -> dict:
    ideal = cluster.store.get_ideal_state(table)
    return {"ONLINE": sum("ONLINE" in m.values() for m in ideal.values()),
            "CONSUMING": sum("CONSUMING" in m.values()
                             for m in ideal.values())}


def _rt_user_queries(cluster, ctxs: dict, wants: dict, sealed: int,
                     consuming: int, device: str, counters: dict,
                     what: str) -> dict:
    """U1-U7 and R1-R3 through ``cluster.query``, == ``wants``: R1 and R2
    on the sealed segments' star-tree, every group-by but R3 on
    ``mutable_device`` over the consuming segments; then U2 with
    OPTION(useStarTree=false) on the fused scan over the sealed segments,
    read from the query's own stats (the servers' counts merged), which
    must agree with the process-wide counter around it. -> per query
    ms."""
    from pinot_tpu_torch.tools import usertable

    out = {}
    sqls = {qid: ctx.sql for qid, ctx in ctxs.items()}
    sqls["U2 scan"] = ctxs["U2"].sql + " OPTION(useStarTree=false)"
    for qid, sql in sqls.items():
        base = qid.split()[0]
        n0 = counters["fused_scan"].launches
        t0 = time.perf_counter()
        resp = cluster.query(sql)
        out[qid] = (time.perf_counter() - t0) * 1e3
        _full(f"{what} {qid}", resp)
        usertable.check_rows(base, resp.result_table.rows, wants[base])
        rungs = resp.stats.rung_segments
        if base in SEALED_STARTREE and qid == base \
                and rungs.get("startree_device") != sealed:
            raise AssertionError(f"{what} {qid}: rungs {rungs}")
        if ctxs[base].is_group_by and base != REALTIME_HLL \
                and rungs.get("mutable_device") != consuming:
            raise AssertionError(f"{what} {qid}: rungs {rungs}")
        want = sealed if device == "cuda" else 0
        got = resp.stats.scan_launches
        if got != counters["fused_scan"].launches - n0 \
                or (qid == "U2 scan" and got != want):
            raise AssertionError(
                f"{what} {qid}: {got} fused launches in the stats, "
                f"{counters['fused_scan'].launches - n0} counted, "
                f"not {want}")
    return out


def _rt_users(cluster, frame, user: int, rows: int, flush: int, more: int,
              device: str, counters: dict, seed: int) -> dict:
    """17a and 17b (see ``phase_realtime_cluster``)."""
    import threading

    from pinot_tpu_torch.engine.mutable_staging import resident_name
    from pinot_tpu_torch.ingestion import MemoryStream
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import usertable

    out: dict = {}
    topic = f"user_events_17_{seed}"
    stream = MemoryStream.create(topic, 2)
    messages = usertable.frame_messages(frame)
    ctxs = {qid: compile_query(sql)
            for qid, sql in usertable.realtime_queries(user).items()}
    cluster.create_table(_realtime_table(
        usertable.realtime_table_config(topic, flush), 2),
        usertable.user_schema())
    t0 = time.perf_counter()
    for p in (0, 1):
        stream.produce_many(messages[p:rows:2], partition=p)
    wait_s = _settled(cluster, _RT_TABLE, "17a")
    consume_s = time.perf_counter() - t0
    per_part = rows // 2
    want_counts = {"ONLINE": 2 * (per_part // flush),
                   "CONSUMING": 2}
    counts = _segment_counts(cluster, _RT_TABLE)
    left = {c.segment_name: c.rows_indexed
            for c in cluster.consumers(_RT_TABLE)}
    if counts != want_counts or set(left.values()) != {per_part % flush}:
        raise AssertionError(f"17a: segments {counts} != {want_counts}, "
                             f"consuming rows {left}")
    seals = _seal_report(cluster, _RT_TABLE)
    deep = _deep_entries(cluster, _RT_TABLE)
    _log_seals("17a", seals, deep)
    log(f"  17a: {rows} rows on 2 partitions x 2 replicas consumed, sealed "
        f"and settled in {consume_s:.1f} s (settle wait {wait_s:.1f} s); "
        f"segments {counts}, {per_part % flush} rows consuming a partition")
    wants = usertable.realtime_answers(usertable.frame_prefix(frame, rows),
                                       user)
    sealed, consuming = counts["ONLINE"], counts["CONSUMING"]
    lat = {}
    for _ in range(3):
        for qid, v in _rt_user_queries(cluster, ctxs, wants, sealed,
                                       consuming, device, counters,
                                       "17a").items():
            lat.setdefault(qid, []).append(v)
    out["users"] = {"rows": rows, "flush": flush, "segments": counts,
                    "consume_s": consume_s, "seals": seals,
                    "deep_store_entries": deep,
                    "per_query_ms": {q: {"p50": float(np.percentile(v, 50)),
                                         "max": float(max(v))}
                                     for q, v in lat.items()}}
    log("  17a: U1-U7, R1-R3 through cluster.query == the oracle over "
        f"{rows} rows, R1/R2 on {sealed} sealed segments' star-tree, the "
        f"group-bys on mutable_device over {consuming} consuming, U2 opted "
        f"out on the fused scan over {sealed}; p50 ms "
        + ", ".join(f"{q} {out['users']['per_query_ms'][q]['p50']:.1f}"
                    for q in lat))

    # 17b: seals under queries
    total = rows + 2 * more
    count_sql = "SELECT count(*) FROM user_events"
    stop, errors, seen = threading.Event(), [], []

    def client(i):
        try:
            k = 0
            while not stop.is_set():
                sql = count_sql if (i + k) % 2 == 0 else ctxs["U2"].sql
                resp = cluster.query(sql)
                _full("17b", resp)
                if sql == count_sql:
                    seen.append(resp.result_table.rows[0][0])
                k += 1
        except Exception as e:  # raised again below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,),
                                name=f"17b-client-{i}")
               for i in range(RT_CLIENTS)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    try:
        for p in (0, 1):
            stream.produce_many(messages[rows + p:total:2], partition=p)
        _settled(cluster, _RT_TABLE, "17b")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=RT_WAIT_S)
    seal_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if not seen or min(seen) < rows or max(seen) > total:
        raise AssertionError(f"17b: counts {min(seen, default=None)}.."
                             f"{max(seen, default=None)} outside "
                             f"[{rows}, {total}]")
    counts = _segment_counts(cluster, _RT_TABLE)
    per_part = total // 2
    if counts["ONLINE"] != 2 * (per_part // flush):
        raise AssertionError(f"17b: segments {counts}")
    wants = usertable.realtime_answers(frame, user)
    for qid, sql in (("count", count_sql), ("U2", ctxs["U2"].sql)):
        resp = cluster.query(sql)
        _full(f"17b {qid}", resp)
        if qid == "count":
            if resp.result_table.rows != [[total]]:
                raise AssertionError(f"17b: count {resp.result_table.rows}")
        else:
            usertable.check_rows("U2", resp.result_table.rows, wants["U2"])
    left = []
    for server in cluster.servers.values():
        names = set(server.executor.residency.resident_names())
        tdm = server.data_manager.get(_RT_TABLE)
        if tdm is None:
            continue
        for seg in tdm.segment_names():
            if not getattr(tdm._segments[seg].segment, "is_mutable", False) \
                    and resident_name(seg) in names:
                left.append((server.instance_id, seg))
    if left:
        raise AssertionError(f"17b: sealed segments' mutable residents "
                             f"left on the card: {left}")
    out["seals_under_queries"] = {
        "rows": total, "queries": len(seen), "count_min": min(seen),
        "count_max": max(seen), "seconds": seal_s, "segments": counts}
    log(f"  17b: {2 * more} more rows sealed each partition's third segment "
        f"under {RT_CLIENTS} clients in {seal_s:.1f} s: {len(seen)} counts "
        f"in [{min(seen)}, {max(seen)}], none partial; count and U2 == the "
        f"oracle over {total} rows; no sealed segment's mutable resident "
        "left on the card")
    out["sealed_segment"] = next(
        tdm._segments[seg].segment
        for server in cluster.servers.values()
        for tdm in [server.data_manager.get(_RT_TABLE)] if tdm is not None
        for seg in tdm.segment_names()
        if not getattr(tdm._segments[seg].segment, "is_mutable", False))
    cluster.controller.delete_table(_RT_TABLE)
    if not _until_none(cluster, _RT_TABLE):
        raise AssertionError("17b: consumers outlived the table's delete")
    MemoryStream.delete(topic)
    return out


def _until_none(cluster, table: str, timeout_s: float = 60.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while cluster.consumers(table):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def _rt_hybrid(cluster, main: dict, seed: int, rows: int, flush: int,
               reps: int, device: str, counters: dict, front: dict) -> dict:
    """17c (see ``phase_realtime_cluster``)."""
    from pinot_tpu_torch.ingestion import MemoryStream
    from pinot_tpu_torch.spi.table import (
        SegmentsValidationConfig,
        StreamIngestionConfig,
        TableConfig,
        TableType,
    )
    from pinot_tpu_torch.tools import ssb

    segs, ctxs = main["segs"], main["ctxs"]
    topic = f"ssb_lineorder_17_{seed}"
    stream = MemoryStream.create(topic, 1)
    t0 = time.perf_counter()
    rt = ssb.generate_segment_frame(7, 8, rows, seed + 1)
    stream.produce_many([json.dumps(r) for r in ssb.frame_rows(rt)])
    cluster.controller.add_table(TableConfig(
        ssb.TABLE, TableType.REALTIME,
        validation_config=SegmentsValidationConfig(
            time_column_name="d_yearmonthnum",
            replication=FRONT_REPLICATION),
        stream_config=StreamIngestionConfig(
            stream_type="memory", topic=topic,
            segment_flush_threshold_rows=flush)))
    _settled(cluster, _SSB_RT_TABLE, "17c")
    consume_s = time.perf_counter() - t0
    boundary = cluster.broker.routing.time_boundary.get_boundary(FRONT_TABLE)
    months = [int(s.metadata.columns["d_yearmonthnum"].max_value)
              for s in segs]
    if boundary != max(months) - 1:
        raise AssertionError(f"17c: boundary {boundary}, months {months}")
    # the oracle: each offline frame's rows up to the boundary (phase 4's
    # partial answers where a segment lies under it), the realtime rows
    # past it
    over = [i for i, m in enumerate(months) if m > boundary]
    frames = {i: ssb.generate_segment_frame(i, len(segs), segs[i].num_docs,
                                            main["seed"]) for i in over}

    def masked(frame, keep):
        return {c: v[keep] for c, v in frame.items()}

    wants = {}
    for qid in ctxs:
        parts = [p for i, p in enumerate(main["parts"][qid])
                 if i not in over]
        parts += [ssb.numpy_answer(masked(
            f, f["d_yearmonthnum"] <= boundary), qid)
            for f in frames.values()]
        parts.append(ssb.numpy_answer(
            masked(rt, rt["d_yearmonthnum"] > boundary), qid))
        wants[qid] = ssb.merge_answers(parts)
    rt_sealed = [
        s for server in cluster.servers.values()
        for tdm in [server.data_manager.get(_SSB_RT_TABLE)] if tdm
        for name in tdm.segment_names()
        for s in [tdm._segments[name].segment]
        if not getattr(s, "is_mutable", False)]
    rt_sealed = list({s.segment_name: s for s in rt_sealed}.values())
    seals = _seal_report(cluster, _SSB_RT_TABLE)
    _log_seals("17c", seals, _deep_entries(cluster, _SSB_RT_TABLE))
    log(f"  17c: {rows} realtime SSB rows over segment 7's months consumed "
        f"and sealed in {consume_s:.1f} s; boundary {boundary}; "
        f"{len(rt_sealed)} sealed, "
        f"{_segment_counts(cluster, _SSB_RT_TABLE)['CONSUMING']} consuming")
    lat = {qid: [] for qid in ctxs}
    scans = {"fused_scan": 0, "fused_scan_probe": 0}
    sealed_scans = 0
    key = "hybrid:realtime_all->time_split:hybrid_time_split"
    for _ in range(reps):
        for qid, ctx in ctxs.items():
            n0 = {k: counters[k].launches for k in scans}
            t1 = time.perf_counter()
            resp = cluster.query(ctx.sql)
            lat[qid].append((time.perf_counter() - t1) * 1e3)
            n = {k: counters[k].launches - n0[k] for k in scans}
            _full(f"17c {qid}", resp)
            _check_flight(f"17c {qid}", resp.result_table, wants[qid])
            if resp.stats.decisions.get(key) != 1:
                raise AssertionError(f"17c {qid}: {resp.stats.decisions}")
            # the offline side's kept segments, and the sealed realtime
            # segment where no star-tree serves it
            extra = n["fused_scan"] - (
                main["kept"][qid] if device == "cuda" else 0)
            if not 0 <= extra <= (len(rt_sealed) if device == "cuda"
                                  else 0):
                raise AssertionError(f"17c {qid}: {n} fused launches, "
                                     f"{main['kept'][qid]} offline "
                                     "segments kept")
            sealed_scans += extra
            for k in scans:
                scans[k] += n[k]
    if device == "cuda" and not sealed_scans:
        raise AssertionError("17c: no flight scanned the sealed realtime "
                             "segment")
    flights = {qid: {"p50_ms": float(np.percentile(v, 50)),
                     "p99_ms": float(np.percentile(v, 99)),
                     "phase16_p50_ms": front.get(qid, {}).get("p50_ms")}
               for qid, v in lat.items()}
    for qid, f in flights.items():
        log(f"  17c {qid}: p50 {f['p50_ms']:.3f} ms p99 {f['p99_ms']:.3f} "
            f"ms (phase 16: {f['phase16_p50_ms']})")
    log(f"  17c: 13 flights x {reps} == the split oracle, every one "
        f"hybrid_time_split; fused launches {scans}, {sealed_scans} of "
        "them on the sealed realtime segment")
    cluster.controller.delete_table(_SSB_RT_TABLE)
    if not _until_none(cluster, _SSB_RT_TABLE):
        raise AssertionError("17c: consumers outlived the table's delete")
    MemoryStream.delete(topic)
    return {"rows": rows, "flush": flush, "boundary": boundary,
            "consume_s": consume_s, "seals": seals,
            "sealed_segments": len(rt_sealed), "flights": flights,
            "launches": scans, "sealed_scans": sealed_scans}


def _rt_upsert(cluster, seed: int, user: int, rows: int, flush: int,
               device: str) -> dict:
    """17d (see ``phase_realtime_cluster``)."""
    from pinot_tpu_torch.ingestion import MemoryStream
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import usertable

    topic = f"user_events_upsert_17_{seed}"
    stream = MemoryStream.create(topic, 1)
    frame = usertable.generate_frame(1, 2, rows, seed)
    t0 = time.perf_counter()
    stream.produce_many(usertable.frame_messages(frame))
    cluster.create_table(_realtime_table(
        usertable.realtime_table_config(topic, flush, upsert=True), 2),
        usertable.user_schema(["user_id"]))
    _settled(cluster, _RT_TABLE, "17d")
    consume_s = time.perf_counter() - t0
    counts = _segment_counts(cluster, _RT_TABLE)
    if counts != {"ONLINE": rows // flush, "CONSUMING": 1}:
        raise AssertionError(f"17d: segments {counts}")
    wants = usertable.realtime_answers(usertable.latest_per_user(frame),
                                       user)
    ms = {}
    for qid, sql in usertable.queries(user).items():
        t1 = time.perf_counter()
        resp = cluster.query(sql)
        ms[qid] = (time.perf_counter() - t1) * 1e3
        _full(f"17d {qid}", resp)
        usertable.check_rows(qid, resp.result_table.rows, wants[qid])
    seals = _seal_report(cluster, _RT_TABLE)
    _log_seals("17d", seals, _deep_entries(cluster, _RT_TABLE))
    live = len(np.unique(frame["user_id"]))
    log(f"  17d: upsert on user_id, {rows} rows ({live} users live) "
        f"consumed and sealed in {consume_s:.1f} s, segments {counts}: "
        "U1-U7 == the oracle over each user's latest row; ms "
        + ", ".join(f"{q} {v:.1f}" for q, v in ms.items()))
    cluster.controller.delete_table(_RT_TABLE)
    if not _until_none(cluster, _RT_TABLE):
        raise AssertionError("17d: consumers outlived the table's delete")
    MemoryStream.delete(topic)
    return {"rows": rows, "flush": flush, "live_users": live,
            "segments": counts, "consume_s": consume_s, "seals": seals,
            "per_query_ms": ms}


def phase_realtime_cluster(main: dict, reps: int, device: str = "cuda",
                           servers: int = FRONT_SERVERS,
                           user_rows: int = RT_USER_ROWS,
                           user_flush: int = RT_USER_FLUSH,
                           more_rows: int = RT_MORE_ROWS,
                           ssb_rows: int = RT_SSB_ROWS,
                           ssb_flush: int = RT_SSB_FLUSH,
                           upsert_rows: int = RT_UPSERT_ROWS,
                           upsert_flush: int = RT_UPSERT_FLUSH,
                           front: dict = None, seed: int = 42,
                           hand_over: list = None) -> dict:
    """Phase 17: realtime and hybrid tables through the front door. Phase
    16's cluster again (``servers`` servers, the residency budget, the
    device merge, phase 4's segments pushed as ``ssb_lineorder_OFFLINE``
    at replication 2), every server negotiating its commits with the
    controller's completion FSM; ``cluster.query`` is the only entry
    point, and every answer must be clean and full.

    (17a) ``user_events_REALTIME``: the user-events table at its full
    width (``user_schema()``, ``user_indexing_config()``), JSON messages
    of ``user_rows`` rows on a 2-partition ``MemoryStream`` (row i to
    partition i % 2), a flush at ``user_flush`` rows, replication 2.
    Once every consumer is at the stream's end: 2 sealed segments and the
    rest consuming a partition; U1-U7 and R1-R3 == the oracle, R1 and R2
    on the sealed segments' star-tree, the group-bys on ``mutable_device``
    over the consuming segments, U2 with OPTION(useStarTree=false) on the
    fused scan over the sealed ones; ingest rate a consumer, flush
    threshold to swap, the replies by kind, swap ms, deep-store entries.
    (17b) ``more_rows`` more a partition while ``RT_CLIENTS`` threads send
    count(*) and U2: each partition's third segment seals, every count in
    [user_rows, user_rows + 2 more_rows], no partial answer; then both ==
    the oracle, and no sealed segment's mutable resident is left on the
    card. (17c) a hybrid SSB table: ``ssb_lineorder_REALTIME`` (1
    partition, replication 2, flush ``ssb_flush``) carries ``ssb_rows``
    rows of a fresh frame over segment 7's months as JSON; the boundary is
    the offline side's largest month less 1, every flight records
    ``hybrid_time_split``, the 13 flights ``reps`` times == the oracle
    over the offline rows up to the boundary and the realtime rows past
    it, and the fused-scan launches are those of the segments each side's
    pruner keeps, less those a star-tree serves; p50 / p99 beside phase
    16's. (17d) ``user_events`` again as an upsert table on user_id (1
    partition, replication 2, ``upsert_rows`` rows, flush
    ``upsert_flush``): U1-U7 == the oracle over each user's latest row.
    On the card, one sealed realtime segment's U2 scan is held against the
    kernel's plain version and timed. -> the report, with the fused
    launches of 17a and 17c (``launches``) and the timing rows. With
    ``hand_over`` (a list), a cluster that passed every check is appended
    to it instead of shut down (phase 18 runs on it)."""
    import torch

    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.tools import usertable

    t_all = time.perf_counter()
    out: dict = {"servers": servers, "replication": FRONT_REPLICATION}
    cluster, push_s, _ = _front_cluster(main["segs"], device, servers)
    log(f"  17: {servers} servers, phase 4's segments pushed in "
        f"{push_s:.2f} s")
    counters = scan_counters()
    _reset(counters)
    total = user_rows + 2 * more_rows
    passed = False
    try:
        frame = usertable.generate_frame(0, 1, total, seed)
        users = usertable.tail_users(total, 1, seed)
        user = users[len(users) // 2]
        t0 = time.perf_counter()
        out.update(_rt_users(cluster, frame, user, user_rows, user_flush,
                             more_rows, device, counters, seed))
        out["users"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["hybrid"] = _rt_hybrid(cluster, main, seed, ssb_rows, ssb_flush,
                                   reps, device, counters, front or {})
        out["hybrid"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["upsert"] = _rt_upsert(cluster, seed, user, upsert_rows,
                                   upsert_flush, device)
        out["upsert"]["seconds"] = time.perf_counter() - t0
        passed = True
    finally:
        if passed and hand_over is not None:
            hand_over.append(cluster)
        else:
            cluster.shutdown()
    out["launches"] = {k: counters[k].launches
                       for k in ("fused_scan", "fused_scan_probe")}
    if device == "cuda" and not all(out["launches"].values()):
        raise AssertionError(f"17: launches {out['launches']}")
    sealed = out.pop("sealed_segment")
    timing, errs = [], {"fused_scan": 0.0, "fused_scan_probe": 0.0}
    if device == "cuda":
        ex = ServerQueryExecutor(device=device)
        staged = ex.stage(sealed)
        sql = usertable.realtime_queries(user)["U2"]
        timing = _time_kernels({"U2 sealed in the cluster": (
            staged, sealed.num_docs, sql)}, errs, 20)
        if any(v != 0.0 for v in errs.values()):
            raise AssertionError(f"17: kernel against plain {errs}")
        del ex, staged
        torch.cuda.empty_cache()
    out["timing"], out["errs"] = timing, errs
    out["seconds"] = time.perf_counter() - t_all
    return out


# -- phase 18: tracing and telemetry through the front door ------------------------

# the flights whose group space the fused scan narrows with a probe (phase
# 16a's count of probe launches)
PROBE_FLIGHTS = ("Q3.2", "Q4.3")
# 18b: client threads and passes over C1-C8
TRACE_CLIENTS = 8
TRACE_ROUNDS = 2
# 18c: phase 17's realtime tables, by their raw names
RT_FRESH_TABLES = ("user_events", "ssb_lineorder")


def _spans(d: dict):
    yield d
    for c in d.get("children", ()):
        yield from _spans(c)


def _tree_text(d: dict) -> str:
    """A span tree on one line: name ms [children]."""
    kids = d.get("children")
    tag = d.get("instance") or d.get("segment") or ""
    head = f"{d['name']}{'@' + tag if tag else ''} {d['ms']:.3f}"
    return head + (" [" + ", ".join(_tree_text(c) for c in kids) + "]"
                   if kids else "")


def _check_trace(what: str, resp) -> dict:
    """One traced response's tree: a broker root with Compile, Routing,
    ScatterGather and Reduce, one ServerQuery a queried server under
    ScatterGather tagged with its instance (SchedulerQueue first), every
    span closed; the fused-scan Kernel spans' launches == the stats'
    scanLaunches + probeLaunches. -> {kernel spans, their launches}."""
    spans = resp.trace_info.get("spans") if resp.trace_info else None
    if not spans or len(spans) != 1 or spans[0]["name"] != "BrokerQuery":
        raise AssertionError(f"{what}: traceInfo {resp.trace_info}")
    root = spans[0]
    names = [c["name"] for c in root.get("children", [])]
    if [n for n in names if n != "Admission"] != [
            "Compile", "Routing", "ScatterGather", "Reduce"]:
        raise AssertionError(f"{what}: broker children {names}")
    sg = root["children"][names.index("ScatterGather")]
    servers = sg.get("children", [])
    insts = [s.get("instance") for s in servers]
    if (len(servers) != resp.num_servers_queried
            or any(s["name"] != "ServerQuery" for s in servers)
            or None in insts or len(set(insts)) != len(insts)
            or any(s["children"][0]["name"] != "SchedulerQueue"
                   for s in servers)):
        raise AssertionError(f"{what}: server trees {insts}, "
                             f"{resp.num_servers_queried} queried")
    for d in _spans(root):
        if not isinstance(d.get("ms"), (int, float)) or d["ms"] < 0:
            raise AssertionError(f"{what}: an unclosed span {d['name']}")
    kernels = [d for d in _spans(root) if d["name"] == "Kernel"
               and d.get("kernel") == "fused_scan"]
    launched = sum(d["launches"] for d in kernels)
    if launched != resp.stats.scan_launches + resp.stats.probe_launches:
        raise AssertionError(
            f"{what}: Kernel spans count {launched} launches, the stats "
            f"{resp.stats.scan_launches} + {resp.stats.probe_launches}")
    if not all(e.get("instance") for e in resp.trace_info["entries"]):
        raise AssertionError(f"{what}: an untagged trace entry")
    return {"kernel_spans": len(kernels), "launches": launched}


def _histo_counts(snap: dict) -> dict:
    return {k: h["lifetime"]["count"]
            for k, h in snap["histograms"].items()}


def phase_trace(main: dict, reps: int, device: str = "cuda",
                cluster=None, servers: int = FRONT_SERVERS,
                fresh_tables: tuple = ()) -> dict:
    """Phase 18: tracing and telemetry through the front door, on
    ``cluster`` (phase 17's, handed over) or on a new phase 16 cluster;
    shut down at the end either way.

    (18a) the 13 flights with OPTION(trace=true) through
    ``cluster.query`` ``reps`` times == phase 4's rows (and the oracle),
    each response's tree checked (``_check_trace``): the fused-scan
    Kernel spans one a kept segment, their launches == the servers'
    scanLaunches + probeLaunches == phase 16a's for the flight; then the
    flight untraced: no traceInfo. Logged per flight: each span name's
    p50, the first traced pass's whole tree and the slowest of the other
    passes' (the p99 query at ``reps`` 5). (18b) C1-C8 traced,
    each alone first, then from ``TRACE_CLIENTS`` threads: every query's
    launch counts == its solo counts, rows == the oracle. (18c) the
    broker's four telemetry snapshots and each server's five debug views
    serve JSON; the broker histogram's count grew by the queries sent and
    server_exec's by the servers they asked; ``fresh_tables`` are in the
    freshness view; the decision ledger's delta == the sum of the
    responses' decisions; after the shutdown no sampler thread runs and
    the cluster's recorder directory is gone. -> the report, with the
    fused launches of 18a-b (``launches``)."""
    import threading

    from pinot_tpu_torch.common.telemetry import TELEMETRY
    from pinot_tpu_torch.common.tracing import LEDGER
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.tools import ssb

    t_all = time.perf_counter()
    if cluster is None:
        cluster, _, _ = _front_cluster(main["segs"], device, servers)
    flight_dir = cluster._flight_dir
    ctxs, wants, results, kept = (main["ctxs"], main["wants"],
                                  main["results"], main["kept"])
    out: dict = {}
    counters = scan_counters()
    responses: dict = {}     # id -> response (a shared flight counts once)
    try:
        t0 = time.perf_counter()
        ledger0 = LEDGER.snapshot()
        hist0 = _histo_counts(cluster.broker.telemetry_snapshot())
        _reset(counters)
        sent = asked = 0
        flights = {}
        for qid, ctx in ctxs.items():
            per_name: dict = {}
            trees = []
            want_launches = 0
            if device == "cuda":
                want_launches = kept[qid] * (2 if qid in PROBE_FLIGHTS
                                             else 1)
            for _ in range(reps):
                resp = cluster.query(ctx.sql + " OPTION(trace=true)")
                responses[id(resp)] = resp
                sent += 1
                asked += resp.num_servers_queried
                _front_check(f"18a {qid}", resp, wants[qid],
                             results[qid].rows)
                got = _check_trace(f"18a {qid}", resp)
                if got["kernel_spans"] != kept[qid] \
                        or got["launches"] != want_launches:
                    raise AssertionError(
                        f"18a {qid}: {got} for {kept[qid]} kept segments, "
                        f"phase 16a launched {want_launches}")
                root = resp.trace_info["spans"][0]
                trees.append(root)
                for d in _spans(root):
                    per_name.setdefault(d["name"], []).append(d["ms"])
            resp = cluster.query(ctx.sql)
            responses[id(resp)] = resp
            sent += 1
            asked += resp.num_servers_queried
            _front_check(f"18a {qid} untraced", resp, wants[qid],
                         results[qid].rows)
            if resp.trace_info or "traceInfo" in resp.to_dict():
                raise AssertionError(f"18a {qid}: an untraced query carries "
                                     "traceInfo")
            # the first traced pass (it stages what phase 17 evicted)
            # apart from the slowest of the rest
            first = trees[0]
            slowest = max(trees[1:], key=lambda d: d["ms"], default=None)
            flights[qid] = {
                "kernel_spans": kept[qid], "launches": want_launches,
                "span_p50_ms": {n: float(np.percentile(v, 50))
                                for n, v in per_name.items()},
                "first_ms": first["ms"], "first_tree": first,
                "slowest_ms": slowest and slowest["ms"],
                "slowest_tree": slowest}
            log(f"  18a {qid}: span p50 ms " + ", ".join(
                f"{n} {v:.3f}" for n, v in
                flights[qid]["span_p50_ms"].items()))
            log(f"  18a {qid} first pass: {_tree_text(first)}")
            if slowest is not None:
                log(f"  18a {qid} slowest of the other {reps - 1}: "
                    f"{_tree_text(slowest)}")
        out["flights"] = flights
        log(f"  18a: 13 flights x {reps} traced == phase 4 == oracle, trees "
            f"checked, Kernel spans == the stats' launches == phase 16a's; "
            f"untraced runs carry no traceInfo "
            f"({time.perf_counter() - t0:.1f} s)")

        # 18b
        t0 = time.perf_counter()
        variants = {c: main["variant_texts"][c] + " OPTION(trace=true)"
                    for c in ssb.COALESCE_QUERIES}
        vwants = {c: main["variant_wants"][c] for c in variants}
        solo = {}
        for cid, sql in variants.items():
            resp = cluster.query(sql)
            responses[id(resp)] = resp
            sent += 1
            asked += resp.num_servers_queried
            _front_check(f"18b {cid} solo", resp, vwants[cid])
            _check_trace(f"18b {cid} solo", resp)
            solo[cid] = resp.stats.launch_counts()
        ids = sorted(variants)
        got = []
        lock = threading.Lock()

        def client(i: int) -> None:
            for k in range(TRACE_ROUNDS):
                cid = ids[(i + k) % len(ids)]
                resp = cluster.query(variants[cid])
                with lock:
                    got.append((cid, resp))

        errors = _threads(TRACE_CLIENTS, client)
        if errors:
            raise AssertionError(f"18b: {errors[:3]}")
        for cid, resp in got:
            _front_check(f"18b {cid}", resp, vwants[cid])
            _check_trace(f"18b {cid}", resp)
            if resp.stats.launch_counts() != solo[cid]:
                raise AssertionError(
                    f"18b {cid}: launches {resp.stats.launch_counts()} "
                    f"under {TRACE_CLIENTS} clients, solo {solo[cid]}")
            if id(resp) not in responses:
                responses[id(resp)] = resp
                sent += 1
                asked += resp.num_servers_queried
        out["concurrency"] = {"clients": TRACE_CLIENTS,
                              "queries": len(got), "solo": solo}
        log(f"  18b: C1-C8 from {TRACE_CLIENTS} client threads, "
            f"{len(got)} queries, each with its solo launch counts "
            f"({time.perf_counter() - t0:.1f} s)")
        out["launches"] = {k: counters[k].launches
                           for k in ("fused_scan", "fused_scan_probe")}
        summed = {"fused_scan": 0, "fused_scan_probe": 0}
        for resp in responses.values():
            summed["fused_scan"] += resp.stats.scan_launches
            summed["fused_scan_probe"] += resp.stats.probe_launches
        if summed != out["launches"]:
            raise AssertionError(f"18: the responses count {summed}, the "
                                 f"process {out['launches']}")

        # 18c
        t0 = time.perf_counter()
        views = {name: getattr(cluster.broker, name)() for name in (
            "telemetry_snapshot", "slo_snapshot", "freshness_snapshot",
            "flightrecorder_snapshot")}
        for sid, srv in cluster.servers.items():
            for name in ("queries_debug", "telemetry_debug", "slo_debug",
                         "freshness_debug", "flightrecorder_debug"):
                views[f"{sid}.{name}"] = getattr(srv, name)()
        json.loads(json.dumps(views))
        hist = _histo_counts(views["telemetry_snapshot"])
        grew = {k: hist.get(k, 0) - hist0.get(k, 0) for k in hist}
        table = FRONT_TABLE.rsplit("_", 1)[0]
        if grew.get(f"{table}:broker") != sent \
                or grew.get(f"{table}:server_exec") != asked:
            raise AssertionError(f"18c: histogram counts grew {grew}, "
                                 f"{sent} queries sent asking {asked} "
                                 "servers")
        missing = [t for t in fresh_tables
                   if t not in views["freshness_snapshot"]["tables"]]
        if missing:
            raise AssertionError(f"18c: no freshness for {missing}")
        decisions: dict = {}
        for resp in responses.values():
            for k, v in resp.stats.decisions.items():
                decisions[k] = decisions.get(k, 0) + v
        ledger = LEDGER.delta(ledger0)
        if ledger != decisions:
            raise AssertionError(f"18c: ledger delta {ledger} != the "
                                 f"responses' {decisions}")
        out["ledger"] = {"equal": True, "delta": ledger}
        out["telemetry"] = {
            "broker_count": grew[f"{table}:broker"],
            "server_exec_count": grew[f"{table}:server_exec"],
            "grew": grew,
            "freshness": {t: b["histogram"]["lifetime"]
                          for t, b in
                          views["freshness_snapshot"]["tables"].items()},
            "events": views["telemetry_snapshot"]["events"],
            "frozen": views["flightrecorder_snapshot"]["frozen"]}
        log(f"  18c: telemetry histograms grew {grew}; freshness tables "
            f"{sorted(views['freshness_snapshot']['tables'])}; ledger "
            f"delta == the responses' decisions ({sum(ledger.values())} "
            f"records); every debug view JSON "
            f"({time.perf_counter() - t0:.1f} s)")
    finally:
        cluster.shutdown()
    if TELEMETRY.sampling:
        raise AssertionError("18: the telemetry sampler outlived the "
                             "cluster")
    if flight_dir is not None and os.path.exists(flight_dir):
        raise AssertionError(f"18: {flight_dir} outlived the cluster")
    out["flight_dir"] = flight_dir
    out["seconds"] = time.perf_counter() - t_all
    return out


# -- phase 19: segments on disk and the reload ------------------------------------

# 19c: the SSB columns reloaded with an inverted index (their flights' every
# filter column where both are, so those flights leave index_missing_index)
# and a bloom filter
DISK_INVERTED = ["d_year", "p_category", "s_region", "c_region"]
DISK_BLOOM = ["p_category", "s_region"]
# the flights whose every filter column is in DISK_INVERTED
DISK_INDEXED_FLIGHTS = ("Q2.1", "Q3.1")
# 19d: an upsert table keyed on user_id in 19b's cluster, one partition at
# replication 2 (tools/usertable.py)
DISK_UPSERT_ROWS = 100_000
DISK_UPSERT_FLUSH = 50_000
_MISSING = "index:index_gather->scan:index_missing_index"


def _dir_bytes(seg_dir: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _d, fs in os.walk(seg_dir) for f in fs)


def _hosted(cluster, table: str) -> dict:
    """{server: {segment: the segment object it serves}}."""
    out = {}
    for sid, srv in cluster.servers.items():
        tdm = srv.data_manager.get(table)
        held = tdm.acquire_segments(None) if tdm is not None else []
        out[sid] = {h.segment_name: h.segment for h in held}
        if tdm is not None:
            tdm.release_segments(held)
    return out


class _DiscardReplica:
    """A server's completion protocol in 19d: the controller's KEEP
    becomes DISCARD, the verdict a replica whose offset differs from the
    committed one gets, so every seal has one replica that fetches the
    committer's directory."""

    def __init__(self, inner):
        self.inner = inner
        self.discards = 0

    def segment_consumed(self, segment_name, instance, offset):
        from pinot_tpu_torch.ingestion.realtime import (
            CompletionReply,
            CompletionResponse,
        )

        reply = self.inner.segment_consumed(segment_name, instance, offset)
        if reply.response is CompletionResponse.KEEP:
            self.discards += 1
            return CompletionReply(CompletionResponse.DISCARD)
        return reply

    def __getattr__(self, name):
        return getattr(self.inner, name)


def phase_disk(main: dict, reps: int, device: str = "cuda",
               servers: int = FRONT_SERVERS,
               upsert_rows: int = DISK_UPSERT_ROWS,
               upsert_flush: int = DISK_UPSERT_FLUSH, seed: int = 7) -> dict:
    """Phase 19: phase 4's segments on disk.
    (19a) ``write_segment`` writes them (the JAX package's layout) into a
    temporary directory, ``verify_crc`` holds for each, ``load_segment``
    loads each; the 13 flights per segment (``reps`` timed passes after a
    first query that stages from the maps) and over the batch: rows
    identical to phase 4's, per-segment launches equal to phase 4's
    count, batch launches as phase 6 counts them. (19b) an
    ``EmbeddedCluster(data_dir=...)`` of ``servers`` servers at
    replication 2 with the directories pushed by ``upload_segment_dir``:
    the flights == 19a's rows, ``table_size`` == the bytes on disk.
    (19c) ``update_table`` adds an inverted index on ``DISK_INVERTED`` and
    a bloom filter on ``DISK_BLOOM``, ``reload_table`` follows: every
    replica serves a new segment object with the indexes (flags, CRC), the
    flights of ``DISK_INDEXED_FLIGHTS`` leave ``index_missing_index``, the
    rows unchanged. (19d) an upsert user-events table in that cluster, one
    partition at replication 2, ``upsert_rows`` rows flushed every
    ``upsert_flush``: every seal a directory on disk, one replica of each
    told DISCARD fetches the committer's directory and registers its keys,
    U1-U7 == the oracle over each user's latest row."""
    import shutil
    import tempfile

    import torch

    from pinot_tpu_torch import native
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.parallel import ShardedQueryExecutor
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.segment.creator import write_segment
    from pinot_tpu_torch.segment.immutable import load_segment, verify_crc

    on_card = device == "cuda"
    segs, ctxs, wants, kept = (main["segs"], main["ctxs"], main["wants"],
                               main["kept"])
    t_all = time.perf_counter()
    root = tempfile.mkdtemp(prefix="pinot_disk_")
    out: dict = {"segments": len(segs)}
    try:
        built = os.path.join(root, "built")
        t0 = time.perf_counter()
        for seg in segs:
            write_segment(seg, built)
        out["write_s"] = time.perf_counter() - t0
        dirs = [os.path.join(built, s.segment_name) for s in segs]
        out["bytes"] = sum(_dir_bytes(d) for d in dirs)
        t0 = time.perf_counter()
        bad = [d for d in dirs if not verify_crc(d)]
        out["verify_crc_s"] = time.perf_counter() - t0
        if bad:
            raise AssertionError(f"19a: CRC does not verify for {bad}")
        t0 = time.perf_counter()
        loaded = [load_segment(d) for d in dirs]
        out["load_s"] = time.perf_counter() - t0
        log(f"  19a: {len(segs)} segments written ({out['bytes']} bytes) "
            f"in {out['write_s']:.1f} s, CRC verified in "
            f"{out['verify_crc_s']:.1f} s, loaded (mapped) in "
            f"{out['load_s']:.3f} s; {native.mmap_buffer_count()} files "
            "mapped")

        counters = scan_counters()
        _reset(counters)
        ex = ServerQueryExecutor(device=device)
        first = next(iter(ctxs))
        t0 = time.perf_counter()
        ex.execute(ctxs[first], loaded)
        if on_card:
            torch.cuda.synchronize()
        out["first_query_ms"] = (time.perf_counter() - t0) * 1e3
        for ctx in ctxs.values():       # untimed: stages the rest
            ex.execute(ctx, loaded)
        if on_card:
            torch.cuda.synchronize()
        _reset(counters)
        lat, results = _run_flights(ex, ctxs, loaded, reps, kept)
        launches = {name: c.launches for name, c in counters.items()}
        expect = ({"fused_scan": sum(kept.values()) * reps,
                   "fused_scan_probe": (kept["Q3.2"] + kept["Q4.3"]) * reps,
                   "sharded_fused_scan": 0, "sharded_fused_scan_probe": 0}
                  if on_card else {k: 0 for k in launches})
        if launches != expect:
            raise AssertionError(f"19a: launch counts {launches} != "
                                 f"{expect} (phase 4's count)")
        for qid, table in results.items():
            _check_flight(qid, table, wants[qid])
            _identical_rows(f"19a {qid}", table.rows,
                            main["results"][qid].rows)
        out["launches"] = launches
        log(f"  19a: the first query ({first}, staging from the maps) "
            f"{out['first_query_ms']:.1f} ms; launches per segment "
            f"{launches} == phase 4's count; 13 flights == phase 4's rows "
            "== numpy oracle")
        out["per_flight"] = _latencies(
            lat, main["rows"] if "rows" in main else 1,
            beside=main.get("per_flight"), beside_label="phase 4")
        del ex
        _reset(counters)
        bex = ShardedQueryExecutor(device=device)
        single = {q: k if k == 1 else 0 for q, k in kept.items()}
        blat, bresults = _run_flights(bex, ctxs, loaded, reps, single)
        blaunch = {name: c.launches for name, c in counters.items()}
        multi = [q for q in ctxs if kept[q] > 1]
        solo = [q for q in ctxs if kept[q] == 1]
        probing = ("Q3.2", "Q4.3")
        runs = reps
        bexpect = ({"fused_scan": len(solo) * runs,
                    "fused_scan_probe": runs * len(
                        [q for q in solo if q in probing]),
                    "sharded_fused_scan": len(multi) * runs,
                    "sharded_fused_scan_probe": len(
                        [q for q in multi if q in probing])}
                   if on_card else {k: 0 for k in blaunch})
        if blaunch != bexpect:
            raise AssertionError(f"19a batch: launch counts {blaunch} != "
                                 f"{bexpect} (phase 6's count)")
        for qid, table in bresults.items():
            _check_flight(qid, table, wants[qid])
        out["batch_launches"] = blaunch
        out["batch_p50_ms"] = {q: float(np.percentile(v[1:], 50))
                               if len(v) > 1 else float(v[0])
                               for q, v in blat.items()}
        log(f"  19a: over the batch (ShardedQueryExecutor, {runs} passes, "
            f"the first binding): launches {blaunch} == phase 6's count; "
            "13 flights == numpy oracle")
        del bex, lat, blat
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        out.update(_disk_cluster(main, results, dirs, loaded, root, reps,
                                 device, servers, upsert_rows, upsert_flush,
                                 seed, counters))
        out["launches"] = {k: out["launches"][k] + out["batch_launches"][k]
                           + out["cluster_launches"][k]
                           for k in out["launches"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_all
    log(f"  phase 19: {out['seconds']:.1f} s")
    return out


def _disk_cluster(main, rows19a, dirs, loaded, root, reps, device, servers,
                  upsert_rows, upsert_flush, seed, counters) -> dict:
    """19b-19d (see ``phase_disk``)."""
    from pinot_tpu_torch.ingestion import MemoryStream
    from pinot_tpu_torch.segment.immutable import verify_crc
    from pinot_tpu_torch.spi.table import (
        IndexingConfig,
        SegmentsValidationConfig,
        TableConfig,
    )
    from pinot_tpu_torch.tools import ssb, usertable

    out: dict = {}
    ctxs, wants = main["ctxs"], main["wants"]
    disk_bytes = {os.path.basename(d): _dir_bytes(d) for d in dirs}
    cluster, push_s, _staged = _front_cluster(
        loaded, device, servers, data_dir=os.path.join(root, "cluster"),
        segment_dirs=dirs)
    try:
        _reset(counters)

        def flights(what: str) -> dict:
            got = {}
            for qid in ctxs:
                resp = cluster.query(ssb.QUERIES[qid] + " LIMIT 100000")
                _front_check(f"{what} {qid}", resp, wants[qid],
                             phase4=rows19a[qid].rows)
                got[qid] = resp.stats.decisions
            return got

        t0 = time.perf_counter()
        before = flights("19b")
        sizes = {sid: srv.table_size(FRONT_TABLE)
                 for sid, srv in cluster.servers.items()}
        hosted = _hosted(cluster, FRONT_TABLE)
        for sid, size in sizes.items():
            for name, seg in hosted[sid].items():
                if size["segments"].get(name) != disk_bytes[name] \
                        or seg.segment_dir not in dirs:
                    raise AssertionError(
                        f"19b: {sid} {name}: table_size "
                        f"{size['segments'].get(name)} != "
                        f"{disk_bytes[name]} bytes on disk "
                        f"({seg.segment_dir})")
        total = sum(s["totalBytes"] for s in sizes.values())
        if total != FRONT_REPLICATION * sum(disk_bytes.values()):
            raise AssertionError(f"19b: table_size {total} != "
                                 f"{FRONT_REPLICATION} x the bytes on disk")
        out["cluster_push_s"] = push_s
        out["cluster_flights_s"] = time.perf_counter() - t0
        out["table_size"] = {sid: s["totalBytes"] for sid, s in sizes.items()}
        log(f"  19b: {servers} servers at replication {FRONT_REPLICATION}, "
            f"{len(dirs)} directories pushed by file:// (served in place) "
            f"and staged in {push_s:.1f} s; 13 flights == 19a's rows; "
            f"table_size {out['table_size']} == the bytes on disk")

        # 19c: the reload
        t0 = time.perf_counter()
        cfg = cluster.store.get_table_config(FRONT_TABLE)
        cfg.indexing_config = IndexingConfig(
            inverted_index_columns=list(DISK_INVERTED),
            bloom_filter_columns=list(DISK_BLOOM))
        cluster.controller.update_table(cfg)
        cluster.controller.reload_table(FRONT_TABLE)
        out["reload_s"] = time.perf_counter() - t0
        failures = [f for srv in cluster.servers.values()
                    for f in srv.reload_failures]
        if failures:
            raise AssertionError(f"19c: reload failures {failures[:3]}")
        after_hosted = _hosted(cluster, FRONT_TABLE)
        for sid, segs_ in after_hosted.items():
            for name, seg in segs_.items():
                cms = [seg.metadata.column(c) for c in DISK_INVERTED]
                if (seg is hosted[sid][name]
                        or not all(cm.has_inverted_index for cm in cms)
                        or not all(seg.metadata.column(c).has_bloom_filter
                                   for c in DISK_BLOOM)
                        or not verify_crc(seg.segment_dir)):
                    raise AssertionError(f"19c: {sid} serves {name} "
                                         "without the reloaded indexes")
        _settle_residency(cluster)
        after = flights("19c")
        for qid in ctxs:
            missing = after[qid].get(_MISSING, 0)
            if qid in DISK_INDEXED_FLIGHTS:
                if missing or not before[qid].get(_MISSING):
                    raise AssertionError(f"19c {qid}: {before[qid]} -> "
                                         f"{after[qid]}")
        out["reload_decisions"] = {
            q: {k: v for k, v in after[q].items() if k.startswith("index:")}
            for q in DISK_INDEXED_FLIGHTS}
        log(f"  19c: update_table + reload_table ({DISK_INVERTED} inverted, "
            f"{DISK_BLOOM} bloom) in {out['reload_s']:.1f} s: every "
            f"replica serves the reloaded segments (new objects, flags, CRC "
            f"verified); {', '.join(DISK_INDEXED_FLIGHTS)} leave "
            f"index_missing_index: {out['reload_decisions']}; 13 flights "
            "== 19a's rows")
        out["cluster_launches"] = {name: c.launches
                                   for name, c in counters.items()}

        # 19d: a realtime upsert table sealing to disk
        t0 = time.perf_counter()
        topic = f"user_events_upsert_19_{seed}"
        stream = MemoryStream.create(topic, 1)
        frame = usertable.generate_frame(1, 2, upsert_rows, seed)
        stream.produce_many(usertable.frame_messages(frame))
        gates = {}
        for sid, srv in cluster.servers.items():
            gates[sid] = srv.completion_protocol = _DiscardReplica(
                srv.completion_protocol)
        rcfg = usertable.realtime_table_config(topic, upsert_flush,
                                               upsert=True)
        rcfg.validation_config = SegmentsValidationConfig(
            time_column_name=rcfg.validation_config.time_column_name,
            replication=2)
        table = "user_events_REALTIME"
        cluster.create_table(rcfg, usertable.user_schema(["user_id"]))
        _settled(cluster, table, "19d")
        consume_s = time.perf_counter() - t0
        online = sorted(md.segment_name
                        for md in cluster.store.segment_metadata_list(table)
                        if md.status == "ONLINE")
        if len(online) != upsert_rows // upsert_flush:
            raise AssertionError(f"19d: {len(online)} sealed segments")
        if sum(g.discards for g in gates.values()) != len(online):
            raise AssertionError("19d: not one DISCARD a seal")
        rt_hosted = _hosted(cluster, table)
        fetched = 0
        for name in online:
            url = cluster.store.get_segment_metadata(table, name).download_url
            seg_dir = url[len("file://"):]
            if not url.startswith("file://") or not verify_crc(seg_dir):
                raise AssertionError(f"19d: {name} at {url}")
            served = [h[name] for h in rt_hosted.values() if name in h]
            if len(served) != 2 or any(s.segment_dir != seg_dir
                                       for s in served):
                raise AssertionError(f"19d: {name} served from "
                                     f"{[s.segment_dir for s in served]}")
        for srv in cluster.servers.values():
            fetched += sum(e["fetched"] for e in
                           srv.data_manager.get(table).seals)
        if fetched != len(online):
            raise AssertionError(f"19d: {fetched} fetched seals")
        want = usertable.realtime_answers(usertable.latest_per_user(frame), 1)
        for qid, sql in usertable.queries(1).items():
            resp = cluster.query(sql)
            _full(f"19d {qid}", resp)
            usertable.check_rows(qid, resp.result_table.rows, want[qid])
        live = len(np.unique(frame["user_id"]))
        out["upsert"] = {"rows": upsert_rows, "flush": upsert_flush,
                         "sealed": len(online), "fetched": fetched,
                         "live_users": live, "consume_s": consume_s}
        log(f"  19d: upsert table, {upsert_rows} rows flushed every "
            f"{upsert_flush} at replication 2 in {consume_s:.1f} s: "
            f"{len(online)} seals written to disk (file://, CRC verified), "
            f"{fetched} DISCARD replicas served the committer's directory "
            f"with their keys registered; U1-U7 == the oracle over each "
            f"user's latest row ({live} users)")
        cluster.controller.delete_table(table)
        MemoryStream.delete(topic)
    finally:
        cluster.shutdown()
    if os.path.exists(os.path.join(root, "cluster")):
        raise AssertionError("19: the cluster's data dir outlived shutdown")
    return out


def _settle_residency(cluster) -> None:
    for srv in cluster.servers.values():
        srv.executor.residency.drain_prefetch()


def phase_startree_disk(segs, ctxs, wants, kept_segs, device: str = "cuda"
                        ) -> dict:
    """19c on phase 12's segments: written with their five star-trees and
    loaded again, the 13 flights per segment served by the star-tree
    device rung from the loaded trees (the tree the JAX executor picks,
    one decision a kept segment) with 0 fused launches, == the oracle."""
    import shutil
    import tempfile

    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.segment.creator import write_segment
    from pinot_tpu_torch.segment.immutable import load_segment
    from pinot_tpu_torch.tools import ssb

    root = tempfile.mkdtemp(prefix="pinot_trees_")
    t0 = time.perf_counter()
    try:
        for seg in segs:
            write_segment(seg, root)
        loaded = [load_segment(os.path.join(root, s.segment_name))
                  for s in segs]
        write_s = time.perf_counter() - t0
        if any(s._star_trees is not None for s in loaded):
            raise AssertionError("19c: trees loaded before first use")
        ex = ServerQueryExecutor(device=device)
        slices = 0
        for qid in ssb.QUERIES:
            ti, k = FLIGHT_TREE[qid], len(kept_segs[qid])
            table, stats = ex.execute(ctxs[qid], loaded)
            _check_flight(qid, table, wants[qid])
            fused = stats.scan_launches + stats.probe_launches
            if stats.decisions != {_TREE_SERVED.format(ti): k} or fused:
                raise AssertionError(f"19c {qid}: {stats.decisions}, "
                                     f"{fused} fused launches")
            slices += stats.startree_launches
        trees = sum(len(s.star_trees) for s in loaded)
        log(f"  19c: phase 12's {len(segs)} segments with {trees} trees "
            f"written and loaded in {write_s:.1f} s; the 13 flights on the "
            f"star-tree rung from the loaded trees, 0 fused launches, "
            f"{slices} node slices, == numpy oracle")
        return {"segments": len(segs), "trees": trees, "write_load_s":
                write_s, "node_slices": slices}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 12's default SSB scale: SF1 from phase 18's arrival (at SF2 the
# five trees took 104-157 s to build on the card's host), SF0.5 since
# phase 21's (at SF1 90-106 s), SF0.25 since phase 22's (at SF0.5 the
# build took 69.3 s of the phase's 93.7): the script must end within
# 1200 s on a slow host too (PERF.md section 4)
STARTREE_SF = 0.25


def _phase_12(args, card: str) -> dict:
    import torch

    log("phase 12: the star-tree (SSB with ssb_indexing_config()'s five "
        f"trees at SF{args.startree_sf})")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    run = phase_startree(args.startree_sf, args.segments, args.seed,
                         args.reps, card=card, on_disk=True)
    log(f"  phase 12: {time.perf_counter() - t0:.1f} s")
    return run


# -- phase 20: the segment lifecycle (minions, lineage, retention, tiers,
# rebalance) and the geo index -------------------------------------------------

LC_SERVERS = 4
LC_REPLICATION = 2
LC_SEGMENTS = 8
# rows a 20a segment: phase 9b's 2.5 M cut to 1 M for the time limit
LC_ROWS = 1_000_000
LC_CLIENTS = 4
# 20b: 4 overlapping segments of 1 M rows, ts at hour granularity
LC_ROLLUP_SEGMENTS = 4
LC_ROLLUP_ROWS = 1_000_000
# 20c: the realtime side of a hybrid table, 2 partitions
LC_RT_ROWS = 200_000
LC_RT_FLUSH = 50_000
LC_RT_DAYS = 4
# 20f: 500 k rows cut to 100 k for the scan without the index (per-doc
# ST_DISTANCE on the host, about 3 s a query at 100 k); 20 k places
LC_GEO_ROWS = 100_000
LC_GEO_PLACES = 20_000
LC_GEO_RADII = (100.0, 500.0, 1000.0, 2500.0, 5000.0)
LC_PURGE_COUNTRY = "DE"
LC_TABLE = "lc_events"
# the CPU test's sizes (tests/test_torch_minion.py)
LIFECYCLE_SMALL = dict(servers=4, segments=4, rows=6000, rollup_segments=2,
                       rollup_rows=4000, rt_rows=2000, rt_flush=500,
                       geo_rows=3000, geo_places=800)


def _lc_schema(name: str):
    from pinot_tpu_torch.spi import DataType, FieldSpec, FieldType, Schema

    return Schema(name, [
        FieldSpec("ts", DataType.LONG, FieldType.DATE_TIME),
        FieldSpec("country", DataType.STRING),
        FieldSpec("event_type", DataType.STRING),
        FieldSpec("revenue", DataType.INT, FieldType.METRIC)])


def _lc_config(name: str, task: dict, replication: int = LC_REPLICATION,
               table_type=None, stream=None):
    from pinot_tpu_torch.spi.table import (
        IndexingConfig,
        SegmentsValidationConfig,
        TableConfig,
        TableType,
    )

    return TableConfig(
        name, table_type or TableType.OFFLINE,
        validation_config=SegmentsValidationConfig(
            time_column_name="ts", replication=replication),
        indexing_config=IndexingConfig(no_dictionary_columns=["ts"]),
        task_config=task, stream_config=stream)


def _lc_frame(rng, n: int, lo: int, hi: int, sort: bool = True,
              round_ms: int = 1) -> dict:
    ts = rng.integers(lo, hi, n)
    if sort:
        ts = np.sort(ts)
    ts = ts // round_ms * round_ms
    return {"ts": ts.astype(np.int64),
            "country": rng.integers(0, len(COUNTRIES), n),
            "event_type": rng.integers(0, len(EVENT_TYPES), n),
            "revenue": rng.integers(0, 500, n).astype(np.int64)}


def _lc_build(schema, cfg, name: str, frame: dict, out_dir: str) -> str:
    from pinot_tpu_torch.segment.creator import SegmentBuilder

    SegmentBuilder(schema, name, table_config=cfg).build({
        "ts": frame["ts"],
        "country": np.array(COUNTRIES)[frame["country"]],
        "event_type": np.array(EVENT_TYPES)[frame["event_type"]],
        "revenue": frame["revenue"]}, out_dir)
    return os.path.join(out_dir, name)


def _lc_staged(cluster) -> dict:
    _settle_residency(cluster)
    return {sid: s.executor.residency.staged_bytes()
            for sid, s in cluster.servers.items()}


def _lc_answers(frame: dict, alive: np.ndarray) -> dict:
    """The numpy oracle: count and revenue overall and by country."""
    c = frame["country"][alive]
    r = frame["revenue"][alive]
    cnt = np.bincount(c, minlength=len(COUNTRIES))
    rev = np.bincount(c, weights=r, minlength=len(COUNTRIES))
    return {"total": [[int(alive.sum()), float(r.sum())]],
            "country": sorted([COUNTRIES[i], int(cnt[i]), float(rev[i])]
                              for i in range(len(COUNTRIES)) if cnt[i])}


LC_QUERIES = {
    "total": f"SELECT count(*), sum(revenue) FROM {LC_TABLE}",
    "country": f"SELECT country, count(*), sum(revenue) FROM {LC_TABLE} "
               "GROUP BY country LIMIT 100",
}


def _lc_query(cluster, qid: str, sql: str = None) -> tuple:
    """-> (rows in the oracle's form, ms, the response)."""
    t0 = time.perf_counter()
    resp = cluster.query(sql or LC_QUERIES[qid])
    ms = (time.perf_counter() - t0) * 1e3
    _full(f"20 {qid}", resp)
    rows = resp.result_table.rows
    if qid == "country":
        rows = sorted([r[0], int(r[1]), float(r[2])] for r in rows)
    else:
        rows = [[int(r[0]), float(r[1])] for r in rows]
    return rows, ms, resp


def _lc_offline(raw: str) -> str:
    return raw + "_OFFLINE"


def _lc_check(cluster, want: dict, what: str) -> dict:
    """Both queries == the oracle and every segment served; -> ms."""
    lat = {}
    for qid in LC_QUERIES:
        rows, ms, _ = _lc_query(cluster, qid)
        if rows != want[qid]:
            raise AssertionError(f"{what} {qid}: {rows[:3]} != the oracle "
                                 f"{want[qid][:3]}")
        lat[qid] = ms
    report = cluster.controller.run_segment_status_check()[
        _lc_offline(LC_TABLE)]
    if report["replicasMissing"]:
        raise AssertionError(f"{what}: segments not served: {report}")
    return lat


def _lc_run_tasks(cluster, minion, now_ms: int) -> tuple:
    """Generate and run tasks until a round generates none. -> (tasks,
    seconds of each)."""
    tasks, spent = 0, []
    while True:
        if not cluster.controller.run_task_generation(now_ms=now_ms):
            return tasks, spent
        while True:
            t0 = time.perf_counter()
            if not minion.run_one_task():
                break
            spent.append(time.perf_counter() - t0)
            tasks += 1
        if minion.tasks_failed:
            raise AssertionError("20: a minion task failed: " + str(
                [t.error for t in cluster.controller.task_manager
                 .list_tasks(status="ERROR")]))


def phase_lifecycle(reps: int, device: str = "cuda",
                    servers: int = LC_SERVERS, segments: int = LC_SEGMENTS,
                    rows: int = LC_ROWS,
                    rollup_segments: int = LC_ROLLUP_SEGMENTS,
                    rollup_rows: int = LC_ROLLUP_ROWS,
                    rt_rows: int = LC_RT_ROWS, rt_flush: int = LC_RT_FLUSH,
                    geo_rows: int = LC_GEO_ROWS,
                    geo_places: int = LC_GEO_PLACES, seed: int = 20) -> dict:
    """Phase 20: the segment lifecycle on the card. An
    ``EmbeddedCluster(data_dir=...)`` of ``servers`` servers (phase 16's
    residency budget) at replication 2 with one minion, every answer
    through ``cluster.query``, clean and full, and equal to the numpy
    oracle over the rows the table holds at that step:

    (20a) ``lc_events``, ``segments`` time-ordered segments of ``rows``
    rows over 28 days (a DATE_TIME ``ts`` in epoch ms, raw), MergeRollup
    CONCAT with 7-day buckets and no buffer: task generation and the
    minion run until no task is left while ``LC_CLIENTS`` client threads
    send count / sum and sum by country, every answer == the oracle
    across every lineage swap; tasks, s a task, segments before and
    after, lineage entries, p50 before and after, fused-scan launches on
    the merged segments (> 0 on the card). (20b) ``lc_rollup``,
    ``rollup_segments`` overlapping segments of hour-granular rows rolled
    up (SUM): sum(revenue) by country and day == the oracle, count(*) ==
    the oracle's distinct (hour, country, event type) keys. (20c) a
    hybrid ``lc_rt``: ``rt_rows`` JSON rows over 4 days on 2 partitions,
    flush ``rt_flush``, replication 2; RealtimeToOffline until the
    watermark passes the last committed window: the hybrid answers ==
    the oracle before and after, the broker's time boundary advances, the
    offline side served by the fused scan. (20d) on ``lc_events``: Purge
    drops one country's rows from one segment, ConvertToRaw rebuilds
    another with ``revenue`` raw (a refresh push under its name): the
    answers == the oracle, every replica serves the converted segment
    with ``revenue`` a raw value column in its plan. (20e) retention
    expires the oldest segment; a fifth server tagged ``cold`` takes the
    aged segments (relocation); a sixth server joins and
    ``rebalance_table`` spreads them make-before-break: after each step
    the rows == the oracle over the remaining data, every segment
    served, stagedBytes per server logged. (20f) ``geo_rows`` rows of WKT
    points over one city (H3, resolution 9): 5 ``ST_DISTANCE(...) < r``
    counts, r 100 m to 5 km, with and without the index == a numpy
    haversine oracle, each on the host engine with 0 fused launches; p50
    with and without."""
    import shutil
    import tempfile

    import torch

    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster

    on_card = device == "cuda"
    t_all = time.perf_counter()
    out: dict = {}
    counters = scan_counters()
    _reset(counters)
    launches = {name: 0 for name in counters}

    def add_launches():
        for name, c in counters.items():
            launches[name] += c.launches
        _reset(counters)

    root = tempfile.mkdtemp(prefix="pinot_lifecycle_")
    cluster = EmbeddedCluster(num_servers=0, device=device,
                              device_reduce=True,
                              data_dir=os.path.join(root, "cluster"))
    try:
        for i in range(servers):
            _budget_server(cluster, f"server_{i}", device, servers)
        minion = cluster.add_minion(start=False)
        out["merge"] = _lc_merge(cluster, minion, root, segments, rows, seed,
                                 counters, on_card, add_launches)
        alive, frame = out["merge"].pop("alive"), out["merge"].pop("frame")
        out["rollup"] = _lc_rollup(cluster, minion, root, rollup_segments,
                                   rollup_rows, seed)
        out["realtime"] = _lc_realtime(cluster, minion, rt_rows, rt_flush,
                                       seed, counters, on_card,
                                       add_launches)
        out["purge_convert"] = _lc_purge_convert(cluster, minion, frame,
                                                 alive)
        out["tiers"] = _lc_tiers(cluster, frame, alive, device, servers)
        add_launches()
    finally:
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = launches
    out["geo"] = _lc_geo(reps, device, geo_rows, geo_places, seed, counters)
    if on_card:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_all
    log(f"  phase 20: {out['seconds']:.1f} s; fused launches {launches}")
    return out


def _lc_merge(cluster, minion, root, segments, rows, seed, counters,
              on_card, add_launches) -> dict:
    """20a (see ``phase_lifecycle``)."""
    import threading

    from pinot_tpu_torch.controller.tasks import MERGE_ROLLUP_TASK

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    schema = _lc_schema(LC_TABLE)
    cfg = _lc_config(LC_TABLE, {MERGE_ROLLUP_TASK: {
        "bucketTimePeriod": "7d", "bufferTimePeriod": "0d",
        "mergeType": "CONCAT"}})
    cluster.create_table(cfg, schema)
    table = _lc_offline(LC_TABLE)
    window = 28 * DAY_MS // segments
    frames = []
    built = os.path.join(root, "built")
    for i in range(segments):
        lo = EVENTS_T0 + i * window
        f = _lc_frame(rng, rows, lo, lo + window)
        frames.append(f)
        cluster.upload_segment_dir(
            table, _lc_build(schema, cfg, f"{LC_TABLE}_{i}", f, built))
    if not cluster.wait_for_ev_converged(table, timeout_s=300):
        raise AssertionError("20a: the ExternalView did not converge")
    frame = {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}
    alive = np.ones(len(frame["ts"]), dtype=bool)
    want = _lc_answers(frame, alive)
    staged_before = _lc_staged(cluster)
    push_s = time.perf_counter() - t0
    before = [_lc_check(cluster, want, "20a before") for _ in range(3)]
    seg_before = len(cluster.store.segment_names(table))

    stop = threading.Event()
    bad, lat_during = [], []

    def client(k):
        qid = list(LC_QUERIES)[k % len(LC_QUERIES)]
        while not stop.is_set():
            try:
                got, ms, _ = _lc_query(cluster, qid)
            except AssertionError as e:
                bad.append(str(e))
                continue
            lat_during.append(ms)
            if got != want[qid]:
                bad.append(f"{qid}: {got[:2]}")

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(LC_CLIENTS)]
    for t in threads:
        t.start()
    t1 = time.perf_counter()
    try:
        tasks, spent = _lc_run_tasks(cluster, minion,
                                     now_ms=EVENTS_T0 + 60 * DAY_MS)
    finally:
        stop.set()
        for t in threads:
            t.join()
    merge_s = time.perf_counter() - t1
    if bad:
        raise AssertionError(f"20a: {len(bad)} answers differ from the "
                             f"oracle across the swaps: {bad[:3]}")
    if not cluster.wait_for_ev_converged(table, timeout_s=300):
        raise AssertionError("20a: the ExternalView did not converge")
    names = cluster.store.segment_names(table)
    merged = [n for n in names if n.startswith("merged_")]
    lineage = cluster.store.get(f"lineage/{table}") or []
    if not tasks or not merged or any(e["state"] != "COMPLETED"
                                      for e in lineage):
        raise AssertionError(f"20a: {tasks} tasks, segments {names}, "
                             f"lineage {[e['state'] for e in lineage]}")
    add_launches()
    after = [_lc_check(cluster, want, "20a after") for _ in range(3)]
    merged_launches = counters["fused_scan"].launches
    if on_card and merged_launches == 0:
        raise AssertionError("20a: no fused-scan launch on the merged "
                             "segments")
    p50 = {q: float(np.percentile([r[q] for r in before], 50))
           for q in LC_QUERIES}
    p50_after = {q: float(np.percentile([r[q] for r in after], 50))
                 for q in LC_QUERIES}
    rep = {"rows": int(len(alive)), "push_s": push_s, "tasks": tasks,
           "s_per_task": float(np.mean(spent)), "merge_s": merge_s,
           "segments_before": seg_before, "segments_after": len(names),
           "merged_segments": len(merged), "lineage_entries": len(lineage),
           "answers_during": len(lat_during), "bad_answers": len(bad),
           "p50_before_ms": p50, "p50_after_ms": p50_after,
           "p50_during_ms": float(np.percentile(lat_during, 50))
           if lat_during else None,
           "fused_launches_merged": merged_launches,
           "staged_before": staged_before,
           "staged_after": _lc_staged(cluster), "alive": alive,
           "frame": frame}
    log(f"  20a: {len(alive)} rows in {seg_before} segments pushed in "
        f"{push_s:.1f} s; MergeRollup (7d, CONCAT): {tasks} tasks, "
        f"{rep['s_per_task']:.2f} s a task, {seg_before} -> {len(names)} "
        f"segments ({len(merged)} merged), {len(lineage)} lineage entries "
        f"COMPLETED; {len(lat_during)} answers from {LC_CLIENTS} clients "
        f"across the swaps == the oracle; p50 before {p50}, after "
        f"{p50_after} ms; fused launches on the merged segments "
        f"{merged_launches}; stagedBytes {rep['staged_after']}")
    return rep


def _lc_rollup(cluster, minion, root, segments, rows, seed) -> dict:
    """20b (see ``phase_lifecycle``)."""
    from pinot_tpu_torch.controller.tasks import MERGE_ROLLUP_TASK

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 1)
    name = "lc_rollup"
    table = _lc_offline(name)
    schema = _lc_schema(name)
    cfg = _lc_config(name, {MERGE_ROLLUP_TASK: {
        "bucketTimePeriod": "7d", "bufferTimePeriod": "0d",
        "mergeType": "ROLLUP", "aggregationType.revenue": "SUM"}})
    cluster.create_table(cfg, schema)
    frames = []
    for i in range(segments):
        f = _lc_frame(rng, rows, EVENTS_T0, EVENTS_T0 + 28 * DAY_MS,
                      sort=False, round_ms=3_600_000)
        frames.append(f)
        cluster.upload_segment_dir(table, _lc_build(
            schema, cfg, f"{name}_{i}", f, os.path.join(root, "built")))
    if not cluster.wait_for_ev_converged(table, timeout_s=300):
        raise AssertionError("20b: the ExternalView did not converge")
    frame = {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}
    tasks, spent = _lc_run_tasks(cluster, minion,
                                 now_ms=EVENTS_T0 + 60 * DAY_MS)
    if not cluster.wait_for_ev_converged(table, timeout_s=300):
        raise AssertionError("20b: the ExternalView did not converge")
    keys = np.unique(np.stack([frame["ts"], frame["country"],
                               frame["event_type"]]), axis=1).shape[1]
    day = (frame["ts"] // DAY_MS).astype(np.int64)
    uk, inv = np.unique(day * len(COUNTRIES) + frame["country"],
                        return_inverse=True)
    rev = np.bincount(inv.reshape(-1), weights=frame["revenue"])
    want = sorted([COUNTRIES[int(x % len(COUNTRIES))],
                   int(x // len(COUNTRIES)), float(v)]
                  for x, v in zip(uk, rev))
    resp = cluster.query(f"SELECT country, toEpochDays(ts), sum(revenue) "
                         f"FROM {name} GROUP BY country, toEpochDays(ts) "
                         "LIMIT 100000")
    _full("20b", resp)
    got = sorted([r[0], int(r[1]), float(r[2])]
                 for r in resp.result_table.rows)
    if got != want:
        raise AssertionError(f"20b: sum(revenue) by country and day "
                             f"{got[:3]} != the oracle {want[:3]}")
    resp = cluster.query(f"SELECT count(*) FROM {name}")
    _full("20b count", resp)
    count = int(resp.result_table.rows[0][0])
    if count != keys or not tasks:
        raise AssertionError(f"20b: count(*) {count} != {keys} distinct "
                             f"rolled-up keys ({tasks} tasks)")
    rep = {"rows_in": int(len(day)), "rows_out": count, "tasks": tasks,
           "s_per_task": float(np.mean(spent)),
           "segments_after": len(cluster.store.segment_names(table)),
           "seconds": time.perf_counter() - t0}
    cluster.controller.delete_table(table)
    log(f"  20b: ROLLUP of {len(day)} rows in {segments} overlapping "
        f"segments: {tasks} task(s), {rep['s_per_task']:.2f} s a task, "
        f"{count} rows == the distinct (hour, country, event type) keys; "
        f"sum(revenue) by country and day == the oracle "
        f"({rep['seconds']:.1f} s)")
    return rep


def _lc_realtime(cluster, minion, rows, flush, seed, counters, on_card,
                 add_launches) -> dict:
    """20c (see ``phase_lifecycle``)."""
    from pinot_tpu_torch.controller.tasks import REALTIME_TO_OFFLINE_TASK
    from pinot_tpu_torch.ingestion import MemoryStream
    from pinot_tpu_torch.spi.table import StreamIngestionConfig, TableType

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 2)
    name = "lc_rt"
    rt, offline = name + "_REALTIME", _lc_offline(name)
    topic = f"lc_rt_{seed}"
    stream = MemoryStream.create(topic, 2)
    schema = _lc_schema(name)
    cluster.create_table(_lc_config(name, {}), schema)
    cluster.create_table(_lc_config(
        name, {REALTIME_TO_OFFLINE_TASK: {"bucketTimePeriod": "1d",
                                          "bufferTimePeriod": "0d"}},
        table_type=TableType.REALTIME,
        stream=StreamIngestionConfig(stream_type="memory", topic=topic,
                                     segment_flush_threshold_rows=flush)),
        schema)
    try:
        f = _lc_frame(rng, rows, EVENTS_T0, EVENTS_T0 + LC_RT_DAYS * DAY_MS)
        msgs = [f'{{"ts": {t}, "country": "{COUNTRIES[c]}", '
                f'"event_type": "{EVENT_TYPES[e]}", "revenue": {r}}}'
                for t, c, e, r in zip(f["ts"].tolist(),
                                      f["country"].tolist(),
                                      f["event_type"].tolist(),
                                      f["revenue"].tolist())]
        for p in range(2):
            stream.produce_many(msgs[p::2], partition=p)
        consume_s = _settled(cluster, rt, "20c")
        sql = (f"SELECT country, count(*), sum(revenue) FROM {name} "
               "GROUP BY country LIMIT 100")
        want = _lc_answers(f, np.ones(rows, dtype=bool))["country"]

        def check(what):
            got, ms, resp = _lc_query(cluster, "country", sql)
            if got != want:
                raise AssertionError(f"{what}: {got[:3]} != the oracle")
            return ms, resp.stats.decisions

        boundary = cluster.broker.routing.time_boundary
        before_b = boundary.get_boundary(offline)
        ms_before, _ = check("20c before")
        sealed = sum(md.status == "ONLINE" for md in
                     cluster.store.segment_metadata_list(rt))
        tasks, spent = _lc_run_tasks(
            cluster, minion,
            now_ms=EVENTS_T0 + (LC_RT_DAYS + 2) * DAY_MS)
        if not cluster.wait_for_ev_converged(offline, timeout_s=300):
            raise AssertionError("20c: the ExternalView did not converge")
        wm = cluster.controller.task_manager.get_watermark_ms(
            rt, REALTIME_TO_OFFLINE_TASK)
        committed_end = max(md.end_time for md in
                            cluster.store.segment_metadata_list(rt)
                            if md.status == "ONLINE")
        after_b = boundary.get_boundary(offline)
        ms_after, decisions = check("20c after")
        if not tasks or wm is None or wm <= committed_end \
                or after_b is None or (before_b is not None
                                       and after_b <= before_b):
            raise AssertionError(f"20c: {tasks} tasks, watermark {wm}, "
                                 f"last committed end {committed_end}, "
                                 f"boundary {before_b} -> {after_b}")
        if not any(k.startswith("hybrid:") for k in decisions):
            raise AssertionError(f"20c: no hybrid decision: {decisions}")
        add_launches()
        got, _, resp = _lc_query(
            cluster, "country", f"SELECT country, count(*), sum(revenue) "
                                f"FROM {offline} GROUP BY country LIMIT 100")
        offline_launches = counters["fused_scan"].launches
        if on_card and (offline_launches == 0
                        or resp.stats.scan_launches == 0):
            raise AssertionError("20c: the offline side was not served by "
                                 "the fused scan")
        rep = {"rows": rows, "flush": flush, "sealed": sealed,
               "consume_s": consume_s, "tasks": tasks,
               "s_per_task": float(np.mean(spent)),
               "offline_segments": len(cluster.store.segment_names(
                   offline)),
               "offline_rows": sum(r[1] for r in got),
               "watermark": wm, "last_committed_end": committed_end,
               "boundary_before": before_b, "boundary_after": after_b,
               "ms_before": ms_before, "ms_after": ms_after,
               "offline_fused_launches": offline_launches,
               "seconds": time.perf_counter() - t0}
        log(f"  20c: hybrid lc_rt, {rows} rows on 2 partitions at "
            f"replication 2 consumed in {consume_s:.1f} s ({sealed} "
            f"seals); RealtimeToOffline {tasks} tasks "
            f"({rep['s_per_task']:.2f} s a task), {rep['offline_rows']} "
            f"rows in {rep['offline_segments']} offline segments, "
            f"watermark {wm} past the last committed end {committed_end}, "
            f"time boundary {before_b} -> {after_b}; hybrid answers == the "
            f"oracle before and after; the offline side on the fused scan "
            f"({offline_launches} launches)")
    finally:
        for c in cluster.consumers(rt):
            c.stop()
        cluster.controller.delete_table(rt)
        cluster.controller.delete_table(offline)
        MemoryStream.delete(topic)
    return rep


def _lc_resident(server, name: str):
    """The segment object a server's residency holds for ``name``."""
    e = server.executor.residency._entries.get(name)
    return None if e is None else getattr(e.resident, "segment", None)


def _lc_purge_convert(cluster, minion, frame, alive) -> dict:
    """20d (see ``phase_lifecycle``)."""
    from pinot_tpu_torch.controller.tasks import (
        CONVERT_TO_RAW_TASK,
        PURGE_TASK,
    )
    from pinot_tpu_torch.engine.plan import plan_segment
    from pinot_tpu_torch.minion.tasks import PurgeTaskExecutor
    from pinot_tpu_torch.query import compile_query

    t0 = time.perf_counter()
    table = _lc_offline(LC_TABLE)
    store = cluster.store
    country = COUNTRIES.index(LC_PURGE_COUNTRY)

    def one_task(task_type, conf):
        cfg = store.get_table_config(table)
        cfg.task_config = {task_type: conf}
        cluster.controller.update_table(cfg)
        created = cluster.controller.run_task_generation(
            now_ms=EVENTS_T0 + 60 * DAY_MS)
        if len(created) != 1:
            raise AssertionError(f"20d: {task_type} generated {created}")
        t1 = time.perf_counter()
        minion.run_one_task()
        spent = time.perf_counter() - t1
        done = cluster.controller.task_manager.get(created[0])
        if done.status != "COMPLETED":
            raise AssertionError(f"20d: {task_type} {done.error}")
        if not cluster.wait_for_ev_converged(table, timeout_s=300):
            raise AssertionError("20d: the ExternalView did not converge")
        return done, spent

    PurgeTaskExecutor.PURGERS[LC_TABLE] = (
        lambda cols: cols["country"] == LC_PURGE_COUNTRY)
    try:
        done, purge_s = one_task(PURGE_TASK, {})
    finally:
        PurgeTaskExecutor.PURGERS.pop(LC_TABLE, None)
    (victim,) = done.input_segments
    (purged,) = done.output_segments
    md = store.get_segment_metadata(table, purged)
    gone = ((frame["ts"] >= md.start_time) & (frame["ts"] <= md.end_time)
            & (frame["country"] == country))
    dropped = int((alive & gone).sum())
    alive &= ~gone
    want = _lc_answers(frame, alive)
    _lc_check(cluster, want, "20d purge")

    done, convert_s = one_task(CONVERT_TO_RAW_TASK,
                               {"columnsToConvert": "revenue"})
    (converted,) = done.input_segments
    if store.get_segment_metadata(table, converted).custom.get(
            "convertToRawDone") != "revenue":
        raise AssertionError("20d: convertToRawDone not recorded")
    lat = _lc_check(cluster, want, "20d convert")
    _settle_residency(cluster)
    ctx = compile_query(LC_QUERIES["country"])
    served = 0
    for sid, segs in _hosted(cluster, table).items():
        seg = segs.get(converted)
        if seg is None:
            continue
        served += 1
        reads = {a[2] for a in plan_segment(ctx, seg).spec[1]}
        if seg.metadata.column("revenue").has_dictionary \
                or ("col", "revenue", False) not in reads:
            raise AssertionError(f"20d: {sid} serves {converted} with "
                                 f"revenue {reads}")
        res = _lc_resident(cluster.servers[sid], converted)
        if res is not None and res is not seg:
            raise AssertionError(f"20d: {sid} keeps the old resident")
    if served != LC_REPLICATION:
        raise AssertionError(f"20d: {served} replicas serve {converted}")
    cfg = store.get_table_config(table)
    cfg.task_config = {}
    cluster.controller.update_table(cfg)
    rep = {"purged_segment": victim, "purged_rows": dropped,
           "purge_s": purge_s, "converted_segment": converted,
           "convert_s": convert_s, "replicas_converted": served,
           "ms": lat, "seconds": time.perf_counter() - t0}
    log(f"  20d: Purge of {LC_PURGE_COUNTRY} from {victim} ({dropped} rows, "
        f"{purge_s:.2f} s) -> {purged}; ConvertToRaw of revenue on "
        f"{converted} ({convert_s:.2f} s), refreshed on {served} replicas, "
        f"revenue a raw value column in the plan; answers == the oracle")
    return rep


def _lc_tiers(cluster, frame, alive, device, budget_servers) -> dict:
    """20e (see ``phase_lifecycle``)."""
    t0 = time.perf_counter()
    table = _lc_offline(LC_TABLE)
    store = cluster.store
    ctl = cluster.controller
    rep: dict = {}
    # retention: a day past the oldest segment's end
    oldest = min(store.segment_metadata_list(table),
                 key=lambda m: m.end_time)
    cfg = store.get_table_config(table)
    cfg.validation_config.retention_time_unit = "DAYS"
    cfg.validation_config.retention_time_value = 1
    ctl.update_table(cfg)
    deleted = ctl.run_retention_manager(now_ms=oldest.end_time + DAY_MS + 1)
    if deleted != [oldest.segment_name]:
        raise AssertionError(f"20e: retention deleted {deleted}, not "
                             f"{oldest.segment_name}")
    alive &= ~((frame["ts"] >= oldest.start_time)
               & (frame["ts"] <= oldest.end_time))
    want = _lc_answers(frame, alive)
    if not cluster.wait_for_ev_converged(table, timeout_s=300):
        raise AssertionError("20e: the ExternalView did not converge")
    _lc_check(cluster, want, "20e retention")
    rep["retention"] = {"deleted": deleted, "staged": _lc_staged(cluster)}
    log(f"  20e: retention expired {deleted}; answers == the oracle over "
        f"the rest; stagedBytes {rep['retention']['staged']}")

    # relocation: a fifth server tagged cold takes the aged segments
    _budget_server(cluster, "server_cold", device, budget_servers)
    ctl.update_instance_tags("server_cold", ["cold"])
    cfg = store.get_table_config(table)
    cfg.tier_configs = [{"name": "cold", "segmentAge": "1d",
                         "serverTag": "cold", "segmentSelectorType": "time"}]
    ctl.update_table(cfg)
    pushes = sorted(md.push_time_ms for md in store.segment_metadata_list(
        table))
    moved = ctl.run_segment_relocation(now_ms=pushes[-1] + DAY_MS - 1)
    if not moved or len(moved) >= len(pushes):
        raise AssertionError(f"20e: relocation moved {moved}")
    if not cluster.wait_for_ev_converged(table, timeout_s=300):
        raise AssertionError("20e: the ExternalView did not converge")
    ideal = store.get_ideal_state(table)
    if any(list(ideal[s]) != ["server_cold"] for s in moved):
        raise AssertionError("20e: a moved segment is off the cold tier")
    _lc_check(cluster, want, "20e relocation")
    staged = _lc_staged(cluster)
    if not staged["server_cold"]:
        raise AssertionError("20e: the cold server staged nothing")
    rep["relocation"] = {"moved": len(moved), "staged": staged}
    log(f"  20e: relocation moved {len(moved)} aged segments to "
        f"server_cold; answers == the oracle; stagedBytes {staged}")

    # rebalance after a sixth server joins
    cfg = store.get_table_config(table)
    cfg.tier_configs = []
    ctl.update_table(cfg)
    _budget_server(cluster, "server_5", device, budget_servers)
    t1 = time.perf_counter()
    steps = ctl.rebalance_table(table, convergence_timeout_s=120,
                                best_effort=False)
    rebalance_s = time.perf_counter() - t1
    if not cluster.wait_for_ev_converged(table, timeout_s=300):
        raise AssertionError("20e: the ExternalView did not converge")
    _lc_check(cluster, want, "20e rebalance")
    staged = _lc_staged(cluster)
    hosted = {sid: len(v) for sid, v in _hosted(cluster, table).items()}
    if not hosted.get("server_5"):
        raise AssertionError(f"20e: the new server hosts nothing: {hosted}")
    rep["rebalance"] = {"steps": len(steps), "s": rebalance_s,
                        "hosted": hosted, "staged": staged}
    rep["seconds"] = time.perf_counter() - t0
    log(f"  20e: rebalance over 6 servers in {len(steps)} steps "
        f"({rebalance_s:.1f} s, make-before-break): hosted {hosted}; "
        f"answers == the oracle; stagedBytes {staged}")
    return rep


def _lc_geo(reps, device, rows, places, seed, counters) -> dict:
    """20f (see ``phase_lifecycle``)."""
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.segment.creator import SegmentBuilder
    from pinot_tpu_torch.spi import DataType, FieldSpec, FieldType, Schema
    from pinot_tpu_torch.spi.table import FieldConfig, TableConfig
    from pinot_tpu_torch.utils import geo

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 3)
    # one city's extent (San Francisco), ``places`` distinct points
    lng = np.round(-122.52 + rng.random(places) * 0.16, 6)
    lat = np.round(37.70 + rng.random(places) * 0.13, 6)
    idx = rng.integers(0, places, rows)
    wkt = np.array([f"SRID=4326;POINT ({x:.6f} {y:.6f})"
                    for x, y in zip(lng, lat)])[idx]
    schema = Schema("places", [FieldSpec("loc", DataType.STRING),
                               FieldSpec("v", DataType.LONG,
                                         FieldType.METRIC)])
    cfg = TableConfig("places", field_config_list=[FieldConfig(
        "loc", index_type="H3", properties={"resolutions": "9"})])
    frame = {"loc": wkt, "v": np.arange(rows, dtype=np.int64)}
    t1 = time.perf_counter()
    indexed = SegmentBuilder(schema, "places_h3", table_config=cfg).build(
        frame)
    build_s = time.perf_counter() - t1
    plain = SegmentBuilder(schema, "places_plain").build(frame)
    if indexed.data_source("loc").geo_index is None:
        raise AssertionError("20f: no geo index built")
    ex = ServerQueryExecutor(device=device)
    center = (-122.4194, 37.7749)
    dist = geo.haversine_m(lng[idx], lat[idx], *center)
    lat_ms = {"index": [], "scan": []}
    _reset(counters)
    for r in LC_GEO_RADII:
        sql = (f"SELECT count(*) FROM places WHERE ST_DISTANCE(loc, "
               f"'SRID=4326;POINT ({center[0]} {center[1]})') < {r}")
        want = int((dist < r).sum())
        for kind, seg in (("index", indexed), ("scan", plain)):
            for _ in range(max(1, min(reps, 3)) if kind == "index" else 1):
                t1 = time.perf_counter()
                table, stats = ex.execute(compile_query(sql), [seg])
                lat_ms[kind].append((time.perf_counter() - t1) * 1e3)
                if table.rows[0][0] != want:
                    raise AssertionError(f"20f {kind} r={r}: "
                                         f"{table.rows[0][0]} != {want}")
                if stats.scan_launches or not any(
                        k.startswith("plan:device_kernel->host_engine:")
                        for k in stats.decisions):
                    raise AssertionError(f"20f {kind} r={r}: "
                                         f"{stats.decisions}")
    if any(c.launches for c in counters.values()):
        raise AssertionError("20f: a fused launch served a geo query")
    rep = {"rows": rows, "places": places, "queries": len(LC_GEO_RADII),
           "index_build_s": build_s,
           "p50_index_ms": float(np.percentile(lat_ms["index"], 50)),
           "p50_scan_ms": float(np.percentile(lat_ms["scan"], 50)),
           "seconds": time.perf_counter() - t0}
    log(f"  20f: {rows} WKT points ({places} places, H3 resolution 9, "
        f"index built in {build_s:.2f} s): 5 ST_DISTANCE counts, r "
        f"{LC_GEO_RADII[0]:.0f}-{LC_GEO_RADII[-1]:.0f} m, == the haversine "
        f"oracle with and without the index, host engine, 0 fused "
        f"launches; p50 {rep['p50_index_ms']:.2f} ms with the index, "
        f"{rep['p50_scan_ms']:.1f} ms without")
    return rep


P24_SF = 0.1            # 600 k rows: the phase in well under 30 s
P24_SEGMENTS = 7        # one d_year a segment (dbgen's 1992..1998)
P24_SERVERS = 2
P24_TABLE = "ssb_part"


def _p24_config():
    from pinot_tpu_torch.spi.table import (
        RoutingConfig,
        SegmentsValidationConfig,
        TableConfig,
    )
    from pinot_tpu_torch.tools import ssb

    return TableConfig(
        P24_TABLE, validation_config=SegmentsValidationConfig(
            time_column_name="d_yearmonthnum"),
        indexing_config=ssb.ssb_indexing_config(
            star_tree=False, num_partitions=P24_SEGMENTS),
        routing_config=RoutingConfig(segment_pruner_types=["partition"]))


def phase_partitioned(reps: int, device: str = "cuda", sf: float = P24_SF,
                      segments: int = P24_SEGMENTS, seed: int = 24,
                      microbench_rows: int = 0) -> dict:
    """Phase 24: (24a) the partitioned SSB on disk through a cluster,
    against the numpy baseline; (24b) the microbench. ``microbench_rows``
    shrinks the microbench's arrays (0: its own 2^20)."""
    import shutil
    import tempfile

    import torch

    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.tools import microbench, ssb, ssb_baseline
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster

    t_all = time.perf_counter()
    counters = scan_counters()
    _reset(counters)
    root = tempfile.mkdtemp(prefix="pinot_part_")
    out: dict = {"sf": sf, "segments": segments}
    cluster = None
    try:
        t0 = time.perf_counter()
        segs, frames = ssb.build_segments(
            sf, num_segments=segments, seed=seed, partitioned=True,
            out_dir=os.path.join(root, "segments"))
        out["build_s"] = time.perf_counter() - t0
        years = {s.segment_name: int(f["d_year"][0])
                 for s, f in zip(segs, frames)}
        cluster = EmbeddedCluster(num_servers=P24_SERVERS, device=device,
                                  data_dir=os.path.join(root, "cluster"))
        table = f"{P24_TABLE}_OFFLINE"
        cluster.create_table(_p24_config(), _ssb_schema(P24_TABLE))
        for s in segs:
            cluster.upload_segment_dir(
                table, os.path.join(root, "segments", s.segment_name))
        if not cluster.wait_for_ev_converged(table, timeout_s=120):
            raise AssertionError("24a: the segments never came online")
        whole = ssb_baseline.make_frame(
            {k: np.concatenate([f[k] for f in frames]) for k in frames[0]})
        flights = {}
        for qid, sql in _flight_sqls(P24_TABLE).items():
            want = ssb_baseline.run_query(whole, qid)
            lat, resp = [], None
            for _ in range(reps):
                t0 = time.perf_counter()
                resp = cluster.query(sql)
                lat.append((time.perf_counter() - t0) * 1e3)
                if resp.exceptions or resp.result_table is None:
                    raise AssertionError(f"24a {qid}: {resp.exceptions}")
                rows = [tuple(r) for r in resp.result_table.rows]
                if not ssb_baseline.rows_match(rows, want):
                    raise AssertionError(f"24a {qid}: {rows[:3]} != "
                                         f"{want[:3]} (baseline)")
            kept = resp.stats.num_segments_queried
            flights[qid] = {"p50_ms": float(np.percentile(lat, 50)),
                            "segments_kept": kept,
                            "decisions": dict(resp.stats.decisions)}
            log(f"  24a {qid}: {kept} of {len(segs)} segments kept, p50 "
                f"{flights[qid]['p50_ms']:.2f} ms")
        q11 = flights["Q1.1"]
        if q11["segments_kept"] != sum(y == 1993 for y in years.values()) \
                or not any("partition_prune" in k
                           for k in q11["decisions"]):
            raise AssertionError(f"24a Q1.1: {q11}")
        out["flights"] = flights
    finally:
        if cluster is not None:
            cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {name: c.launches for name, c in counters.items()}
    _reset(counters)
    if device == "cuda" and out["launches"]["fused_scan"] == 0:
        raise AssertionError("24a: the flights launched no fused scan")
    old = microbench.N_ROWS
    if microbench_rows:
        microbench.N_ROWS = microbench_rows
    try:
        out["microbench"] = microbench.run(device=device)
    finally:
        microbench.N_ROWS = old
    for r in out["microbench"]:
        log("  24b " + json.dumps(r))
    if device == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_all
    log(f"  phase 24: {out['seconds']:.1f} s (build {out['build_s']:.1f} "
        f"s); fused launches {out['launches']}")
    return out


def _phase_14(args) -> dict:
    log("phase 14: a realtime user-events table (a consuming segment on "
        f"the card, upsert, the seal) at {REALTIME_ROWS} rows")
    t0 = time.perf_counter()
    run = phase_realtime(args.seed, args.reps)
    log(f"  phase 14: {time.perf_counter() - t0:.1f} s")
    return run


def _ptxas_frame(nvcc_log: str, kernel: str) -> tuple:
    """(stack frame, spill stores, spill loads) bytes ptxas reports for
    ``kernel``."""
    import re

    lines = nvcc_log.splitlines()
    for i, line in enumerate(lines):
        if line.rstrip().endswith(f"Function properties for {kernel}"):
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", lines[i + 1])
            if m:
                return tuple(int(x) for x in m.groups())
    raise AssertionError(f"ptxas reported no frame for {kernel}")


# phase 21: the wire
WIRE_PROCS = 2          # server processes of 21d
WIRE_ROUNDS = 2         # passes over the 13 flights a client run sends
WIRE_TIMEOUT_S = 120.0  # every HTTP and gRPC call of the phase


def phase_wire(main: dict, reps: int, device: str = "cuda",
               front: dict = None, procs: int = WIRE_PROCS,
               rounds: int = WIRE_ROUNDS) -> dict:
    """Phase 21 (see the module docstring): 21a-21b on an in-process
    cluster behind its REST front doors, 21c the preflight against the
    kernel, 21d servers in processes of their own. ``front``: phase 16's
    run (its in-process p50 per flight). -> the report."""
    import shutil
    import tempfile

    from pinot_tpu_torch.segment import write_segment

    tmp = tempfile.mkdtemp(prefix="wire_")
    out: dict = {}
    try:
        t0 = time.perf_counter()
        dirs = []
        for seg in main["segs"]:
            write_segment(seg, tmp)
            dirs.append(os.path.join(tmp, seg.segment_name))
        log(f"  21: {len(dirs)} segments written in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["rest"] = _wire_rest(main, dirs, reps, device, front, rounds)
        log(f"  21a-b: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["preflight"] = _wire_preflight(main, device)
        log(f"  21c: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["processes"] = _wire_processes(main, dirs, reps, device, procs,
                                           rounds, out["rest"], tmp)
        log(f"  21d: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = out["rest"]["launches"]
    return out


def _wire_get(url: str, body=None, method: str = None):
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WIRE_TIMEOUT_S) as r:
        if r.status != 200:
            raise AssertionError(f"21: {url} answered {r.status}")
        return json.loads(r.read().decode())


def _wire_warm(conn, sqls: dict, wants: dict, what: str) -> None:
    """One untimed pass of the flights through a client connection, every
    answer == the oracle."""
    for qid, sql in sqls.items():
        _check_flight(f"{what} {qid}", conn.execute(sql).result_set,
                      wants[qid])


def _wire_flights(conn, sqls: dict, wants: dict, reps: int, what: str,
                  sync) -> tuple:
    """``reps`` timed passes of the flights through a client connection,
    every answer == the oracle. -> (p50 per flight, the responses'
    JSON)."""
    lat = {qid: [] for qid in sqls}
    raws = []
    for _ in range(reps):
        for qid, sql in sqls.items():
            t0 = time.perf_counter()
            res = conn.execute(sql)
            sync()
            lat[qid].append((time.perf_counter() - t0) * 1e3)
            _check_flight(f"{what} {qid}", res.result_set, wants[qid])
            raws.append(res.raw)
    return {q: float(np.percentile(v, 50)) for q, v in lat.items()}, raws


def _wire_clients(connect, sqls: dict, wants: dict, clients: int,
                  rounds: int, what: str) -> dict:
    """``clients`` threads, each on its own connection, sending the
    flights in turn (client i from flight i) ``rounds`` passes between
    them, every answer == the oracle. -> QPS and p50 / p99."""
    ids = sorted(sqls)
    lat = []
    conns = [connect() for _ in range(clients)]

    def client(i: int) -> None:
        for k in range(max(1, rounds * len(ids) // clients)):
            qid = ids[(i + k) % len(ids)]
            t0 = time.perf_counter()
            res = conns[i].execute(sqls[qid])
            lat.append((time.perf_counter() - t0) * 1e3)
            _check_flight(f"{what} {qid}", res.result_set, wants[qid])

    t0 = time.perf_counter()
    errors = _threads(clients, client)
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"{what}: {errors[:3]}")
    return {"clients": clients, "queries": len(lat),
            "qps": len(lat) / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def _wire_rest(main: dict, dirs: list, reps: int, device: str,
               front, rounds: int) -> dict:
    """21a and 21b."""
    import torch

    from pinot_tpu_torch import client
    from pinot_tpu_torch.engine.results import WIRE_COUNTERS
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.spi.table import SegmentsValidationConfig, TableConfig
    from pinot_tpu_torch.tools import preflight
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster
    from pinot_tpu_torch.transport.rest import ServerAdminApi, serve_cluster

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    segs, ctxs, wants = main["segs"], main["ctxs"], main["wants"]
    sqls = {qid: ctx.sql for qid, ctx in ctxs.items()}
    out: dict = {"servers": FRONT_SERVERS, "replication": FRONT_REPLICATION}
    # the preflight's verdicts at the default limits, for /debug/pallas
    # (its probe launches come before the counted window)
    table = preflight.run_preflight(segs, fuzz=False, device=device)
    if table["ssb_failed"]:
        raise AssertionError(f"21b: preflight fails {table['ssb_failed']}")
    cluster = EmbeddedCluster(num_servers=0, device=device,
                              device_reduce=True)
    apis = []
    try:
        for i in range(FRONT_SERVERS):
            _budget_server(cluster, f"server_{i}", device, FRONT_SERVERS)
        for srv in cluster.servers.values():
            preflight.attach_verdicts(srv.executor, table)
        apis = list(serve_cluster(cluster))
        ctrl = f"http://localhost:{apis[0].port}"
        brk = f"http://localhost:{apis[1].port}"
        admins = {sid: ServerAdminApi(s, port=0)
                  for sid, s in cluster.servers.items()}
        for api in admins.values():
            api.start()
            apis.append(api)
        base = {sid: f"http://localhost:{api.port}"
                for sid, api in admins.items()}
        _wire_get(f"{ctrl}/schemas", segs[0].metadata.schema.to_dict())
        _wire_get(f"{ctrl}/tables", TableConfig(
            FRONT_TABLE, validation_config=SegmentsValidationConfig(
                time_column_name="d_yearmonthnum",
                replication=FRONT_REPLICATION)).to_dict())
        t0 = time.perf_counter()
        for d in dirs:
            _wire_get(f"{ctrl}/segments",
                      {"tableName": FRONT_TABLE, "segmentDir": d})
        if not cluster.wait_for_ev_converged(FRONT_TABLE, timeout_s=300):
            raise AssertionError("21a: the ExternalView did not converge")
        for srv in cluster.servers.values():
            srv.executor.residency.drain_prefetch()
        sync()
        out["push_to_queryable_s"] = time.perf_counter() - t0
        conn = client.connect([brk], timeout_s=WIRE_TIMEOUT_S)

        # 21a: the flights; 21b: the launch counts of the timed window
        _wire_warm(conn, sqls, wants, "21a")
        before = {sid: _wire_get(f"{b}/debug/launches")["launches"]
                  for sid, b in base.items()}
        counters = scan_counters()
        _reset(counters)
        p50, raws = _wire_flights(conn, sqls, wants, reps, "21a", sync)
        launches = {n: c.launches for n, c in counters.items()}
        after = {sid: _wire_get(f"{b}/debug/launches")["launches"]
                 for sid, b in base.items()}
        wires = [w for _n, w in WIRE_COUNTERS]
        served = {w: sum(r.get(w, 0) for r in raws) for w in wires}
        counted = {w: sum(after[s].get(w, 0) - before[s].get(w, 0)
                          for s in base) for w in wires}
        if served != counted or (device == "cuda" and (
                launches["fused_scan"] == 0
                or served["scanLaunches"] != launches["fused_scan"]
                or served["probeLaunches"] != launches["fused_scan_probe"])):
            raise AssertionError(f"21b: responses' launches {served}, "
                                 f"servers' {counted}, process {launches}")
        out["flights"] = {q: {"p50_ms": v, "phase16_p50_ms": (
            front["flights"][q]["p50_ms"] if front else None)}
            for q, v in p50.items()}
        for q, f in out["flights"].items():
            log(f"  21a {q}: p50 {f['p50_ms']:.3f} ms through REST "
                f"(phase 16 in process: {f['phase16_p50_ms']})")
        out["launches"] = launches
        out["server_launches"] = counted
        log(f"  21a: 13 flights x {reps} through the client == oracle; "
            f"launches {launches}, the servers' /debug/launches {counted}")
        out["clients"] = {
            n: _wire_clients(lambda: client.connect(
                [brk], timeout_s=WIRE_TIMEOUT_S), sqls, wants, n, rounds,
                f"21a {n} clients") for n in (1, 8)}
        for n, r in out["clients"].items():
            log(f"  21a {n} clients: {r['queries']} queries, QPS "
                f"{r['qps']:.1f}, p50 {r['p50_ms']:.3f} ms, p99 "
                f"{r['p99_ms']:.3f} ms")

        # 21b: every debug route
        routes = {}
        for api, url in [(apis[1], brk)] + [(admins[s], base[s])
                                            for s in sorted(base)]:
            for m, pat, _fn, _scope in api._routes:
                if m != "GET" or not pat.pattern.startswith("/debug/"):
                    continue
                path = pat.pattern.replace("([^/]+)", FRONT_TABLE)
                body = _wire_get(url + path)
                if not isinstance(body, dict):
                    raise AssertionError(f"21b: {url}{path}: {body!r}")
                routes[path] = routes.get(path, 0) + 1
        for sid, srv in cluster.servers.items():
            mem = _wire_get(f"{base[sid]}/debug/memory")
            if mem["stagedBytes"] != srv.executor.residency.staged_bytes() \
                    or not mem["stagedBytes"]:
                raise AssertionError(f"21b: {sid} stagedBytes "
                                     f"{mem['stagedBytes']}")
            pal = _wire_get(f"{base[sid]}/debug/pallas")
            rows = [r for r in pal["preflight"]["shapes"]
                    if r["source"] == "ssb"]
            if len(rows) != 13 or any(r["verdict"] != "pass" for r in rows) \
                    or pal["blockedShapes"]:
                raise AssertionError(f"21b: {sid} /debug/pallas {pal}")
        out["debug_routes"] = routes
        log(f"  21b: {len(routes)} debug routes answered JSON "
            f"({sum(routes.values())} calls); stagedBytes == residency; "
            "/debug/pallas: 13 flights pass")
    finally:
        for api in apis:
            api.stop()
        cluster.shutdown()
    return out


def _wire_preflight(main: dict, device: str) -> dict:
    """21c."""
    import tempfile

    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.engine.pallas_blocklist import PallasBlocklist
    from pinot_tpu_torch.engine.plan import plan_segment
    from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration
    from pinot_tpu_torch.tools import preflight

    launched, declined, err = [], {}, 0.0
    for label, pp, bits in preflight.fuzz_specs():
        v = preflight.preflight_program(pp, bits, shape=label)
        if v.ok == label.endswith(("_over", "_straddle")):
            raise AssertionError(f"21c {label}: {v.row()}")
        if not v.ok:
            declined[label] = v.rule
            continue
        prog = fs.compile_program(pp, bits)
        words, values, num_docs = preflight.launch_inputs(pp, bits, device)
        kern = fs.fused_scan(prog, words, values, num_docs)
        plain = fs.fused_scan_plain(prog, words, values, num_docs)
        err = max(err, _compare(kern, plain, f"21c {label}"))
        launched.append(label)
    if set(declined.values()) != {r.code for r in preflight.RULES}:
        raise AssertionError(f"21c: the grid's declines {declined}")
    log(f"  21c: {len(launched)} fuzz shapes the preflight passes == plain "
        f"version on the card (max abs err {err}); {len(declined)} past a "
        f"limit declined by compile_program with its code: {declined}")
    segs, ctxs, wants = main["segs"], main["ctxs"], main["wants"]
    codes = {qid: preflight.RULES[k % len(preflight.RULES)].code
             for k, qid in enumerate(sorted(ctxs))}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "blocklist.json")
        written = PallasBlocklist(path)
        for qid, ctx in ctxs.items():
            written.add(plan_segment(ctx, segs[0]).spec, reason=codes[qid])
        ex = ServerQueryExecutor(device=device, config=PinotConfiguration(
            {CommonConstants.PALLAS_BLOCKLIST_PATH_KEY: path}))
        blocked = 0
        try:
            for qid, ctx in ctxs.items():
                got, _stats = ex.execute(ctx, segs)
                _check_flight(f"21c {qid}", got, wants[qid])
                # the file holds the flights' plans over segment 0 (a
                # plan's spec carries its segment's cardinalities)
                _got, stats = ex.execute(ctx, segs[:1])
                if not stats.num_segments_processed:
                    continue
                if not any(k.endswith(":" + codes[qid])
                           for k in stats.decisions) or stats.scan_launches:
                    raise AssertionError(f"21c {qid}: {stats.decisions}, "
                                         f"{stats.scan_launches} launches")
                blocked += 1
        finally:
            ex.close()
        if not blocked:
            raise AssertionError("21c: no flight's plan on segment 0 met "
                                 "the blocklist")
    log(f"  21c: a blocklist file of the 13 flights' plans read by a new "
        f"executor: {blocked} flights' plans on segment 0 declined with "
        "their codes, no launch; every flight == oracle")
    return {"launched": launched, "declined": declined, "max_abs_err": err,
            "blocked": blocked}


def _wire_processes(main: dict, dirs: list, reps: int, device: str,
                    procs: int, rounds: int, rest: dict, tmp: str) -> dict:
    """21d."""
    import threading

    import torch

    from pinot_tpu_torch import client, native
    from pinot_tpu_torch.broker.broker import BrokerRequestHandler
    from pinot_tpu_torch.controller.controller import Controller
    from pinot_tpu_torch.controller.state import ONLINE, ClusterStateStore
    from pinot_tpu_torch.engine import _build
    from pinot_tpu_torch.segment.immutable import load_segment
    from pinot_tpu_torch.spi.filesystem import file_url
    from pinot_tpu_torch.spi.table import SegmentsValidationConfig, TableConfig
    from pinot_tpu_torch.transport.grpc_transport import GrpcServerStub
    from pinot_tpu_torch.transport.rest import BrokerApi
    from pinot_tpu_torch.transport.state_service import StateStoreApi

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    segs, ctxs, wants = main["segs"], main["ctxs"], main["wants"]
    sqls = {qid: ctx.sql for qid, ctx in ctxs.items()}
    if device == "cuda":    # built once here: no child builds them
        _build.load_library("fused_scan")
    native.load()
    budget = (int(0.75 * torch.cuda.get_device_properties(0).total_memory
                  / procs) if device == "cuda" else 0)
    store = ClusterStateStore()
    state_api = StateStoreApi(store, port=0)
    state_api.start()
    controller = Controller(store)
    controller.add_schema(segs[0].metadata.schema)
    controller.add_table(TableConfig(
        FRONT_TABLE, validation_config=SegmentsValidationConfig(
            time_column_name="d_yearmonthnum", replication=1)))
    broker = BrokerRequestHandler(store, device=device)
    brk_api = BrokerApi(broker, port=0)
    brk_api.start()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    children, stubs, ports, out = [], [], {}, {}
    try:
        t0 = time.perf_counter()
        for i in range(procs):
            sid = f"proc_server_{i}"
            err = open(os.path.join(tmp, f"{sid}.log"), "w")
            children.append((sid, err, subprocess.Popen(
                [sys.executable, "-m", "pinot_tpu_torch", "StartServer",
                 "-stateUrl", f"http://localhost:{state_api.port}",
                 "-instanceId", sid, "-device", device,
                 "-budgetBytes", str(budget),
                 "-segmentDir", os.path.join(tmp, sid)],
                cwd=root, env=env, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=err, text=True)))

        def ready(sid, proc):
            ports[sid] = json.loads(proc.stdout.readline())

        waits = [threading.Thread(target=ready, args=(sid, p))
                 for sid, _e, p in children]
        for w in waits:
            w.start()
        for w in waits:
            w.join(WIRE_TIMEOUT_S)
        if len(ports) != procs:
            raise AssertionError(f"21d: servers up: {sorted(ports)}; "
                                 + _wire_logs(children))
        out["start_s"] = time.perf_counter() - t0
        for sid, p in ports.items():
            stub = GrpcServerStub(f"localhost:{p['grpcPort']}",
                                  timeout_s=WIRE_TIMEOUT_S)
            stubs.append(stub)
            broker.register_server(sid, stub)
        t0 = time.perf_counter()
        for d in dirs:
            controller.add_segment(FRONT_TABLE, load_segment(d).metadata,
                                   file_url(d))
        ideal = store.get_ideal_state(FRONT_TABLE)
        deadline = time.monotonic() + 300
        while any(store.get_external_view(FRONT_TABLE).get(seg, {}).get(i)
                  != ONLINE for seg, m in ideal.items() for i in m):
            if time.monotonic() > deadline:
                raise AssertionError("21d: the ExternalView did not "
                                     "converge; " + _wire_logs(children))
            time.sleep(0.05)
        out["push_to_queryable_s"] = time.perf_counter() - t0
        for sid, p in ports.items():
            base = f"http://localhost:{p['adminPort']}"
            size = _wire_get(f"{base}/tables/{FRONT_TABLE}/size")
            mine = sorted(s for s, m in ideal.items() if sid in m)
            if sorted(size["segments"]) != mine or not size["totalBytes"]:
                raise AssertionError(f"21d: {sid} size {size} vs {mine}")
        conn = client.connect([f"localhost:{brk_api.port}"],
                              timeout_s=WIRE_TIMEOUT_S)
        _wire_warm(conn, sqls, wants, "21d")
        p50, _raws = _wire_flights(conn, sqls, wants, reps, "21d", sync)
        out["flights"] = {q: {"p50_ms": v,
                              "in_process_p50_ms": rest["flights"][q]
                              ["p50_ms"]} for q, v in p50.items()}
        for q, f in out["flights"].items():
            log(f"  21d {q}: p50 {f['p50_ms']:.3f} ms over gRPC to "
                f"{procs} server processes (21a in process: "
                f"{f['in_process_p50_ms']:.3f})")
        out["clients"] = {
            n: _wire_clients(lambda: client.connect(
                [f"localhost:{brk_api.port}"], timeout_s=WIRE_TIMEOUT_S),
                sqls, wants, n, rounds, f"21d {n} clients")
            for n in (1, 8)}
        for n, r in out["clients"].items():
            ip = rest["clients"][n]
            log(f"  21d {n} clients: QPS {r['qps']:.1f} (21a {ip['qps']:.1f})"
                f", p50 {r['p50_ms']:.3f} ms (21a {ip['p50_ms']:.3f}), p99 "
                f"{r['p99_ms']:.3f} ms")
        launches, staged = {}, {}
        for sid, p in ports.items():
            base = f"http://localhost:{p['adminPort']}"
            launches[sid] = _wire_get(f"{base}/debug/launches")["launches"]
            staged[sid] = _wire_get(f"{base}/debug/memory")["stagedBytes"]
            if not staged[sid] or (device == "cuda" and not launches[sid]
                                   .get("scanLaunches")):
                raise AssertionError(f"21d: {sid} staged {staged[sid]}, "
                                     f"launches {launches[sid]}")
        out["server_launches"], out["staged_bytes"] = launches, staged
        log(f"  21d: the servers' launches {launches}, stagedBytes {staged}")

        # a server process killed: exceptions and the live server's rows
        victim_sid, _e, victim = children[-1]
        victim.kill()
        victim.wait(30)
        lax = client.connect([f"localhost:{brk_api.port}"],
                             timeout_s=WIRE_TIMEOUT_S,
                             fail_on_exceptions=False)
        got = lax.execute("SELECT count(*) FROM ssb_lineorder")
        total = sum(s.num_docs for s in segs)
        rows = got.result_set.rows if got.result_set else [[0]]
        if not got.exceptions or not 0 < rows[0][0] < total:
            raise AssertionError(f"21d: after the kill {got.exceptions}, "
                                 f"{rows} of {total}")
        out["killed"] = {"server": victim_sid, "rows": rows[0][0],
                         "of": total, "exceptions": got.exceptions}
        log(f"  21d: {victim_sid} killed: {len(got.exceptions)} exceptions, "
            f"count {rows[0][0]} of {total} from the live server")
    finally:
        for stub in stubs:
            stub.close()
        for _sid, err, proc in children:
            if proc.poll() is None:
                proc.stdin.close()
                try:
                    proc.wait(30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(30)
            err.close()
        brk_api.stop()
        broker.shutdown()
        state_api.stop()
    return out


def _wire_logs(children) -> str:
    """The last lines of each server process's standard error."""
    out = []
    for sid, err, _proc in children:
        err.flush()
        with open(err.name) as f:
            out.append(f"{sid}: " + "".join(f.readlines()[-20:]))
    return " | ".join(out)


# -- phase 22: batch and stream ingestion --------------------------------------

ING_SF = 0.25           # SSB scale of 22a: 1.5 M rows (SF1's 6 M took 77 s)
ING_PARTS = 8           # landing files of 22a, one segment each
ING_PARALLELISM = 8     # segmentCreationJobParallelism of 22a's job
ING_SERVERS = 2
ING_TASK_ROWS = (250_000, 250_000, 100_000)     # 22b: CSV, JSON lines, Avro
# 22d: rows and flush thresholds, 4 seals each (200 k Kafka rows at flush
# 50 k took 33.8 s to consume on the H100's host, 2.6 k rows/s a consumer)
ING_KAFKA_ROWS = 100_000
ING_SOCKET_ROWS = 50_000
ING_FLUSH = 25_000
ING_SOCKET_FLUSH = 12_500
ING_WAIT_S = 300.0      # every wait on a cluster or a stream of the phase
ING_TABLE = "ssb_lineorder"
ING_S3_TABLE = "ssb_s3"
ING_TASK_TABLE = "ssb_task"
ING_CRYPTER = "chip_smoke_keyed"
# the phase at a size the CPU tests run
INGEST_SMALL = dict(sf=0.002, parts=2, parallelism=2,
                    task_rows=(3000, 3000, 1200), kafka_rows=8000,
                    socket_rows=4000, flush=2000, socket_flush=1000)


def _ssb_schema(name: str):
    from pinot_tpu_torch.spi.data import FieldSpec, Schema
    from pinot_tpu_torch.tools import ssb

    return Schema(name, [FieldSpec(c, dt, ft) for c, dt, ft in ssb.COLUMNS])


def _ssb_config(name: str, task: dict = None):
    from pinot_tpu_torch.spi.table import SegmentsValidationConfig, TableConfig

    return TableConfig(name, validation_config=SegmentsValidationConfig(
        time_column_name="d_yearmonthnum"), task_config=task or {})


def _text_columns(frame: dict) -> list:
    """A decoded SSB frame's columns in ``ssb.COLUMNS`` order as lists of
    the cells a CSV holds."""
    from pinot_tpu_torch.tools import ssb

    return [np.asarray(frame[c]).astype(str).tolist()
            for c, _, _ in ssb.COLUMNS]


def _write_csv(path: str, frame: dict) -> None:
    import csv

    from pinot_tpu_torch.tools import ssb

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([c for c, _, _ in ssb.COLUMNS])
        w.writerows(zip(*_text_columns(frame)))


def _ingest_part(i: int, parts: int, rows: int, seed: int, csv_path: str,
                 ref_dir: str, name: str) -> dict:
    """22a's setup for part ``i``, in a spawned worker: the part's rows,
    written as a CSV landing file, the segment ``SegmentBuilder`` builds
    from the same frame (the reference for the job's directory), and each
    flight's answer over the part. The worker must not touch the card."""
    import torch

    from pinot_tpu_torch.segment.creator import SegmentBuilder
    from pinot_tpu_torch.tools import ssb

    frame = ssb.generate_segment_frame(i, parts, rows, seed)
    decoded = ssb.decode_frame(frame)
    _write_csv(csv_path, decoded)
    SegmentBuilder(_ssb_schema(ING_TABLE), name,
                   table_config=_ssb_config(ING_TABLE)).build(decoded,
                                                              ref_dir)
    answers = {qid: ssb.numpy_answer(frame, qid) for qid in ssb.QUERIES}
    if torch.cuda.is_initialized():
        raise AssertionError(f"22a: the setup worker of part {i} "
                             "initialised CUDA")
    return answers


def _dir_differences(a: str, b: str) -> list:
    """The files of segment directories ``a`` and ``b`` that differ, the
    metadata's creation time and star-tree build seconds aside."""
    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _dirs, fs in os.walk(d) for f in fs)

    out = sorted(set(files(a)) ^ set(files(b)))
    for rel in files(a):
        if rel in out:
            continue
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            x, y = fa.read(), fb.read()
        if rel == "metadata.json":
            x, y = json.loads(x), json.loads(y)
            for k in ("creationTimeMs", "starTreeBuildS"):
                x.pop(k, None)
                y.pop(k, None)
        if x != y:
            out.append(rel)
    return out


def _flight_sqls(table: str) -> dict:
    from pinot_tpu_torch.tools import ssb

    return {qid: (q + " LIMIT 100000").replace(
        "FROM ssb_lineorder", f"FROM {table}")
        for qid, q in ssb.QUERIES.items()}


def _ingest_flights(cluster, sqls: dict, wants: dict, reps: int,
                    counters: dict, on_card: bool, what: str) -> dict:
    """The 13 flights through ``cluster.query`` ``reps`` times, clean,
    full and == ``wants``, on the fused scan (probe first for Q3.2 and
    Q4.3) and never on the host engine. -> p50 ms and rows per flight."""
    out = {}
    for qid, sql in sqls.items():
        n0 = {k: c.launches for k, c in counters.items()}
        lat, resp = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            resp = cluster.query(sql)
            lat.append((time.perf_counter() - t0) * 1e3)
            _front_check(f"{what} {qid}", resp, wants[qid])
        host = [k for k in resp.stats.decisions if "host_engine" in k]
        scans = counters["fused_scan"].launches - n0["fused_scan"]
        probes = (counters["fused_scan_probe"].launches
                  - n0["fused_scan_probe"])
        if host or (on_card and (scans == 0 or (
                qid in PROBE_FLIGHTS) != (probes > 0))):
            raise AssertionError(f"{what} {qid}: {scans} scans, {probes} "
                                 f"probes, host decisions {host}")
        out[qid] = {"p50_ms": float(np.percentile(lat, 50)),
                    "rows": resp.result_table.rows, "scans": scans,
                    "probes": probes}
    return out


def phase_ingest(reps: int, device: str = "cuda", front: dict = None,
                 sf: float = ING_SF, parts: int = ING_PARTS,
                 parallelism: int = ING_PARALLELISM,
                 task_rows: tuple = ING_TASK_ROWS,
                 kafka_rows: int = ING_KAFKA_ROWS,
                 socket_rows: int = ING_SOCKET_ROWS,
                 flush: int = ING_FLUSH,
                 socket_flush: int = ING_SOCKET_FLUSH,
                 seed: int = 22) -> dict:
    """Phase 22: batch and stream ingestion on the card, at SSB
    ``lineorder``'s full width (17 columns). ``front``: phase 16's
    flights, whose p50 22a's stand beside.

    (22a) SSB at ``sf`` from ``ssb.generate_segment_frame`` in ``parts``
    parts, each written as a CSV landing file by a spawned pool (setup,
    timed apart); the job at parallelism 1 over one file, then a YAML job
    spec (``SegmentCreationAndTarPush``, ``segmentCreationJobParallelism``
    ``parallelism``) through ``run_ingestion_job(..., cluster=)`` into an
    ``EmbeddedCluster(data_dir=...)`` of ``ING_SERVERS`` servers (no
    star-tree): every segment directory equal, file for file, to the one
    ``SegmentBuilder`` writes from the same frame, the times aside; the
    13 flights through ``cluster.query`` == the oracle merged over the
    parts, on the fused scan (the probe for Q3.2 and Q4.3), no host-engine
    decision. (22b) SegmentGenerationAndPush under a minion on a landing
    directory of a CSV and a JSON-lines file, then an Avro file written
    by ``write_container``: the second task reads only it, the store's
    processed set holds all three, count(*) and sum(lo_revenue) == the
    oracle after each, ``GET /tasks/tasktypes`` lists the type. (22c)
    22a's segments copied into an in-process ``MockS3Server`` by
    ``S3PinotFS``, registered under ``s3://`` as a second table whose
    servers copy them into their segment directories: the flights ==
    22a's rows; one segment encrypted in a ``file://`` store, fetched with
    the crypter: the local copy == the original, the store still
    encrypted, Q1.1 and Q3.2 on it through a ``ServerQueryExecutor`` ==
    the part's oracle. (22d) a realtime user-events table fed by a
    ``KafkaBrokerSim`` of 2 partitions over TCP (``kafka_rows`` JSON rows,
    flush ``flush``), then one by a ``StreamBrokerServer``
    (``socket_rows``): count(*) and a group-by on event_type == numpy
    before the seals (on the consuming rung) and after (the fused scan on
    the seals)."""
    import shutil
    import tempfile

    import torch

    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster

    on_card = device == "cuda"
    t_all = time.perf_counter()
    counters = scan_counters()
    _reset(counters)
    launches = {name: 0 for name in counters}

    def add_launches():
        for name, c in counters.items():
            launches[name] += c.launches
        _reset(counters)

    out: dict = {}
    root = tempfile.mkdtemp(prefix="pinot_ingest_")
    cluster = EmbeddedCluster(num_servers=ING_SERVERS, device=device,
                              data_dir=os.path.join(root, "cluster"))
    try:
        batch = _ingest_batch(cluster, root, reps, device, front, sf, parts,
                              parallelism, seed, counters, add_launches)
        out["batch"] = batch["report"]
        out["task"] = _ingest_task(cluster, root, task_rows, seed,
                                   counters)
        add_launches()
        out["s3"] = _ingest_s3(cluster, root, batch, reps, device, counters)
        add_launches()
    finally:
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    out["streams"] = _ingest_streams(device, kafka_rows, socket_rows, flush,
                                     socket_flush, seed, counters)
    add_launches()
    out["launches"] = launches
    if on_card:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_all
    log(f"  phase 22: {out['seconds']:.1f} s; fused launches {launches}")
    return out


def _ingest_batch(cluster, root, reps, device, front, sf, parts,
                  parallelism, seed, counters, add_launches) -> dict:
    """22a (see ``phase_ingest``)."""
    import multiprocessing as mp

    import torch
    import yaml

    from pinot_tpu_torch.ingestion.batchjob import (
        SegmentGenerationJobRunner,
        SegmentGenerationJobSpec,
        run_ingestion_job,
    )
    from pinot_tpu_torch.tools import ssb

    on_card = device == "cuda"
    land, ref, one = (os.path.join(root, d)
                      for d in ("landing", "reference", "one_file"))
    os.makedirs(land)
    os.makedirs(ref)
    rows_each = ssb.segment_rows(parts, int(sf * ssb.ROWS_PER_SF))
    names = [f"{ING_TABLE}_batch_{i}" for i in range(len(rows_each))]
    files = [os.path.join(land, f"part_{i}.csv")
             for i in range(len(rows_each))]
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(min(parallelism,
                                          len(rows_each))) as pool:
        answers = pool.starmap(_ingest_part, [
            (i, len(rows_each), n, seed, files[i], ref, names[i])
            for i, n in enumerate(rows_each)])
    write_s = time.perf_counter() - t0
    rows = sum(rows_each)
    wants = {qid: ssb.merge_answers([a[qid] for a in answers])
             for qid in ssb.QUERIES}
    csv_bytes = sum(os.path.getsize(f) for f in files)
    log(f"  22a setup: SSB SF{sf}, {rows} rows in {len(files)} CSV files "
        f"({csv_bytes} bytes), the frame-built segments and the oracle in "
        f"a spawned pool of {min(parallelism, len(files))}: {write_s:.1f} s")

    schema, cfg = _ssb_schema(ING_TABLE), _ssb_config(ING_TABLE)
    cluster.create_table(cfg, schema)
    with open(os.path.join(root, f"{ING_TABLE}_schema.json"), "w") as f:
        json.dump(schema.to_dict(), f)
    with open(os.path.join(root, f"{ING_TABLE}_offline_table_config.json"),
              "w") as f:
        json.dump(cfg.to_dict(), f)
    job = {"jobType": "SegmentCreationAndTarPush",
           "inputDirURI": "landing",
           "includeFileNamePattern": "glob:**/*.csv",
           "outputDirURI": "segments",
           "segmentCreationJobParallelism": parallelism,
           "tableSpec": {
               "tableName": ING_TABLE,
               "schemaURI": f"{ING_TABLE}_schema.json",
               "tableConfigURI": f"{ING_TABLE}_offline_table_config.json"},
           "recordReaderSpec": {"dataFormat": "csv"}}
    spec_file = os.path.join(root, "ingestionJobSpec.yaml")
    with open(spec_file, "w") as f:
        yaml.safe_dump(job, f)

    # the job at parallelism 1 over one file, in this process
    spec1 = SegmentGenerationJobSpec.from_yaml(spec_file)
    spec1.resolve_relative(root)
    spec1.output_dir_uri, spec1.parallelism = one, 1
    t0 = time.perf_counter()
    (one_dir,) = SegmentGenerationJobRunner(spec1).run_files(files[:1])
    one_s = time.perf_counter() - t0
    diff = _dir_differences(one_dir, os.path.join(ref, names[0]))
    if diff:
        raise AssertionError(f"22a: the one-file job's directory differs "
                             f"from the frame-built one in {diff}")

    class PushClock:
        """The cluster as ``run_ingestion_job`` pushes into it, with the
        time of its first push (the builds end there)."""

        def __init__(self):
            self.first = None

        def upload_segment_dir(self, table, seg_dir):
            if self.first is None:
                self.first = time.perf_counter()
            return cluster.upload_segment_dir(table, seg_dir)

    clock = PushClock()
    t0 = time.perf_counter()
    dirs = run_ingestion_job(spec_file, cluster=clock)
    if not cluster.wait_for_ev_converged(cfg.table_name_with_type,
                                         timeout_s=ING_WAIT_S):
        raise AssertionError("22a: the ExternalView did not converge")
    for srv in cluster.servers.values():
        srv.executor.residency.drain_prefetch()
    if on_card:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    job_s, push_s = clock.first - t0, t1 - clock.first
    bad = {os.path.basename(d): _dir_differences(
        d, os.path.join(ref, os.path.basename(d))) for d in dirs}
    bad = {k: v for k, v in bad.items() if v}
    if sorted(map(os.path.basename, dirs)) != sorted(names) or bad:
        raise AssertionError(f"22a: directories {sorted(dirs)} differ from "
                             f"the frame-built ones: {bad}")
    log(f"  22a: the job at parallelism 1, one file of {rows_each[0]} rows: "
        f"{one_s:.2f} s ({rows_each[0] / one_s:.0f} rows/s); at "
        f"parallelism {parallelism}, {len(files)} files: {job_s:.2f} s "
        f"({rows / job_s:.0f} rows/s); push to queryable {push_s:.2f} s; "
        f"{len(dirs)} directories == the frame-built ones file for file")

    add_launches()
    sqls = _flight_sqls(ING_TABLE)
    for qid, sql in sqls.items():      # an untimed pass stages the columns
        _front_check(f"22a {qid}", cluster.query(sql), wants[qid])
    flights = _ingest_flights(cluster, sqls, wants, reps, counters,
                              on_card, "22a")
    add_launches()
    report = {"sf": sf, "rows": rows, "files": len(files),
              "csv_bytes": csv_bytes, "write_s": write_s,
              "one_file_rows": rows_each[0], "one_file_s": one_s,
              "one_file_rows_per_s": rows_each[0] / one_s,
              "parallelism": parallelism, "job_s": job_s,
              "job_rows_per_s": rows / job_s, "push_to_queryable_s": push_s,
              "flights": {q: {"p50_ms": f["p50_ms"],
                              "phase16_p50_ms": (front[q]["p50_ms"]
                                                 if front else None),
                              "scans": f["scans"], "probes": f["probes"]}
                          for q, f in flights.items()}}
    log("  22a: 13 flights == the oracle on the fused scan, no host "
        "engine; p50 ms (phase 16's) " + ", ".join(
            f"{q} {f['p50_ms']:.1f}" + (f" ({f['phase16_p50_ms']:.1f})"
                                         if f["phase16_p50_ms"] else "")
            for q, f in report["flights"].items()))
    return {"report": report, "dirs": dirs, "wants": wants,
            "answers": answers, "rows": {q: f["rows"]
                                         for q, f in flights.items()}}


def _ingest_task(cluster, root, task_rows, seed, counters) -> dict:
    """22b (see ``phase_ingest``)."""
    import urllib.request

    from pinot_tpu_torch.controller.tasks import (
        SEGMENT_GENERATION_AND_PUSH_TASK,
        ingested_files_path,
    )
    from pinot_tpu_torch.ingestion.avro import write_container
    from pinot_tpu_torch.tools import ssb
    from pinot_tpu_torch.transport.rest import serve_cluster

    t_all = time.perf_counter()
    land = os.path.join(root, "task_landing")
    os.makedirs(land)
    table = ING_TASK_TABLE + "_OFFLINE"
    frames = [ssb.generate_segment_frame(i, len(task_rows), n, seed + 1)
              for i, n in enumerate(task_rows)]
    t0 = time.perf_counter()
    _write_csv(os.path.join(land, "a.csv"), ssb.decode_frame(frames[0]))
    with open(os.path.join(land, "b.json"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in ssb.frame_rows(frames[1]))
    write_s = time.perf_counter() - t0
    cluster.create_table(_ssb_config(ING_TASK_TABLE, {
        SEGMENT_GENERATION_AND_PUSH_TASK: {"inputDirURI": land}}),
        _ssb_schema(ING_TASK_TABLE))
    minion = cluster.add_minion(start=False)
    now = int(time.time() * 1000)
    sql = (f"SELECT count(*), sum(lo_revenue) FROM {ING_TASK_TABLE}")

    def check(k: int, what: str) -> None:
        if not cluster.wait_for_ev_converged(table, timeout_s=ING_WAIT_S):
            raise AssertionError(f"{what}: the ExternalView did not converge")
        resp = cluster.query(sql)
        _full(what, resp)
        want = (sum(len(f["lo_revenue"]) for f in frames[:k]),
                sum(int(f["lo_revenue"].sum()) for f in frames[:k]))
        got = resp.result_table.rows
        if len(got) != 1 or got[0][0] != want[0] \
                or float(got[0][1]) != float(want[1]):
            raise AssertionError(f"{what}: {got} != {want}")

    def one_round(what: str) -> tuple:
        t0 = time.perf_counter()
        made = cluster.controller.run_task_generation(now_ms=now)
        if len(made) != 1:
            raise AssertionError(f"{what}: {len(made)} tasks generated")
        task = cluster.controller.task_manager.get(made[0])
        if not minion.run_one_task() or minion.tasks_failed:
            raise AssertionError(f"{what}: the task failed: " + str(
                [t.error for t in cluster.controller.task_manager
                 .list_tasks(status="ERROR")]))
        return json.loads(task.configs["inputFiles"]), \
            time.perf_counter() - t0

    first, first_s = one_round("22b first")
    check(2, "22b first")
    t0 = time.perf_counter()
    avro_schema = {"type": "record", "name": "lineorder", "fields": [
        {"name": c, "type": "int" if dt.is_numeric else "string"}
        for c, dt, _ in ssb.COLUMNS]}
    write_container(os.path.join(land, "c.avro"), avro_schema,
                    ssb.frame_rows(frames[2]))
    avro_s = time.perf_counter() - t0
    second, second_s = one_round("22b second")
    if [os.path.basename(p) for p in first] != ["a.csv", "b.json"] \
            or [os.path.basename(p) for p in second] != ["c.avro"]:
        raise AssertionError(f"22b: tasks read {first} then {second}")
    done = cluster.store.get(ingested_files_path(table)) or {}
    if sorted(done) != ["a.csv", "b.json", "c.avro"]:
        raise AssertionError(f"22b: processed set {sorted(done)}")
    check(3, "22b second")
    if cluster.controller.run_task_generation(now_ms=now):
        raise AssertionError("22b: a third task was generated")
    apis = serve_cluster(cluster)
    try:
        with urllib.request.urlopen(
                f"http://localhost:{apis[0].port}/tasks/tasktypes",
                timeout=ING_WAIT_S) as r:
            types = json.loads(r.read().decode())
    finally:
        for api in apis:
            api.stop()
    if SEGMENT_GENERATION_AND_PUSH_TASK not in types:
        raise AssertionError(f"22b: /tasks/tasktypes {types}")
    rep = {"rows": list(task_rows), "write_s": write_s, "avro_write_s": avro_s,
           "first_task_s": first_s, "second_task_s": second_s,
           "segments": len(cluster.store.segment_names(table)),
           "seconds": time.perf_counter() - t_all}
    log(f"  22b: SegmentGenerationAndPush, CSV {task_rows[0]} + JSON lines "
        f"{task_rows[1]} rows in {first_s:.2f} s (written in "
        f"{write_s:.2f} s), then Avro {task_rows[2]} rows (written in "
        f"{avro_s:.2f} s) alone in {second_s:.2f} s; processed set "
        f"{sorted(done)}; count and sum(lo_revenue) == the oracle after "
        f"each; /tasks/tasktypes lists {SEGMENT_GENERATION_AND_PUSH_TASK}")
    return rep


def _ingest_s3(cluster, root, batch, reps, device, counters) -> dict:
    """22c (see ``phase_ingest``)."""
    import shutil

    import torch

    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.segment.immutable import load_segment
    from pinot_tpu_torch.segment.metadata import METADATA_FILE, SegmentMetadata
    from pinot_tpu_torch.spi.crypt import (
        KeyedStreamCrypter,
        get_crypter,
        register_crypter,
    )
    from pinot_tpu_torch.spi.filesystem import fetch_segment, file_url
    from pinot_tpu_torch.spi.s3fs import MockS3Server, S3PinotFS

    on_card = device == "cuda"
    t_all = time.perf_counter()
    dirs = batch["dirs"]
    table = ING_S3_TABLE + "_OFFLINE"
    s3 = MockS3Server().start()
    env = {"PINOT_S3_ENDPOINT": s3.endpoint,
           "AWS_ACCESS_KEY_ID": s3.access_key,
           "AWS_SECRET_ACCESS_KEY": s3.secret_key,
           "AWS_REGION": s3.region}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        fs = S3PinotFS()
        urls = [f"s3://pinot-deep-store/{os.path.basename(d)}" for d in dirs]
        t0 = time.perf_counter()
        for d, url in zip(dirs, urls):
            fs.copy_from_local_dir(d, url)
        put_s = time.perf_counter() - t0
        nbytes = sum(_dir_bytes(d) for d in dirs)
        probe = os.path.join(root, "s3_probe")
        t0 = time.perf_counter()
        got = [fetch_segment(url, probe) for url in urls]
        fetch_s = time.perf_counter() - t0
        bad = {u: _dir_differences(d, g)
               for u, d, g in zip(urls, dirs, got)}
        bad = {k: v for k, v in bad.items() if v}
        if bad:
            raise AssertionError(f"22c: fetched copies differ: {bad}")
        shutil.rmtree(probe)
        cluster.create_table(_ssb_config(ING_S3_TABLE),
                             _ssb_schema(ING_S3_TABLE))
        t0 = time.perf_counter()
        for d, url in zip(dirs, urls):
            cluster.controller.add_segment(
                table, SegmentMetadata.load(os.path.join(d, METADATA_FILE)),
                url)
        if not cluster.wait_for_ev_converged(table, timeout_s=ING_WAIT_S):
            raise AssertionError("22c: the ExternalView did not converge")
        for srv in cluster.servers.values():
            srv.executor.residency.drain_prefetch()
        if on_card:
            torch.cuda.synchronize()
        push_s = time.perf_counter() - t0
        hosted = [getattr(m.segment, "segment_dir", None)
                  for srv in cluster.servers.values()
                  for tdm in [srv.data_manager.get(table)] if tdm is not None
                  for m in tdm._segments.values()]
        if len(hosted) != len(dirs) or not all(
                h and h.startswith(cluster.server_segment_dir)
                for h in hosted):
            raise AssertionError(f"22c: hosted copies {hosted}")
        sqls = _flight_sqls(ING_S3_TABLE)
        for qid, sql in sqls.items():
            _front_check(f"22c {qid}", cluster.query(sql),
                         batch["wants"][qid])
        flights = _ingest_flights(cluster, sqls, batch["wants"], reps,
                                  counters, on_card, "22c")
        for qid, f in flights.items():
            _identical_rows(f"22c {qid}", f["rows"], batch["rows"][qid])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        s3.stop()

    # a crypter on a file:// store: the local copy decrypted, the store not
    register_crypter(ING_CRYPTER,
                     lambda: KeyedStreamCrypter(b"chip-smoke-phase-22"))
    store = os.path.join(root, "encrypted_store")
    enc = os.path.join(store, os.path.basename(dirs[0]))
    shutil.copytree(dirs[0], enc)
    crypter = get_crypter(ING_CRYPTER)
    for r, _dirs, fs_ in os.walk(enc):
        for f in fs_:
            crypter.encrypt(os.path.join(r, f))
    t0 = time.perf_counter()
    local = fetch_segment(file_url(enc), os.path.join(root, "decrypted"),
                          crypter=ING_CRYPTER)
    decrypt_s = time.perf_counter() - t0
    if _dir_differences(dirs[0], local) or os.path.samefile(local, enc):
        raise AssertionError("22c: the decrypted copy differs from the "
                             "original")
    still = []
    for r, _dirs, fs_ in os.walk(enc):
        for f in fs_:
            with open(os.path.join(r, f), "rb") as fh:
                if fh.read(len(KeyedStreamCrypter._MAGIC)) \
                        != KeyedStreamCrypter._MAGIC:
                    still.append(f)
    if still:
        raise AssertionError(f"22c: the store's files were decrypted: "
                             f"{still}")
    ex = ServerQueryExecutor(device=device)
    try:
        seg = load_segment(local)
        part0 = batch["answers"][0]
        for qid in ("Q1.1", "Q3.2"):
            table_ = ex.execute(compile_query(
                _flight_sqls(ING_TABLE)[qid]), [seg])[0]
            _check_flight(f"22c decrypted {qid}", table_, part0[qid])
    finally:
        ex.close()
        ex.residency.close()
    rep = {"segments": len(dirs), "bytes": nbytes, "put_s": put_s,
           "fetch_s": fetch_s, "fetch_mb_per_s": nbytes / 1e6 / fetch_s,
           "push_to_queryable_s": push_s,
           "p50_ms": {q: f["p50_ms"] for q, f in flights.items()},
           "decrypt_s": decrypt_s, "seconds": time.perf_counter() - t_all}
    log(f"  22c: {len(dirs)} segments ({nbytes} bytes) put into the mock S3 "
        f"in {put_s:.2f} s, fetched at {rep['fetch_mb_per_s']:.1f} MB/s; "
        f"s3:// push to queryable {push_s:.2f} s (each server's own copy); "
        f"the 13 flights == 22a's rows; a crypted file:// segment fetched "
        f"and decrypted in {decrypt_s:.2f} s == the original, the store "
        "still encrypted, Q1.1 and Q3.2 on it == the part's oracle")
    return rep


def _ingest_streams(device, kafka_rows, socket_rows, flush, socket_flush,
                    seed, counters) -> dict:
    """22d (see ``phase_ingest``)."""
    import dataclasses

    from pinot_tpu_torch.ingestion.kafkawire import KafkaBrokerSim
    from pinot_tpu_torch.ingestion.socketstream import (
        BROKER_URL_PROP,
        StreamBrokerServer,
        create_topic,
        produce,
    )
    from pinot_tpu_torch.tools import usertable
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster

    on_card = device == "cuda"
    out = {}
    frame = usertable.generate_frame(0, 1, max(kafka_rows, socket_rows),
                                     seed)
    messages = usertable.frame_messages(frame)
    cluster = EmbeddedCluster(num_servers=ING_SERVERS, device=device)
    kafka = KafkaBrokerSim().start()
    sock = StreamBrokerServer().start()
    try:
        def table(stream_type, topic, props, flush):
            cfg = usertable.realtime_table_config(topic, flush)
            cfg.stream_config = dataclasses.replace(
                cfg.stream_config, stream_type=stream_type,
                properties=props)
            return cfg

        def fill(put, rows, flush):
            """Produce rows ``[0, first)`` and wait for them (below the
            flush), then the rest; -> (rows/s a consumer, the check of
            each step)."""
            first = min(flush // 2, rows)
            for p in (0, 1):
                put(messages[p:first:2], p)
            if not cluster.wait_for_docs("user_events", first,
                                         timeout_s=ING_WAIT_S):
                raise AssertionError(f"22d: {first} rows never counted")
            before = _ingest_stream_check(cluster, frame, first, counters,
                                          on_card, sealed=False)
            t0 = time.perf_counter()
            for p in (0, 1):
                put(messages[first + p:rows:2], p)
            _settled(cluster, "user_events_REALTIME", "22d")
            consume_s = time.perf_counter() - t0
            after = _ingest_stream_check(cluster, frame, rows, counters,
                                         on_card, sealed=True)
            seals = _seal_report(cluster, "user_events_REALTIME")
            return {"rows": rows, "flush": flush, "consume_s": consume_s,
                    "rows_per_s_a_consumer":
                        (rows - first) / 2 / consume_s,
                    "before": before, "after": after, "seals": seals}

        topic = f"ingest_kafka_{seed}"
        kafka.create_topic(topic, 2)
        cluster.create_table(table("kafka", topic, {
            "stream.kafka.broker.list": f"{kafka.host}:{kafka.port}"},
            flush), usertable.user_schema())
        out["kafka"] = fill(
            lambda msgs, p: kafka.produce(topic, [m.encode() for m in msgs],
                                          partition=p), kafka_rows, flush)
        cluster.controller.delete_table("user_events_REALTIME")
        if not _until_none(cluster, "user_events_REALTIME"):
            raise AssertionError("22d: consumers outlived the table")

        topic = f"ingest_socket_{seed}"
        create_topic(sock.url, topic, 2, timeout=ING_WAIT_S)
        cluster.create_table(table("socket", topic,
                                   {BROKER_URL_PROP: sock.url},
                                   socket_flush), usertable.user_schema())
        out["socket"] = fill(
            lambda msgs, p: produce(sock.url, topic,
                                    [json.loads(m) for m in msgs],
                                    partition=p, timeout=ING_WAIT_S),
            socket_rows, socket_flush)
        cluster.controller.delete_table("user_events_REALTIME")
        if not _until_none(cluster, "user_events_REALTIME"):
            raise AssertionError("22d: consumers outlived the table")
    finally:
        cluster.shutdown()
        kafka.stop()
        sock.stop()
    for name, r in out.items():
        s = r["seals"]
        log(f"  22d {name}: {r['rows']} rows on 2 partitions over TCP, "
            f"flush {r['flush']}: {s['seals']} seals, "
            f"{r['rows_per_s_a_consumer']:.0f} rows/s a consumer (phase "
            f"17 from memory: 7.9-11.6 k), threshold to swap p50 "
            f"{(s['threshold_to_swap_s'] or {}).get('p50', 0):.3f} s; "
            f"count and event_type == numpy before the seals (consuming "
            f"rung on {r['before']['consuming']} segments) and after "
            f"({r['after']['scans']} fused launches on "
            f"{r['after']['sealed']} seals)")
    return out


def _ingest_stream_check(cluster, frame, rows, counters, on_card,
                         sealed: bool) -> dict:
    """count(*) and count by event_type of the first ``rows`` rows through
    ``cluster.query`` == numpy; before the seals the group-by runs on the
    consuming rung, after them its star-tree opt-out on the fused scan
    over every seal."""
    from pinot_tpu_torch.tools import usertable

    want_types = np.bincount(np.asarray(frame["event_type"][:rows]),
                             minlength=len(usertable.EVENT_TYPES))
    want = sorted([usertable.EVENT_TYPES[i], int(n)]
                  for i, n in enumerate(want_types) if n)
    resp = cluster.query("SELECT count(*) FROM user_events")
    _full("22d count", resp)
    if resp.result_table.rows[0][0] != rows:
        raise AssertionError(f"22d: count {resp.result_table.rows} != "
                             f"{rows}")
    counts = _segment_counts(cluster, "user_events_REALTIME")
    sql = ("SELECT event_type, count(*) FROM user_events GROUP BY "
           "event_type ORDER BY event_type LIMIT 10")
    if sealed:
        sql += " OPTION(useStarTree=false)"
    n0 = counters["fused_scan"].launches
    resp = cluster.query(sql)
    _full("22d event_type", resp)
    got = sorted([r[0], int(r[1])] for r in resp.result_table.rows)
    if got != want:
        raise AssertionError(f"22d: event_type {got} != {want}")
    rungs = resp.stats.rung_segments
    scans = counters["fused_scan"].launches - n0
    consuming = rungs.get("mutable_device", 0)
    if not sealed and (counts["ONLINE"] or not consuming):
        raise AssertionError(f"22d: before the seals {counts}, rungs "
                             f"{rungs}")
    if sealed and (not counts["ONLINE"]
                   or (on_card and scans != counts["ONLINE"])):
        raise AssertionError(f"22d: {scans} fused launches on "
                             f"{counts['ONLINE']} seals, rungs {rungs}")
    return {"sealed": counts["ONLINE"], "consuming": consuming,
            "scans": scans}


def _phases_2_to_11(args, smi: str) -> tuple:
    """Phases 2-11 and 13a-b: the fused-scan kernel, every earlier path,
    then residency and coalescing on phase 4's segments. -> (their
    report, the kernels line's rows, their part of the rungs line)."""
    import torch

    from pinot_tpu_torch.engine import _build

    log("phase 2: build")
    t0 = time.perf_counter()
    _build.load_library("fused_scan")
    log(f"  fused_scan built and loaded in {time.perf_counter() - t0:.1f} s")
    nvcc_log = _build.ptxas_log("fused_scan")
    ptxas = [line.strip() for line in nvcc_log.splitlines()
             if "registers" in line or "stack frame" in line
             or "spill" in line or "Function properties" in line]
    for line in ptxas:
        log(f"  ptxas: {line}")
    frame = _ptxas_frame(nvcc_log, "fused_scan_many_kernel")
    if frame != (0, 0, 0):
        raise AssertionError(f"fused_scan_many_kernel: stack frame, spill "
                             f"stores, spill loads {frame} bytes, not 0")

    log("phase 3: kernel against plain version")
    t0 = time.perf_counter()
    errs = phase_kernels()
    log(f"  all cases agree ({time.perf_counter() - t0:.1f} s)")

    log("phase 4: per-segment path")
    t0 = time.perf_counter()
    main_run = phase_main(args.sf, args.segments, args.seed, args.reps)
    log(f"  per-segment path phase: {time.perf_counter() - t0:.1f} s")

    log("phase 5: kernel against plain version and timings at the "
        "per-segment path's shapes (segment 0)")
    timing = phase_timing(main_run, errs)

    log("phase 6: batch path")
    t0 = time.perf_counter()
    batch_run = phase_batch(main_run, args.reps, errs)
    log(f"  batch path phase: {time.perf_counter() - t0:.1f} s")
    timing += batch_run["timing"]

    log("phase 23 (after 6): the combine mesh: phase 6's flights over "
        "meshes of cells cuda:i % cards, 1x1 (phase 6's), 8x1, 4x2 and 2x2, "
        "the query axis and a sliced flight on 4x2, the broker's merge over "
        "4 cells")
    t0 = time.perf_counter()
    mesh_run = phase_mesh(main_run, batch_run["ex"], args.reps, errs)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 23: {time.perf_counter() - t0:.1f} s")

    log("phase 7: general rung")
    t0 = time.perf_counter()
    general_run = phase_general(main_run, args.reps)
    log(f"  general rung phase: {time.perf_counter() - t0:.1f} s")

    log("phase 8: the user-events table (raw, multi-value columns)")
    t0 = time.perf_counter()
    users_run = phase_users(args.seed, args.reps,
                            segments=args.user_segments,
                            rows_per_segment=args.user_rows, errs=errs)
    log("phase 8b: null bitmaps, multi-value aggregations, upsert mask")
    columns_run = phase_columns(args.seed, args.reps)
    log(f"  user-events phase: {time.perf_counter() - t0:.1f} s")

    log("phase 9: the SQL slice: LIKE / REGEXP_LIKE, HAVING, OFFSET, "
        "OPTION and the metadata answer on SSB (9a), time-bucket group-bys "
        "(9b), TEXT_MATCH and JSON_MATCH (9c)")
    t0 = time.perf_counter()
    sql_run = phase_sql(main_run["segs"], main_run["sql_texts"],
                        main_run["sql_wants"], main_run["sql_kept"],
                        main_run["ex"],
                        batch_run["ex"], args.reps, errs,
                        q33_rows=main_run["results"]["Q3.3"].rows)
    timing += sql_run["timing"]
    time_run = phase_time(args.seed, args.reps,
                          segments=args.user_segments,
                          rows_per_segment=args.user_rows)
    text_run = phase_text(args.seed, args.reps)
    log(f"  SQL-slice phase: {time.perf_counter() - t0:.1f} s")

    log("phase 10: the host engine (percentile, mode, t-digest, grouped "
        "DISTINCTCOUNT, DISTINCT, selection, a virtual column, grouped MV "
        "aggregations) and ordered selection on the device top-k")
    t0 = time.perf_counter()
    host_run = phase_host(main_run, users_run, batch_run["ex"],
                          min(args.reps, 3), card=smi)
    del users_run["host_wants"]
    log(f"  host-engine phase: {time.perf_counter() - t0:.1f} s")

    log("phase 11: the jnp combine over a segment batch (11a) and the "
        "index rung on the indexed user-events table (11b)")
    t0 = time.perf_counter()
    del batch_run["ex"], main_run["ex"]
    torch.cuda.empty_cache()
    combine_run = phase_combine(
        general_run.pop("combine_jobs") + users_run.pop("combine_jobs")
        + sql_run.pop("combine_jobs") + time_run.pop("combine_jobs"),
        args.reps, card=smi)
    index_run = phase_index(users_run, args.reps, card=smi)
    log(f"  phase 11: {time.perf_counter() - t0:.1f} s")

    log("phase 13: residency, sliced execution and launch coalescing on "
        "phase 4's segments (13c runs with phase 12)")
    t0 = time.perf_counter()
    budget_run = phase_budget(main_run, batch_run["per_flight"], args.reps)
    coalesce_run = phase_coalesce(main_run)
    log(f"  phase 13a-b: {time.perf_counter() - t0:.1f} s")
    log(f"phase 15 (before 14): scatter/gather on one card, {SERVERS} "
        "in-process servers and the broker reduce with its device merge")
    t0 = time.perf_counter()
    scatter_run = phase_scatter(main_run, users_run, args.reps)
    del users_run["segs"], users_run["frames"]
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 15: {time.perf_counter() - t0:.1f} s")
    log(f"phase 16 (before 14): the front door on one card, an "
        f"EmbeddedCluster of {FRONT_SERVERS} servers over phase 4's "
        f"segments at replication {FRONT_REPLICATION}")
    t0 = time.perf_counter()
    front_run = phase_front_door(main_run, args.reps)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 16: {time.perf_counter() - t0:.1f} s")
    log(f"phase 17 (after 16, before 14): realtime and hybrid tables "
        f"through the front door, {FRONT_SERVERS} servers at replication "
        f"{FRONT_REPLICATION}")
    t0 = time.perf_counter()
    handed: list = []
    rt_cluster_run = phase_realtime_cluster(
        main_run, args.reps, front=front_run["flights"], seed=args.seed,
        hand_over=handed)
    timing += rt_cluster_run.pop("timing")
    for k, v in rt_cluster_run.pop("errs").items():
        errs[k] = max(errs[k], v)
    log(f"  phase 17: {time.perf_counter() - t0:.1f} s")
    log("phase 18 (after 17, on its cluster): tracing and telemetry through "
        "the front door")
    t0 = time.perf_counter()
    trace_run = phase_trace(main_run, args.reps, cluster=handed.pop(),
                            fresh_tables=RT_FRESH_TABLES)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 18: {time.perf_counter() - t0:.1f} s")
    log(f"phase 19 (after 18, before 14): phase 4's segments on disk, "
        f"loaded, pushed by file:// to {FRONT_SERVERS} servers, reloaded "
        "with new indexes, and realtime seals written to disk")
    disk_run = phase_disk(main_run, args.reps)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 20 (after 19, before 14): the segment lifecycle on "
        f"{LC_SERVERS} servers at replication {LC_REPLICATION} with a "
        "minion (merge-rollup under 4 clients, rollup, realtime-to-offline, "
        "purge, convert-to-raw, retention, tiers, rebalance) and the geo "
        "index")
    lifecycle_run = phase_lifecycle(args.reps)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 21 (after 20, before 14): the wire: REST front doors with "
        "their /debug routes and the client (21a-b), the preflight against "
        f"the kernel (21c), {WIRE_PROCS} servers in processes of their own "
        "over gRPC and the state service (21d)")
    t0 = time.perf_counter()
    wire_run = phase_wire(main_run, args.reps, front=front_run)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 21: {time.perf_counter() - t0:.1f} s")
    log(f"phase 22 (after 21, before 14): batch and stream ingestion: SSB "
        f"SF{ING_SF} as {ING_PARTS} CSV files through the job at "
        f"parallelism {ING_PARALLELISM} (22a), SegmentGenerationAndPush "
        "under a minion (22b), an s3:// deep store and a crypter (22c), "
        "the Kafka wire and socket streams (22d)")
    ingest_run = phase_ingest(args.reps, front=front_run["flights"])
    gc.collect()
    torch.cuda.empty_cache()
    realtime_run = _phase_14(args)
    timing += realtime_run.pop("timing")
    for k, v in realtime_run["errs"].items():
        errs[k] = max(errs[k], v)

    # each path's launches, read after its own run: phases 4 and 6 (per
    # segment and batch), 8 (per segment and batch) and 9
    launches = {k: 0 for k in main_run["launches"]}
    for got in (main_run["launches"], batch_run["launches"],
                users_run["launches"], users_run["batch_launches"],
                sql_run["launches"]["per_segment"],
                sql_run["launches"]["batch"], time_run["launches"],
                text_run["launches"], realtime_run["launches"],
                front_run["launches"], rt_cluster_run["launches"],
                trace_run["launches"], disk_run["launches"],
                lifecycle_run["launches"], wire_run["launches"],
                ingest_run["launches"], mesh_run["launches"]):
        for k in launches:
            launches[k] += got.get(k, 0)
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels the main paths never launched: {idle}")
    kernels = []
    for name, replaces in (
            ("fused_scan", "pinot_tpu/engine/pallas_kernels.py:603"),
            ("fused_scan_probe", "pinot_tpu/engine/pallas_kernels.py:456"),
            ("sharded_fused_scan", "pinot_tpu/parallel/combine.py:298"),
            ("sharded_fused_scan_probe",
             "pinot_tpu/parallel/combine.py:360")):
        rs = [r for r in timing if r["kernel"] == name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pinot_tpu_torch/engine/csrc/fused_scan.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": float(np.mean([r["ms"] for r in rs])),
            "plain_ms": float(np.mean([r["plain_ms"] for r in rs])),
            "bound_ms": float(np.mean([r["bound_ms"] for r in rs])),
            "bound_by": "bytes", "library_ms": None})
    # the query axis: launches from 13b's concurrent run, ms and error at
    # the shapes that launched
    for r, replaces in zip(coalesce_run["kernels"], (
            "pinot_tpu/parallel/combine.py:298 under jax.vmap "
            "(pinot_tpu/parallel/launcher.py:92)",
            "pinot_tpu/parallel/combine.py:360 under jax.vmap "
            "(pinot_tpu/parallel/launcher.py:92)")):
        kernels.append({
            "name": r["kernel"], "route": "cuda",
            "source": "pinot_tpu_torch/engine/csrc/fused_scan.cu",
            "replaces": replaces,
            "launches": coalesce_run["launches"][r["kernel"]]
            + mesh_run["launches"].get(r["kernel"], 0),
            "max_abs_err": max(r["max_abs_err"], errs.get(r["kernel"], 0.0)),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    report = {"ptxas": ptxas, "per_flight": main_run["per_flight"],
              "batch_per_flight": batch_run["per_flight"],
              "batch_per_flight_by_flight":
                  batch_run["per_flight_by_flight"],
              "batch_resident_bytes": batch_run["resident_bytes"],
              "batch_max_memory_allocated":
                  batch_run["max_memory_allocated"],
              "batch_bytes": batch_run["batch_bytes"],
              "batch_setup_ms": batch_run["setup_ms"],
              "q43_combine": batch_run["q43_combine"],
              "kernel_timing": timing, "kernels": kernels,
              "general": general_run,
              "user_events": users_run, "columns": columns_run,
              "sql": {k: v for k, v in sql_run.items() if k != "timing"},
              "time": time_run, "text": text_run,
              "host": host_run, "combine": combine_run,
              "index": index_run, "budget": budget_run,
              "coalesce": coalesce_run, "realtime": realtime_run,
              "scatter": scatter_run, "front_door": front_run,
              "realtime_cluster": rt_cluster_run, "trace": trace_run,
              "disk": disk_run, "lifecycle": lifecycle_run,
              "wire": wire_run, "ingest": ingest_run, "mesh": mesh_run}
    rungs = {
        "flights_fused_off": general_run["rungs"],
        "declined": {g: d["rung_segments"]
                     for g, d in general_run["declined"].items()},
        "user_events": users_run["paths"], "columns": columns_run["paths"],
        "sql": sql_run["paths"], "time": time_run["paths"],
        "text": text_run["paths"], "host": host_run["paths"],
        "combine": {q: r["rung"] for q, r in combine_run["queries"].items()},
        "index": {q: r["kept_segments"]
                  for q, r in index_run["queries"].items()}}
    return report, kernels, rungs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=5)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--user-segments", type=int, default=8)
    ap.add_argument("--user-rows", type=int, default=2_500_000,
                    help="rows per user-events segment")
    ap.add_argument("--startree-sf", type=float, default=STARTREE_SF,
                    help="SSB scale of phase 12 (the star-tree)")
    ap.add_argument("--startree-only", action="store_true",
                    help="run phases 1 and 12 only")
    ap.add_argument("--out-dir", default=None,
                    help="also write the full report as chip_smoke.json here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    log("phase 1: card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    report, kernels, rungs = {"card": smi, "args": vars(args)}, None, {}
    if not args.startree_only:
        got, kernels, rungs = _phases_2_to_11(args, smi)
        report.update(got)
        del got
    gc.collect()
    torch.cuda.empty_cache()
    report["startree"] = run = _phase_12(args, smi)
    rungs["startree"] = {
        **{q: f"tree{r['tree']}:{r['node_slices']}"
           for q, r in run["flights"].items()},
        **{q: r["route"] for q, r in run["routes"].items()}}
    log(f"phase 24 (last): the SSB tools: SSB at SF{P24_SF} partitioned "
        f"by d_year into {P24_SEGMENTS} segments on disk, through a "
        f"cluster of {P24_SERVERS} servers against the numpy baseline "
        "(24a), the microbench (24b)")
    report["partitioned"] = part = phase_partitioned(args.reps)
    if kernels is not None:
        for k in kernels:
            k["launches"] += part["launches"].get(k["name"], 0)
    log("rungs " + json.dumps(rungs))
    report["seconds"] = time.perf_counter() - t_all
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
    log(f"  total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    if kernels is not None:     # phases 2-11 held them
        print(json.dumps({"kernels": kernels}))
    # the run used one card, whatever the host holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
