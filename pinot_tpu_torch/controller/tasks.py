"""Minion task orchestration: generation, queueing and status.

Counterpart of ``pinot_tpu/controller/tasks.py`` (the reference's
``PinotTaskManager`` and its task-queue wrapper): tasks live in the
cluster state store under ``tasks/`` as the JAX package's dicts, minions
poll for them (``minion/worker.py``), and the per-(table, task type)
watermarks live under ``minionTaskMetadata/``. ``generate_tasks`` reads
each table's ``task_config`` (the taskTypeConfigsMap) and runs the
generators of MergeRollup, RealtimeToOffline, Purge, ConvertToRaw and
SegmentGenerationAndPush (the landing files of ``inputDirURI`` that
``ingested_files_path`` does not record yet); an unknown type logs "no
generator".

A segment's time range is the one the controller recorded at its push
(``start_time`` / ``end_time`` in the units of the table's
``time_type``): the min and max of the table's time column
(``controller/state.py`` ``segment_time_range``), where JAX records the
range of the schema's time column alone. A table whose time column the
schema declares as a DIMENSION therefore gives the JAX generators no
candidates and the port's some.
"""

from __future__ import annotations

import json
import logging
import os
import time
import uuid

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.controller.state import (
    CONSUMING,
    ONLINE,
    ClusterStateStore,
)
from pinot_tpu_torch.segment.processing import TIME_UNIT_MS
from pinot_tpu_torch.spi.table import TableType, table_type_from_name

log = logging.getLogger(__name__)

# task states (Helix's TaskState)
WAITING = "WAITING"
IN_PROGRESS = "IN_PROGRESS"
COMPLETED = "COMPLETED"
ERROR = "ERROR"

MERGE_ROLLUP_TASK = "MergeRollupTask"
REALTIME_TO_OFFLINE_TASK = "RealtimeToOfflineSegmentsTask"
PURGE_TASK = "PurgeTask"
CONVERT_TO_RAW_TASK = "ConvertToRawIndexTask"
SEGMENT_GENERATION_AND_PUSH_TASK = "SegmentGenerationAndPushTask"

# stop regenerating a unit of work after this many ERROR attempts; pruning
# terminal records after the TTL both bounds state-store growth and acts as
# a coarse retry backoff (the attempt counter resets once records age out)
MAX_TASK_ATTEMPTS = 3
TERMINAL_TASK_TTL_MS = 24 * 3_600_000

_PERIOD_MS = {"m": 60_000, "h": 3_600_000, "d": 86_400_000}


def parse_period_ms(period: str, default_ms: int) -> int:
    """'1d' / '6h' / '30m' -> milliseconds (the reference's
    TimeUtils.convertPeriodToMillis); ``default_ms`` where it does not
    parse."""
    if not period:
        return default_ms
    period = period.strip().lower()
    try:
        return int(period[:-1]) * _PERIOD_MS[period[-1]]
    except (KeyError, ValueError, IndexError):
        return default_ms


@dataclass
class PinotTaskConfig:
    """One unit of minion work (the reference's PinotTaskConfig)."""

    task_id: str
    task_type: str
    table: str                      # table name with type
    configs: Dict[str, str] = field(default_factory=dict)
    input_segments: List[str] = field(default_factory=list)
    status: str = WAITING
    worker: Optional[str] = None
    error: Optional[str] = None
    output_segments: List[str] = field(default_factory=list)
    created_ms: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "taskId": self.task_id, "taskType": self.task_type,
            "tableName": self.table, "configs": dict(self.configs),
            "inputSegments": list(self.input_segments),
            "status": self.status, "worker": self.worker,
            "error": self.error,
            "outputSegments": list(self.output_segments),
            "createdMs": self.created_ms,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PinotTaskConfig":
        return cls(task_id=d["taskId"], task_type=d["taskType"],
                   table=d["tableName"], configs=d.get("configs", {}),
                   input_segments=d.get("inputSegments", []),
                   status=d.get("status", WAITING), worker=d.get("worker"),
                   error=d.get("error"),
                   output_segments=d.get("outputSegments", []),
                   created_ms=d.get("createdMs", 0))


class PinotTaskManager:
    """Generates + tracks minion tasks over the cluster state store."""

    def __init__(self, store: ClusterStateStore):
        self.store = store  # race-ok: delegates_locking

    # -- queue ---------------------------------------------------------------
    def _path(self, task_id: str) -> str:
        return f"tasks/{task_id}"

    def submit(self, task: PinotTaskConfig) -> str:
        task.created_ms = int(time.time() * 1000)
        self.store.set(self._path(task.task_id), task.to_dict())
        return task.task_id

    def get(self, task_id: str) -> Optional[PinotTaskConfig]:
        d = self.store.get(self._path(task_id))
        return PinotTaskConfig.from_dict(d) if d else None

    def list_tasks(self, table: Optional[str] = None,
                   task_type: Optional[str] = None,
                   status: Optional[str] = None) -> List[PinotTaskConfig]:
        out = []
        for key in self.store.children("tasks"):
            t = self.get(key.split("/", 1)[1])
            if t is None:
                continue
            if table and t.table != table:
                continue
            if task_type and t.task_type != task_type:
                continue
            if status and t.status != status:
                continue
            out.append(t)
        return sorted(out, key=lambda t: t.created_ms)

    def poll(self, worker_id: str) -> Optional[PinotTaskConfig]:
        """Claim the oldest WAITING task (minion work loop)."""
        for t in self.list_tasks(status=WAITING):
            claimed = {"ok": False}

            def apply(d):
                if d and d.get("status") == WAITING:
                    d = dict(d, status=IN_PROGRESS, worker=worker_id)
                    claimed["ok"] = True
                return d

            self.store.update(self._path(t.task_id), apply)
            if claimed["ok"]:
                return self.get(t.task_id)
        return None

    def report(self, task_id: str, status: str,
               output_segments: Optional[List[str]] = None,
               error: Optional[str] = None) -> None:
        def apply(d):
            if d:
                d = dict(d, status=status, error=error,
                         outputSegments=list(output_segments or []))
            return d

        self.store.update(self._path(task_id), apply)

    def prune_terminal_tasks(self, now_ms: int) -> int:
        """Drop COMPLETED/ERROR records older than the TTL (bounded state)."""
        n = 0
        for key in self.store.children("tasks"):
            t = self.get(key.split("/", 1)[1])
            if t and t.status in (COMPLETED, ERROR) and \
                    now_ms - t.created_ms > TERMINAL_TASK_TTL_MS:
                self.store.delete(self._path(t.task_id))
                n += 1
        return n

    def error_attempts(self, table: str, task_type: str,
                       configs_match: Optional[Dict[str, str]] = None,
                       input_segments: Optional[List[str]] = None) -> int:
        """How many times this unit of work has already ended in ERROR."""
        n = 0
        for t in self.list_tasks(table=table, task_type=task_type,
                                 status=ERROR):
            if configs_match and any(t.configs.get(k) != v
                                     for k, v in configs_match.items()):
                continue
            if input_segments is not None and \
                    t.input_segments != input_segments:
                continue
            n += 1
        return n

    # -- per-(table, type) watermarks ----------------------------------------
    def get_watermark_ms(self, table: str, task_type: str) -> Optional[int]:
        return self.store.get(f"minionTaskMetadata/{table}/{task_type}")

    def set_watermark_ms(self, table: str, task_type: str, wm: int) -> None:
        self.store.set(f"minionTaskMetadata/{table}/{task_type}", int(wm))

    # -- generation ------------------------------------------------------------
    def generate_tasks(self, now_ms: Optional[int] = None) -> List[str]:
        """Scan every table's taskTypeConfigsMap and emit new tasks; skips a
        (table, type) that still has WAITING/IN_PROGRESS work."""
        now_ms = now_ms or int(time.time() * 1000)
        self.prune_terminal_tasks(now_ms)
        created: List[str] = []
        for table in self.store.table_names():
            cfg = self.store.get_table_config(table)
            if cfg is None or not cfg.task_config:
                continue
            for task_type, tconf in cfg.task_config.items():
                if self.list_tasks(table=table, task_type=task_type,
                                   status=WAITING) or \
                        self.list_tasks(table=table, task_type=task_type,
                                        status=IN_PROGRESS):
                    continue
                gen = _GENERATORS.get(task_type)
                if gen is None:
                    log.warning("no generator for task type %s", task_type)
                    continue
                for task in gen(self, table, cfg, tconf, now_ms):
                    created.append(self.submit(task))
        return created


# --------------------------------------------------------------------------
# generators
# --------------------------------------------------------------------------

def _new_id(task_type: str) -> str:
    return f"Task_{task_type}_{uuid.uuid4().hex[:12]}"


def _segment_time_bounds_ms(md, time_unit_ms: int):
    if md.start_time is None or md.end_time is None:
        return None
    return md.start_time * time_unit_ms, md.end_time * time_unit_ms


def _generate_merge_rollup(mgr: PinotTaskManager, table: str, cfg,
                           tconf: Dict[str, str], now_ms: int):
    """Merge ONLINE segments bucket by bucket behind a buffer window (the
    reference's MergeRollupTaskGenerator watermark walk)."""
    if table_type_from_name(table) is not TableType.OFFLINE:
        return
    unit_ms = TIME_UNIT_MS.get(cfg.validation_config.time_type.upper(), 1)
    bucket_ms = parse_period_ms(tconf.get("bucketTimePeriod", "1d"), 86_400_000)
    buffer_ms = parse_period_ms(tconf.get("bufferTimePeriod", "0d"), 0)
    max_segs = int(tconf.get("maxNumSegmentsPerTask", "100"))

    candidates = []
    for md in mgr.store.segment_metadata_list(table):
        if md.status != ONLINE or md.segment_name.startswith("merged_"):
            continue
        bounds = _segment_time_bounds_ms(md, unit_ms)
        if bounds is None:
            continue
        candidates.append((md, bounds))
    if not candidates:
        return

    wm = mgr.get_watermark_ms(table, MERGE_ROLLUP_TASK)
    if wm is None:
        wm = (min(b[0] for _, b in candidates) // bucket_ms) * bucket_ms
    while wm + bucket_ms <= now_ms - buffer_ms:
        in_bucket = [md.segment_name for md, (s, e) in candidates
                     if s < wm + bucket_ms and e >= wm]
        if len(in_bucket) >= 2:
            # The watermark only advances once the bucket drains (inputs
            # merged away by a COMPLETED task) or is poisoned (retry cap).
            # Advancing at scheduling time would skip the bucket forever on
            # task ERROR; draining also re-queues truncated-off segments
            # while >= 2 of them remain (a lone leftover stays unmerged —
            # there is nothing to merge it with).
            attempts = mgr.error_attempts(
                table, MERGE_ROLLUP_TASK,
                configs_match={"windowStartMs": str(wm)})
            if attempts < MAX_TASK_ATTEMPTS:
                yield PinotTaskConfig(
                    task_id=_new_id(MERGE_ROLLUP_TASK),
                    task_type=MERGE_ROLLUP_TASK, table=table,
                    configs=dict(tconf, windowStartMs=str(wm),
                                 windowEndMs=str(wm + bucket_ms),
                                 bucketTimeMs=str(bucket_ms)),
                    input_segments=in_bucket[:max_segs])
                return  # one bucket per generation round
            log.error("MergeRollup bucket [%d, %d) of %s failed %d times; "
                      "skipping it", wm, wm + bucket_ms, table, attempts)
        wm += bucket_ms
        mgr.set_watermark_ms(table, MERGE_ROLLUP_TASK, wm)


def _generate_realtime_to_offline(mgr: PinotTaskManager, table: str, cfg,
                                  tconf: Dict[str, str], now_ms: int):
    """Move a completed realtime window into the OFFLINE table (the
    reference's RealtimeToOfflineSegmentsTaskGenerator)."""
    if table_type_from_name(table) is not TableType.REALTIME:
        return
    unit_ms = TIME_UNIT_MS.get(cfg.validation_config.time_type.upper(), 1)
    bucket_ms = parse_period_ms(tconf.get("bucketTimePeriod", "1d"), 86_400_000)
    buffer_ms = parse_period_ms(tconf.get("bufferTimePeriod", "0d"), 0)

    completed = []
    for md in mgr.store.segment_metadata_list(table):
        if md.status == CONSUMING:
            continue
        bounds = _segment_time_bounds_ms(md, unit_ms)
        if bounds is None:
            continue
        completed.append((md, bounds))
    if not completed:
        return

    wm = mgr.get_watermark_ms(table, REALTIME_TO_OFFLINE_TASK)
    if wm is None:
        wm = (min(b[0] for _, b in completed) // bucket_ms) * bucket_ms
    window_end = wm + bucket_ms
    if window_end > now_ms - buffer_ms:
        return
    # every completed segment overlapping the window must exist; consuming
    # segments overlapping the window block the task (data not committed yet)
    for md in mgr.store.segment_metadata_list(table):
        if md.status == CONSUMING and md.start_time is not None:
            s = md.start_time * unit_ms
            if s < window_end:
                return
    in_window = [md.segment_name for md, (s, e) in completed
                 if s < window_end and e >= wm]
    if not in_window:
        mgr.set_watermark_ms(table, REALTIME_TO_OFFLINE_TASK, window_end)
        return
    if mgr.error_attempts(table, REALTIME_TO_OFFLINE_TASK,
                          configs_match={"windowStartMs": str(wm)}) \
            >= MAX_TASK_ATTEMPTS:
        # do NOT skip the window (that would drop data from the offline
        # table); stop regenerating until the ERROR records age out
        log.error("RealtimeToOffline window [%d, %d) of %s failed %d+ "
                  "times; awaiting operator attention", wm, window_end,
                  table, MAX_TASK_ATTEMPTS)
        return
    yield PinotTaskConfig(
        task_id=_new_id(REALTIME_TO_OFFLINE_TASK),
        task_type=REALTIME_TO_OFFLINE_TASK, table=table,
        configs=dict(tconf, windowStartMs=str(wm),
                     windowEndMs=str(window_end)),
        input_segments=in_window)


def _generate_purge(mgr: PinotTaskManager, table: str, cfg,
                    tconf: Dict[str, str], now_ms: int):
    """One purge pass per un-purged segment (PurgeTaskGenerator)."""
    # one scan of the ERROR records, not one list_tasks per candidate
    attempts: Dict[str, int] = {}
    for t in mgr.list_tasks(table=table, task_type=PURGE_TASK, status=ERROR):
        for seg in t.input_segments:
            attempts[seg] = attempts.get(seg, 0) + 1
    for md in mgr.store.segment_metadata_list(table):
        if md.status != ONLINE or md.segment_name.startswith("purged_"):
            continue
        if attempts.get(md.segment_name, 0) >= MAX_TASK_ATTEMPTS:
            continue  # poisoned segment: stop regenerating every cycle
        yield PinotTaskConfig(
            task_id=_new_id(PURGE_TASK), task_type=PURGE_TASK, table=table,
            configs=dict(tconf), input_segments=[md.segment_name])
        return


def _generate_convert_to_raw(mgr: PinotTaskManager, table: str, cfg,
                             tconf: Dict[str, str], now_ms: int):
    """One conversion per not-yet-converted ONLINE segment
    (ConvertToRawIndexTaskGenerator: a segment whose custom map records
    the conversion of these columns is skipped). A segment that failed
    MAX_TASK_ATTEMPTS times is skipped, so one bad segment cannot block the
    rest for ever."""
    want = ",".join(sorted(c.strip() for c in
                           tconf.get("columnsToConvert", "").split(",")
                           if c.strip()))
    for md in mgr.store.segment_metadata_list(table):
        if md.status != ONLINE:
            continue
        done = md.custom.get("convertToRawDone")
        # reconvert when the requested column set CHANGED (the recorded
        # value is the converted set, compared — not just truthiness)
        if done is not None and done == (want or "*"):
            continue
        if mgr.error_attempts(table, CONVERT_TO_RAW_TASK,
                              input_segments=[md.segment_name]) \
                >= MAX_TASK_ATTEMPTS:
            continue
        yield PinotTaskConfig(
            task_id=_new_id(CONVERT_TO_RAW_TASK),
            task_type=CONVERT_TO_RAW_TASK, table=table,
            configs=dict(tconf), input_segments=[md.segment_name])
        return  # one at a time, like the purge generator


def ingested_files_path(table: str) -> str:
    """Where the landing files a table's SegmentGenerationAndPush tasks
    ingested are recorded, ``{file name: mtime ms}``."""
    return f"minionTaskMetadata/{table}/{SEGMENT_GENERATION_AND_PUSH_TASK}.files"


def _generate_segment_generation_and_push(mgr: PinotTaskManager, table: str,
                                          cfg, tconf: Dict[str, str],
                                          now_ms: int):
    """One task over the landing files of ``inputDirURI`` not yet ingested
    (SegmentGenerationAndPushTaskGenerator, JAX :393-432). The executor
    records a file as ingested after its push, with the mtime seen here,
    so a task that ends in ERROR is generated again, up to
    MAX_TASK_ATTEMPTS times for the same set of files (``fileSetKey``).
    A file rewritten under its name (a new mtime) is ingested again."""
    input_dir = tconf.get("inputDirURI", "")
    if not input_dir or not os.path.isdir(input_dir):
        return
    processed = mgr.store.get(ingested_files_path(table)) or {}
    fresh = []
    mtimes: Dict[str, int] = {}
    for entry in sorted(os.listdir(input_dir)):
        path = os.path.join(input_dir, entry)
        try:
            if not os.path.isfile(path):
                continue
            mtime = int(os.path.getmtime(path) * 1000)
        except FileNotFoundError:
            continue  # deleted while listed: a producer's race
        if processed.get(entry) != mtime:
            fresh.append(path)
            mtimes[entry] = mtime
    if not fresh:
        return
    key = ",".join(sorted(os.path.basename(f) for f in fresh))
    if mgr.error_attempts(table, SEGMENT_GENERATION_AND_PUSH_TASK,
                          configs_match={"fileSetKey": key}) \
            >= MAX_TASK_ATTEMPTS:
        return  # a poisoned set of files is not generated again
    yield PinotTaskConfig(
        task_id=_new_id(SEGMENT_GENERATION_AND_PUSH_TASK),
        task_type=SEGMENT_GENERATION_AND_PUSH_TASK, table=table,
        configs=dict(tconf, inputFiles=json.dumps(fresh),
                     inputFileMtimes=json.dumps(mtimes), fileSetKey=key))


_GENERATORS = {
    MERGE_ROLLUP_TASK: _generate_merge_rollup,
    REALTIME_TO_OFFLINE_TASK: _generate_realtime_to_offline,
    PURGE_TASK: _generate_purge,
    CONVERT_TO_RAW_TASK: _generate_convert_to_raw,
    SEGMENT_GENERATION_AND_PUSH_TASK: _generate_segment_generation_and_push,
}
