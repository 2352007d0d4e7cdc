"""Minion task executors: MergeRollup, RealtimeToOffline, Purge,
ConvertToRaw and SegmentGenerationAndPush.

Counterpart of ``pinot_tpu/minion/tasks.py`` (the reference's builtin
minion tasks) over the segment processing framework
(``segment/processing.py``). Each executor reads its input segments
through their deep-store URLs (a ``file://`` directory is read in place),
runs the framework into the minion's work directory, pushes the outputs
as ``file://`` directories and applies the replacement:

- MergeRollup: the outputs are pushed behind a lineage entry
  (``start_replace_segments``; they stay hidden while they upload), the
  entry turns COMPLETED (the inputs hidden, the outputs served, in one
  step for every query), then the inputs are deleted; a failed push
  reverts the entry;
- RealtimeToOffline: the window's rows go to the companion OFFLINE table,
  and the window's watermark advances only once they are pushed;
- Purge: the rows the table's purger matches are dropped, the rewritten
  segment pushed and the input deleted;
- ConvertToRaw: the segment is built again with the configured columns
  raw and pushed under the SAME name (a refresh: the servers swap it in),
  and its metadata's custom map records ``convertToRawDone``;
- SegmentGenerationAndPush: the batch job (``ingestion/batchjob.py``)
  builds a segment from each landing file, the segments are pushed, then
  the files are recorded as ingested.

The input segments are fetched into ``<work_dir>/downloads`` (a local
``file://`` one is read in place), as the JAX minion does.
"""

from __future__ import annotations

import json
import logging
import os

from dataclasses import dataclass, replace
from typing import Callable, Dict, List

import numpy as np

from pinot_tpu_torch.controller.tasks import (
    CONVERT_TO_RAW_TASK,
    MERGE_ROLLUP_TASK,
    PURGE_TASK,
    REALTIME_TO_OFFLINE_TASK,
    SEGMENT_GENERATION_AND_PUSH_TASK,
    PinotTaskConfig,
    ingested_files_path,
)
from pinot_tpu_torch.segment.creator import SegmentBuilder
from pinot_tpu_torch.segment.immutable import ImmutableSegment, load_segment
from pinot_tpu_torch.segment.processing import (
    MergeType,
    SegmentProcessorConfig,
    SegmentProcessorFramework,
    read_columnar,
)
from pinot_tpu_torch.spi.filesystem import fetch_segment, file_url
from pinot_tpu_torch.spi.table import (
    TableType,
    raw_table_name,
    table_name_with_type,
)

log = logging.getLogger(__name__)


@dataclass
class MinionContext:
    """What an executor needs of the cluster."""

    controller: object          # controller.Controller
    work_dir: str

    @property
    def store(self):
        return self.controller.store

    @property
    def task_manager(self):
        return self.controller.task_manager


class BaseTaskExecutor:
    task_type = "base"

    def execute(self, task: PinotTaskConfig, ctx: MinionContext) -> List[str]:
        """-> the output segments' names; raising marks the task ERROR."""
        raise NotImplementedError

    # -- shared helpers ------------------------------------------------------
    def _download(self, task: PinotTaskConfig,
                  ctx: MinionContext) -> List[ImmutableSegment]:
        """The input segments, read through their download URLs (a
        ``file://`` directory in place, no copy; a remote one copied under
        the work directory)."""
        segs = []
        for name in task.input_segments:
            md = ctx.store.get_segment_metadata(task.table, name)
            if md is None or not md.download_url:
                raise FileNotFoundError(
                    f"segment {name} of {task.table} has no download url")
            segs.append(load_segment(fetch_segment(
                md.download_url, os.path.join(ctx.work_dir, "downloads"))))
        return segs

    def _schema_and_config(self, ctx: MinionContext, table: str):
        cfg = ctx.store.get_table_config(table)
        schema = ctx.store.get_schema(raw_table_name(table))
        if cfg is None or schema is None:
            raise KeyError(f"missing table config/schema for {table}")
        return schema, cfg

    def _upload(self, ctx: MinionContext, table: str,
                seg_dirs: List[str]) -> List[str]:
        names = []
        for d in seg_dirs:
            seg = load_segment(d)
            ctx.controller.add_segment(table, seg.metadata, file_url(d))
            names.append(seg.segment_name)
        return names


def _merge_settings(task: PinotTaskConfig):
    merge_type = MergeType[task.configs.get("mergeType", "CONCAT").upper()]
    agg_types = {k[len("aggregationType."):]: v
                 for k, v in task.configs.items()
                 if k.startswith("aggregationType.")}
    max_docs = int(task.configs.get("maxNumRecordsPerSegment", "5000000"))
    return merge_type, agg_types, max_docs


class MergeRollupTaskExecutor(BaseTaskExecutor):
    """Merge (and optionally roll up) a time bucket of offline segments,
    then replace the inputs behind lineage."""

    task_type = MERGE_ROLLUP_TASK

    def execute(self, task: PinotTaskConfig, ctx: MinionContext) -> List[str]:
        schema, cfg = self._schema_and_config(ctx, task.table)
        segments = self._download(task, ctx)
        merge_type, agg_types, max_docs = _merge_settings(task)
        # rows partition by time bucket rather than clamp to the window:
        # an input may straddle the bucket's edge, and its rows past the
        # edge land in their own bucket's output
        ws = int(task.configs["windowStartMs"])
        we = int(task.configs["windowEndMs"])
        bucket_ms = int(task.configs.get("bucketTimeMs", we - ws))
        proc = SegmentProcessorFramework(segments, SegmentProcessorConfig(
            schema=schema, table_config=cfg, merge_type=merge_type,
            aggregation_types=agg_types, bucket_time_ms=bucket_ms,
            # the task id in the name keeps a retry from overwriting an
            # earlier attempt's outputs
            segment_name_prefix=f"merged_{raw_table_name(task.table)}"
                                f"_{task.configs['windowStartMs']}"
                                f"_{task.task_id[-8:]}",
            max_docs_per_segment=max_docs))
        out_dirs = proc.process(os.path.join(ctx.work_dir, task.task_id))
        out_names = [os.path.basename(d) for d in out_dirs]
        entry_id = ctx.controller.start_replace_segments(
            task.table, list(task.input_segments), out_names)
        try:
            names = self._upload(ctx, task.table, out_dirs)
        except Exception:
            ctx.controller.revert_replace_segments(task.table, entry_id)
            raise
        # waits until the outputs are served; reverts itself on a timeout
        ctx.controller.end_replace_segments(task.table, entry_id)
        # hidden by lineage now; deleting them frees their servers
        for name in task.input_segments:
            ctx.controller.delete_segment(task.table, name)
        return names


class RealtimeToOfflineSegmentsTaskExecutor(BaseTaskExecutor):
    """Build offline segments of a committed realtime window, push them to
    the companion OFFLINE table, then advance the window's watermark."""

    task_type = REALTIME_TO_OFFLINE_TASK

    def execute(self, task: PinotTaskConfig, ctx: MinionContext) -> List[str]:
        raw = raw_table_name(task.table)
        offline_table = table_name_with_type(raw, TableType.OFFLINE)
        offline_cfg = ctx.store.get_table_config(offline_table)
        if offline_cfg is None:
            raise KeyError(f"RT->offline needs companion table {offline_table}")
        schema, _cfg = self._schema_and_config(ctx, task.table)
        segments = self._download(task, ctx)
        ws = int(task.configs["windowStartMs"])
        we = int(task.configs["windowEndMs"])
        merge_type, agg_types, max_docs = _merge_settings(task)
        proc = SegmentProcessorFramework(segments, SegmentProcessorConfig(
            schema=schema, table_config=offline_cfg, merge_type=merge_type,
            aggregation_types=agg_types,
            window_start_ms=ws, window_end_ms=we,
            segment_name_prefix=f"rt2off_{raw}_{ws}",
            max_docs_per_segment=max_docs))
        out_dirs = proc.process(os.path.join(ctx.work_dir, task.task_id))
        names = self._upload(ctx, offline_table, out_dirs)
        ctx.task_manager.set_watermark_ms(task.table,
                                          REALTIME_TO_OFFLINE_TASK, we)
        return names


class PurgeTaskExecutor(BaseTaskExecutor):
    """Rewrite a segment without the rows its table's purger matches."""

    task_type = PURGE_TASK

    #: raw table name -> purger: the columns of a segment (as
    #: ``read_columnar`` gives them) -> bool mask of the rows to purge. The
    #: port's own registry (the reference's RecordPurgerFactory); the JAX
    #: package's purgers take one row dict at a time.
    PURGERS: Dict[str, Callable[[Dict[str, object]], np.ndarray]] = {}

    def execute(self, task: PinotTaskConfig, ctx: MinionContext) -> List[str]:
        schema, cfg = self._schema_and_config(ctx, task.table)
        purger = self.PURGERS.get(raw_table_name(task.table))
        if purger is None:
            raise KeyError(f"no record purger registered for {task.table}")
        segments = self._download(task, ctx)
        (in_name,) = task.input_segments
        proc = SegmentProcessorFramework(segments, SegmentProcessorConfig(
            schema=schema, table_config=cfg, merge_type=MergeType.CONCAT,
            record_filter=purger, segment_name_prefix=f"purged_{in_name}"))
        out_dirs = proc.process(os.path.join(ctx.work_dir, task.task_id))
        names = self._upload(ctx, task.table, out_dirs)
        ctx.controller.delete_segment(task.table, in_name)
        return names


class ConvertToRawIndexTaskExecutor(BaseTaskExecutor):
    """Build a segment again with the configured columns raw
    (no dictionary) and push it under the same name."""

    task_type = CONVERT_TO_RAW_TASK

    def execute(self, task: PinotTaskConfig, ctx: MinionContext) -> List[str]:
        schema, cfg = self._schema_and_config(ctx, task.table)
        cols_to_convert = [c.strip() for c in
                           task.configs.get("columnsToConvert", "").split(",")
                           if c.strip()]
        (in_name,) = task.input_segments
        (segment,) = self._download(task, ctx)
        cols = read_columnar(segment)
        indexing = replace(
            cfg.indexing_config,
            no_dictionary_columns=sorted(
                set(cfg.indexing_config.no_dictionary_columns)
                | set(cols_to_convert)))
        out_dir = os.path.join(ctx.work_dir, task.task_id)
        SegmentBuilder(schema, in_name, table_name=cfg.table_name,
                       indexing=indexing).build(cols.frame(), out_dir)
        names = self._upload(ctx, task.table,
                             [os.path.join(out_dir, in_name)])
        # the converted column set, sorted, so the generator's comparison
        # ignores the config's order
        md = ctx.store.get_segment_metadata(task.table, in_name)
        if md is not None:
            md.custom["convertToRawDone"] = \
                ",".join(sorted(cols_to_convert)) or "*"
            ctx.store.set_segment_metadata(md)
        return names


class SegmentGenerationAndPushTaskExecutor(BaseTaskExecutor):
    """Run the batch segment generation job over the task's landing files
    in the minion, push the segments, then record the files as ingested
    with the mtimes the generator saw (JAX :263-305): a re-stat here
    would bind a later rewrite's mtime to the content that was read."""

    task_type = SEGMENT_GENERATION_AND_PUSH_TASK

    def execute(self, task: PinotTaskConfig, ctx: MinionContext) -> List[str]:
        from pinot_tpu_torch.ingestion.batchjob import (
            SegmentGenerationJobRunner,
            SegmentGenerationJobSpec,
        )

        schema, cfg = self._schema_and_config(ctx, task.table)
        files = json.loads(task.configs.get("inputFiles", "[]"))
        if not files:
            raise ValueError("SegmentGenerationAndPushTask without "
                             "inputFiles")
        spec = SegmentGenerationJobSpec(
            output_dir_uri=os.path.join(ctx.work_dir, task.task_id),
            table_name=cfg.table_name,
            data_format=task.configs.get("inputFormat") or None,
            segment_name_prefix=f"{cfg.table_name}_{task.task_id}")
        seg_dirs = SegmentGenerationJobRunner(
            spec, schema=schema, table_config=cfg).run_files(files)
        names = self._upload(ctx, task.table, seg_dirs)
        recorded = json.loads(task.configs.get("inputFileMtimes", "{}"))

        def apply(d):
            d = dict(d or {})
            d.update(recorded)
            return d

        ctx.store.update(ingested_files_path(task.table), apply)
        return names


TASK_EXECUTORS: Dict[str, BaseTaskExecutor] = {
    e.task_type: e for e in (MergeRollupTaskExecutor(),
                             RealtimeToOfflineSegmentsTaskExecutor(),
                             PurgeTaskExecutor(),
                             ConvertToRawIndexTaskExecutor(),
                             SegmentGenerationAndPushTaskExecutor())
}
