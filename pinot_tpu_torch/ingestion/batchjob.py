"""Batch ingestion: the job spec and the segment generation job runner.

Counterpart of ``pinot_tpu/ingestion/batchjob.py`` (JAX :34-365; the
reference's ``SegmentGenerationJobSpec`` and the standalone
``SegmentGenerationJobRunner``): the job spec in the reference's YAML
layout (``from_yaml`` imports ``yaml`` at first use; ``from_dict`` takes
the same dict), input files matched by a Java glob (``**`` crosses
directories, ``*`` and ``?`` do not, ``{a,b}``, ``[!x]``), one segment a
file, read through the record reader SPI, built by
``segment/creator.py`` ``SegmentBuilder`` into ``outputDirURI``, in
order or in a ``spawn`` pool of ``segmentCreationJobParallelism``
workers (never ``fork``: the parent may hold a CUDA context, and the
children never touch the card). ``run_ingestion_job`` is
LaunchDataIngestionJob: it runs the job and, for a job type with a push,
pushes each segment directory into a cluster by its ``file://``
location.

Where a reader gives whole columns (``read_columnar``) and the table has
no row transforms, the columns go straight to the builder, cleaned as
``SanitizationTransformer`` cleans a row; otherwise the rows go through
``CompositeTransformer`` and the nulls it recorded are put back as
nulls, so the builder writes the null bitmap. Both paths build the same
segment.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.ingestion.readers import create_record_reader
from pinot_tpu_torch.ingestion.transformers import CompositeTransformer
from pinot_tpu_torch.segment.creator import SegmentBuilder
from pinot_tpu_torch.spi.data import Schema
from pinot_tpu_torch.spi.readers import RecordReaderConfig
from pinot_tpu_torch.spi.table import TableConfig


def _strip_uri(uri: str) -> str:
    return uri[7:] if uri.startswith("file://") else uri


def _load_json_uri(uri: str) -> Dict[str, Any]:
    """Schema/table-config URIs may be files OR controller endpoints (the
    reference's shipped job specs point at http://controller/...)."""
    import json

    if uri.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(uri, timeout=30) as resp:
            return json.loads(resp.read().decode("utf-8"))
    with open(_strip_uri(uri)) as f:
        return json.load(f)


@dataclass
class SegmentGenerationJobSpec:
    """Ref: SegmentGenerationJobSpec.java + the shipped YAML layout."""

    job_type: str = "SegmentCreation"
    input_dir_uri: str = ""
    include_file_name_pattern: str = "glob:**/*"
    exclude_file_name_pattern: Optional[str] = None
    output_dir_uri: str = ""
    table_name: str = ""
    schema_uri: Optional[str] = None
    table_config_uri: Optional[str] = None
    data_format: Optional[str] = None
    reader_config: Dict[str, Any] = field(default_factory=dict)
    segment_name_prefix: Optional[str] = None
    # ref: segmentCreationJobParallelism — <=1 = sequential (the reference
    # default); >1 opts into a spawn-based process pool
    parallelism: int = 1

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SegmentGenerationJobSpec":
        table = d.get("tableSpec") or {}
        reader = d.get("recordReaderSpec") or {}
        namegen = d.get("segmentNameGeneratorSpec") or {}
        return cls(
            job_type=d.get("jobType", "SegmentCreation"),
            input_dir_uri=_strip_uri(d.get("inputDirURI", "")),
            include_file_name_pattern=d.get("includeFileNamePattern",
                                            "glob:**/*"),
            exclude_file_name_pattern=d.get("excludeFileNamePattern"),
            output_dir_uri=_strip_uri(d.get("outputDirURI", "")),
            table_name=table.get("tableName", ""),
            schema_uri=table.get("schemaURI"),
            table_config_uri=table.get("tableConfigURI"),
            data_format=(reader.get("dataFormat") or "").lower() or None,
            reader_config=reader.get("configs") or {},
            segment_name_prefix=(namegen.get("configs") or {}).get(
                "segment.name.prefix"),
            parallelism=int(d.get("segmentCreationJobParallelism", 1) or 1),
        )

    @classmethod
    def from_yaml(cls, path: str) -> "SegmentGenerationJobSpec":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def resolve_relative(self, base_dir: str) -> None:
        """The reference resolves spec URIs against the working dir; resolve
        against the job file's directory for hermetic specs."""
        for attr in ("input_dir_uri", "output_dir_uri"):
            v = getattr(self, attr)
            if v and not os.path.isabs(v):
                setattr(self, attr, os.path.join(base_dir, v))
        for attr in ("schema_uri", "table_config_uri"):
            v = getattr(self, attr)
            if v and not v.startswith(("http://", "https://")):
                v = _strip_uri(v)
                if not os.path.isabs(v):
                    setattr(self, attr, os.path.join(base_dir, v))


def _glob_regex(pattern: str):
    """Java-glob semantics ('glob:' prefix, ref: FileSystems.getPathMatcher
    as used by SegmentGenerationUtils): '**' crosses directory separators,
    '*' and '?' do NOT — unlike fnmatch, whose '*' spans '/'."""
    import re

    pat = pattern[5:] if pattern.startswith("glob:") else pattern
    return re.compile(_glob_translate(pat) + r"\Z")


def _glob_translate(pat: str) -> str:
    import re

    out = []
    i = 0
    while i < len(pat):
        c = pat[i]
        if c == "*":
            if pat[i:i + 3] == "**/":
                out.append(r"(?:[^/]+/)*")
                i += 3
                continue
            if pat[i:i + 2] == "**":
                out.append(r".*")
                i += 2
                continue
            out.append(r"[^/]*")
        elif c == "?":
            out.append(r"[^/]")
        elif c == "{":
            # '{a,b}' alternation (non-nested, like java's glob); the
            # alternatives are themselves glob sub-patterns ('{*.csv,*.json}')
            end = pat.find("}", i)
            if end < 0:
                raise ValueError(f"unterminated '{{' in glob {pat!r}")
            alts = pat[i + 1:end].split(",")
            out.append("(?:" + "|".join(_glob_translate(a) for a in alts)
                       + ")")
            i = end + 1
            continue
        elif c == "[":
            end = pat.find("]", i + 1)
            if end < 0:
                raise ValueError(f"unterminated '[' in glob {pat!r}")
            out.append(pat[i:end + 1].replace("[!", "[^"))
            i = end + 1
            continue
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


def _match_glob(root: str, pattern: str,
                exclude: Optional[str] = None) -> List[str]:
    """'glob:**/*.csv'-style matching over files under root (ref:
    SegmentGenerationUtils.listMatchedFilesWithRecursiveOption)."""
    inc = _glob_regex(pattern)
    exc = _glob_regex(exclude) if exclude else None
    out = []
    for dirpath, _, files in os.walk(root):
        for fname in files:
            full = os.path.join(dirpath, fname)
            rel = os.path.relpath(full, root)
            if not inc.match(rel):
                continue
            if exc and exc.match(rel):
                continue
            out.append(full)
    return sorted(out)


def _all_str(vals) -> bool:
    return isinstance(vals, list) and set(map(type, vals)) <= {str}


def _build_one_process(spec, schema, table_config, input_file: str,
                       segment_name: str) -> None:
    """Process-pool entry: rebuild the runner in the worker (spawn-started,
    so nothing is inherited; specs/schemas are small plain dataclasses that
    pickle across the spawn boundary). A worker that initialised CUDA
    raises: a build is host work, and the card belongs to the parent."""
    SegmentGenerationJobRunner(spec, schema, table_config)._build_one(
        input_file, segment_name)
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError(f"building {segment_name} initialised CUDA in a "
                           "job worker")


class SegmentGenerationJobRunner:
    """Ref: standalone SegmentGenerationJobRunner.java — one segment per
    matched input file, sequence-numbered names."""

    def __init__(self, spec: SegmentGenerationJobSpec,
                 schema: Optional[Schema] = None,
                 table_config: Optional[TableConfig] = None):
        self.spec = spec
        if schema is None:
            if not spec.schema_uri:
                raise ValueError(
                    "job spec has no tableSpec.schemaURI and no schema was "
                    "passed in")
            schema = Schema.from_dict(_load_json_uri(spec.schema_uri))
        self.schema = schema
        self.table_config = table_config
        if table_config is None and spec.table_config_uri:
            self.table_config = TableConfig.from_dict(
                _load_json_uri(spec.table_config_uri))

    def run(self) -> List[str]:
        """Build all glob-matched segments; returns the segment dirs."""
        spec = self.spec
        files = _match_glob(spec.input_dir_uri,
                            spec.include_file_name_pattern,
                            spec.exclude_file_name_pattern)
        if not files:
            raise FileNotFoundError(
                f"no input files match {spec.include_file_name_pattern!r} "
                f"under {spec.input_dir_uri!r}")
        return self.run_files(files)

    def run_files(self, files: List[str]) -> List[str]:
        """Build segments from an EXPLICIT file list (no glob round-trip —
        callers with exact paths, like the minion task, must not lose
        files to glob metacharacters in their names)."""
        spec = self.spec
        os.makedirs(spec.output_dir_uri, exist_ok=True)
        table = (spec.table_name
                 or (self.table_config.table_name if self.table_config
                     else self.schema.schema_name))
        prefix = spec.segment_name_prefix or f"{table}_batch"
        jobs = [(path, f"{prefix}_{seq}") for seq, path in enumerate(files)]
        workers = min(max(spec.parallelism, 1), len(jobs))
        if workers > 1:
            # per-file builds are independent (ref: the runner submits one
            # SegmentGenerationTaskRunner per file to an ExecutorService,
            # segmentCreationJobParallelism wide). SPAWN, not fork: a
            # caller may hold a CUDA context and threads that a forked
            # child would inherit mid-flight
            import multiprocessing as mp

            args = [(self.spec, self.schema, self.table_config, p, n)
                    for p, n in jobs]
            with mp.get_context("spawn").Pool(workers) as pool:
                pool.starmap(_build_one_process, args)
        else:
            for path, name in jobs:
                self._build_one(path, name)
        return [os.path.join(spec.output_dir_uri, name) for _, name in jobs]

    def _build_one(self, input_file: str, segment_name: str) -> None:
        spec = self.spec
        cfg = RecordReaderConfig(spec.reader_config)
        # only schema-declared MV columns split on the CSV MV delimiter
        cfg.setdefault("multiValueColumns",
                       [fs.name for fs in self.schema.field_specs
                        if not fs.single_value])
        reader = create_record_reader(
            input_file, spec.data_format,
            fields_to_read=self.schema.column_names, config=cfg)
        transformer = CompositeTransformer.for_table(self.table_config,
                                                     self.schema)
        columns = None
        if self._no_row_transforms():
            columns = reader.read_columnar()
            if columns is not None:
                self._sanitize_columnar(columns)
        if columns is None:
            from pinot_tpu_torch.ingestion.transformers import (
                NullValueTransformer,
            )

            rows = [t for t in (transformer.transform(dict(r))
                                for r in reader) if t is not None]
            # restore None for recorded nulls: the builder owns default
            # substitution AND the null bitmap, so defaults substituted by
            # NullValueTransformer must not masquerade as real values
            for row in rows:
                for col in row.pop(NullValueTransformer.NULL_FIELDS_KEY, ()):
                    row[col] = None
            columns = rows  # builder consumes row iterables directly
        reader.close()
        builder = SegmentBuilder(
            self.schema, segment_name,
            table_config=self.table_config)
        builder.build(columns, spec.output_dir_uri)

    def _sanitize_columnar(self, columns: Dict[str, Any]) -> None:
        """SanitizationTransformer semantics on the columnar path (NUL
        stripping + maxLength truncation) so both ingest paths build the
        same segment. Cells are only rewritten when they offend — the
        common all-clean case stays a read-only scan."""
        for fs in self.schema.field_specs:
            if fs.data_type.is_numeric or fs.name not in columns:
                continue
            max_len = fs.max_length
            vals = columns[fs.name]

            def clean(v):
                if isinstance(v, str):
                    if "\x00" in v:
                        v = v.replace("\x00", "")
                    return v[:max_len] if len(v) > max_len else v
                if isinstance(v, list):
                    return [clean(x) for x in v]
                return v

            import numpy as np

            def offends(v) -> bool:
                if isinstance(v, str):
                    return "\x00" in v or len(v) > max_len
                if isinstance(v, list):
                    return any(offends(x) for x in v)
                return False

            if isinstance(vals, np.ndarray) and vals.dtype.kind == "U":
                dirty = ((np.char.str_len(vals) > max_len)
                         | (np.char.find(vals, "\x00") >= 0))
                if dirty.any():
                    fixed = vals.astype(object)
                    for i in np.nonzero(dirty)[0]:
                        fixed[i] = clean(str(vals[i]))
                    columns[fs.name] = fixed.astype(str)
            elif _all_str(vals):
                # a reader's strings: two scans in C find whether any
                # offends, and only then are the cells cleaned one by one
                if max(map(len, vals), default=0) > max_len \
                        or "\x00" in "".join(vals):
                    columns[fs.name] = [clean(v) for v in vals]
            elif any(offends(v) for v in vals):
                # scan-first: the all-clean common case stays read-only
                columns[fs.name] = [clean(v) for v in vals]

    def _no_row_transforms(self) -> bool:
        """Columnar fast path is sound only without row-level transforms
        (the builder does its own type coercion + null substitution)."""
        if any(fs.transform_function for fs in self.schema.field_specs):
            return False
        ic = (self.table_config.ingestion_config
              if self.table_config else None)
        return not (ic and (ic.transform_configs or ic.filter_function))


def run_ingestion_job(job_spec_file: str, cluster=None,
                      schema: Optional[Schema] = None,
                      table_config: Optional[TableConfig] = None) -> List[str]:
    """LaunchDataIngestionJob equivalent (ref: IngestionJobLauncher.java):
    run the generation job; when ``cluster`` (EmbeddedCluster) is given and
    the jobType includes a push, upload each built segment."""
    spec = SegmentGenerationJobSpec.from_yaml(job_spec_file)
    spec.resolve_relative(os.path.dirname(os.path.abspath(job_spec_file)))
    runner = SegmentGenerationJobRunner(spec, schema=schema,
                                        table_config=table_config)
    seg_dirs = runner.run()
    if cluster is not None and "Push" in spec.job_type:
        if runner.table_config is not None:
            table = runner.table_config.table_name_with_type
        else:
            # same fallback chain run() uses for segment names
            raw = spec.table_name or runner.schema.schema_name
            table = f"{raw}_OFFLINE"
        for seg_dir in seg_dirs:
            cluster.upload_segment_dir(table, seg_dir)
    return seg_dirs
