"""Segment builder from a column frame, and the segment writer.

Counterpart of ``pinot_tpu/segment/creator.py`` (``SegmentBuilder``,
``_normalize`` and ``_build_column`` at :297-540): dictionary-encoded
columns, raw columns (``no_dictionary_columns`` or a RAW field config,
single-value numeric only, as the JAX builder allows), multi-value
columns, null handling and the indexes an ``IndexingConfig`` names, all
built in memory by ``segment_from_arrays``. ``build(frame, out_dir)``
also writes the segment to ``out_dir/<name>``.

``write_segment(segment, out_dir)`` serialises an in-memory segment into
the JAX package's directory layout (JAX :8-27), file for file:
``metadata.json``; under ``columns/`` per column ``<col>.dict.npy`` (or
``.dictoff.npy`` / ``.dictblob.npy``), ``.fwdpk.bin`` (fixed-bit packed
single-value dictIds over the padded capacity, ``storedDtype``
``packed:<bits>``), ``.fwd.npy`` (raw values, or a multi-value column's
flat dictIds with ``.mvoff.npy``), ``.fwdcc.bin`` (a raw column under a
chunk codec), ``.null.npy``, the inverted index (``.invoff.npy``,
``.invbo.npy``, ``.inv.bin``: delta+varint postings) and the bloom,
range, text, JSON and FST files; then ``startree<i>/`` per star-tree. The
CRC-32 of ``columns/`` in sorted file order (``compute_dir_crc``, JAX :70)
goes into the metadata. The segment is written into a temporary directory
renamed into place, so a reader never finds half a segment.

A frame maps each column to its rows: a numpy array or a list for a
single-value column (``None``, and NaN in a float column, is null); for a
multi-value column a list of lists (``None`` or an empty list is null), or
``(values [n, k], counts [n])``, the dense form a generator draws in one
call. A null row stores the field's default null value (a null MV row the
one-value list of it), and the column's null bitmap marks it.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import (
    Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union,
)

import numpy as np

from pinot_tpu_torch import native
from pinot_tpu_torch.segment.convert import ColumnArrays, segment_from_arrays
from pinot_tpu_torch.segment.dictionary import encode_strings
from pinot_tpu_torch.segment.geoindex import DEFAULT_RESOLUTION
from pinot_tpu_torch.segment.immutable import (
    COLUMNS_DIR,
    DataSource,
    ImmutableSegment,
)
from pinot_tpu_torch.segment.metadata import (
    METADATA_FILE,
    ColumnMetadata,
    SegmentMetadata,
    column_range,
    narrowest_int_dtype,
    now_ms,
)
from pinot_tpu_torch.spi.data import FieldSpec, Schema
from pinot_tpu_torch.spi.table import IndexingConfig, TableConfig
from pinot_tpu_torch.utils.partition import get_partition_function


def write_file(path: str, data: Union[np.ndarray, bytes]) -> None:
    """An array as ``.npy`` (``np.save``'s bytes) or raw bytes, written
    under a temporary name in the same directory and renamed into place."""
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.{os.getpid()}."
                       f"{threading.get_ident()}.tmp")
    with open(tmp, "wb") as f:
        if isinstance(data, np.ndarray):
            np.save(f, data, allow_pickle=False)
        else:
            f.write(data)
    os.replace(tmp, path)


def compute_dir_crc(col_dir: str) -> int:
    """CRC-32 over every file of ``col_dir`` in sorted file-name order
    (JAX :70; the reference's creation.meta CRC)."""
    crc = 0
    for fname in sorted(os.listdir(col_dir)):
        crc = native.crc32_file(os.path.join(col_dir, fname), crc)
    return crc & 0xFFFFFFFF


def postings_files(prefix: str, offsets: np.ndarray, docs: np.ndarray
                   ) -> Dict[str, Any]:
    """An inverted index's three files (JAX ``build_inverted_index``,
    :82-110): doc-count offsets, byte offsets and the delta+varint
    postings."""
    blob, byte_offsets = native.varint_encode_lists(docs, offsets)
    return {f"{prefix}off": np.asarray(offsets, dtype=np.int64),
            f"{prefix}bo": byte_offsets, prefix: blob}


def column_files(ds: DataSource, num_docs: int, capacity: int,
                 codec: Optional[str] = None
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """One in-memory column's files, suffix -> array (``.npy``) or bytes
    (``.bin``), and what its metadata records of them (``storedDtype``,
    ``totalNumberOfEntries``, ``compressionCodec``)."""
    cm = ds.metadata
    files: Dict[str, Any] = {}
    extra: Dict[str, Any] = {"total_number_of_entries": 0}
    if cm.has_nulls:
        files["null"] = np.asarray(ds.null_bitmap, dtype=bool)
    fwd = np.asarray(ds.forward_index)
    if not cm.has_dictionary:
        arr = np.ascontiguousarray(fwd, dtype=cm.data_type.stored_np)
        extra["stored_dtype"] = str(arr.dtype)
        if codec:
            from pinot_tpu_torch.segment.compression import write_compressed

            fd, tmp = tempfile.mkstemp(suffix=".fwdcc")
            os.close(fd)
            try:
                extra["compression_codec"] = write_compressed(tmp, arr, codec)
                with open(tmp, "rb") as f:
                    files["fwdcc"] = f.read()
            finally:
                os.unlink(tmp)
        else:
            files["fwd"] = arr
        if ds.range_order is not None:
            files["rangeord"] = np.asarray(ds.range_order, dtype=np.int32)
    else:
        d = ds.dictionary
        card = d.cardinality
        if cm.data_type.is_numeric:
            files["dict"] = np.asarray(d.values, dtype=cm.data_type.stored_np)
        else:
            files["dictoff"], files["dictblob"] = encode_strings(
                d.values.tolist())
        if cm.single_value:
            bits = native.bits_needed(max(card, 1))
            files["fwdpk"] = native.bitpack(fwd.astype(np.int32), bits)
            extra["stored_dtype"] = f"packed:{bits}"
            extra["total_number_of_entries"] = num_docs
        else:
            counts = np.asarray(ds.mv_counts[:num_docs], dtype=np.int64)
            offsets = np.zeros(num_docs + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            valid = np.arange(fwd.shape[1])[None, :] < counts[:, None]
            dtype = narrowest_int_dtype(card)
            files["mvoff"] = offsets
            files["fwd"] = fwd[:num_docs][valid].astype(dtype)
            extra["stored_dtype"] = dtype
            extra["total_number_of_entries"] = int(offsets[-1])
        if ds.inverted_index is not None:
            files.update(postings_files("inv", *ds.inverted_index))
    if ds.bloom_filter is not None:
        files["bloom"] = ds.bloom_filter.to_array()
    if ds.json_index is not None:
        files.update(ds.json_index.files())
    if ds.text_index is not None:
        files.update(ds.text_index.files())
    if ds.fst_index is not None:
        from pinot_tpu_torch.segment.fstindex import FST_FILES

        fst = ds.fst_index
        files.update(zip(FST_FILES, (fst.edge_offsets, fst.edge_labels,
                                     fst.edge_targets, fst.node_ranges)))
    if getattr(ds, "geo_index", None) is not None:
        files.update(ds.geo_index.files())
    return files, extra


def write_segment(segment: ImmutableSegment, out_dir: str,
                  codecs: Optional[Mapping[str, str]] = None
                  ) -> SegmentMetadata:
    """Write ``segment`` to ``out_dir/<segment name>`` in the JAX
    package's layout (a directory already there is replaced whole);
    ``codecs`` maps a raw column to its chunk codec (default: the codec
    its metadata records, so a loaded segment writes back as it was
    read). -> the metadata
    written (``crc``, ``stored_dtype`` and the time range filled in)."""
    src = segment.metadata
    name = src.segment_name
    os.makedirs(out_dir, exist_ok=True)
    seg_dir = os.path.join(out_dir, name)
    tmp_dir = tempfile.mkdtemp(prefix=f".{name}.", dir=out_dir)
    try:
        col_dir = os.path.join(tmp_dir, COLUMNS_DIR)
        os.makedirs(col_dir)
        columns: Dict[str, ColumnMetadata] = {}
        for col, cm in src.columns.items():
            files, extra = column_files(segment.data_source(col),
                                        src.num_docs, src.padded_capacity,
                                        (codecs or {}).get(
                                            col, cm.compression_codec))
            for suffix, data in files.items():
                ext = "npy" if isinstance(data, np.ndarray) else "bin"
                write_file(os.path.join(col_dir, f"{col}.{suffix}.{ext}"),
                           data)
            columns[col] = ColumnMetadata(**{**cm.__dict__, **extra})
        md = SegmentMetadata(
            segment_name=name, table_name=src.table_name, schema=src.schema,
            num_docs=src.num_docs, padded_capacity=src.padded_capacity,
            columns=columns, star_tree_count=len(segment.star_trees),
            star_tree_build_s=list(src.star_tree_build_s),
            custom=dict(src.custom), creation_time_ms=now_ms(),
            time_column=src.schema.time_column,
            crc=compute_dir_crc(col_dir))
        md.min_time, md.max_time = column_range(md, md.time_column)
        for i, tree in enumerate(segment.star_trees):
            tree.save(tmp_dir, index=i)
        md.save(os.path.join(tmp_dir, METADATA_FILE))
        if os.path.exists(seg_dir):
            # the old directory goes aside first: a replica that mapped
            # its files keeps reading them
            old = tempfile.mkdtemp(prefix=f".{name}.old.", dir=out_dir)
            os.replace(seg_dir, os.path.join(old, name))
            shutil.rmtree(old, ignore_errors=True)
        os.replace(tmp_dir, seg_dir)
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise
    return md


def _is_null(v: Any) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _sv_values(fs: FieldSpec, rows: Sequence[Any]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (values in the stored type, null mask)."""
    dt = fs.data_type
    if isinstance(rows, np.ndarray) and dt.is_numeric \
            and rows.dtype.kind in "iuf":
        nulls = (np.isnan(rows) if rows.dtype.kind == "f"
                 else np.zeros(rows.shape[0], dtype=bool))
        vals = rows.copy() if nulls.any() else rows
        vals[nulls] = fs.default_null_value
        return vals.astype(dt.stored_np), nulls
    if isinstance(rows, np.ndarray) and rows.dtype.kind == "U" \
            and not dt.is_numeric:
        return rows, np.zeros(rows.shape[0], dtype=bool)
    types = set(map(type, rows))
    if not any(t is type(None) or issubclass(t, float) for t in types):
        # no cell can be a null (a reader's strings, say): the values
        # JAX's convert gives, without a test a cell (strings as they are)
        vals = rows if types <= {str} and not dt.is_numeric \
            else list(map(dt.converter, rows))
        return (np.asarray(vals, dtype=dt.stored_np if dt.is_numeric
                           else np.str_),
                np.zeros(len(rows), dtype=bool))
    nulls = np.fromiter((_is_null(v) for v in rows), dtype=bool,
                        count=len(rows))
    vals = [fs.default_null_value if n else dt.convert(v)
            for v, n in zip(rows, nulls)]
    return np.asarray(vals, dtype=dt.stored_np if dt.is_numeric
                      else np.str_), nulls


def _mv_values(fs: FieldSpec, rows: Any
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (dense values [n, k], counts [n], null mask)."""
    dt = fs.data_type
    np_dt = dt.stored_np if dt.is_numeric else np.str_
    if isinstance(rows, tuple):
        dense, counts = np.asarray(rows[0]), np.asarray(rows[1], np.int32)
        nulls = counts == 0
        if nulls.any():
            dense = dense.astype(np_dt)
            dense[nulls, 0] = fs.default_null_value
            counts = np.where(nulls, 1, counts).astype(np.int32)
        return dense.astype(np_dt), counts, nulls
    lists, nulls = [], np.zeros(len(rows), dtype=bool)
    for i, v in enumerate(rows):
        vals = ([] if v is None or (isinstance(v, float) and v != v)
                else [dt.convert(x) for x in
                      (v if isinstance(v, (list, tuple, np.ndarray)) else [v])
                      if not _is_null(x)])
        if not vals:
            nulls[i] = True
            vals = [fs.default_null_value]
        lists.append(vals)
    counts = np.asarray([len(v) for v in lists], dtype=np.int32)
    dense = np.zeros((len(lists), max(int(counts.max(initial=0)), 1)),
                     dtype=np_dt if dt.is_numeric else object)
    for i, v in enumerate(lists):
        dense[i, :len(v)] = v
    return dense.astype(np_dt), counts, nulls


class SegmentBuilder:
    """``table_config`` supplies the indexing config and the field
    configs: a RAW field config makes a single-value numeric column raw,
    and its ``compression_codec`` chunk-compresses that column's forward
    index on disk; an H3 field config on a single-value string column
    builds its geo index at the first of its ``resolutions`` (default
    ``DEFAULT_RESOLUTION``, 9)."""

    def __init__(self, schema: Schema, segment_name: str,
                 table_name: Optional[str] = None,
                 no_dictionary_columns: Sequence[str] = (),
                 indexing: Optional[IndexingConfig] = None,
                 table_config: Optional[TableConfig] = None):
        self.schema = schema
        self.segment_name = segment_name
        self.codecs: Dict[str, str] = {}
        self.geo_columns: Dict[str, int] = {}
        raw = set(no_dictionary_columns)
        if table_config is not None:
            table_name = table_name or table_config.table_name
            indexing = indexing or table_config.indexing_config
            for fc in table_config.field_config_list:
                if fc.encoding_type.upper() == "RAW":
                    raw.add(fc.name)
                    if fc.compression_codec:
                        self.codecs[fc.name] = fc.compression_codec
                if (fc.index_type or "").upper() == "H3":
                    self.geo_columns[fc.name] = int(str(fc.properties.get(
                        "resolutions", DEFAULT_RESOLUTION)).split(",")[0])
        self.table_name = table_name or schema.schema_name
        self.indexing = indexing
        self.no_dictionary_columns = raw | set(
            indexing.no_dictionary_columns if indexing else ())

    def build(self, frame: Union[Mapping[str, Any], Iterable[Mapping]],
              out_dir: Optional[str] = None
              ) -> Union[ImmutableSegment, SegmentMetadata]:
        """One segment, in memory; with ``out_dir`` also written to
        ``out_dir/<name>`` (``write_segment``), and then the written
        metadata comes back, as the JAX builder's does. ``frame`` is a
        mapping of columns or an iterable of row dicts (JAX
        ``_to_columnar``); a schema column it lacks is all nulls. A column
        of the indexing config's ``segment_partition_config`` records the
        partitions its values fall in (JAX ``_partition_meta``)."""
        if not isinstance(frame, Mapping):
            rows, names = frame, self.schema.column_names
            frame = {n: [] for n in names}
            for row in rows:
                for n in names:
                    frame[n].append(row.get(n))
        sizes = {len(frame[c][1]) if isinstance(frame[c], tuple)
                 else len(frame[c]) for c in self.schema.column_names
                 if c in frame}
        if not sizes:
            raise ValueError("no input rows")
        if len(sizes) != 1:
            raise ValueError(f"ragged column lengths: {sorted(sizes)}")
        num_docs = sizes.pop()
        columns = {fs.name: self._partitioned(
            self._column(fs, frame[fs.name] if fs.name in frame
                         else [None] * num_docs), fs.name)
            for fs in self.schema.field_specs}
        seg = segment_from_arrays(self.segment_name, num_docs, columns,
                                  table_name=self.table_name,
                                  indexing=self.indexing,
                                  geo_columns=self.geo_columns)
        seg.metadata.schema = self.schema
        if out_dir is None:
            return seg
        return write_segment(seg, out_dir, self.codecs)

    def _partitioned(self, arrays: ColumnArrays, name: str) -> ColumnArrays:
        spc = self.indexing.segment_partition_config if self.indexing \
            else None
        if spc is None or name not in spc.column_partition_map:
            return arrays
        cfg = spc.column_partition_map[name]
        fn = get_partition_function(cfg.get("functionName", "Murmur"),
                                    int(cfg.get("numPartitions", 1)))
        distinct = (arrays.dictionary if arrays.dictionary is not None
                    else np.unique(arrays.values))
        arrays.partition_function = fn.name
        arrays.num_partitions = fn.num_partitions
        arrays.partitions = sorted({fn.partition(v)
                                    for v in distinct.tolist()})
        return arrays

    def _column(self, fs: FieldSpec, rows: Any) -> ColumnArrays:
        if not fs.single_value:
            dense, counts, nulls = _mv_values(fs, rows)
            valid = np.arange(dense.shape[1])[None, :] < counts[:, None]
            uniq, inv = np.unique(dense[valid], return_inverse=True)
            ids = np.zeros(dense.shape, dtype=np.int32)
            ids[valid] = inv.reshape(-1)
            return ColumnArrays(fs.data_type, fs.field_type, uniq, ids,
                                mv_counts=counts, null=nulls)
        vals, nulls = _sv_values(fs, rows)
        if fs.name in self.no_dictionary_columns and fs.data_type.is_numeric:
            return ColumnArrays(fs.data_type, fs.field_type, values=vals,
                                null=nulls)
        uniq, ids = np.unique(vals, return_inverse=True)
        return ColumnArrays(fs.data_type, fs.field_type, uniq,
                            ids.reshape(-1), null=nulls)
