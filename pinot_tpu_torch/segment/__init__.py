from pinot_tpu_torch.segment.convert import (
    ColumnArrays,
    attach_star_trees,
    columns_of,
    segment_from_arrays,
    star_trees_of,
)
from pinot_tpu_torch.segment.creator import SegmentBuilder
from pinot_tpu_torch.segment.dictionary import Dictionary, build_dictionary
from pinot_tpu_torch.segment.immutable import DataSource, ImmutableSegment
from pinot_tpu_torch.segment.metadata import (
    DOC_TILE,
    ColumnMetadata,
    SegmentMetadata,
    pad_capacity,
)

__all__ = [
    "ColumnArrays", "attach_star_trees", "columns_of", "segment_from_arrays", "star_trees_of",
    "SegmentBuilder",
    "Dictionary", "build_dictionary", "DataSource", "ImmutableSegment",
    "DOC_TILE", "ColumnMetadata", "SegmentMetadata", "pad_capacity",
]
