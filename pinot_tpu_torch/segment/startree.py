"""Star-tree: the pre-aggregated record index, its builder and its walk.

Counterpart of ``pinot_tpu/segment/startree.py`` (:28-619): the records are
flat columns, ``dims [R, D]`` int32 dictIds with ``STAR = -1`` where a
record aggregates over that dimension, and one column per function-column
pair (``count__*`` int64, the others float64); the nodes are one
``_NODE_DTYPE`` array in depth-first order, root first. The builder is the
JAX package's level-batched lexsort construction, which emits the same
bytes as its recursive oracle; ``select_records`` is the host walk that
picks the records answering a query. The tree lives in memory (no tree
files yet). This is host numpy code, as in the JAX package: the walk is a
pointer chase over R records, R far below the segment's docs; the device
aggregates the selected slice (``engine/startree_device.py``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

STAR = -1


class DictIdRange:
    """Contiguous inclusive dictId interval [lo, hi]: a RANGE predicate
    over a sorted dictionary matches one dictId run, checked with two
    compares instead of a set (``startree_exec._MAX_RANGE_IDS``)."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo: int, hi: int):
        self.lo = int(lo)
        self.hi = int(hi)

    def __contains__(self, v) -> bool:
        return self.lo <= int(v) <= self.hi

    def __len__(self) -> int:
        return max(0, self.hi - self.lo + 1)

    def __repr__(self) -> str:
        return f"DictIdRange({self.lo}, {self.hi})"


def match_bounds(match) -> Tuple[int, int]:
    """Inclusive (lo, hi) dictId bounds of a match (set or DictIdRange);
    (0, -1) for an empty match."""
    if isinstance(match, DictIdRange):
        return match.lo, match.hi
    if not match:
        return 0, -1
    return min(match), max(match)


_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*\Z")


def canonical_pair_column(col: str) -> str:
    """A function-column pair's column half: a column name or ``*`` as
    is; an arithmetic expression (``lo_extendedprice*lo_discount``) as its
    canonical key (``query/expressions.py`` ``canonical_arith_key``), the
    key the query side derives from ``sum(lo_discount *
    lo_extendedprice)``. Raises ValueError outside the ``+ - *`` subset."""
    from pinot_tpu_torch.query.expressions import canonical_arith_key
    from pinot_tpu_torch.query.parser import parse_expression

    col = col.strip()
    if col == "*" or _IDENT_RE.match(col):
        return col
    key = canonical_arith_key(parse_expression(col))
    if key is None:
        raise ValueError(f"function-column pair expression {col!r} is not "
                         "pre-aggregable (+/-/* over columns only)")
    return key


def derived_pair_expr(col: str):
    """The parsed expression behind a derived pair's key (canonical,
    parenthesised), or None for a plain column or ``*``."""
    if not col.startswith("("):
        return None
    from pinot_tpu_torch.query.parser import parse_expression

    return parse_expression(col)


def eval_derived_column(expr, columns: Dict[str, np.ndarray],
                        num_docs: int) -> np.ndarray:
    """A derived pair column over the base columns' values, vectorised:
    integer inputs stay integral, so the f64 sums the tree stores are
    exact."""
    from pinot_tpu_torch.query.expressions import (
        Function,
        Identifier,
        Literal,
    )

    def ev(e):
        if isinstance(e, Identifier):
            return np.asarray(columns[e.name][:num_docs])
        if isinstance(e, Literal):
            return e.value
        assert isinstance(e, Function) and len(e.args) == 2, e
        a, b = ev(e.args[0]), ev(e.args[1])
        if e.name == "plus":
            return a + b
        if e.name == "minus":
            return a - b
        if e.name == "times":
            return a * b
        raise ValueError(f"derived column op {e.name} unsupported")

    return ev(expr)


@dataclass
class StarTreeConfig:
    """One tree's build config: pairs are ``(function, column)``, COUNT's
    column ``*``, a derived pair's column its canonical key."""

    dimensions_split_order: List[str]
    function_column_pairs: List[Tuple[str, str]]
    max_leaf_records: int = 10_000
    skip_star_creation: List[str] = field(default_factory=list)

    @classmethod
    def from_spi(cls, spi_config) -> "StarTreeConfig":
        """From ``spi.table.StarTreeIndexConfig`` (``SUM__revenue``; the
        column half may be a ``+ - *`` expression, ``SUM__a*b``)."""
        pairs = []
        for p in spi_config.function_column_pairs:
            fn, _, col = p.partition("__")
            pairs.append((fn.lower(), canonical_pair_column(col or "*")))
        return cls(list(spi_config.dimensions_split_order), pairs,
                   spi_config.max_leaf_records,
                   list(spi_config.skip_star_node_creation_for_dimensions))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "dimensionsSplitOrder": self.dimensions_split_order,
            "functionColumnPairs": [f"{f}__{c}" for f, c in
                                    self.function_column_pairs],
            "maxLeafRecords": self.max_leaf_records,
            "skipStarNodeCreationForDimensions": self.skip_star_creation,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StarTreeConfig":
        pairs = []
        for p in d["functionColumnPairs"]:
            fn, _, col = p.partition("__")
            pairs.append((fn, canonical_pair_column(col or "*")))
        return cls(list(d["dimensionsSplitOrder"]), pairs,
                   d["maxLeafRecords"],
                   list(d.get("skipStarNodeCreationForDimensions", [])))


# one node: the split dimension of its children, its dictId on the
# parent's split dimension (STAR allowed), its record range and its
# children's node range ([-1, -1) for a leaf)
_NODE_DTYPE = np.dtype([
    ("dim", np.int32),
    ("value", np.int32),
    ("start", np.int64),
    ("end", np.int64),
    ("child_first", np.int64),
    ("child_last", np.int64),
])


class _BuildNode:
    """A node under construction: a record range inside one chunk and its
    children (value children in dictId order, the star child apart)."""

    __slots__ = ("value", "chunk", "lo", "hi", "dim", "kids", "star", "idx")

    def __init__(self, value: int, chunk: int, lo: int, hi: int):
        self.value = value
        self.chunk = chunk
        self.lo = lo
        self.hi = hi
        self.dim = -1
        self.kids: Optional[List["_BuildNode"]] = None
        self.star: Optional["_BuildNode"] = None
        self.idx = -1


class StarTreeBuilder:
    """Builds one tree from a segment's dictIds and metric values."""

    def __init__(self, config: StarTreeConfig):
        self.config = config

    def build(self, dim_dict_ids: Dict[str, np.ndarray],
              metric_values: Dict[str, np.ndarray],
              num_docs: int) -> "StarTree":
        """``dim_dict_ids``: per split dimension, [num_docs] dictIds.
        ``metric_values``: per pair column, [num_docs] values (a derived
        pair's column is evaluated here from its base columns unless given
        under its key)."""
        cfg = self.config
        dims = np.stack([np.asarray(dim_dict_ids[d][:num_docs], dtype=np.int32)
                         for d in cfg.dimensions_split_order], axis=1)
        metrics: Dict[str, np.ndarray] = {}
        for fn, col in cfg.function_column_pairs:
            key = f"{fn}__{col}"
            if fn == "count":
                metrics[key] = np.ones(num_docs, dtype=np.int64)
                continue
            if col not in metric_values:
                expr = derived_pair_expr(col)
                if expr is not None:
                    metric_values[col] = eval_derived_column(
                        expr, metric_values, num_docs)
            metrics[key] = np.asarray(metric_values[col][:num_docs],
                                      dtype=np.float64)
        # sort by the dimensions, aggregate records of equal tuples
        dims, metrics = self._sort_and_dedup(dims, metrics)
        return self._construct(dims, metrics)

    def _construct(self, dims: np.ndarray,
                   metrics: Dict[str, np.ndarray]) -> "StarTree":
        """Level by level: per depth, one boundary scan per chunk finds
        every splitting node's children, and one lexsort over every star
        candidate's records aggregates every star child of the level. The
        assembly then lays the nodes and records out in the recursion's
        depth-first order (JAX ``_construct_lexsort``, :252)."""
        cfg = self.config
        D = len(cfg.dimensions_split_order)
        max_leaf = cfg.max_leaf_records
        chunks: List[Tuple[np.ndarray, Dict[str, np.ndarray]]] = [
            (dims, metrics)]
        root = _BuildNode(STAR, 0, 0, dims.shape[0])
        level = [root]
        for depth in range(D):
            splitting = [n for n in level if n.hi - n.lo > max_leaf]
            if not splitting:
                break
            dim_name = cfg.dimensions_split_order[depth]
            make_star = dim_name not in cfg.skip_star_creation
            # every position where column ``depth`` changes (records are
            # sorted within each node's range)
            cuts: Dict[int, np.ndarray] = {}
            for ci in {n.chunk for n in splitting}:
                col = chunks[ci][0][:, depth]
                cuts[ci] = np.flatnonzero(col[1:] != col[:-1]) + 1
            next_level: List[_BuildNode] = []
            star_jobs: List[_BuildNode] = []
            for n in splitting:
                n.dim = depth
                b = cuts[n.chunk]
                col = chunks[n.chunk][0][:, depth]
                inner = b[np.searchsorted(b, n.lo, side="right"):
                          np.searchsorted(b, n.hi, side="left")]
                starts = [n.lo] + [int(x) for x in inner]
                ends = starts[1:] + [n.hi]
                n.kids = [_BuildNode(int(col[s]), n.chunk, s, e)
                          for s, e in zip(starts, ends)]
                next_level.extend(n.kids)
                if make_star and len(n.kids) > 1:
                    star_jobs.append(n)
            if star_jobs:
                self._batch_star_children(chunks, star_jobs, depth,
                                          next_level)
            level = next_level
        return self._assemble(self.config, chunks, root)

    def _batch_star_children(self, chunks, star_jobs: List[_BuildNode],
                             depth: int,
                             next_level: List[_BuildNode]) -> None:
        """Every star child of one level in one lexsort: the splitting
        nodes' records with the split dimension starred, sorted by (node,
        dims) and aggregated by equal tuple; each node's star child is a
        slice of the result, appended as a chunk of its own."""
        D = chunks[0][0].shape[1]
        keys = list(chunks[0][1].keys())
        d_parts: List[np.ndarray] = []
        id_parts: List[np.ndarray] = []
        m_parts: Dict[str, List[np.ndarray]] = {k: [] for k in keys}
        for j, n in enumerate(star_jobs):
            cd, cm = chunks[n.chunk]
            part = cd[n.lo:n.hi].copy()
            part[:, depth] = STAR
            d_parts.append(part)
            id_parts.append(np.full(n.hi - n.lo, j, dtype=np.int64))
            for k in keys:
                m_parts[k].append(cm[k][n.lo:n.hi])
        bd = np.concatenate(d_parts, axis=0)
        bi = np.concatenate(id_parts)
        bm = {k: np.concatenate(v) for k, v in m_parts.items()}
        # the node is the primary key (np.lexsort's last key); within a
        # node this is _sort_and_dedup's permutation (same stable sort)
        order = np.lexsort(tuple(bd[:, i] for i in range(D - 1, -1, -1))
                           + (bi,))
        bd, bi = bd[order], bi[order]
        bm = {k: v[order] for k, v in bm.items()}
        change = (bi[1:] != bi[:-1]) | np.any(bd[1:] != bd[:-1], axis=1)
        starts = np.concatenate([[0], np.flatnonzero(change) + 1])
        gid = np.zeros(bd.shape[0], dtype=np.int64)
        gid[starts[1:]] = 1
        gid = np.cumsum(gid)
        ng = starts.shape[0]
        dd = bd[starts]
        di = bi[starts]
        dm = {k: self._segmented(k, v, gid, ng) for k, v in bm.items()}
        offs = np.searchsorted(di, np.arange(len(star_jobs) + 1))
        for j, n in enumerate(star_jobs):
            lo, hi = int(offs[j]), int(offs[j + 1])
            ci = len(chunks)
            chunks.append((dd[lo:hi],
                           {k: v[lo:hi] for k, v in dm.items()}))
            n.star = _BuildNode(STAR, ci, 0, hi - lo)
            next_level.append(n.star)

    @staticmethod
    def _assemble(cfg: StarTreeConfig, chunks, root: _BuildNode
                  ) -> "StarTree":
        """Depth-first layout: a node's children take their indices when
        it splits (value children, then the star child), and each star
        chunk joins the record stream where the recursion appended it."""
        chunk_off = {0: 0}
        chunk_order = [0]
        next_off = chunks[0][0].shape[0]
        nodes: List[List[int]] = []

        def alloc(bn: _BuildNode) -> None:
            bn.idx = len(nodes)
            off = chunk_off[bn.chunk]
            nodes.append([-1, bn.value, off + bn.lo, off + bn.hi, -1, -1])

        alloc(root)
        stack = [root]
        while stack:
            bn = stack.pop()
            if bn.kids is None:
                continue
            rec = nodes[bn.idx]
            rec[0] = bn.dim
            rec[4] = len(nodes)
            for c in bn.kids:
                alloc(c)
            if bn.star is not None:
                ci = bn.star.chunk
                chunk_off[ci] = next_off
                chunk_order.append(ci)
                next_off += chunks[ci][0].shape[0]
                alloc(bn.star)
            rec[5] = len(nodes)
            kids = bn.kids + ([bn.star] if bn.star is not None else [])
            stack.extend(reversed(kids))
        all_dims = np.concatenate([chunks[ci][0] for ci in chunk_order],
                                  axis=0)
        all_metrics = {k: np.concatenate([chunks[ci][1][k]
                                          for ci in chunk_order])
                       for k in chunks[0][1]}
        nodes_arr = np.array([tuple(n) for n in nodes], dtype=_NODE_DTYPE)
        return StarTree(cfg, all_dims, all_metrics, nodes_arr)

    def _sort_and_dedup(self, dims, metrics):
        order = np.lexsort(tuple(dims[:, i] for i
                                 in range(dims.shape[1] - 1, -1, -1)))
        dims = dims[order]
        metrics = {k: v[order] for k, v in metrics.items()}
        if dims.shape[0]:
            change = np.any(np.diff(dims, axis=0) != 0, axis=1)
            starts = np.concatenate([[0], np.nonzero(change)[0] + 1])
            group_id = np.zeros(dims.shape[0], dtype=np.int64)
            group_id[starts[1:]] = 1
            group_id = np.cumsum(group_id)
            n = starts.shape[0]
            dims = dims[starts]
            metrics = {k: self._segmented(k, v, group_id, n)
                       for k, v in metrics.items()}
        return dims, metrics

    @staticmethod
    def _segmented(key: str, v: np.ndarray, gid: np.ndarray, n: int):
        fn = key.split("__", 1)[0]
        if fn in ("count", "sum"):
            out = np.zeros(n, dtype=v.dtype)
            np.add.at(out, gid, v)
            return out
        if fn == "min":
            out = np.full(n, np.inf)
            np.minimum.at(out, gid, v)
            return out
        out = np.full(n, -np.inf)
        np.maximum.at(out, gid, v)
        return out


class StarTree:
    """A built tree: flat record columns and the node array."""

    def __init__(self, config: StarTreeConfig, dims: np.ndarray,
                 metrics: Dict[str, np.ndarray], nodes: np.ndarray):
        self.config = config
        self.dims = dims          # [R, D] int32, STAR = -1
        self.metrics = metrics    # pair key -> [R]
        self.nodes = nodes        # _NODE_DTYPE array; root = 0
        self._dim_index = {d: i for i, d
                           in enumerate(config.dimensions_split_order)}

    @property
    def num_records(self) -> int:
        return int(self.dims.shape[0])

    def has_pair(self, fn: str, col: str) -> bool:
        return f"{fn}__{col}" in self.metrics

    def nbytes(self) -> int:
        """Host bytes of the records and nodes."""
        return (self.dims.nbytes + self.nodes.nbytes
                + sum(v.nbytes for v in self.metrics.values()))

    def select_records(self, eq_in_per_dim: Dict[str, Any],
                       group_by_dims: List[str]) -> np.ndarray:
        """int64 indices of the records answering a query. Per split
        dimension: with a predicate, descend the matching children;
        grouped, every non-star child; otherwise the star child (every
        child where there is none). Matches are dictId sets or
        :class:`DictIdRange` (JAX :578). The leaves' records are then
        post-filtered: a leaf covers an unsplit tail, so its records may
        hold values the predicates exclude, and STAR never reaches a
        predicated or grouped dimension."""
        grouped = set(self._dim_index[d] for d in group_by_dims)
        predicates = {self._dim_index[d]: ids
                      for d, ids in eq_in_per_dim.items()}
        out: List[np.ndarray] = []
        stack: List[int] = [0]
        nodes = self.nodes
        while stack:
            ni = stack.pop()
            n = nodes[ni]
            if n["child_first"] < 0:
                out.append(np.arange(n["start"], n["end"], dtype=np.int64))
                continue
            dim = int(n["dim"])
            first, last = int(n["child_first"]), int(n["child_last"])
            kids = range(first, last)
            if dim in predicates:
                match = predicates[dim]
                for c in kids:
                    if int(nodes[c]["value"]) in match:
                        stack.append(c)
            elif dim in grouped:
                for c in kids:
                    if int(nodes[c]["value"]) != STAR:
                        stack.append(c)
            else:
                star = next((c for c in kids
                             if int(nodes[c]["value"]) == STAR), None)
                if star is not None:
                    stack.append(star)
                else:
                    for c in kids:
                        stack.append(c)
        if not out:
            return np.empty(0, dtype=np.int64)
        idx = np.concatenate(out)
        mask = np.ones(idx.shape[0], dtype=bool)
        for dim, match in predicates.items():
            col = self.dims[idx, dim]
            if isinstance(match, DictIdRange):
                mask &= (col >= match.lo) & (col <= match.hi)
            else:
                mask &= np.isin(col, np.fromiter(match, dtype=np.int32,
                                                 count=len(match)))
        for dim in grouped:
            mask &= self.dims[idx, dim] != STAR
        # free dimensions need no post-filter: each leaf range holds either
        # the star-aggregated records or a whole concrete partition
        return idx[mask]
