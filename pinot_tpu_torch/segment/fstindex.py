"""FST index: REGEXP_LIKE over a sorted string dictionary.

Counterpart of ``pinot_tpu/segment/fstindex.py``, copied so the port
imports nothing of the JAX package. The dictionary is sorted, so the
index is a byte trie over its terms, each node carrying its ``[lo, hi)``
dictId range (contiguous because the terms are sorted): the literal prefix
of an anchored regexp walks the trie to a candidate interval, and the
regexp is verified only on the terms inside it. A regexp with no literal
prefix scans every term, as the index-less loop does, so both give the
same dictIds. The trie lives in memory as CSR arrays (``build``); on
disk they are the JAX package's four files, ``fstoff``, ``fstlab``,
``fsttgt`` and ``fstrng`` (``FST_FILES``, in ``build``'s order).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

FST_FILES = ("fstoff", "fstlab", "fsttgt", "fstrng")
MAX_DEPTH = 16  # trie depth cap: deeper prefixes narrow via dictId binsearch


class FstIndexBuilder:
    """Builds the CSR trie over sorted utf-8 terms. Depth is fixed at
    MAX_DEPTH: the reader's walk predicate must agree with the builder's
    expansion rule, so the cap is a module contract, not a parameter."""

    def __init__(self, terms: List[str]):
        self.terms = [t.encode("utf-8") for t in terms]
        self.max_depth = MAX_DEPTH

    def build(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """-> (edge_offsets [n_nodes+1], edge_labels [n_edges] u8,
        edge_targets [n_edges] i32, node_ranges [n_nodes, 2] i32).
        Node 0 is the root; ranges are [lo, hi) dictId intervals."""
        edge_labels: List[int] = []
        edge_targets: List[int] = []
        # per node id (creation order): (depth, lo, hi); children always get
        # larger ids than their parent, so processing ids sequentially keeps
        # edge_offsets[k]..edge_offsets[k+1] = node k's edges
        nodes: List[Tuple[int, int, int]] = [(0, 0, len(self.terms))]
        edge_offsets = [0]
        i = 0
        while i < len(nodes):
            depth, lo, hi = nodes[i]
            if depth < self.max_depth and hi - lo > 1:
                # group terms[lo:hi] by byte at `depth` (terms shorter than
                # depth+1 end here — no edge; byte groups are contiguous
                # because terms are sorted)
                p = lo
                while p < hi:
                    t = self.terms[p]
                    if len(t) <= depth:
                        p += 1
                        continue
                    b = t[depth]
                    q = p
                    while q < hi and len(self.terms[q]) > depth \
                            and self.terms[q][depth] == b:
                        q += 1
                    edge_labels.append(b)
                    edge_targets.append(len(nodes))
                    nodes.append((depth + 1, p, q))
                    p = q
            edge_offsets.append(len(edge_labels))
            i += 1
        node_ranges = [(lo, hi) for _, lo, hi in nodes]
        return (np.asarray(edge_offsets, dtype=np.int64),
                np.asarray(edge_labels, dtype=np.uint8),
                np.asarray(edge_targets, dtype=np.int32),
                np.asarray(node_ranges, dtype=np.int32))


class FstIndexReader:
    """Query-side trie walk + regexp verification."""

    def __init__(self, edge_offsets, edge_labels, edge_targets, node_ranges,
                 dictionary):
        self.edge_offsets = np.asarray(edge_offsets)
        self.edge_labels = np.asarray(edge_labels)
        self.edge_targets = np.asarray(edge_targets)
        self.node_ranges = np.asarray(node_ranges)
        self.dictionary = dictionary  # StringDictionary (get_value / card)

    # -- prefix machinery ---------------------------------------------------
    def prefix_range(self, prefix: str) -> Tuple[int, int]:
        """[lo, hi) dictIds of terms starting with ``prefix``."""
        data = prefix.encode("utf-8")
        node = 0
        for depth, b in enumerate(data):
            lo, hi = self.node_ranges[node]
            expanded = depth < MAX_DEPTH and hi - lo > 1
            if not expanded:
                # single-term subtree or depth cap: finish by direct compare
                return self._narrow_by_scan(int(lo), int(hi), prefix)
            off0, off1 = self.edge_offsets[node], self.edge_offsets[node + 1]
            labels = self.edge_labels[off0:off1]
            pos = np.searchsorted(labels, b)
            if pos == len(labels) or labels[pos] != b:
                return (0, 0)  # byte groups are complete: no term matches
            node = int(self.edge_targets[off0 + pos])
        lo, hi = self.node_ranges[node]
        return int(lo), int(hi)

    def _narrow_by_scan(self, lo: int, hi: int, prefix: str) -> Tuple[int, int]:
        ids = [i for i in range(lo, hi)
               if str(self.dictionary.get_value(i)).startswith(prefix)]
        if not ids:
            return (0, 0)
        return (ids[0], ids[-1] + 1)

    # -- the regexp entry ---------------------------------------------------
    def matching_ids(self, pattern: str) -> np.ndarray:
        """dictIds whose term matches the regexp (search semantics, matching
        the reference's RegexpLikePredicateEvaluator)."""
        rx = re.compile(pattern)
        prefix = literal_prefix(pattern)
        if prefix:
            lo, hi = self.prefix_range(prefix)
        else:
            lo, hi = 0, int(self.node_ranges[0][1])
        out = [i for i in range(lo, hi)
               if rx.search(str(self.dictionary.get_value(i)))]
        return np.asarray(out, dtype=np.int64)


def literal_prefix(pattern: str) -> str:
    """Longest literal prefix implied by an ANCHORED regexp (``^abc.*`` ->
    "abc"); un-anchored patterns have search semantics, so any term position
    can match and no prefix narrowing applies."""
    if not pattern.startswith("^"):
        return ""
    # the anchor binds only to the FIRST alternative ('^abc|xyz' matches
    # 'xyz' anywhere), so any unescaped top-level '|' voids prefix narrowing
    depth = 0
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            i += 2
            continue
        if c == "[":
            j = pattern.find("]", i + 1)
            i = (j if j >= 0 else len(pattern)) + 1
            continue
        if c == "(":
            depth += 1
        elif c == ")":
            depth = max(0, depth - 1)
        elif c == "|" and depth == 0:
            return ""
        i += 1
    out = []
    i = 1
    specials = set(".*+?()[]{}|\\$^")
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern) \
                and pattern[i + 1] in specials:
            # escaped metachar is a literal — but only safe to consume if
            # not followed by a quantifier
            if i + 2 < len(pattern) and pattern[i + 2] in "*+?{":
                break
            out.append(pattern[i + 1])
            i += 2
            continue
        if c in specials:
            break
        if i + 1 < len(pattern) and pattern[i + 1] in "*+?{":
            break  # quantified literal isn't a fixed prefix
        out.append(c)
        i += 1
    return "".join(out)
