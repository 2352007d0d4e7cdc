"""Text index and TEXT_MATCH's query dialect.

Counterpart of ``pinot_tpu/segment/textindex.py``: terms map to posting
lists over the column's dictionary ids, so a TEXT_MATCH query resolves to
a dictId set (``TextIndexReader.matching_ids``), the lookup-table shape the
device rungs and the host evaluator read. Without the index the planner
evaluates the same dialect once per distinct value (``match_text_value``);
both give the same dictIds. The index lives in memory: the sorted terms,
doc-count offsets and one flat array of postings (the JAX package keeps
the postings as delta+varint lists on disk).

Analyzer: lowercase + split on non-alphanumerics. Dialect: bare terms,
``"quoted phrases"`` (adjacency verified against the source values),
``prefix*`` wildcards, AND / OR (OR is the default operator) and
parentheses.
"""

from __future__ import annotations

import re
from bisect import bisect_left
from typing import Any, Callable, List, Sequence, Set, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(str(text).lower())


def build_text_index(values: Sequence[Any]
                     ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Postings of each term over ``values`` (a dictionary's values: the
    postings hold dictIds) -> (sorted terms, offsets [terms + 1], the
    postings of term ``i`` at ``postings[offsets[i]:offsets[i + 1]]``,
    int32, ascending)."""
    postings: dict = {}
    for vid, value in enumerate(values):
        if value is None:
            continue
        for term in set(tokenize(value)):
            postings.setdefault(term, []).append(vid)
    terms = sorted(postings)
    offsets = np.zeros(len(terms) + 1, dtype=np.int64)
    for i, t in enumerate(terms):
        offsets[i + 1] = offsets[i] + len(postings[t])
    flat = np.asarray([v for t in terms for v in postings[t]],
                      dtype=np.int32)
    return terms, offsets, flat


_QTOKEN = re.compile(r"""
    \s*(?:
      (?P<lp>\() | (?P<rp>\)) |
      (?P<and>AND\b) | (?P<or>OR\b) |
      "(?P<phrase>[^"]*)" |
      (?P<word>[^\s()"]+)
    )""", re.VERBOSE)


def parse_text_query(q: str):
    """-> AST: ("term", t) | ("prefix", p) | ("phrase", [terms], raw)
    | ("and"|"or", [children])."""
    toks: List[Tuple[str, str]] = []
    i = 0
    q = q.strip()
    while i < len(q):
        m = _QTOKEN.match(q, i)
        if m is None or m.end() == i:
            raise ValueError(f"bad TEXT_MATCH query at {q[i:i+20]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind:
            toks.append((kind, m.group(kind)))
    pos = 0

    def peek():
        return toks[pos][0] if pos < len(toks) else None

    def take():
        nonlocal pos
        if pos >= len(toks):
            raise ValueError(f"unexpected end of TEXT_MATCH query {q!r}")
        t = toks[pos]
        pos += 1
        return t

    def unit():
        kind, text = take()
        if kind == "lp":
            node = expr()
            if peek() != "rp":
                raise ValueError("unbalanced parentheses")
            take()
            return node
        if kind == "phrase":
            terms = tokenize(text)
            if not terms:
                raise ValueError("empty phrase")
            return ("phrase", terms, text)
        if kind == "word":
            if text.endswith("*") and len(text) > 1:
                p = tokenize(text[:-1])
                if len(p) != 1:
                    raise ValueError(f"bad wildcard {text!r}")
                return ("prefix", p[0])
            terms = tokenize(text)
            if not terms:
                # '*', '%%', ... — no analyzable content; rejecting beats
                # an index/decay divergence (empty phrase matched ALL rows
                # on the decay path and crashed the indexed path)
                raise ValueError(f"no searchable terms in {text!r}")
            if len(terms) != 1:
                # 'foo-bar' tokenizes to two terms: treat as a phrase
                return ("phrase", terms, text)
            return ("term", terms[0])
        raise ValueError(f"expected a term, got {text!r}")

    def and_expr():
        node = unit()
        children = [node]
        while peek() == "and":
            take()
            children.append(unit())
        return children[0] if len(children) == 1 else ("and", children)

    def expr():
        node = and_expr()
        children = [node]
        while peek() in ("or", "lp", "phrase", "word"):
            if peek() == "or":
                take()
            children.append(and_expr())  # juxtaposition = OR (Lucene)
        return children[0] if len(children) == 1 else ("or", children)

    node = expr()
    if pos != len(toks):
        raise ValueError(f"trailing tokens in TEXT_MATCH query: {toks[pos:]}")
    return node


def match_text_value(value: Any, ast) -> bool:
    """Index-less evaluation of one value (the fallback oracle)."""
    terms = tokenize(value)
    have = set(terms)

    def ev(node) -> bool:
        op = node[0]
        if op == "term":
            return node[1] in have
        if op == "prefix":
            return any(t.startswith(node[1]) for t in have)
        if op == "phrase":
            want = node[1]
            return any(terms[i:i + len(want)] == want
                       for i in range(len(terms) - len(want) + 1))
        if op == "and":
            return all(ev(c) for c in node[1])
        return any(ev(c) for c in node[1])

    return ev(ast)


class TextIndexReader:
    """TEXT_MATCH resolved through the postings to a sorted dictId set."""

    def __init__(self, terms: List[str], offsets: np.ndarray,
                 postings: np.ndarray, num_ids: int,
                 value_of: Callable[[int], Any]):
        self._terms = terms
        self._offsets = offsets
        self._postings_flat = postings
        self.num_ids = num_ids
        self._value_of = value_of  # id -> source text (phrase verification)

    def _postings(self, idx: int) -> np.ndarray:
        return self._postings_flat[int(self._offsets[idx]):
                                   int(self._offsets[idx + 1])]

    def _ids_for_term(self, term: str) -> Set[int]:
        i = bisect_left(self._terms, term)
        if i < len(self._terms) and self._terms[i] == term:
            return set(int(x) for x in self._postings(i))
        return set()

    def _ids_for_prefix(self, prefix: str) -> Set[int]:
        lo = bisect_left(self._terms, prefix)
        hi = bisect_left(self._terms, prefix + "\U0010ffff")
        out: Set[int] = set()
        for i in range(lo, hi):
            out |= set(int(x) for x in self._postings(i))
        return out

    def matching_ids(self, query: str) -> np.ndarray:
        """Sorted value ids matching the TEXT_MATCH query."""
        ast = parse_text_query(query)

        def ev(node) -> Set[int]:
            op = node[0]
            if op == "term":
                return self._ids_for_term(node[1])
            if op == "prefix":
                return self._ids_for_prefix(node[1])
            if op == "phrase":
                # AND the terms, then verify adjacency against the source
                # values (positions are not stored; candidates are few)
                cand: Set[int] = None  # type: ignore[assignment]
                for t in node[1]:
                    ids = self._ids_for_term(t)
                    cand = ids if cand is None else (cand & ids)
                    if not cand:
                        return set()
                return {i for i in cand
                        if match_text_value(self._value_of(i), node)}
            if op == "and":
                out: Set[int] = None  # type: ignore[assignment]
                for c in node[1]:
                    ids = ev(c)
                    out = ids if out is None else (out & ids)
                    if not out:
                        return set()
                return out
            out = set()
            for c in node[1]:
                out |= ev(c)
            return out

        return np.asarray(sorted(ev(ast)), dtype=np.int64)
