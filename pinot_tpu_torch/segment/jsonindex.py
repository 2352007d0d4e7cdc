"""JSON index and JSON_MATCH's filter dialect.

Counterpart of ``pinot_tpu/segment/jsonindex.py``: every document of a
JSON column flattens to canonical ``path\\0value`` keys, each owning the
sorted docIds that hold it (``build_json_index``), and a JSON_MATCH filter
resolves to unions and intersections of those postings
(``JsonIndexReader.match``, the host engine's indexed branch). Without the
index the planner evaluates the filter once per distinct dictionary value
into a dictId lookup table (``match_json_value``), the index-less branch
of the JAX planner. The index lives in memory: sorted keys, doc-count
offsets and one flat int32 postings array. On disk it is the JAX
package's five files (JAX :72-110): the keys as offsets and a UTF-8 blob
(``jkeysoff``, ``jkeysblob``), the doc-count offsets (``jinvoff``) and the
postings as delta+varint lists with their byte offsets (``jinvbo``,
``jinv.bin``), written by ``json_index_files`` and read by
``json_index_from_files``.

Documents flatten to ``(path, canonical value)`` pairs, nested objects as
dotted paths and array elements as ``[*]``. Dialect: ``"$.path" = 'v'`` /
``!=`` / ``<>``, ``"$.path" IS [NOT] NULL``, AND / OR and parentheses.
"""

from __future__ import annotations

import json
import re
from bisect import bisect_left
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

_SEP = "\x00"


def _canon(value: Any) -> Optional[str]:
    """Canonical value string (query literals normalize the same way)."""
    if value is None:
        return None
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return str(value)


def flatten_json(obj: Any, prefix: str = "") -> Iterator[Tuple[str, str]]:
    """(path, canonical value) pairs for every scalar leaf; arrays collapse
    to ``[*]`` path steps."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from flatten_json(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from flatten_json(v, f"{prefix}[*]")
    else:
        c = _canon(obj)
        if c is not None and prefix:
            yield prefix, c


_TOKEN = re.compile(r"""
    \s*(?:
      (?P<lp>\() | (?P<rp>\)) |
      (?P<and>AND\b) | (?P<or>OR\b) |
      (?P<isnotnull>IS\s+NOT\s+NULL\b) | (?P<isnull>IS\s+NULL\b) |
      (?P<neq><>|!=) | (?P<eq>=) |
      '(?P<sq>(?:[^']|'')*)' | "(?P<dq>(?:[^"]|"")*)" |
      (?P<num>-?\d+(?:\.\d+)?) | (?P<word>[^\s()=<>!]+)
    )""", re.VERBOSE | re.IGNORECASE)


def _tokenize(s: str) -> List[Tuple[str, str]]:
    s = s.strip()
    out, i = [], 0
    while i < len(s):
        m = _TOKEN.match(s, i)
        if m is None or m.end() == i:
            raise ValueError(f"bad JSON_MATCH filter at {s[i:i+20]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind is None:
            continue
        text = m.group(kind)
        if kind == "sq":
            out.append(("str", text.replace("''", "'")))
        elif kind == "dq":
            out.append(("str", text.replace('""', '"')))
        else:
            out.append((kind, text))
    return out


def parse_match_filter(s: str):
    """-> AST: ("eq"|"neq", path, value) | ("exists"|"missing", path)
    | ("and"|"or", [children])."""
    toks = _tokenize(s)
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else (None, None)

    def take(kind=None):
        nonlocal pos
        t = toks[pos]
        if kind is not None and t[0] != kind:
            raise ValueError(f"expected {kind}, got {t}")
        pos += 1
        return t

    def norm_path(p: str) -> str:
        if p.startswith("$."):
            p = p[2:]
        elif p.startswith("$"):
            p = p[1:]
        if re.search(r"\[\d+\]", p):
            raise ValueError(
                "exact array indices are not indexed; use [*]")
        return p

    def term():
        kind, text = peek()
        if kind == "lp":
            take("lp")
            node = expr()
            take("rp")
            return node
        kind, text = take()
        if kind not in ("str", "word"):
            raise ValueError(f"expected a path, got {text!r}")
        path = norm_path(text)
        kind2, _ = peek()
        if kind2 in ("eq", "neq"):
            op, _ = take()
            vkind, vtext = take()
            if vkind not in ("str", "num", "word"):
                raise ValueError(f"expected a literal, got {vtext!r}")
            value = _canon(json.loads(vtext) if vkind == "num" else vtext)
            return ("eq" if op == "eq" else "neq", path, value)
        if kind2 == "isnotnull":
            take()
            return ("exists", path)
        if kind2 == "isnull":
            take()
            return ("missing", path)
        raise ValueError(f"expected an operator after {path!r}")

    def and_expr():
        # AND binds tighter than OR (SQL precedence)
        node = term()
        children = [node]
        while peek()[0] == "and":
            take()
            children.append(term())
        return children[0] if len(children) == 1 else ("and", children)

    def expr():
        node = and_expr()
        children = [node]
        while peek()[0] == "or":
            take()
            children.append(and_expr())
        return children[0] if len(children) == 1 else ("or", children)

    node = expr()
    if pos != len(toks):
        raise ValueError(f"trailing tokens in JSON_MATCH filter: {toks[pos:]}")
    return node


def eval_match_ast(ast, doc_pairs: set, doc_paths: set) -> bool:
    """Evaluate the AST against one flattened document (the index-less
    fallback; ``doc_pairs`` = {(path, value)}, ``doc_paths`` = {path})."""
    op = ast[0]
    if op == "eq":
        return (ast[1], ast[2]) in doc_pairs
    if op == "neq":
        return ast[1] in doc_paths and (ast[1], ast[2]) not in doc_pairs
    if op == "exists":
        return ast[1] in doc_paths
    if op == "missing":
        return ast[1] not in doc_paths
    if op == "and":
        return all(eval_match_ast(c, doc_pairs, doc_paths) for c in ast[1])
    return any(eval_match_ast(c, doc_pairs, doc_paths) for c in ast[1])


def match_json_value(raw: Any, ast) -> bool:
    """Index-less evaluation of one JSON value (dictionary-LUT fallback).
    Unparseable/null docs flatten to NOTHING — the same view the index has
    of them (never flattened), so 'missing' is True and 'eq' False on both
    paths."""
    try:
        obj = json.loads(raw) if isinstance(raw, str) else raw
        pairs = set(flatten_json(obj))
    except (ValueError, TypeError):
        pairs = set()
    paths = {p for p, _ in pairs}
    return eval_match_ast(ast, pairs, paths)


def build_json_index(json_values: List[Any], num_docs: int
                     ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Flatten every doc -> (sorted ``path\\0value`` keys, offsets
    [keys + 1], the docIds of key ``i`` at
    ``postings[offsets[i]:offsets[i + 1]]``, int32, ascending). A null or
    unparseable doc holds no key."""
    pairs: Dict[str, List[int]] = {}
    for doc_id in range(num_docs):
        raw = json_values[doc_id]
        if raw is None:
            continue
        try:
            obj = json.loads(raw) if isinstance(raw, str) else raw
        except (ValueError, TypeError):
            continue
        seen = set()
        for path, value in flatten_json(obj):
            key = path + _SEP + value
            if key not in seen:
                seen.add(key)
                pairs.setdefault(key, []).append(doc_id)
    keys = sorted(pairs)
    offsets = np.zeros(len(keys) + 1, dtype=np.int64)
    for i, k in enumerate(keys):
        offsets[i + 1] = offsets[i] + len(pairs[k])
    flat = np.asarray([d for k in keys for d in pairs[k]], dtype=np.int32)
    return keys, offsets, flat


def json_index_files(keys: List[str], offsets: np.ndarray,
                     postings: np.ndarray) -> Dict[str, Any]:
    """The index's files: suffix -> array (``.npy``) or bytes (``.bin``)."""
    from pinot_tpu_torch.native import varint_encode_lists
    from pinot_tpu_torch.segment.dictionary import encode_strings

    key_off, blob = encode_strings(keys)
    inv, byte_off = varint_encode_lists(postings, offsets)
    return {"jkeysoff": key_off, "jkeysblob": blob, "jinvoff": offsets,
            "jinvbo": byte_off, "jinv": inv}


def json_index_from_files(files: Mapping[str, Any], num_docs: int
                          ) -> "JsonIndexReader":
    """``json_index_files``'s inverse (``files["jinv"]`` any buffer)."""
    from pinot_tpu_torch.native import varint_decode_lists
    from pinot_tpu_torch.segment.dictionary import decode_strings

    offsets = np.asarray(files["jinvoff"], dtype=np.int64)
    postings = varint_decode_lists(files["jinv"], files["jinvbo"], offsets)
    return JsonIndexReader(decode_strings(files["jkeysoff"],
                                          files["jkeysblob"]),
                           offsets, postings, num_docs)


class JsonIndexReader:
    """JSON_MATCH filters resolved through the postings to a doc mask."""

    def __init__(self, keys: List[str], offsets: np.ndarray,
                 postings: np.ndarray, num_docs: int):
        self._keys = keys
        self._offsets = offsets
        self._postings_flat = postings
        self.num_docs = num_docs

    def files(self) -> Dict[str, Any]:
        """The index's files on disk (``json_index_files``)."""
        return json_index_files(self._keys, self._offsets,
                                self._postings_flat)

    def _postings(self, idx: int) -> np.ndarray:
        return self._postings_flat[int(self._offsets[idx]):
                                   int(self._offsets[idx + 1])]

    def _docs_for_key(self, key: str) -> np.ndarray:
        i = bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            return self._postings(i)
        return np.empty(0, dtype=np.int32)

    def _docs_for_path(self, path: str) -> np.ndarray:
        """Union of the postings of every key of ``path``: one contiguous
        range of the sorted keys (``path + "\\x01"`` bounds it for every
        value)."""
        lo = bisect_left(self._keys, path + _SEP)
        hi = bisect_left(self._keys, path + "\x01")
        if lo == hi:
            return np.empty(0, dtype=np.int32)
        return np.unique(np.concatenate([self._postings(i)
                                         for i in range(lo, hi)]))

    def _mask(self, docs: np.ndarray) -> np.ndarray:
        m = np.zeros(self.num_docs, dtype=bool)
        m[docs] = True
        return m

    def match(self, filter_string: str) -> np.ndarray:
        """[num_docs] bool mask for a JSON_MATCH filter string."""
        return self._eval(parse_match_filter(filter_string))

    def _eval(self, ast) -> np.ndarray:
        op = ast[0]
        if op == "eq":
            return self._mask(self._docs_for_key(ast[1] + _SEP + ast[2]))
        if op == "neq":
            return (self._mask(self._docs_for_path(ast[1]))
                    & ~self._mask(self._docs_for_key(
                        ast[1] + _SEP + ast[2])))
        if op == "exists":
            return self._mask(self._docs_for_path(ast[1]))
        if op == "missing":
            return ~self._mask(self._docs_for_path(ast[1]))
        out = self._eval(ast[1][0])
        for c in ast[1][1:]:
            if op == "and":
                out &= self._eval(c)
            else:
                out |= self._eval(c)
        return out
