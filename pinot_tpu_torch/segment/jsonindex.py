"""JSON_MATCH's filter dialect and its per-value matcher.

Counterpart of the matchers in ``pinot_tpu/segment/jsonindex.py``
(``_canon``, ``flatten_json``, ``_tokenize``, ``parse_match_filter``,
``eval_match_ast``, ``match_json_value``): the planner evaluates a
JSON_MATCH filter once per distinct dictionary value into a dictId lookup
table, the index-less branch of the JAX planner. The JSON index builder
and reader are not ported (port segments carry no JSON index).

Documents flatten to ``(path, canonical value)`` pairs, nested objects as
dotted paths and array elements as ``[*]``. Dialect: ``"$.path" = 'v'`` /
``!=`` / ``<>``, ``"$.path" IS [NOT] NULL``, AND / OR and parentheses.
"""

from __future__ import annotations

import json
import re
from typing import Any, Iterator, List, Optional, Tuple

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
