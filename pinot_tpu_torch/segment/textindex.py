"""TEXT_MATCH's query dialect and its per-value matcher.

Counterpart of the matchers in ``pinot_tpu/segment/textindex.py``
(``tokenize``, ``parse_text_query``, ``match_text_value``): the planner
evaluates a TEXT_MATCH query once per distinct dictionary value into a
dictId lookup table. The JAX package's text index resolves the same
dialect through posting lists to the same dictIds; the index builder and
reader are not ported (port segments carry no text index).

Analyzer: lowercase + split on non-alphanumerics. Dialect: bare terms,
``"quoted phrases"``, ``prefix*`` wildcards, AND / OR (OR is the default
operator) and parentheses.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(str(text).lower())


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
