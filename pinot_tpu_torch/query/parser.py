"""SQL parser: SQL text -> parsed query AST.

Counterpart of ``pinot_tpu/query/parser.py`` (``parse_sql``), cut to the
dialect the port serves:

    SELECT [DISTINCT] select_list FROM table
    [WHERE bool_expr] [GROUP BY expr_list] [HAVING bool_expr]
    [ORDER BY expr [ASC|DESC], ...] [LIMIT n [OFFSET m] | LIMIT m, n]
    [OPTION(k=v, ...)]

``bool_expr`` is AND/OR/NOT over ``= != <> < <= > >= BETWEEN IN NOT IN
LIKE NOT LIKE`` with a column on one side and a literal on the other,
``IS [NOT] NULL`` and the predicate calls ``REGEXP_LIKE(col, 're')``,
``TEXT_MATCH(col, 'q')`` and ``JSON_MATCH(col, 'filter')``. Value
expressions are columns, numeric literals, ``+ - * / %`` and function
calls: the aggregation functions (``query/context.py``
``is_aggregation``; ``count(DISTINCT x)`` is ``distinctcount(x)``),
transforms and ``*``. ``EXPLAIN PLAN FOR <query>`` marks the parsed
query ``explain`` (the broker answers it with ``query/explain.py``'s
rows). ``CASE`` (which no JAX server path evaluates) raises
:class:`SqlParseError`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from pinot_tpu_torch.query.expressions import (
    STAR,
    Expr,
    FilterNode,
    Function,
    Identifier,
    Literal,
    OrderByExpr,
    Predicate,
    PredicateType,
    fold_constants,
)


class SqlParseError(Exception):
    pass


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<number>\d+\.\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|\d+([eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<op><>|!=|<=|>=|=|<|>|\(|\)|,|\*|\+|-|/|%|\.|;)
""", re.VERBOSE)


@dataclass
class Token:
    kind: str   # number | string | ident | qident | op | eof
    text: str
    pos: int

    @property
    def upper(self) -> str:
        return self.text.upper()


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            raise SqlParseError(
                f"unexpected character {sql[pos]!r} at position {pos}")
        for kind in ("ws", "number", "string", "qident", "ident", "op"):
            if m.group(kind) is not None:
                break
        if kind != "ws":
            tokens.append(Token(kind, m.group(kind), pos))
        pos = m.end()
    tokens.append(Token("eof", "", len(sql)))
    return tokens


_KEYWORDS = {
    "SELECT", "DISTINCT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER",
    "LIMIT", "OFFSET", "OPTION", "AND", "OR", "NOT", "IN", "BETWEEN", "LIKE",
    "IS", "NULL", "TRUE", "FALSE", "AS", "ASC", "DESC", "CASE", "WHEN",
    "THEN", "ELSE", "END",
}

# function-call predicates: f(col, literal) used in WHERE position
_PREDICATE_FUNCTIONS = {
    "regexp_like": PredicateType.REGEXP_LIKE,
    "text_match": PredicateType.TEXT_MATCH,
    "json_match": PredicateType.JSON_MATCH,
}

@dataclass
class ParsedQuery:
    table: str
    select: List[Tuple[Expr, Optional[str]]]  # (expr, alias)
    distinct: bool = False
    where: Optional[FilterNode] = None
    group_by: List[Expr] = field(default_factory=list)
    having: Optional[FilterNode] = None
    order_by: List[OrderByExpr] = field(default_factory=list)
    limit: int = 10
    offset: int = 0
    options: Dict[str, str] = field(default_factory=dict)
    explain: bool = False   # EXPLAIN PLAN FOR <sql>


class _Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.i = 0

    def peek(self) -> Token:
        return self.tokens[self.i]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_keyword(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.upper in words

    def accept_keyword(self, *words: str) -> bool:
        if self.at_keyword(*words):
            self.next()
            return True
        return False

    def expect_keyword(self, word: str) -> None:
        if not self.accept_keyword(word):
            t = self.peek()
            raise SqlParseError(
                f"expected {word} at position {t.pos}, got {t.text!r}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.text in ops

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            t = self.peek()
            raise SqlParseError(
                f"expected {op!r} at position {t.pos}, got {t.text!r}")

    def unsupported(self, what: str) -> SqlParseError:
        return SqlParseError(f"{what} at position {self.peek().pos} is not "
                             "supported by this port")

    def parse(self) -> ParsedQuery:
        self.expect_keyword("SELECT")
        distinct = self.accept_keyword("DISTINCT")
        select = self.parse_select_list()
        self.expect_keyword("FROM")
        table = self.parse_identifier_token()
        where = having = None
        group_by: List[Expr] = []
        order_by: List[OrderByExpr] = []
        limit, offset = 10, 0
        options: Dict[str, str] = {}
        if self.accept_keyword("WHERE"):
            where = self.parse_or()
        if self.accept_keyword("GROUP"):
            self.expect_keyword("BY")
            group_by = self.parse_expr_list()
        if self.accept_keyword("HAVING"):
            having = self.parse_or()
        if self.accept_keyword("ORDER"):
            self.expect_keyword("BY")
            order_by = self.parse_order_list()
        if self.accept_keyword("LIMIT"):
            a = self.parse_int()
            if self.accept_op(","):
                offset, limit = a, self.parse_int()  # LIMIT offset, n
            elif self.accept_keyword("OFFSET"):
                limit, offset = a, self.parse_int()
            else:
                limit = a
        if self.accept_keyword("OPTION"):
            self.expect_op("(")
            while not self.accept_op(")"):
                k = self.next().text
                self.expect_op("=")
                v = self.next().text
                if v.startswith("'"):
                    v = v[1:-1].replace("''", "'")
                options[k] = v
                self.accept_op(",")
        self.accept_op(";")
        t = self.peek()
        if t.kind != "eof":
            raise SqlParseError(
                f"unexpected trailing input at position {t.pos}: {t.text!r}")
        return ParsedQuery(table=table, select=select, distinct=distinct,
                           where=where, group_by=group_by, having=having,
                           order_by=order_by, limit=limit, offset=offset,
                           options=options)

    def parse_identifier_token(self) -> str:
        t = self.next()
        if t.kind == "qident":
            return t.text[1:-1].replace('""', '"')
        if t.kind == "ident" and t.upper not in _KEYWORDS:
            return t.text
        raise SqlParseError(
            f"expected identifier at position {t.pos}, got {t.text!r}")

    def parse_int(self) -> int:
        t = self.next()
        if t.kind != "number" or not t.text.isdigit():
            raise SqlParseError(
                f"expected integer at position {t.pos}, got {t.text!r}")
        return int(t.text)

    def parse_select_list(self) -> List[Tuple[Expr, Optional[str]]]:
        items: List[Tuple[Expr, Optional[str]]] = []
        while True:
            expr = self.parse_expr()
            alias = None
            if self.accept_keyword("AS"):
                alias = self.parse_identifier_token()
            elif (self.peek().kind in ("ident", "qident")
                  and self.peek().upper not in _KEYWORDS):
                alias = self.parse_identifier_token()
            items.append((expr, alias))
            if not self.accept_op(","):
                return items

    def parse_expr_list(self) -> List[Expr]:
        out = [self.parse_expr()]
        while self.accept_op(","):
            out.append(self.parse_expr())
        return out

    def parse_order_list(self) -> List[OrderByExpr]:
        out = []
        while True:
            e = self.parse_expr()
            asc = not self.accept_keyword("DESC")
            if asc:
                self.accept_keyword("ASC")
            out.append(OrderByExpr(e, asc))
            if not self.accept_op(","):
                return out

    # -- boolean expressions -------------------------------------------------
    def parse_or(self) -> FilterNode:
        children = [self.parse_and()]
        while self.accept_keyword("OR"):
            children.append(self.parse_and())
        return children[0] if len(children) == 1 else FilterNode.or_(children)

    def parse_and(self) -> FilterNode:
        children = [self.parse_not()]
        while self.accept_keyword("AND"):
            children.append(self.parse_not())
        return children[0] if len(children) == 1 else FilterNode.and_(children)

    def parse_not(self) -> FilterNode:
        if self.accept_keyword("NOT"):
            return FilterNode.not_(self.parse_not())
        if self.at_op("("):
            # a parenthesised boolean group, or arithmetic that starts the
            # left-hand side of a predicate: try the group, else backtrack
            save = self.i
            try:
                self.expect_op("(")
                node = self.parse_or()
                self.expect_op(")")
                if not (self.at_op("=", "!=", "<>", "<", "<=", ">", ">=",
                                   "+", "-", "*", "/", "%")
                        or self.at_keyword("BETWEEN", "IN", "LIKE", "IS",
                                           "NOT")):
                    return node
            except SqlParseError:
                pass
            self.i = save
        return self.parse_predicate()

    def parse_predicate(self) -> FilterNode:
        lhs = self.parse_expr()
        # function-call predicates: regexp_like(col, 're'), text_match(...)
        if isinstance(lhs, Function) and lhs.name in _PREDICATE_FUNCTIONS:
            if len(lhs.args) != 2 or not isinstance(lhs.args[1], Literal):
                raise SqlParseError(f"{lhs.name} expects (expr, literal)")
            return FilterNode.pred(Predicate(
                _PREDICATE_FUNCTIONS[lhs.name], lhs.args[0],
                values=(lhs.args[1].value,)))
        negate = self.accept_keyword("NOT")
        if self.accept_keyword("IN"):
            self.expect_op("(")
            values = [self.parse_literal_value()]
            while self.accept_op(","):
                values.append(self.parse_literal_value())
            self.expect_op(")")
            ptype = PredicateType.NOT_IN if negate else PredicateType.IN
            return FilterNode.pred(Predicate(ptype, lhs, values=tuple(values)))
        if self.accept_keyword("BETWEEN"):
            lo = self.parse_literal_value()
            self.expect_keyword("AND")
            hi = self.parse_literal_value()
            node = FilterNode.pred(Predicate(
                PredicateType.RANGE, lhs, lower=lo, upper=hi,
                lower_inclusive=True, upper_inclusive=True))
            return FilterNode.not_(node) if negate else node
        if self.accept_keyword("LIKE"):
            node = FilterNode.pred(Predicate(
                PredicateType.LIKE, lhs, values=(self.parse_literal_value(),)))
            return FilterNode.not_(node) if negate else node
        if negate:
            raise SqlParseError("expected IN/BETWEEN/LIKE after NOT")
        if self.accept_keyword("IS"):
            is_not = self.accept_keyword("NOT")
            self.expect_keyword("NULL")
            return FilterNode.pred(Predicate(
                PredicateType.IS_NOT_NULL if is_not else PredicateType.IS_NULL,
                lhs))
        for op in ("=", "!=", "<>", "<=", ">=", "<", ">"):
            if self.accept_op(op):
                return self._comparison(op, lhs, self.parse_expr())
        raise SqlParseError(
            f"expected predicate operator at position {self.peek().pos}, "
            f"got {self.peek().text!r}")

    _SWAP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}

    def _comparison(self, op: str, lhs: Expr, rhs: Expr) -> FilterNode:
        lhs, rhs = fold_constants(lhs), fold_constants(rhs)
        if isinstance(lhs, Literal) and not isinstance(rhs, Literal):
            lhs, rhs = rhs, lhs
            op = self._SWAP.get(op, op)
        if not isinstance(rhs, Literal):
            raise SqlParseError(
                f"comparison right-hand side must be a literal, got {rhs}")
        v = rhs.value
        if op == "=":
            return FilterNode.pred(Predicate(PredicateType.EQ, lhs, values=(v,)))
        if op in ("!=", "<>"):
            return FilterNode.pred(
                Predicate(PredicateType.NOT_EQ, lhs, values=(v,)))
        return FilterNode.pred(Predicate(
            PredicateType.RANGE, lhs,
            lower=v if op in (">", ">=") else None,
            upper=v if op in ("<", "<=") else None,
            lower_inclusive=op == ">=", upper_inclusive=op == "<="))

    def parse_literal_value(self) -> Any:
        e = fold_constants(self.parse_expr())
        if not isinstance(e, Literal):
            raise SqlParseError(f"expected literal, got {e}")
        return e.value

    # -- value expressions ---------------------------------------------------
    def parse_expr(self) -> Expr:
        left = self.parse_mul()
        while self.at_op("+", "-"):
            op = self.next().text
            left = Function("plus" if op == "+" else "minus",
                            (left, self.parse_mul()))
        return left

    def parse_mul(self) -> Expr:
        left = self.parse_unary()
        while self.at_op("*", "/", "%"):
            name = {"*": "times", "/": "divide", "%": "mod"}[self.next().text]
            left = Function(name, (left, self.parse_unary()))
        return left

    def parse_unary(self) -> Expr:
        if self.accept_op("-"):
            inner = self.parse_unary()
            if isinstance(inner, Literal) and isinstance(inner.value,
                                                         (int, float)):
                return Literal(-inner.value)
            return Function("minus", (Literal(0), inner))
        return self.parse_primary()

    def parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "number":
            self.next()
            if "." in t.text or "e" in t.text.lower():
                return Literal(float(t.text))
            return Literal(int(t.text))
        if t.kind == "string":
            self.next()
            return Literal(t.text[1:-1].replace("''", "'"))
        if t.kind == "op" and t.text == "(":
            self.next()
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "op" and t.text == "*":
            self.next()
            return STAR
        if t.kind == "qident":
            self.next()
            return Identifier(t.text[1:-1].replace('""', '"'))
        if t.kind == "ident":
            if t.upper in _KEYWORDS:
                raise self.unsupported(f"keyword {t.upper}")
            self.next()
            if self.at_op("("):
                return self.parse_function_call(t.text)
            return Identifier(t.text)
        raise SqlParseError(f"unexpected token {t.text!r} at position {t.pos}")

    def parse_function_call(self, name: str) -> Expr:
        self.expect_op("(")
        if self.accept_op(")"):
            return Function(name, ())
        if self.accept_keyword("DISTINCT"):
            # COUNT(DISTINCT x) -> distinctcount(x)
            args = self.parse_expr_list()
            self.expect_op(")")
            if name.lower() == "count":
                return Function("distinctcount", args)
            raise SqlParseError(f"DISTINCT not supported inside {name}")
        args = self.parse_expr_list()
        self.expect_op(")")
        return Function(name, args)


_EXPLAIN_RE = re.compile(r"^\s*EXPLAIN\s+PLAN\s+FOR\s+", re.I)


def parse_sql(sql: str) -> ParsedQuery:
    text = sql.strip()
    m = _EXPLAIN_RE.match(text)
    if m is not None:
        text = text[m.end():]
    q = _Parser(text).parse()
    q.explain = m is not None
    return q


def parse_expression(text: str) -> Expr:
    """A standalone value expression (a star-tree pair's column half,
    ``lo_extendedprice*lo_discount``)."""
    p = _Parser(text.strip())
    e = p.parse_expr()
    if p.peek().kind != "eof":
        raise SqlParseError(f"trailing input in expression: {text!r}")
    return e


def parse_filter_expression(text: str) -> FilterNode:
    """A standalone boolean expression (an ingestion filter config's
    ``filterFunction``; JAX ``parser.py:544``)."""
    p = _Parser(text.strip())
    node = p.parse_or()
    if p.peek().kind != "eof":
        raise SqlParseError(f"trailing input in filter: {text!r}")
    return node

