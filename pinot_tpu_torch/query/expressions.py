"""Expression + filter AST.

Counterpart of ``pinot_tpu/query/expressions.py``: a small hashable AST the
planner compiles into scan programs. Operators are canonical function calls
(``a + b`` is ``plus(a, b)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, List, Optional, Tuple


class Expr:
    def columns(self) -> List[str]:
        """All identifier names referenced."""
        out: List[str] = []
        self._collect_columns(out)
        return out

    def _collect_columns(self, out: List[str]) -> None:
        pass


@dataclass(frozen=True)
class Identifier(Expr):
    name: str

    def _collect_columns(self, out: List[str]) -> None:
        out.append(self.name)

    def __str__(self) -> str:
        return self.name


@dataclass(frozen=True)
class Literal(Expr):
    value: Any  # int | float | str | bool

    def __str__(self) -> str:
        if isinstance(self.value, str):
            escaped = self.value.replace("'", "''")
            return f"'{escaped}'"
        return str(self.value)


@dataclass(frozen=True)
class Function(Expr):
    name: str  # canonical lower-case name
    args: Tuple[Expr, ...]

    def __init__(self, name: str, args):
        object.__setattr__(self, "name", name.lower())
        object.__setattr__(self, "args", tuple(args))

    def _collect_columns(self, out: List[str]) -> None:
        for a in self.args:
            a._collect_columns(out)

    def __str__(self) -> str:
        return f"{self.name}({','.join(str(a) for a in self.args)})"


STAR = Identifier("*")

_FOLDABLE = {
    "plus": lambda a, b: a + b,
    "minus": lambda a, b: a - b,
    "times": lambda a, b: a * b,
    "divide": lambda a, b: a / b,
    "mod": lambda a, b: a % b,
}


def fold_constants(expr: Expr) -> Expr:
    """Evaluate literal-only arithmetic sub-trees."""
    if not isinstance(expr, Function):
        return expr
    args = tuple(fold_constants(a) for a in expr.args)
    expr = Function(expr.name, args)
    fn = _FOLDABLE.get(expr.name)
    if fn is not None and all(isinstance(a, Literal)
                              and isinstance(a.value, (int, float, bool))
                              for a in args):
        try:
            return Literal(fn(args[0].value, args[1].value))
        except ZeroDivisionError:
            return expr
    return expr


# the operators of a star-tree derived pair; division is left out, as in
# the JAX package: it breaks the exact integer sums the tree stores
_ARITH_KEY_OPS = {"plus": "+", "minus": "-", "times": "*"}
_ARITH_COMMUTATIVE = {"plus", "times"}


def canonical_arith_key(e: Expr) -> Optional[str]:
    """The star-tree pair key of a ``+ - *`` expression over identifiers
    and numeric literals (JAX ``expressions.py:114``): a bare identifier
    is its name, a binary operation ``(a*b)`` with the operands of ``+``
    and ``*`` sorted, so ``sum(a * b)`` and ``SUM__b*a`` name one pair.
    None for anything else (division, transforms, virtual columns)."""
    if isinstance(e, Identifier):
        if e.name == "*" or e.name.startswith("$"):
            return None
        return e.name
    if isinstance(e, Literal):
        if isinstance(e.value, bool) or not isinstance(e.value, (int, float)):
            return None
        return str(e.value)
    if isinstance(e, Function):
        sym = _ARITH_KEY_OPS.get(e.name)
        if sym is None or len(e.args) != 2:
            return None
        parts = [canonical_arith_key(a) for a in e.args]
        if any(p is None for p in parts):
            return None
        if e.name in _ARITH_COMMUTATIVE:
            parts.sort()
        return f"({parts[0]}{sym}{parts[1]})"
    return None


class PredicateType(Enum):
    EQ = "EQ"
    NOT_EQ = "NOT_EQ"
    IN = "IN"
    NOT_IN = "NOT_IN"
    RANGE = "RANGE"
    REGEXP_LIKE = "REGEXP_LIKE"
    LIKE = "LIKE"            # rewritten to REGEXP_LIKE by the optimizer
    TEXT_MATCH = "TEXT_MATCH"
    JSON_MATCH = "JSON_MATCH"
    IS_NULL = "IS_NULL"
    IS_NOT_NULL = "IS_NOT_NULL"


@dataclass(frozen=True)
class Predicate:
    """Leaf predicate. RANGE uses (lower, upper, inclusive flags) with None
    for an open end: the single form of >, >=, <, <= and BETWEEN."""

    type: PredicateType
    lhs: Expr
    values: Tuple[Any, ...] = ()
    lower: Any = None
    upper: Any = None
    lower_inclusive: bool = False
    upper_inclusive: bool = False

    @property
    def value(self) -> Any:
        return self.values[0] if self.values else None

    def __str__(self) -> str:
        t = self.type
        if t in (PredicateType.EQ, PredicateType.NOT_EQ):
            op = "=" if t is PredicateType.EQ else "!="
            return f"{self.lhs} {op} {self.value!r}"
        if t in (PredicateType.IN, PredicateType.NOT_IN):
            return f"{self.lhs} {t.value} {self.values!r}"
        if t in (PredicateType.IS_NULL, PredicateType.IS_NOT_NULL):
            return f"{self.lhs} {t.value}"
        if t is PredicateType.RANGE:
            lb = "[" if self.lower_inclusive else "("
            ub = "]" if self.upper_inclusive else ")"
            lo = "*" if self.lower is None else repr(self.lower)
            hi = "*" if self.upper is None else repr(self.upper)
            return f"{self.lhs} IN {lb}{lo},{hi}{ub}"
        return f"{t.value}({self.lhs}, {self.values!r})"


class FilterOp(Enum):
    AND = "AND"
    OR = "OR"
    NOT = "NOT"
    PREDICATE = "PREDICATE"


@dataclass(frozen=True)
class FilterNode:
    """AND/OR/NOT tree with Predicate leaves."""

    op: FilterOp
    children: Tuple["FilterNode", ...] = ()
    predicate: Optional[Predicate] = None

    def __init__(self, op: FilterOp, children=(),
                 predicate: Optional[Predicate] = None):
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "children", tuple(children))
        object.__setattr__(self, "predicate", predicate)

    @classmethod
    def pred(cls, predicate: Predicate) -> "FilterNode":
        return cls(FilterOp.PREDICATE, predicate=predicate)

    @classmethod
    def and_(cls, children) -> "FilterNode":
        return cls(FilterOp.AND, children=children)

    @classmethod
    def or_(cls, children) -> "FilterNode":
        return cls(FilterOp.OR, children=children)

    @classmethod
    def not_(cls, child: "FilterNode") -> "FilterNode":
        return cls(FilterOp.NOT, children=(child,))

    def columns(self) -> List[str]:
        out: List[str] = []
        if self.predicate is not None:
            out.extend(self.predicate.lhs.columns())
        for c in self.children:
            out.extend(c.columns())
        return out

    def predicates(self) -> List[Predicate]:
        out: List[Predicate] = []
        if self.predicate is not None:
            out.append(self.predicate)
        for c in self.children:
            out.extend(c.predicates())
        return out

    def __str__(self) -> str:
        if self.op is FilterOp.PREDICATE:
            return str(self.predicate)
        if self.op is FilterOp.NOT:
            return f"NOT ({self.children[0]})"
        sep = f" {self.op.value} "
        return "(" + sep.join(str(c) for c in self.children) + ")"


@dataclass(frozen=True)
class OrderByExpr:
    expr: Expr
    ascending: bool = True

    def __str__(self) -> str:
        return f"{self.expr} {'ASC' if self.ascending else 'DESC'}"
