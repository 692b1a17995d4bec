"""PromQL parser: text -> LogicalPlan.

Replaces the reference's packrat-combinator Parser + AST + toSeriesPlan
walk (reference: prometheus/.../parse/Parser.scala:375-426, ast/Vectors.scala,
ast/Expressions.scala:120).  Hand-written lexer + Pratt parser; the AST *is*
the LogicalPlan (no separate tree), built with the same range semantics:
selectors get a lookback window (staleness default 5m), windowed functions
read [start - window - offset, end].
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from filodb_tpu_torch.core.filters import (ColumnFilter, Equals, EqualsRegex,
                                     NotEquals, NotEqualsRegex)
from filodb_tpu_torch.query.logical import (Aggregate, AggregationOperator,
                                      ApplyAbsentFunction,
                                      ApplyInstantFunction,
                                      ApplyMiscellaneousFunction,
                                      ApplySortFunction, BinaryJoin,
                                      BinaryOperator, Cardinality,
                                      InstantFunctionId, IntervalSelector,
                                      LogicalPlan, MiscellaneousFunctionId,
                                      PeriodicSeries,
                                      PeriodicSeriesPlan,
                                      PeriodicSeriesWithWindowing,
                                      RangeFunctionId, RawSeries,
                                      ScalarBinaryOperation,
                                      ScalarFixedDoublePlan, ScalarFunctionId,
                                      ScalarPlan, ScalarTimeBasedPlan,
                                      ScalarVaryingDoublePlan,
                                      ScalarVectorBinaryOperation,
                                      SortFunctionId, VectorPlan)

STALENESS_MS = 300_000  # Prometheus 5m lookback (reference: WindowConstants)
METRIC_COL = "_metric_"


class ParseError(Exception):
    pass


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<WS>\s+)
  | (?P<DURATION>[0-9]+(?:\.[0-9]+)?(?:ms|s|m|h|d|w|y)(?:[0-9]+(?:ms|s|m|h|d|w|y))*)
  | (?P<NUMBER>(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)(?:[eE][+-]?[0-9]+)?|0x[0-9a-fA-F]+|(?:[Ii]nf|NaN)(?![a-zA-Z0-9_:.]))
  | (?P<STRING>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<OP>=~|!~|!=|==|>=|<=|->|[\[\]{}()+\-*/%^,=<>:@])
  | (?P<IDENT>[a-zA-Z_:][a-zA-Z0-9_:.]*)
""", re.VERBOSE)

_DUR_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, "d": 86_400_000,
           "w": 7 * 86_400_000, "y": 365 * 86_400_000}
_DUR_PART = re.compile(r"([0-9]+(?:\.[0-9]+)?)(ms|s|m|h|d|w|y)")


def duration_ms(text: str) -> int:
    parts = _DUR_PART.findall(text)
    if not parts or "".join(n + u for n, u in parts) != text:
        raise ParseError(f"invalid duration {text!r}")
    return int(sum(float(n) * _DUR_MS[u] for n, u in parts))


@dataclasses.dataclass
class Token:
    kind: str
    text: str
    pos: int


def tokenize(query: str) -> list[Token]:
    out = []
    pos = 0
    while pos < len(query):
        m = _TOKEN_RE.match(query, pos)
        if not m:
            raise ParseError(f"unexpected character {query[pos]!r} at {pos}")
        kind = m.lastgroup
        if kind != "WS":
            out.append(Token(kind, m.group(), pos))
        pos = m.end()
    return out


# ---------------------------------------------------------------------------
# Function tables
# ---------------------------------------------------------------------------

_RANGE_FNS = {f.value: f for f in RangeFunctionId}
_RANGE_FNS["last_over_time"] = RangeFunctionId.LAST_OVER_TIME
_INSTANT_FNS = {f.value: f for f in InstantFunctionId}
_AGG_OPS = {o.value: o for o in AggregationOperator}
_MISC_FNS = {f.value: f for f in MiscellaneousFunctionId}
_SORT_FNS = {f.value: f for f in SortFunctionId}
_TIME_FNS = {"time", "hour", "minute", "month", "year", "day_of_month",
             "day_of_week", "days_in_month"}
_CMP_OPS = {"==": BinaryOperator.EQL, "!=": BinaryOperator.NEQ,
            ">": BinaryOperator.GTR, "<": BinaryOperator.LSS,
            ">=": BinaryOperator.GTE, "<=": BinaryOperator.LTE}

# precedence (Prometheus): or < and/unless < comparison < +- < */% < ^
_PRECEDENCE = {
    "or": 1,
    "and": 2, "unless": 2,
    "==": 3, "!=": 3, ">": 3, "<": 3, ">=": 3, "<=": 3,
    "+": 4, "-": 4,
    "*": 5, "/": 5, "%": 5,
    "^": 6,
}
_RIGHT_ASSOC = {"^"}


def _binop(text: str) -> BinaryOperator:
    return _CMP_OPS.get(text) or BinaryOperator(text)


# ---------------------------------------------------------------------------
# AST (thin, desugared into LogicalPlan at build time)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Selector:
    metric: Optional[str]
    matchers: list[tuple[str, str, str]]   # (label, op, value)
    window_ms: Optional[int] = None
    offset_ms: int = 0
    at_ms: Optional[int] = None

    def filters(self) -> tuple[ColumnFilter, ...]:
        out = []
        if self.metric is not None:
            out.append(ColumnFilter(METRIC_COL, Equals(self.metric)))
        for label, op, value in self.matchers:
            col = METRIC_COL if label == "__name__" else label
            if op == "=":
                out.append(ColumnFilter(col, Equals(value)))
            elif op == "!=":
                out.append(ColumnFilter(col, NotEquals(value)))
            elif op == "=~":
                out.append(ColumnFilter(col, EqualsRegex(value)))
            elif op == "!~":
                out.append(ColumnFilter(col, NotEqualsRegex(value)))
        return tuple(out)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

class Parser:
    """One instance per query; ``start/step/end`` (ms) fix the output grid
    (instant query = start == end, one step)."""

    def __init__(self, tokens: list[Token], start_ms: int, step_ms: int,
                 end_ms: int):
        self.toks = tokens
        self.i = 0
        self.start = start_ms
        self.step = max(step_ms, 1)
        self.end = end_ms

    # -- token helpers ------------------------------------------------------

    def peek(self, offset: int = 0) -> Optional[Token]:
        j = self.i + offset
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> Token:
        t = self.peek()
        if t is None:
            raise ParseError("unexpected end of query")
        self.i += 1
        return t

    def expect(self, text: str) -> Token:
        t = self.next()
        if t.text != text:
            raise ParseError(f"expected {text!r}, got {t.text!r} at {t.pos}")
        return t

    def at(self, text: str) -> bool:
        t = self.peek()
        return t is not None and t.text == text

    # -- grammar ------------------------------------------------------------

    def parse(self) -> LogicalPlan:
        plan = self.expr(0)
        if self.peek() is not None:
            t = self.peek()
            raise ParseError(f"unexpected token {t.text!r} at {t.pos}")
        return plan

    def expr(self, min_prec: int) -> LogicalPlan:
        lhs = self.unary()
        while True:
            t = self.peek()
            if t is None or t.text not in _PRECEDENCE:
                break
            prec = _PRECEDENCE[t.text]
            if prec < min_prec:
                break
            op_text = self.next().text
            bool_mode = False
            if self.at("bool"):
                self.next()
                bool_mode = True
            on, ignoring, include = (), (), ()
            card = Cardinality.ONE_TO_ONE
            use_on = False
            if self.peek() is not None and self.peek().text in ("on", "ignoring"):
                use_on = self.next().text == "on"
                names = self.name_list()
                if use_on:
                    on = names
                else:
                    ignoring = names
                if self.peek() is not None and self.peek().text in (
                        "group_left", "group_right"):
                    side = self.next().text
                    card = (Cardinality.MANY_TO_ONE if side == "group_left"
                            else Cardinality.ONE_TO_MANY)
                    if self.at("("):
                        include = self.name_list()
            next_min = prec + 1 if op_text not in _RIGHT_ASSOC else prec
            rhs = self.expr(next_min)
            lhs = self.combine(op_text, lhs, rhs, bool_mode, on, ignoring,
                               include, card)
        return lhs

    def unary(self) -> LogicalPlan:
        if self.at("-") or self.at("+"):
            neg = self.next().text == "-"
            # '^' binds tighter than unary minus (Prometheus: -2^2 == -(2^2))
            operand = self.expr(_PRECEDENCE["^"])
            if not neg:
                return operand
            zero = ScalarFixedDoublePlan(0.0, self.start, self.step, self.end)
            if isinstance(operand, ScalarPlan):
                return ScalarBinaryOperation(BinaryOperator.SUB, 0.0, operand,
                                             self.start, self.step, self.end)
            return ScalarVectorBinaryOperation(BinaryOperator.SUB, zero,
                                               operand, scalar_is_lhs=True)
        return self.postfix(self.atom())

    def postfix(self, plan: LogicalPlan) -> LogicalPlan:
        return plan

    def atom(self) -> LogicalPlan:
        t = self.peek()
        if t is None:
            raise ParseError("unexpected end of query")
        if t.kind == "NUMBER":
            self.next()
            return ScalarFixedDoublePlan(_number(t.text), self.start,
                                         self.step, self.end)
        if t.kind == "STRING":
            raise ParseError("string literal not valid as expression")
        if t.text == "(":
            self.next()
            inner = self.expr(0)
            self.expect(")")
            return inner
        if t.kind in ("IDENT",) or t.text == "{":
            return self.ident_or_call()
        raise ParseError(f"unexpected token {t.text!r} at {t.pos}")

    def ident_or_call(self) -> LogicalPlan:
        t = self.peek()
        name = t.text if t.kind == "IDENT" else None
        nxt = self.peek(1)
        if name is not None and nxt is not None and nxt.text == "(" and (
                name in _RANGE_FNS or name in _INSTANT_FNS or name in _AGG_OPS
                or name in _MISC_FNS or name in _SORT_FNS or name in _TIME_FNS
                or name in ("scalar", "vector", "absent", "rate", "label_replace")):
            if name in _AGG_OPS:
                return self.aggregation(name)
            return self.call(name)
        if name is not None and nxt is not None and nxt.text in ("by", "without") \
                and name in _AGG_OPS:
            return self.aggregation(name)
        # vector selector
        return self.selector_plan()

    # -- selectors ----------------------------------------------------------

    def selector(self) -> Selector:
        metric = None
        t = self.peek()
        if t is not None and t.kind == "IDENT":
            metric = self.next().text
        matchers: list[tuple[str, str, str]] = []
        if self.at("{"):
            self.next()
            while not self.at("}"):
                label = self.next().text
                op = self.next().text
                if op not in ("=", "!=", "=~", "!~"):
                    raise ParseError(f"bad matcher op {op!r}")
                val = self.string()
                matchers.append((label, op, val))
                if self.at(","):
                    self.next()
            self.expect("}")
        if metric is None and not matchers:
            raise ParseError("empty selector")
        sel = Selector(metric, matchers)
        if self.at("["):
            self.next()
            d = self.next()
            sel.window_ms = duration_ms(d.text)
            self.expect("]")
        sel.offset_ms = self.maybe_offset()
        return sel

    def maybe_offset(self) -> int:
        if self.at("offset"):
            self.next()
            neg = False
            if self.at("-"):
                self.next()
                neg = True
            d = duration_ms(self.next().text)
            return -d if neg else d
        return 0

    def selector_plan(self) -> PeriodicSeriesPlan:
        sel = self.selector()
        if sel.window_ms is not None:
            raise ParseError("range vector must be wrapped in a range function")
        return self.instant_vector(sel)

    def instant_vector(self, sel: Selector) -> PeriodicSeries:
        lookback = STALENESS_MS
        raw = RawSeries(
            IntervalSelector(self.start - lookback - sel.offset_ms,
                             self.end - sel.offset_ms),
            sel.filters(), lookback_ms=lookback,
            offset_ms=sel.offset_ms or None)
        return PeriodicSeries(raw, self.start, self.step, self.end,
                              offset_ms=sel.offset_ms or None)

    def windowed(self, sel: Selector, fn: RangeFunctionId,
                 args: tuple = ()) -> PeriodicSeriesWithWindowing:
        if sel.window_ms is None:
            raise ParseError(f"{fn.value} needs a range vector [duration]")
        raw = RawSeries(
            IntervalSelector(self.start - sel.window_ms - sel.offset_ms,
                             self.end - sel.offset_ms),
            sel.filters(), lookback_ms=sel.window_ms,
            offset_ms=sel.offset_ms or None)
        return PeriodicSeriesWithWindowing(
            raw, self.start, self.step, self.end, sel.window_ms, fn,
            function_args=args, offset_ms=sel.offset_ms or None)

    # -- calls --------------------------------------------------------------

    def call(self, name: str) -> LogicalPlan:
        self.next()  # name
        self.expect("(")
        # zero-arg time functions (hour(), month(), ...) must win over their
        # one-arg instant-function forms, which share the same names
        if name in _TIME_FNS and self.at(")"):
            self.next()
            return ScalarTimeBasedPlan(ScalarFunctionId(name), self.start,
                                       self.step, self.end)
        if name in _RANGE_FNS:
            fn = _RANGE_FNS[name]
            # arg layouts: quantile_over_time(q, sel[w]) / holt_winters(sel, sf, tf)
            pre_args: list = []
            if name == "quantile_over_time":
                pre_args.append(self.number_arg())
                self.expect(",")
            sel = self.selector()
            post_args: list = []
            while self.at(","):
                self.next()
                post_args.append(self.number_arg())
            self.expect(")")
            if fn == RangeFunctionId.LAST_OVER_TIME:
                # last_over_time == default instant selection over [w]
                raw = RawSeries(
                    IntervalSelector(self.start - sel.window_ms - sel.offset_ms,
                                     self.end - sel.offset_ms),
                    sel.filters(), lookback_ms=sel.window_ms,
                    offset_ms=sel.offset_ms or None)
                return PeriodicSeries(raw, self.start, self.step, self.end,
                                      offset_ms=sel.offset_ms or None)
            return self.windowed(sel, fn, tuple(pre_args + post_args))
        if name in _INSTANT_FNS:
            fn = _INSTANT_FNS[name]
            pre: list = []
            if name in ("histogram_quantile", "histogram_max_quantile",
                        "histogram_bucket"):
                pre.append(self.number_arg())
                self.expect(",")
            vec = self.expr(0)
            post: list = []
            while self.at(","):
                self.next()
                post.append(self.number_arg())
            self.expect(")")
            if name == "round" and post:
                args = tuple(post)
            else:
                args = tuple(pre + post)
            return ApplyInstantFunction(vec, fn, args)
        if name in _MISC_FNS:
            vec = self.expr(0)
            args: list[str] = []
            while self.at(","):
                self.next()
                args.append(self.string())
            self.expect(")")
            return ApplyMiscellaneousFunction(vec, _MISC_FNS[name], tuple(args))
        if name in _SORT_FNS:
            vec = self.expr(0)
            self.expect(")")
            return ApplySortFunction(vec, _SORT_FNS[name])
        if name == "absent":
            vec = self.expr(0)
            self.expect(")")
            filters = ()
            from filodb_tpu_torch.query.logical import leaf_raw_series
            leaves = leaf_raw_series(vec)
            if leaves:
                filters = leaves[0].filters
            return ApplyAbsentFunction(vec, filters, self.start, self.step,
                                       self.end)
        if name == "scalar":
            vec = self.expr(0)
            self.expect(")")
            return ScalarVaryingDoublePlan(vec)
        if name == "vector":
            inner = self.expr(0)
            self.expect(")")
            if not isinstance(inner, ScalarPlan):
                raise ParseError("vector() takes a scalar expression")
            return VectorPlan(inner)
        if name in _TIME_FNS:
            if self.at(")"):
                self.next()
                return ScalarTimeBasedPlan(ScalarFunctionId(name), self.start,
                                           self.step, self.end)
            vec = self.expr(0)
            self.expect(")")
            return ApplyInstantFunction(vec, InstantFunctionId(name))
        raise ParseError(f"unknown function {name!r}")

    def aggregation(self, name: str) -> Aggregate:
        op = _AGG_OPS[name]
        self.next()  # name
        by, without = (), ()
        if self.peek() is not None and self.peek().text in ("by", "without"):
            which = self.next().text
            names = self.name_list()
            if which == "by":
                by = names
            else:
                without = names
        self.expect("(")
        params: list = []
        if op in (AggregationOperator.TOPK, AggregationOperator.BOTTOMK,
                  AggregationOperator.QUANTILE):
            params.append(self.number_arg())
            self.expect(",")
        elif op == AggregationOperator.COUNT_VALUES:
            params.append(self.string())
            self.expect(",")
        vec = self.expr(0)
        self.expect(")")
        if not (by or without) and self.peek() is not None \
                and self.peek().text in ("by", "without"):
            which = self.next().text
            names = self.name_list()
            if which == "by":
                by = names
            else:
                without = names
        return Aggregate(op, vec, tuple(params), by, without)

    # -- small pieces -------------------------------------------------------

    def name_list(self) -> tuple[str, ...]:
        self.expect("(")
        names = []
        while not self.at(")"):
            names.append(self.next().text)
            if self.at(","):
                self.next()
        self.expect(")")
        return tuple(names)

    def number_arg(self) -> float:
        neg = False
        if self.at("-"):
            self.next()
            neg = True
        t = self.next()
        if t.kind != "NUMBER":
            raise ParseError(f"expected number, got {t.text!r}")
        v = _number(t.text)
        return -v if neg else v

    def string(self) -> str:
        t = self.next()
        if t.kind != "STRING":
            raise ParseError(f"expected string, got {t.text!r}")
        return _unescape(t.text[1:-1])

    # -- binary combination -------------------------------------------------

    def combine(self, op_text: str, lhs: LogicalPlan, rhs: LogicalPlan,
                bool_mode: bool, on, ignoring, include,
                card: Cardinality) -> LogicalPlan:
        op = _binop(op_text)
        lhs_scalar = isinstance(lhs, ScalarPlan)
        rhs_scalar = isinstance(rhs, ScalarPlan)
        if lhs_scalar and rhs_scalar:
            return ScalarBinaryOperation(op, _fold(lhs), _fold(rhs),
                                         self.start, self.step, self.end)
        if lhs_scalar or rhs_scalar:
            if op.is_set_op:
                raise ParseError(f"set operator {op.value} requires vectors")
            scalar = lhs if lhs_scalar else rhs
            vector = rhs if lhs_scalar else lhs
            return ScalarVectorBinaryOperation(op, scalar, vector,
                                               scalar_is_lhs=lhs_scalar,
                                               bool_mode=bool_mode)
        return BinaryJoin(lhs, op, card, rhs, on, ignoring, include,
                          bool_mode=bool_mode)


def _fold(p: ScalarPlan):
    if isinstance(p, ScalarFixedDoublePlan):
        return p.scalar
    return p


_ESC_RE = re.compile(
    r"\\(u[0-9a-fA-F]{4}|U[0-9a-fA-F]{8}|x[0-9a-fA-F]{2}|[0-7]{1,3}|.)",
    re.DOTALL)
_ESC_MAP = {"n": "\n", "t": "\t", "r": "\r", "a": "\a", "b": "\b",
            "f": "\f", "v": "\v", "\\": "\\", '"': '"', "'": "'"}


def _unescape(body: str) -> str:
    """Decode PromQL string escapes without mangling non-ASCII text (a
    unicode_escape round-trip would read UTF-8 bytes as latin-1)."""
    def repl(m: "re.Match[str]") -> str:
        s = m.group(1)
        if s[0] in "uUx":
            return chr(int(s[1:], 16))
        if s[0] in "01234567":
            return chr(int(s, 8))
        return _ESC_MAP.get(s, s)
    return _ESC_RE.sub(repl, body)


def _number(text: str) -> float:
    t = text.lower()
    if t in ("inf", "+inf"):
        return float("inf")
    if t == "-inf":
        return float("-inf")
    if t == "nan":
        return float("nan")
    if t.startswith("0x"):
        return float(int(t, 16))
    return float(text)


# ---------------------------------------------------------------------------
# Public API (reference: Parser.queryToLogicalPlan / queryRangeToLogicalPlan,
# Parser.scala:402-426)
# ---------------------------------------------------------------------------

def parse_query(query: str, start_ms: int, step_ms: int,
                end_ms: int) -> LogicalPlan:
    return Parser(tokenize(query), start_ms, step_ms, end_ms).parse()


def query_to_logical_plan(query: str, time_ms: int) -> LogicalPlan:
    """Instant query at one evaluation timestamp."""
    return parse_query(query, time_ms, 1000, time_ms)


def query_range_to_logical_plan(query: str, start_ms: int, step_ms: int,
                                end_ms: int) -> LogicalPlan:
    return parse_query(query, start_ms, step_ms, end_ms)


def parse_selector(text: str) -> tuple[ColumnFilter, ...]:
    """A bare series selector (e.g. ``up{job="api"}``) -> column filters;
    the /api/v1/series match[] parameter (reference:
    Parser.metadataQueryToLogicalPlan)."""
    p = Parser(tokenize(text), 0, 1000, 0)
    sel = p.selector()
    if p.peek() is not None:
        raise ParseError(f"unexpected trailing tokens in selector {text!r}")
    return sel.filters()
