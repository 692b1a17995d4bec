"""Instant (sample-wise) functions and binary operators on tensors.

Replaces the reference's InstantFunction family and ScalarOperationMapper
math (reference: query/exec/rangefn/InstantFunction.scala:81-110,
query/exec/rangefn/BinaryOperatorFunction.scala).  All are elementwise
torch ops over ``[S, T]`` tensors on the device the values live on.
"""

from __future__ import annotations

import torch


def _days_in_month(year, month):
    thirty_one = (month == 1) | (month == 3) | (month == 5) | (month == 7) | \
                 (month == 8) | (month == 10) | (month == 12)
    thirty = (month == 4) | (month == 6) | (month == 9) | (month == 11)
    leap = ((year % 4 == 0) & (year % 100 != 0)) | (year % 400 == 0)
    return torch.where(thirty_one, 31, torch.where(
        thirty, 30, torch.where(leap, 29, 28)))


def _fdiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z):
    """days-since-epoch -> (year, month, day); Howard Hinnant's algorithm."""
    z = z + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _secs(v):
    """Whole seconds of ``v`` as int64 (NaN read as 0, masked later)."""
    return torch.where(torch.isnan(v), torch.zeros_like(v), v).to(torch.int64)


def _ymd(v):
    return _civil_from_days(_fdiv(_secs(v), 86400))


def _masked(v, x):
    return torch.where(torch.isnan(v), torch.full_like(v, float("nan")),
                       x.to(v.dtype))


INSTANT_FUNCTIONS = {}


def _register(name):
    def deco(fn):
        INSTANT_FUNCTIONS[name] = fn
        return fn
    return deco


@_register("abs")
def abs_(v):
    return torch.abs(v)


@_register("ceil")
def ceil(v):
    return torch.ceil(v)


@_register("floor")
def floor(v):
    return torch.floor(v)


@_register("exp")
def exp(v):
    return torch.exp(v)


@_register("ln")
def ln(v):
    return torch.log(v)


@_register("log2")
def log2(v):
    return torch.log2(v)


@_register("log10")
def log10(v):
    return torch.log10(v)


@_register("sqrt")
def sqrt(v):
    return torch.sqrt(v)


@_register("round")
def round_(v, to_nearest=1.0):
    # Prometheus round(): halves round up
    return torch.floor(v / to_nearest + 0.5) * to_nearest


@_register("clamp_max")
def clamp_max(v, mx):
    return torch.minimum(v, torch.as_tensor(mx, dtype=v.dtype,
                                            device=v.device))


@_register("clamp_min")
def clamp_min(v, mn):
    return torch.maximum(v, torch.as_tensor(mn, dtype=v.dtype,
                                            device=v.device))


@_register("sgn")
def sgn(v):
    return torch.where(torch.isnan(v), v, torch.sign(v))


@_register("year")
def year(v):
    return _masked(v, _ymd(v)[0])


@_register("month")
def month(v):
    return _masked(v, _ymd(v)[1])


@_register("day_of_month")
def day_of_month(v):
    return _masked(v, _ymd(v)[2])


@_register("day_of_week")
def day_of_week(v):
    return _masked(v, (_fdiv(_secs(v), 86400) + 4) % 7)


@_register("hour")
def hour(v):
    return _masked(v, _fdiv(_secs(v) % 86400, 3600))


@_register("minute")
def minute(v):
    return _masked(v, _fdiv(_secs(v) % 3600, 60))


@_register("days_in_month")
def days_in_month(v):
    y, m, _ = _ymd(v)
    return _masked(v, _days_in_month(y, m))


# --------------------------------------------------------------------------
# Binary operators (scalar-vector and vector-vector)
# --------------------------------------------------------------------------

BINARY_OPERATORS = {
    "ADD": torch.add,
    "SUB": torch.sub,
    "MUL": torch.mul,
    "DIV": torch.true_divide,
    "MOD": torch.remainder,
    "POW": torch.pow,
}

_COMPARISON = {
    "EQL": lambda a, b: a == b,
    "NEQ": lambda a, b: a != b,
    "GTR": lambda a, b: a > b,
    "LSS": lambda a, b: a < b,
    "GTE": lambda a, b: a >= b,
    "LTE": lambda a, b: a <= b,
}


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def apply_binary(op: str, lhs, rhs, bool_mode: bool = False):
    """PromQL binary operator semantics: comparisons filter (keep lhs value)
    unless the ``bool`` modifier, which yields 0/1 (reference
    BinaryOperatorFunction).  Either side may be a tensor or a number;
    at least one is a tensor."""
    like = lhs if isinstance(lhs, torch.Tensor) else rhs
    lhs, rhs = _as_tensor(lhs, like), _as_tensor(rhs, like)
    if op in BINARY_OPERATORS:
        return BINARY_OPERATORS[op](lhs, rhs)
    if op.endswith("_BOOL"):
        op, bool_mode = op[:-5], True
    cmp = _COMPARISON[op](lhs, rhs)
    both = torch.isfinite(lhs) if lhs.ndim else torch.ones_like(cmp)
    nan = torch.tensor(float("nan"), dtype=like.dtype, device=like.device)
    if bool_mode:
        out = torch.where(cmp, 1.0, 0.0).to(like.dtype)
        return torch.where(torch.isnan(lhs) | torch.isnan(rhs), nan, out)
    return torch.where(cmp & both, lhs, nan)
