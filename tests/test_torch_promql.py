"""The port's PromQL parser against the JAX package's: the same query
string, at the same start/step/end, gives the same logical plan, compared
as a structural dump (class names, enum names, field values)."""

import dataclasses
import enum
import math

import pytest

from filodb_tpu.promql.parser import ParseError as JParseError
from filodb_tpu.promql.parser import \
    query_range_to_logical_plan as jquery_range_to_logical_plan
from filodb_tpu_torch.promql.parser import ParseError
from filodb_tpu_torch.promql.parser import query_range_to_logical_plan

BASE = 1_700_000_000_000
STEP = 10_000
SEL = '{_ws_="demo",_ns_="App-0"}'

# the query set of tests/test_grid_differential.py
DIFFERENTIAL = [
    f'rate(m_diff{SEL}[2m])',
    f'sum(rate(m_diff{SEL}[2m]))',
    f'sum by (g) (increase(m_diff{SEL}[3m]))',
    f'avg_over_time(m_diff{SEL}[2m])',
    f'min by (g) (min_over_time(m_diff{SEL}[2m]))',
    f'max(max_over_time(m_diff{SEL}[90s]))',
    f'quantile(0.5, rate(m_diff{SEL}[2m]))',
    f'stdvar by (g) (rate(m_diff{SEL}[2m]))',
    f'count(m_diff{SEL})',
    f'sum_over_time(m_diff{SEL}[2m]) / count_over_time(m_diff{SEL}[2m])',
    f'topk(2, sum by (g)(rate(m_diff{SEL}[2m])))',
    f'last_over_time(m_diff{SEL}[1m]) * 2 + 1',
]

MORE = [
    'a + on (job) group_left (inst) b',
    'a / ignoring (code) b',
    'a > bool 3',
    '2 < a',
    'a and b',
    'a or on (g) b',
    'a unless ignoring (x) b',
    'sum without (instance) (rate(m[5m]))',
    'count_values("v", m)',
    'quantile_over_time(0.9, m[10m] offset 1h)',
    'holt_winters(m[10m], 0.3, 0.1)',
    'predict_linear(m{a=~"x.*",b!="y",c!~"z"}[5m], 600)',
    'label_replace(m, "dst", "$1", "src", "(.*)")',
    'histogram_quantile(0.9, sum by (le) (rate(h_bucket[5m])))',
    'scalar(sum(m)) * vector(2) - time()',
    '-m ^ 2',
    'absent(up{job="x"})',
    'sort_desc(clamp_max(m, 10))',
    'hour() + minute(m)',
    '(1 + 2) * 3',
    'round(m, 0.5)',
    'm offset -5m',
]

BAD = ['rate(m)', 'sum(', 'm[5m]', '{}', 'a and 1']


def dump(x):
    """Structural form of a plan: dataclasses by class name and fields,
    enums by name, NaN as a token."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, dump(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, (tuple, list)):
        return tuple(dump(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, dump(v)) for k, v in x.items()))
    if isinstance(x, float) and math.isnan(x):
        return "NaN"
    return x


@pytest.mark.parametrize("query", DIFFERENTIAL + MORE)
def test_same_plan(query):
    start, end = BASE + 240_000, BASE + 1_180_000
    want = jquery_range_to_logical_plan(query, start, STEP, end)
    got = query_range_to_logical_plan(query, start, STEP, end)
    assert dump(got) == dump(want)
    assert type(got).__module__.startswith("filodb_tpu_torch.")


@pytest.mark.parametrize("query", BAD)
def test_same_errors(query):
    with pytest.raises(JParseError):
        jquery_range_to_logical_plan(query, BASE, STEP, BASE)
    with pytest.raises(ParseError):
        query_range_to_logical_plan(query, BASE, STEP, BASE)
