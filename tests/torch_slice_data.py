"""Data and stores shared by the slice-level tests
(``tests/test_torch_devicestore*.py``): the same RecordContainer bytes,
built once with the JAX package's ``RecordBuilder``, ingested into a
``filodb_tpu`` memstore and into a ``filodb_tpu_torch`` memstore
(``device="cpu"``)."""

import numpy as np

from filodb_tpu.core.filters import ColumnFilter as JColumnFilter
from filodb_tpu.core.filters import Equals as JEquals
from filodb_tpu.core.record import RecordBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.storeconfig import StoreConfig as JStoreConfig
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.query.logical import RangeFunctionId as JF
from filodb_tpu_torch.core.filters import ColumnFilter, Equals
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.core.storeconfig import StoreConfig
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.query.logical import RangeFunctionId as F

STEP = 60_000
T0 = 1_700_000_040_000
WINDOW = 300_000
K = WINDOW // STEP
N_SERIES = 8
N_ROWS = 150            # two 128-bucket blocks
N_GROUPS = 3
GIDS = [i % N_GROUPS for i in range(N_SERIES)]

SERVED = ("RATE", "INCREASE", "DELTA", "SUM_OVER_TIME", "COUNT_OVER_TIME",
          "AVG_OVER_TIME", "MIN_OVER_TIME", "MAX_OVER_TIME",
          "LAST_OVER_TIME", None)
SELECTION = ("COUNT_OVER_TIME", "MIN_OVER_TIME", "MAX_OVER_TIME",
             "LAST_OVER_TIME", None)
# the range functions the grid serves beyond those, with their scalar
# arguments; the dense-only ones answer None over gappy lanes
MORE_SERVED = {"STDDEV_OVER_TIME": (), "STDVAR_OVER_TIME": (),
               "CHANGES": (), "RESETS": (), "IRATE": (), "IDELTA": (),
               "DERIV": (), "PREDICT_LINEAR": (600.0,), "TIMESTAMP": (),
               "Z_SCORE": (), "QUANTILE_OVER_TIME": (0.9,),
               "MAD_OVER_TIME": (), "HOLT_WINTERS": (0.5, 0.3)}
DENSE_ONLY = ("CHANGES", "RESETS", "IRATE", "IDELTA", "QUANTILE_OVER_TIME",
              "MAD_OVER_TIME", "HOLT_WINTERS")
# bit-equal on both stores: counts, and timestamps re-based in f64
EXACT = ("CHANGES", "RESETS", "TIMESTAMP")


# ------------------------------------------------------------------ data

def mk_jitter(b, rng):
    """Per-sample jittered counters (ts-mode data), with missed scrapes
    in half the series (gappy lanes)."""
    for i in range(N_SERIES):
        tags = {"__name__": "m", "instance": f"i{i}", "_ws_": "w",
                "_ns_": "n"}
        base = T0 + np.arange(N_ROWS, dtype=np.int64) * STEP - STEP + 1
        ts = base + rng.integers(0, 30_000, size=N_ROWS)
        vals = np.cumsum(rng.random(N_ROWS) * 5)
        keep = np.ones(N_ROWS, bool)
        if i % 2:
            keep[rng.random(N_ROWS) < 0.1] = False
        b.add_series(ts[keep], [vals[keep]], tags)


def mk_uniform(b, rng):
    """Constant per-series phase (the uniform-phase proof holds) with a
    counter reset in series 1."""
    phases = rng.integers(1, STEP, N_SERIES)
    for i in range(N_SERIES):
        tags = {"__name__": "m", "instance": f"i{i}", "_ws_": "w",
                "_ns_": "n"}
        ts = T0 + np.arange(N_ROWS, dtype=np.int64) * STEP - STEP \
            + phases[i]
        vals = np.cumsum(rng.random(N_ROWS) * 5)
        if i == 1:
            vals[N_ROWS // 2:] -= vals[N_ROWS // 2] * 0.9
        b.add_series(ts, [vals], tags)


def mk_gauge(b, rng):
    """Integer-valued gauge on the bucket edges: a bounded random walk
    around 1e6."""
    for i in range(N_SERIES):
        tags = {"__name__": "m", "instance": f"i{i}", "_ws_": "w",
                "_ns_": "n"}
        ts = T0 + np.arange(N_ROWS, dtype=np.int64) * STEP
        vals = (1_000_000 + np.cumsum(
            rng.integers(-500, 500, size=N_ROWS))).astype(np.float64)
        b.add_series(ts, [vals], tags)


def mk_counter(b, rng):
    """Integer counters with a pinned f32 exponent and a constant phase:
    the residuals fit one narrow XOR class."""
    for i in range(N_SERIES):
        tags = {"__name__": "m", "instance": f"i{i}", "_ws_": "w",
                "_ns_": "n"}
        ph = int(rng.integers(1, STEP))
        ts = T0 + np.arange(N_ROWS, dtype=np.int64) * STEP - STEP + ph
        vals = (2 ** 23 + 128 * np.cumsum(
            rng.integers(1, 8, N_ROWS))).astype(np.float64)
        b.add_series(ts, [vals], tags)


DATASETS = {"jitter": ("prom-counter", mk_jitter),
            "uniform": ("prom-counter", mk_uniform),
            "gauge": ("gauge", mk_gauge),
            "counter": ("prom-counter", mk_counter)}
CONTAINERS: dict = {}


def containers(kind: str) -> list:
    """RecordContainer bytes built once by the JAX package."""
    if kind not in CONTAINERS:
        schema, maker = DATASETS[kind]
        b = RecordBuilder(J_SCHEMAS[schema])
        maker(b, np.random.default_rng(sorted(DATASETS).index(kind)))
        CONTAINERS[kind] = b.containers()
    return CONTAINERS[kind]


def stores(kind: str, compress: bool):
    """(JAX shard, port shard) holding the same ingested bytes."""
    jms = JMemStore()
    jshard = jms.setup("prom", J_SCHEMAS, 0,
                       JStoreConfig(device_cache_compress=compress))
    tms = TimeSeriesMemStore(device="cpu")
    tshard = tms.setup("prom", DEFAULT_SCHEMAS, 0,
                       StoreConfig(device_cache_compress=compress))
    for off, c in enumerate(containers(kind)):
        assert jshard.ingest_container(c, off) == \
            tshard.ingest_container(c, off)
    jshard.flush_all()
    tshard.flush_all()
    return jshard, tshard


def ids(jshard, tshard):
    jres = jshard.lookup_partitions(
        [JColumnFilter("_metric_", JEquals("m"))], 0, 2**62)
    tres = tshard.lookup_partitions(
        [ColumnFilter("_metric_", Equals("m"))], 0, 2**62)
    np.testing.assert_array_equal(jres.part_ids, tres.part_ids)
    return jres.part_ids, tres.part_ids


def fns(name):
    return (getattr(JF, name) if name else None,
            getattr(F, name) if name else None)


# spans: across the block boundary, and inside block 0
SPANS = {"two_blocks": (T0 + (K + 1) * STEP, N_ROWS - K - 2, 1),
         "one_block": (T0 + (K + 1) * STEP, 60, 1),
         "stride2": (T0 + (K + 1) * STEP, 60, 2)}


def assert_close(got, want, exact: bool, rtol: float, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert (np.isfinite(got) == np.isfinite(want)).all(), what
    fin = np.isfinite(want)
    if exact:
        np.testing.assert_array_equal(got[fin], want[fin], err_msg=what)
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                                   err_msg=what)
