"""Data and stores shared by the persistence, flush and integrity tests
(``tests/test_torch_{integrity,persistence,flush,quarantine_grid}.py``):
one time-major container stream, built once with the JAX package's
``RecordBuilder``, driven into a ``filodb_tpu`` memstore and a
``filodb_tpu_torch`` memstore (``device="cpu"``), each over sqlite files
of its own under ``tmp_path``."""

import gc
import sqlite3

import numpy as np
import pytest

from filodb_tpu import integrity as jintegrity
from filodb_tpu.core.record import RecordBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.storeconfig import StoreConfig as JStoreConfig
from filodb_tpu.memstore.flush import FlushScheduler as JFlushScheduler
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.store.persistence import DiskColumnStore as JDiskColumnStore
from filodb_tpu.store.persistence import DiskMetaStore as JDiskMetaStore
from filodb_tpu_torch import integrity
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.core.storeconfig import StoreConfig
from filodb_tpu_torch.memstore.flush import FlushScheduler
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.store.persistence import DiskColumnStore, DiskMetaStore

STEP = 60_000
T0 = 1_700_000_040_000
WINDOW = 300_000
N_SERIES = 12            # two pods of six series
N_ROWS = 200
GROUPS = 4               # flush groups: boundaries 15 min apart
INTERVAL = 3_600_000     # flush-interval
HOUR_ROWS = 40           # rows of one container set
CONTAINER = 2048         # container bytes: several a set
N_PODS = 2


# memstores a test opened, closed when it ends (see clear_quarantines)
_OPEN: list = []


def opened(*memstores):
    """Register memstores to be closed when the test ends; returns
    them."""
    _OPEN.extend(memstores)
    return memstores


@pytest.fixture(autouse=True)
def clear_quarantines():
    """Both packages keep a process-wide quarantine: every test starts
    and ends with both empty, whatever order a worker runs them in.  The
    memstores the test opened are closed at its end (a paging shard's
    page-cache pool is registered in a process-wide gauge until then)
    and their garbage collected here: the JAX package's device ledger
    takes a plain lock in ``track``, and a cycle collected inside it runs
    that ledger's finalizers on the same thread, which then wait on the
    lock forever."""
    integrity.QUARANTINE.clear()
    jintegrity.QUARANTINE.clear()
    yield
    for ms in _OPEN:
        ms.reset()
    _OPEN.clear()
    gc.collect()
    integrity.QUARANTINE.clear()
    jintegrity.QUARANTINE.clear()


def series_data(seed: int = 0):
    """Counters at a constant phase a series (the uniform-phase proof
    holds), a reset in series 3: ``(ts [S, R], vals [S, R], tags)``."""
    rng = np.random.default_rng(seed)
    phase = rng.integers(1, STEP, N_SERIES)
    rows = np.arange(N_ROWS, dtype=np.int64)
    ts = T0 + rows[None, :] * STEP + phase[:, None]
    vals = (rng.integers(0, 1000, N_SERIES)[:, None]
            + np.cumsum(rng.integers(0, 10, (N_SERIES, N_ROWS)), axis=1)
            ).astype(np.float64)
    vals[3, N_ROWS // 2:] -= vals[3, N_ROWS // 2 - 1]
    tags = [{"__name__": "m", "pod": f"p{i // 6}", "instance": f"i{i:02d}",
             "_ws_": "w", "_ns_": "n"} for i in range(N_SERIES)]
    return ts, vals, tags


_STREAMS: dict = {}


def stream(kind: str = "hours") -> list:
    """``[(offset, container)]``.  ``hours``: a container set a
    HOUR_ROWS of rows, pod by pod (the time-major order a Kafka partition
    delivers); ``minutes``: one container a row, every series (the
    shard's newest timestamp advances a minute a container, so the
    groups' staggered boundaries fall in different containers)."""
    if kind not in _STREAMS:
        ts, vals, tags = series_data()
        out = []
        if kind == "hours":
            for r0 in range(0, N_ROWS, HOUR_ROWS):
                for pod in range(N_PODS):
                    b = RecordBuilder(J_SCHEMAS["prom-counter"],
                                      container_size=CONTAINER)
                    for s in range(pod * 6, pod * 6 + 6):
                        sl = slice(r0, r0 + HOUR_ROWS)
                        b.add_series(ts[s, sl], [vals[s, sl]], tags[s])
                    out += b.containers()
        else:
            for r in range(N_ROWS):
                b = RecordBuilder(J_SCHEMAS["prom-counter"],
                                  container_size=1 << 20)
                for s in range(N_SERIES):
                    b.add_series(ts[s, r:r + 1], [vals[s, r:r + 1]], tags[s])
                out += b.containers()
        _STREAMS[kind] = list(enumerate(out))
    return _STREAMS[kind]


@pytest.fixture(params=[True, False], ids=["paging", "no_paging"])
def paging(request) -> bool:
    """``demand_paging_enabled`` for both packages' stores: a test about
    flushing or integrity runs over paging shards (the default) and
    plain ones."""
    return request.param


def disk_stores(tmp_path, name: str = "a", groups: int = GROUPS,
                paging: bool = True):
    """((JAX memstore, shard), (port memstore, shard)) over sqlite files
    of their own, both with the same ``demand_paging_enabled``: a paging
    shard (the default over a disk store) is only ever compared with a
    paging shard."""
    j = JMemStore(JDiskColumnStore(str(tmp_path / f"j{name}.db")),
                  JDiskMetaStore(str(tmp_path / f"j{name}m.db")))
    jshard = j.setup("prom", J_SCHEMAS, 0,
                     JStoreConfig(demand_paging_enabled=paging,
                                  groups_per_shard=groups))
    t = TimeSeriesMemStore(DiskColumnStore(str(tmp_path / f"t{name}.db")),
                           DiskMetaStore(str(tmp_path / f"t{name}m.db")),
                           device="cpu")
    tshard = t.setup("prom", DEFAULT_SCHEMAS, 0,
                     StoreConfig(demand_paging_enabled=paging,
                                 groups_per_shard=groups))
    opened(j, t)
    return (j, jshard), (t, tshard)


def drive(shard, records, jax: bool, flush_remaining: bool,
          interval: int = INTERVAL):
    """Ingest through a FlushScheduler, ``note_ingested`` after each
    container, then close it; returns the scheduler and the offsets the
    flush tasks snapshotted, in submission order by group."""
    sched = (JFlushScheduler if jax else FlushScheduler)(shard, interval, 2)
    snaps: dict = {}
    prepare = shard.prepare_flush_group

    def recording(group, ingestion_time=None):
        task = prepare(group, ingestion_time)
        snaps.setdefault(group, []).append(task.offset)
        return task

    shard.prepare_flush_group = recording
    try:
        for off, c in records:
            shard.ingest_container(c, off)
            sched.note_ingested()
        sched.drain()
    finally:
        sched.close(flush_remaining=flush_remaining)
        del shard.prepare_flush_group
    return sched, snaps


def table(path, sql: str) -> list:
    conn = sqlite3.connect(str(path))
    try:
        return conn.execute(sql).fetchall()
    finally:
        conn.close()


# every column of a chunk row but ingestion_time (a flush task stamps
# the wall clock it was prepared at)
CHUNK_COLS = ("dataset, shard, partkey, chunk_id, num_rows, start_time, "
              "end_time, schema_hash, vectors, crc")


def chunk_rows(path) -> list:
    return table(path, f"SELECT {CHUNK_COLS} FROM chunks "
                       f"ORDER BY partkey, chunk_id")


def samples(shard) -> dict:
    """{partkey: (ts, values)} of every in-memory partition."""
    return {p.partkey: p.read_range(0, 2**62) for p in
            shard.partitions.values()}
