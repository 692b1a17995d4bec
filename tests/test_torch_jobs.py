"""The port's maintenance jobs (``filodb_tpu_torch/jobs.py``) against the
JAX package's over the same store contents: ``ChunkCopier`` (chunks,
their ingestion times and part keys copied between sqlite stores),
``PerShardCardinalityBuster`` (dry run and delete by tag filters) and
``DSIndexJob`` (part keys migrated to the downsample datasets)."""

import numpy as np
import pytest
import torch

from filodb_tpu.core.filters import ColumnFilter as JColumnFilter
from filodb_tpu.core.filters import Equals as JEquals
from filodb_tpu.core.record import RecordBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.jobs import ChunkCopier as JChunkCopier
from filodb_tpu.jobs import DSIndexJob as JDSIndexJob
from filodb_tpu.jobs import PerShardCardinalityBuster as JBuster
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.store.persistence import DiskColumnStore as JDiskColumnStore
from filodb_tpu.store.persistence import DiskMetaStore as JDiskMetaStore
from filodb_tpu_torch.core.filters import ColumnFilter, Equals
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.jobs import ChunkCopier, DSIndexJob
from filodb_tpu_torch.jobs import PerShardCardinalityBuster
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.store.persistence import DiskColumnStore, DiskMetaStore

torch.set_num_threads(1)

BASE = 1_700_000_000_000
RESOLUTIONS = (60_000, 3_600_000)


def _containers(n_series=8, n_rows=300):
    """Two container sets: the first and the second half of the rows."""
    rng = np.random.default_rng(3)
    halves = [RecordBuilder(J_SCHEMAS["gauge"]) for _ in range(2)]
    for s in range(n_series):
        tags = {"__name__": "cpu", "pod": f"pod-{s % 2}", "inst": f"i{s}",
                "_ws_": "w", "_ns_": "n"}
        ts = BASE + np.arange(n_rows, dtype=np.int64) * 10_000 + 1 + s
        v = rng.normal(5, 1, n_rows)
        h = n_rows // 2
        halves[0].add_series(ts[:h], [v[:h]], tags)
        halves[1].add_series(ts[h:], [v[h:]], tags)
    return [b.containers() for b in halves]


@pytest.fixture
def stores(tmp_path):
    """Each package's sqlite column store, holding the same rows flushed
    at two ingestion times."""
    first, second = _containers()
    out = {}
    for tag, MS, Disk, Meta, schemas, kw in (
            ("j", JMemStore, JDiskColumnStore, JDiskMetaStore, J_SCHEMAS,
             {}),
            ("t", TimeSeriesMemStore, DiskColumnStore, DiskMetaStore,
             DEFAULT_SCHEMAS, {"device": "cpu"})):
        disk = Disk(str(tmp_path / f"{tag}c.db"))
        ms = MS(disk, Meta(str(tmp_path / f"{tag}m.db")), **kw)
        shard = ms.setup("prom", schemas, 0)
        for off, c in enumerate(first):
            ms.ingest("prom", 0, c, off)
        shard.flush_all(ingestion_time=1000)
        for off, c in enumerate(second):
            ms.ingest("prom", 0, c, len(first) + off)
        shard.flush_all(ingestion_time=2000)
        out[tag] = (disk, Disk)
    return tmp_path, out


def _chunks(disk, dataset, start=0, end=2**62):
    return sorted((it, cs.partkey, cs.info.chunk_id,
                   tuple(bytes(v) for v in cs.vectors))
                  for it, cs in disk.chunksets_with_ingestion_time(
                      dataset, 0, start, end))


def _keys(disk, dataset):
    return sorted((r.partkey, r.start_time, r.end_time, r.schema_hash)
                  for r in disk.scan_part_keys(dataset, 0))


@pytest.mark.parametrize("window", [(0, 2**62), (0, 1500), (1500, 2**62)])
def test_chunk_copier_matches_jax(stores, window):
    tmp, out = stores
    got = {}
    for tag, Copier in (("j", JChunkCopier), ("t", ChunkCopier)):
        src, Disk = out[tag]
        dst = Disk(str(tmp / f"{tag}-{window[0]}-dst.db"))
        n = Copier(src, dst, "prom", "prom_copy", batch_size=7).run(
            [0], *window)
        got[tag] = (n, _chunks(dst, "prom_copy"), _keys(dst, "prom_copy"))
        # what was copied is what the source holds in the window, with
        # its ingestion times
        assert got[tag][1] == _chunks(src, "prom", *window)
    assert got["t"] == got["j"]
    assert got["t"][0][0] > 0


@pytest.mark.parametrize("dry_run", [True, False])
def test_cardinality_buster_matches_jax(stores, dry_run):
    _tmp, out = stores
    got = {}
    for tag, Buster, CF, Eq in (("j", JBuster, JColumnFilter, JEquals),
                                ("t", PerShardCardinalityBuster,
                                 ColumnFilter, Equals)):
        disk, _D = out[tag]
        buster = Buster(disk, "prom")
        filters = [CF("pod", Eq("pod-1"))]
        matched = sorted(buster.matching_partkeys(0, filters))
        n = buster.run([0], filters, dry_run=dry_run)
        got[tag] = (matched, n, _keys(disk, "prom"))
    assert got["t"] == got["j"]
    assert got["t"][1] == {0: 4}
    assert len(got["t"][2]) == (8 if dry_run else 4)


def test_ds_index_job_matches_jax(stores):
    _tmp, out = stores
    got = {}
    for tag, Job in (("j", JDSIndexJob), ("t", DSIndexJob)):
        disk, _D = out[tag]
        n = Job(disk, "prom", RESOLUTIONS).run([0, 1])
        got[tag] = (n, [_keys(disk, f"prom_ds_{r}") for r in RESOLUTIONS])
    assert got["t"] == got["j"]
    assert got["t"][0] == {0: 8, 1: 0}
    assert got["t"][1][0] == _keys(out["t"][0], "prom")
