"""Per-dataset store configuration: the knobs the shard, its flush
scheduler and its device grid cache read (reference: core/src/main/scala/filodb.core/store/
IngestionConfig.scala:202 and conf/timeseries-dev-source.conf:28-102).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    flush_interval_ms: int = 3_600_000        # flush-interval = 1h
    flush_task_parallelism: int = 2           # flush executor workers
    max_chunks_size: int = 400                # max rows per chunk
    groups_per_shard: int = 60
    # local-tier retention: chunk rows older than this age out to the
    # cold tier's bucket (coldstore/ageout.py)
    disk_ttl_seconds: int = 3 * 24 * 3600
    # on-demand paging: over a persistent column store the shard pages
    # partitions absent from memory (evicted, or index-only after a
    # restart) back from disk at query time (reference:
    # OnDemandPagingShard.scala, DemandPagedChunkStore.scala:34)
    demand_paging_enabled: bool = True
    # bytes of chunk blobs one query may scan on a shard (reference:
    # capDataScannedPerShardCheck)
    max_data_per_shard_query: int = 50 * 1024 * 1024
    evicted_pk_bloom_filter_capacity: int = 5_000_000
    # padded batch shapes of the general query path (scan_batch): rows
    # round up to batch_row_pad (then powers of two), series to a
    # multiple of batch_series_pad
    batch_row_pad: int = 64
    batch_series_pad: int = 128
    # device-resident chunk store (reclaim-on-demand — the BlockManager
    # equivalent, reference: memory/BlockManager.scala:142)
    device_cache_bytes: int = 2 * 1024 * 1024 * 1024
    # host page cache of demand-paged partitions, decoded bytes counted;
    # it must hold a dashboard's working set for the device grid to
    # build from paged history
    page_cache_bytes: int = 256 * 1024 * 1024
    grid_step_ms: Optional[int] = None   # bucket width; None = detect
    # keep grid blocks compressed on the device (XOR-class value planes +
    # elided uniform-phase ts planes), decoded on device inside the
    # serving program; compression is taken per block only when it
    # saves >=25% (reference: compressed BinaryVectors served in place
    # from block memory, doc/compression.md)
    device_cache_compress: bool = True
    # proactive reclaim target: a flush trims each device cache to
    # (1-frac) of budget off the query path (reference: BlockManager
    # ensureHeadroomPercentAvailable headroom task)
    device_headroom_frac: float = 0.1
    # tag subset selecting series created as TracingTimeSeriesPartition
    # (reference: `trace-filters` config -> TimeSeriesPartition.scala:451)
    trace_filters: Optional[Mapping] = None


def parse_bool(v) -> bool:
    """Config booleans arrive as real bools or as strings from config
    files; ``bool('false')`` is True, which would defeat every
    string-valued kill switch."""
    if isinstance(v, str):
        lv = v.strip().lower()
        if lv in ("true", "yes", "on", "1"):
            return True
        if lv in ("false", "no", "off", "0"):
            return False
        raise ValueError(f"not a boolean config value: {v!r}")
    return bool(v)
