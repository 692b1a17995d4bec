"""Per-dataset store configuration: the knobs the shard and its device
grid cache read (reference: core/src/main/scala/filodb.core/store/
IngestionConfig.scala:202 and conf/timeseries-dev-source.conf:28-102).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    max_chunks_size: int = 400                # max rows per chunk
    groups_per_shard: int = 60
    # padded batch shapes of the general query path (scan_batch): rows
    # round up to batch_row_pad (then powers of two), series to a
    # multiple of batch_series_pad
    batch_row_pad: int = 64
    batch_series_pad: int = 128
    # device-resident chunk store (reclaim-on-demand — the BlockManager
    # equivalent, reference: memory/BlockManager.scala:142)
    device_cache_bytes: int = 2 * 1024 * 1024 * 1024
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
