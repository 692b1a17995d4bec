"""In-memory time-series store with its device-resident grid."""

from filodb_tpu_torch.memstore.index import PartKeyIndex
from filodb_tpu_torch.memstore.partition import TimeSeriesPartition
from filodb_tpu_torch.memstore.shard import TimeSeriesShard
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore

__all__ = ["PartKeyIndex", "TimeSeriesPartition", "TimeSeriesShard",
           "TimeSeriesMemStore"]
