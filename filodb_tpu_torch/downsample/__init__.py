"""Multi-resolution downsampling: flush-time (``ShardDownsampler``, fed
by the shard's flush tasks and the paging shard's eviction), served
(``DownsampledTimeSeriesStore``) and batch (``BatchDownsampler``)
(reference: core/downsample/* and the spark-jobs offline downsampler)."""

from filodb_tpu_torch.downsample.chunkdown import (  # noqa: F401
    ChunkDownsampler, parse_downsampler, parse_period_marker)
from filodb_tpu_torch.downsample.sharddown import (  # noqa: F401
    DEFAULT_RESOLUTIONS_MS, DownsamplePublisher, MemoryDownsamplePublisher,
    ShardDownsampler)
from filodb_tpu_torch.downsample.dsstore import (  # noqa: F401
    BatchDownsampler, DownsampledTimeSeriesStore, ds_dataset_name)
