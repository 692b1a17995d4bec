"""FiloDB on PyTorch and CUDA: the device-resident grid serving path of
the time-series store, with hand-written Hopper kernels.

The shard-level slice — ingest → partitions → device grid → windowed
range function → on-device group reduce — the query engine above it,
and the fused north-star kernel path (``northstar``) run on a CUDA
device by default; callers that want the CPU say so (``device="cpu"``),
and then every kernel wrapper runs its plain PyTorch version.  Beneath
the store sit the host tiers: the sqlite column and meta stores
(``store``), on-demand paging, downsampling and the live rollup tiers,
the result cache, and the cold tier's store layer (``coldstore``: an
object bucket, the tiered column store, and the age-out with its
watermark).
"""

__version__ = "0.1.0"
