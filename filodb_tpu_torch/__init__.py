"""FiloDB on PyTorch and CUDA: the device-resident grid serving path of
the time-series store, with hand-written Hopper kernels.

The shard-level slice — ingest → partitions → device grid → windowed
range function → on-device group reduce — the query engine above it,
and the fused north-star kernel path (``northstar``) run on a CUDA
device by default; callers that want the CPU say so (``device="cpu"``),
and then every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
