"""Cold tier: an object-store chunk archive beneath the local column store.

The store layer of the reference's months-of-history tier, rebuilt as an
S3-shaped object bucket (get/put/list/delete) holding immutable chunk
objects, fronted by the local ``DiskColumnStore`` as the warm tier:

* :mod:`filodb_tpu_torch.coldstore.bucket` — the ``ObjectBucket``
  interface and the local-FS implementation (``LocalFSBucket``), with the
  fault hooks the tests drive (stall injection, byte corruption).
* :mod:`filodb_tpu_torch.coldstore.store` — ``ColdChunkStore``, a
  :class:`~filodb_tpu_torch.store.columnstore.ColumnStore` over a bucket
  (CRC verified on EVERY fetch, quarantine intact, deadline-derived fetch
  timeouts), and ``TieredColumnStore``, which merges local-then-cold so a
  reader never knows which tier served a chunk.
* :mod:`filodb_tpu_torch.coldstore.ageout` — the retention policy: rows
  past the retention floor move local -> bucket (upload, read-back
  verify, THEN delete), with a persisted per-shard watermark.

Host code only: chunk bodies travel as bytes; whatever decodes them onto
the card is the reader's.
"""

from filodb_tpu_torch.coldstore.bucket import (BucketTimeout, LocalFSBucket,
                                               ObjectBucket, ObjectMissing)
from filodb_tpu_torch.coldstore.store import ColdChunkStore, TieredColumnStore
from filodb_tpu_torch.coldstore.ageout import AgeOutManager

__all__ = [
    "ObjectBucket", "LocalFSBucket", "BucketTimeout", "ObjectMissing",
    "ColdChunkStore", "TieredColumnStore", "AgeOutManager",
]
