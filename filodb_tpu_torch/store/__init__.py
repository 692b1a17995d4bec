"""Persistence-plane APIs: ChunkSink/ColumnStore + MetaStore
(reference: core/src/main/scala/filodb.core/store/)."""

from filodb_tpu_torch.store.columnstore import (ColumnStore,
                                                InMemoryColumnStore,
                                                NullColumnStore, PartKeyRecord)
from filodb_tpu_torch.store.metastore import InMemoryMetaStore, MetaStore

__all__ = ["ColumnStore", "NullColumnStore", "InMemoryColumnStore",
           "PartKeyRecord", "MetaStore", "InMemoryMetaStore"]
