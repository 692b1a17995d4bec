"""Downsampled dataset serving + batch downsampler job.

Capability match for:
- DownsampledTimeSeriesStore/Shard — read-only store serving downsampled
  data per resolution, index recovered from persisted partkeys
  (reference: core/src/main/scala/filodb.core/downsample/
  DownsampledTimeSeriesStore.scala:21, DownsampledTimeSeriesShard.scala:40).
- The offline Spark downsampler — batch job that reads raw chunks by
  ingestion time, applies the schema's ChunkDownsamplers, and writes
  downsample chunks to the downsample dataset (reference: spark-jobs/
  .../DownsamplerMain.scala:43, BatchDownsampler.scala:36, SURVEY.md §3.5).
  Spark's executor parallelism maps to per-(shard × time-split) work items
  that are embarrassingly parallel on host CPU.

Both run on the card unless the caller asks for the CPU: the serving
store's grid, and the batch job's period reduce.
"""

from __future__ import annotations

from typing import Optional, Sequence

from filodb_tpu_torch.codecs import deltadelta, doublecodec
from filodb_tpu_torch.core.chunk import (ChunkSet, ChunkSetInfo, chunk_id,
                                         encode_chunksets_batch)
from filodb_tpu_torch.core.record import canonical_partkey, parse_partkey
from filodb_tpu_torch.core.schemas import ColumnType, Schema, Schemas
from filodb_tpu_torch.core.storeconfig import StoreConfig
from filodb_tpu_torch.downsample.sharddown import (DEFAULT_RESOLUTIONS_MS,
                                             MemoryDownsamplePublisher,
                                             ShardDownsampler)
from filodb_tpu_torch.memstore.devicestore import resolve_device
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.store.columnstore import ColumnStore, PartKeyRecord
from filodb_tpu_torch.store.metastore import MetaStore


def ds_dataset_name(dataset: str, resolution_ms: int) -> str:
    """Downsample dataset naming, e.g. prom_ds_60000 (reference: downsample
    datasets <ds>_ds_<res> convention)."""
    return f"{dataset}_ds_{resolution_ms}"


class DownsampledTimeSeriesStore:
    """Serves downsampled datasets, one memstore dataset per resolution.

    Read path is identical to the raw store (same shard/scan surface), so
    planners can route long-range queries here transparently (reference:
    DownsampledTimeSeriesStore is a read-only TimeSeriesStore)."""

    def __init__(self, raw_dataset: str,
                 column_store: Optional[ColumnStore] = None,
                 meta_store: Optional[MetaStore] = None,
                 resolutions_ms: Sequence[int] = DEFAULT_RESOLUTIONS_MS,
                 device="cuda"):
        self.raw_dataset = raw_dataset
        self.resolutions = tuple(sorted(resolutions_ms))
        self.memstore = TimeSeriesMemStore(column_store, meta_store,
                                           device=device)

    def setup(self, schemas: Schemas, shard_num: int,
              config: Optional[StoreConfig] = None) -> None:
        for res in self.resolutions:
            self.memstore.setup(ds_dataset_name(self.raw_dataset, res),
                                schemas, shard_num, config)

    def best_resolution(self, step_ms: int) -> int:
        """Coarsest resolution that still gives >=1 sample per step."""
        best = self.resolutions[0]
        for res in self.resolutions:
            if res <= step_ms:
                best = res
        return best

    def shard(self, resolution_ms: int, shard_num: int):
        return self.memstore.get_shard(
            ds_dataset_name(self.raw_dataset, resolution_ms), shard_num)

    def ingest_from_publisher(self, publisher: MemoryDownsamplePublisher,
                              offset: int = 0) -> int:
        """Drain published downsample containers into the serving store
        (the in-process stand-in for the Kafka downsample topics)."""
        total = 0
        for res in self.resolutions:
            for shard_num, container in publisher.drain(res):
                total += self.memstore.ingest(
                    ds_dataset_name(self.raw_dataset, res), shard_num,
                    container, offset)
        return total

    def recover(self, shard_num: int) -> int:
        """Index + data recovery for every resolution dataset."""
        n = 0
        for res in self.resolutions:
            n += self.memstore.recover_index(
                ds_dataset_name(self.raw_dataset, res), shard_num)
        return n


class BatchDownsampler:
    """Offline batch job: raw chunks -> downsample datasets (reference:
    spark-jobs BatchDownsampler.downsampleBatch)."""

    def __init__(self, raw_dataset: str, schemas: Schemas,
                 column_store: ColumnStore,
                 resolutions_ms: Sequence[int] = DEFAULT_RESOLUTIONS_MS,
                 config: Optional[StoreConfig] = None, device="cuda"):
        self.raw_dataset = raw_dataset
        self.schemas = schemas
        self.store = column_store
        self.resolutions = tuple(resolutions_ms)
        self.config = config or StoreConfig()
        self.device = resolve_device(device)

    def run_shard(self, shard_num: int, ingestion_start: int,
                  ingestion_end: int) -> dict[int, int]:
        """Downsample one shard's raw chunks in [ingestion_start,
        ingestion_end] (one Spark work item; reference:
        Downsampler.run RDD over shard × time splits).

        Direct chunk-build path: downsampled series arrays are encoded
        into ChunkSets and written to the per-resolution datasets in ONE
        store call each — the reference's Spark BatchDownsampler writes
        chunksets straight to Cassandra (DownsamplerMain.scala:43,
        BatchDownsampler.downsampleBatch), never re-ingesting through a
        memstore, and the batch encode rides the native codec path.

        Returns {resolution: chunksets_written}."""
        samplers: dict[int, ShardDownsampler] = {}
        by_schema: dict[int, list] = {}
        tags_memo: dict[bytes, dict] = {}    # partkey parses once, not
        for cs in self.store.chunksets_by_ingestion_time(  # per chunk
                self.raw_dataset, shard_num, ingestion_start, ingestion_end):
            schema = self._schema_for(cs)
            # a schema that downsamples into itself (prom-counter, the
            # histograms: ``downsample`` is None) is downsampled too, as
            # the flush-time ShardDownsampler does; the reference's batch
            # job skips it (dsstore.py:121), leaving its counters without
            # a batch-built dataset
            if schema is None or schema.data.downsample_schema is None:
                continue
            tags = tags_memo.get(cs.partkey)
            if tags is None:
                tags = tags_memo[cs.partkey] = parse_partkey(cs.partkey)
            by_schema.setdefault(schema.schema_hash, []).append((tags, cs))
            if schema.schema_hash not in samplers:
                # publisher=None: the batch job builds chunksets
                # directly (downsample_arrays), it never publishes
                samplers[schema.schema_hash] = ShardDownsampler(
                    self.raw_dataset, shard_num, schema, None,
                    self.resolutions, device=self.device)

        prepared = {h: samplers[h].prepare_arrays(pairs)
                    for h, pairs in by_schema.items()}
        written: dict[int, int] = {}
        with self.store.deferred_commits():
            self._write_resolutions(shard_num, ingestion_end, by_schema,
                                    samplers, prepared, written)
        return written

    def _write_resolutions(self, shard_num, ingestion_end, by_schema,
                           samplers, prepared, written) -> None:
        # one canonical partkey per series, not per series x resolution
        # (the tags dicts are shared across the resolution ladder)
        pk_memo: dict[int, bytes] = {}

        def pk_for(tags: dict) -> bytes:
            pk = pk_memo.get(id(tags))
            if pk is None:
                pk = pk_memo[id(tags)] = canonical_partkey(tags)
            return pk

        for res in self.resolutions:
            ds_name = ds_dataset_name(self.raw_dataset, res)
            chunksets = []
            pkrecs = []
            for h in by_schema:
                sampler = samplers[h]
                if not sampler.enabled:
                    continue
                ds_schema = sampler.ds_schema
                all_dbl = all(c.ctype == ColumnType.DOUBLE
                              for c in ds_schema.data.columns[1:])
                planar = sampler.downsample_planes(prepared[h], res) \
                    if all_dbl else None
                if planar is not None:
                    # columnar fast path (the aligned common case): the
                    # shared period-end vector encodes ONCE, each value
                    # plane encodes as one contiguous [S, P] native call,
                    # and no per-series array slicing happens at all
                    tags_list, pe, planes, per_series = planar
                    if tags_list:
                        ts_blob = deltadelta.encode_batch([pe])[0]
                        col_blobs = [doublecodec.encode_batch_2d(pl.T)
                                     for pl in planes]
                        t0, t1 = int(pe[0]), int(pe[-1])
                        cid = chunk_id(t0, 0)
                        P = len(pe)
                        for i, tags in enumerate(tags_list):
                            pk = pk_for(tags)
                            vectors = [ts_blob] + [cb[i]
                                                   for cb in col_blobs]
                            chunksets.append(ChunkSet(
                                ChunkSetInfo(cid, P, t0, t1), pk,
                                vectors,
                                schema_hash=ds_schema.schema_hash))
                            pkrecs.append(PartKeyRecord(
                                pk, t0, t1, shard_num,
                                ds_schema.schema_hash))
                else:
                    per_series = sampler.downsample_arrays(
                        prepared[h], res)
                items = []
                for tags, ts_arr, cols in per_series:
                    pk = pk_for(tags)
                    items.append((pk, ts_arr, cols, 0))
                    pkrecs.append(PartKeyRecord(
                        pk, int(ts_arr[0]), int(ts_arr[-1]), shard_num,
                        ds_schema.schema_hash))
                chunksets.extend(encode_chunksets_batch(ds_schema, items))
            if chunksets:
                self.store.write_chunks(ds_name, shard_num, chunksets,
                                        ingestion_end)
                # widen, don't replace: a later ingestion window must
                # not narrow the partkey's visible time range
                self.store.merge_part_keys(ds_name, shard_num, pkrecs)
            written[res] = len(chunksets)

    def _schema_for(self, cs) -> Optional[Schema]:
        if cs.schema_hash:
            try:
                return self.schemas.by_hash(cs.schema_hash)
            except KeyError:
                return None
        ncols = len(cs.vectors)
        for s in self.schemas.all:
            if len(s.data.columns) == ncols and s.downsample is not None:
                return s
        return None
