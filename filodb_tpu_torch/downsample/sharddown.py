"""Flush-time downsampling: ShardDownsampler + publisher.

Capability match for the reference's streaming downsample path
(reference: core/src/main/scala/filodb.core/downsample/
ShardDownsampler.scala:58 — populateDownsampleRecords called from
TimeSeriesShard.doFlushSteps :915-917; DownsamplePublisher.scala — emits
RecordContainers to Kafka downsample topics, one per resolution).

Here the publisher is an in-process queue, and records are built with
the standard RecordBuilder against the schema's downsample schema (e.g.
gauge -> ds-gauge).  A downsampler runs its grid path's period reduce on
its ``device``: the shard's, so a CUDA store reduces on its card.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Sequence

import numpy as np

from filodb_tpu_torch.codecs import histcodec
from filodb_tpu_torch.core.chunk import ChunkSet, decode_partitions_batch
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import Schema
from filodb_tpu_torch.downsample import griddown
from filodb_tpu_torch.downsample.chunkdown import (CounterPeriodMarker,
                                                   parse_downsampler,
                                                   parse_period_marker)

DEFAULT_RESOLUTIONS_MS = (60_000, 3_600_000)  # 1m / 1h (conf resolutions)


def decode_concat_with_keys(schema: Schema, pairs):
    """Group ``(tags, chunkset)`` pairs by partition, decode once, and
    concatenate in chunk-id order -> ``[(partkey, tags, ts, cols)]``.
    The keyed sibling of :meth:`ShardDownsampler._decode_concat` — the
    live rollup engine buffers decoded rows per PARTKEY across ticks,
    so it needs the key the flush-path helper drops."""
    by_pk: dict[bytes, list] = {}
    for tags, cs in pairs:
        by_pk.setdefault(cs.partkey, [tags, []])[1].append(cs)
    groups = []
    for _pk, (_tags, css) in by_pk.items():
        css.sort(key=lambda c: c.info.chunk_id)
        groups.append(css)
    parts = decode_partitions_batch(schema, groups)
    return [(pk, tags, ts, cols)
            for (pk, (tags, _css)), (ts, cols)
            in zip(by_pk.items(), parts)]


class DownsamplePublisher:
    """Collects downsample record containers per resolution (reference:
    DownsamplePublisher -> Kafka downsample topics)."""

    def publish(self, resolution_ms: int, shard: int,
                containers: list[bytes]) -> None:
        raise NotImplementedError


class MemoryDownsamplePublisher(DownsamplePublisher):
    """In-process sink: resolution -> list[(shard, container)]."""

    def __init__(self) -> None:
        self.published: dict[int, list[tuple[int, bytes]]] = defaultdict(list)

    def publish(self, resolution_ms, shard, containers) -> None:
        self.published[resolution_ms].extend(
            (shard, c) for c in containers)

    def drain(self, resolution_ms: int) -> list[tuple[int, bytes]]:
        out = self.published.get(resolution_ms, [])
        self.published[resolution_ms] = []
        return out


class ShardDownsampler:
    """Downsamples freshly-flushed chunksets into records at each
    resolution (reference: ShardDownsampler.populateDownsampleRecords)."""

    def __init__(self, dataset: str, shard: int, schema: Schema,
                 publisher: DownsamplePublisher,
                 resolutions_ms: Sequence[int] = DEFAULT_RESOLUTIONS_MS,
                 enabled: bool = True, device="cuda"):
        self.dataset = dataset
        self.device = device
        self.shard = shard
        self.schema = schema
        self.publisher = publisher
        self.resolutions = tuple(resolutions_ms)
        # downsample_schema == own name means self-downsampling (counters,
        # histograms re-aggregate into the same schema)
        self.enabled = enabled and bool(schema.data.downsamplers) \
            and schema.data.downsample_schema is not None
        if self.enabled:
            self.downsamplers = [parse_downsampler(s)
                                 for s in schema.data.downsamplers]
            self.marker = parse_period_marker(
                schema.data.downsample_period_marker)
            self.ds_schema = schema.downsample or schema

    def downsample_chunksets(self, chunksets: Sequence[tuple[dict, ChunkSet]]
                             ) -> int:
        """(tags, chunkset) pairs -> publish one container set per
        resolution.  Chunks of one partition are concatenated before period
        assignment so a period spanning a mid-flush chunk boundary yields
        ONE record, not conflicting partials.  Returns records emitted."""
        if not self.enabled or not chunksets:
            return 0
        decoded = self._decode_concat(chunksets)
        staged = self._try_stage_grid(decoded)
        emitted = 0
        keys: dict = {}      # series -> its record hashes, once a call
        for res in self.resolutions:
            builder = RecordBuilder(self.ds_schema)
            served = None
            if staged is not None:
                got = griddown.grid_outputs(staged, res, self.downsamplers,
                                            self.marker, self.device)
                if got is not None:
                    served, outs, pends, plive = got
                    emitted += self._emit_grid(builder, decoded, served,
                                               outs, pends, plive, keys)
            for si, (tags, ts, cols) in enumerate(decoded):
                if served is not None and served[si]:
                    continue
                emitted += self._emit(builder, tags, ts, cols, res)
            containers = builder.containers()
            if containers:
                self.publisher.publish(res, self.shard, containers)
        return emitted

    def _decode_concat(self, chunksets):
        """Group (tags, chunkset) pairs by partition, decode once, and
        concatenate in chunk-id order so a period spanning a mid-flush
        chunk boundary yields ONE record, not conflicting partials."""
        return [(tags, ts, cols) for _pk, tags, ts, cols
                in decode_concat_with_keys(self.schema, chunksets)]

    def prepare_arrays(self, chunksets):
        """Decode + grid-stage ONCE for use across every resolution
        (the batch job re-uses one decode for the whole resolution
        ladder).  Returns an opaque handle for :meth:`downsample_arrays`
        or None when there is nothing to do."""
        if not self.enabled or not chunksets:
            return None
        decoded = self._decode_concat(chunksets)
        return decoded, self._try_stage_grid(decoded)

    def prepare_decoded(self, decoded):
        """:meth:`prepare_arrays` for callers that already hold decoded
        per-series arrays ``[(tags, ts, cols)]`` — the live rollup
        engine's resident buffers skip the chunkset decode but share
        the grid staging (and its resolution-ladder cascade)."""
        if not self.enabled or not decoded:
            return None
        decoded = [(tags, ts, cols) for tags, ts, cols in decoded
                   if len(ts)]
        if not decoded:
            return None
        return decoded, self._try_stage_grid(decoded)

    def downsample_planes(self, prepared, resolution_ms: int):
        """COLUMNAR batch-job output for the grid-served, fully-live
        series (the aligned common case): one shared period-end vector
        plus per-column [P, S_f] planes, ready for the contiguous 2D
        batch encode — no per-series slicing at all.  Returns
        (tags_list, pe [P] int64, planes, leftovers) where ``leftovers``
        are the per-series (tags, ts, cols) tuples for partially-live or
        unserved series (same contract as :meth:`downsample_arrays`), or
        None when this resolution can't be served from the grid (the
        caller falls back to :meth:`downsample_arrays`)."""
        if prepared is None:
            return None
        decoded, staged = prepared
        if staged is None:
            return None
        got = griddown.grid_outputs(staged, resolution_ms,
                                    self.downsamplers, self.marker,
                                    self.device)
        if got is None:
            return None
        served, outs, pends, plive = got
        outs = [np.asarray(o) if o is not None else None for o in outs]
        pends = np.asarray(pends)
        plive = np.asarray(plive)
        # the k_align row padding leaves dead periods at the grid's head
        # and tail; "fully live" is judged (and planes emitted) over the
        # live span only, or alignment pads would push EVERY series to
        # the per-series path
        row_any = plive.any(axis=1)                    # [P]
        if row_any.any():
            a = int(np.argmax(row_any))
            b = int(len(row_any) - np.argmax(row_any[::-1]))
        else:
            a = b = 0
        core = slice(a, b)
        full = served & plive[core].all(axis=0)        # [S]
        sidx = np.flatnonzero(full)
        tags_list = [decoded[int(i)][0] for i in sidx]
        planes = [out[core][:, sidx] for out in outs if out is not None]
        pe = pends[core].astype(np.int64)
        leftovers = []
        pe_cache: dict[bytes, np.ndarray] = {}
        for si, (tags, ts, cols) in enumerate(decoded):
            if full[si]:
                continue
            if served[si]:
                pm = plive[:, si]
                if not pm.any():
                    continue
                key = pm.tobytes()
                pe_s = pe_cache.get(key)
                if pe_s is None:
                    pe_s = pe_cache[key] = pends[pm].astype(np.int64)
                leftovers.append((tags, pe_s,
                                  [out[pm, si] for out in outs
                                   if out is not None]))
                continue
            got = self._series_downsample(tags, ts, cols, resolution_ms)
            if got is not None:
                leftovers.append(got)
        return tags_list, pe, planes, leftovers

    def _series_downsample(self, tags: dict, ts: np.ndarray, cols,
                           resolution_ms: int):
        """Per-series host downsample: (tags, t_col, val_cols) or None
        when the series contributes no periods.  Shared by the planar
        leftovers and the downsample_arrays fallback — the period-marker
        semantics must never diverge between the two paths."""
        if len(ts) == 0:
            return None
        bounds, ends = self.marker.periods(ts, cols, resolution_ms)
        if len(ends) == 0:
            return None
        outputs = [d.downsample(ts, cols, bounds, ends)
                   for d in self.downsamplers]
        t_col = None
        val_cols = []
        for d, out in zip(self.downsamplers, outputs):
            if d.is_time:
                t_col = np.asarray(out, dtype=np.int64)
            else:
                val_cols.append(out)
        if t_col is None:
            t_col = np.asarray(ends, dtype=np.int64)
        return tags, t_col, val_cols

    def downsample_arrays(self, prepared, resolution_ms: int):
        """Batch-job form of :meth:`downsample_chunksets`: returns
        per-series arrays ``(tags, ts [P] int64, cols)`` instead of
        building records — the direct chunk-build path of the offline
        downsampler (reference: the Spark BatchDownsampler writes
        chunksets straight to the store, DownsamplerMain.scala:43,
        never re-ingesting through a memstore).  ``cols`` entries are
        float arrays, or (buckets, rows) for histogram outputs, in
        downsample-schema column order (time column first)."""
        if prepared is None:
            return []
        decoded, staged = prepared
        served = None
        results = []
        if staged is not None:
            got = griddown.grid_outputs(staged, resolution_ms,
                                        self.downsamplers, self.marker,
                                        self.device)
            if got is not None:
                served, outs, pends, plive = got
                # the planes are host arrays (one readback a reduce)
                outs = [np.asarray(o) for o in outs if o is not None]
                pends = np.asarray(pends)
                plive = np.asarray(plive)
                # series live over the same periods share one
                # period-end vector and one block of their columns
                sidx = np.flatnonzero(np.asarray(served, bool)
                                      & plive.any(axis=0))
                _p, first, which = np.unique(
                    np.packbits(plive[:, sidx], axis=0).T, axis=0,
                    return_index=True, return_inverse=True)
                which = which.reshape(-1)
                rank = np.empty(len(sidx), np.int64)   # column in block
                blocks = []
                for k, f in enumerate(first):
                    pm = plive[:, sidx[f]]
                    members = np.flatnonzero(which == k)
                    rank[members] = np.arange(len(members))
                    rows = np.ix_(pm, sidx[members])
                    blocks.append((pends[pm].astype(np.int64),
                                   [out[rows] for out in outs]))
                for si, k, j in zip(sidx.tolist(), which.tolist(),
                                    rank.tolist()):
                    pe, block = blocks[k]
                    results.append((decoded[si][0], pe,
                                    [b[:, j] for b in block]))
        for si, (tags, ts, cols) in enumerate(decoded):
            if served is not None and served[si]:
                continue
            got = self._series_downsample(tags, ts, cols, resolution_ms)
            if got is not None:
                results.append(got)
        return results

    def _try_stage_grid(self, decoded):
        """Stage the whole batch as a [B, S] bucket grid when every
        downsampler and resolution is grid-servable (griddown.py)."""
        if not griddown.grid_supported(self.downsamplers):
            return None
        g = griddown.detect_gstep([ts for _, ts, _ in decoded])
        if not g or any(res % g != 0 for res in self.resolutions):
            return None
        ks = [res // g for res in self.resolutions]
        k_align = math.lcm(*ks)
        if k_align > 4096:
            return None
        reset_col = self.marker.col_id - 1 \
            if isinstance(self.marker, CounterPeriodMarker) else None
        return griddown.stage_grid([ts for _, ts, _ in decoded],
                                   [cols for _, _, cols in decoded],
                                   g, k_align, reset_col=reset_col)

    def _emit_grid(self, builder: RecordBuilder, decoded, served, outs,
                   period_ends, plive, keys: dict) -> int:
        """Vectorized emission of every served series, only the periods
        that contain samples (host-path parity): one record encode for
        all series whose partkeys share a length, each series' records
        in time order.  ``keys`` keeps each series' record hashes across
        the resolutions."""
        live = plive & np.asarray(served, bool)[None, :]        # [P, S]
        s_idx, p_idx = np.nonzero(live.T)      # series-major, time order
        if not len(s_idx):
            return 0
        sel, per = np.unique(s_idx, return_counts=True)
        for si in sel:
            if si not in keys:
                keys[si] = builder.series_key(decoded[si][0])
        pklen = np.fromiter((len(keys[si][2]) for si in sel), np.int64,
                            len(sel))
        rec_len = np.repeat(pklen, per)
        vals = [out[p_idx, s_idx] for out in outs if out is not None]
        for n in np.unique(pklen):
            group = sel[pklen == n]
            shash, phash, pks = zip(*(keys[si] for si in group))
            counts = per[pklen == n]
            mask = rec_len == n
            builder.add_records_hashed(
                period_ends[p_idx[mask]], [v[mask] for v in vals],
                np.repeat(np.asarray(shash, np.uint32), counts),
                np.repeat(np.asarray(phash, np.uint32), counts), int(n),
                np.repeat(np.frombuffer(b"".join(pks), f"V{n}"), counts)
                if n else None)
        return len(s_idx)

    def _emit(self, builder: RecordBuilder, tags: dict, ts: np.ndarray,
              cols: Sequence, resolution_ms: int) -> int:
        if len(ts) == 0:
            return 0
        bounds, ends = self.marker.periods(ts, cols, resolution_ms)
        outputs = [d.downsample(ts, cols, bounds, ends)
                   for d in self.downsamplers]
        n = 0
        for p in range(len(ends)):
            t = None
            values = []
            for d, out in zip(self.downsamplers, outputs):
                if d.is_time:
                    t = int(out[p])
                elif isinstance(out, tuple):  # histogram column
                    buckets, rows = out
                    values.append(histcodec.encode_hist_value(buckets, rows[p]))
                else:
                    values.append(float(out[p]))
            if t is None:
                t = int(ends[p])
            builder.add(t, values, tags)
            n += 1
        return n
