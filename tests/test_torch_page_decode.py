"""The page-in decode layer, port against the JAX package on the same
chunk sets, bit for bit: the native batch decoder (``ll/dbl_decode_batch``,
``page_decode``, ``page_decode_into`` with ``out_starts``, and the CRC32C
span check that fails a row set with one flipped byte),
``decode_partitions_batch`` with the decoder on and off, and
``concat_hist_parts`` across a bucket-scheme widening."""

import numpy as np
import pytest

from filodb_tpu import native as jnative
from filodb_tpu.core import chunk as jchunk
from filodb_tpu.core import histogram as jhistogram
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu_torch import integrity, native
from filodb_tpu_torch.core import chunk
from filodb_tpu_torch.core import histogram
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.store.persistence import pack_vectors

T0 = 1_700_000_000_000


def _chunksets(schema_name: str = "ds-gauge", n_parts: int = 7, seed=3):
    """``n_parts`` partitions of 1-4 chunks each, every numeric column
    random (a constant one among them), timestamps jittered."""
    rng = np.random.default_rng(seed)
    schema = DEFAULT_SCHEMAS[schema_name]
    ncols = len(schema.data.columns) - 1
    groups = []
    for p in range(n_parts):
        t, css = T0, []
        for c in range(int(rng.integers(1, 5))):
            n = int(rng.integers(1, 90))
            ts = t + np.cumsum(rng.integers(1, 20_000, n)).astype(np.int64)
            t = int(ts[-1])
            cols = [np.full(n, 7.25) if j == 1 else
                    np.round(rng.normal(0, 1e3, n), int(rng.integers(0, 6)))
                    for j in range(ncols)]
            css.append(chunk.encode_chunkset(schema, f"pk{p}".encode(), ts,
                                             cols, ingestion_seq=c))
        groups.append(css)
    return schema, groups


def _decoders():
    jnb, nb = jnative.batch_decoder(), native.batch_decoder()
    assert jnb is not None and nb is not None
    return jnb, nb


def _same(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))


def test_ll_and_dbl_decode_batch():
    jnb, nb = _decoders()
    _schema, groups = _chunksets()
    css = [cs for g in groups for cs in g]
    counts = [cs.info.num_rows for cs in css]
    for j, fn in ((0, "ll_decode_batch"), (1, "dbl_decode_batch"),
                  (3, "dbl_decode_batch")):
        blobs = [cs.vectors[j] for cs in css]
        got = getattr(nb, fn)(blobs, counts)
        want = getattr(jnb, fn)(blobs, counts)
        assert len(got) == len(want) == len(css)
        for g, w in zip(got, want):
            _same(g, w)
    with pytest.raises(ValueError):
        nb.dbl_decode_batch([b"\x07garbage"], [5])


def test_page_decode_and_decode_into_with_crcs():
    jnb, nb = _decoders()
    schema, groups = _chunksets()
    css = [cs for g in groups for cs in g]
    blobs = [pack_vectors(cs.vectors) for cs in css]
    crcs = [integrity.chunk_crc(b) for b in blobs]
    counts = [cs.info.num_rows for cs in css]
    cols = [(0, False)] + [(j, True) for j in
                           range(1, len(schema.data.columns))]
    got = nb.page_decode(blobs, counts, cols, crcs=crcs)
    want = jnb.page_decode(blobs, counts, cols, crcs=crcs)
    assert len(got) == len(want) == len(cols)
    for g, w in zip(got, want):
        _same(g, w)
    # decode straight into a padded [S, R] plane: row k at out_starts[k]
    R = 512
    starts, run = [], {}
    for cs in css:
        s = int(cs.partkey[2:])
        starts.append(s * R + run.get(s, 0))
        run[s] = run.get(s, 0) + cs.info.num_rows
    outs = []
    for nbk in (nb, jnb):
        ts2d = np.full((len(groups), R), -1, np.int64)
        v2d = np.full((len(groups), R), np.nan)
        assert nbk.page_decode_into(blobs, counts,
                                    [(0, False, ts2d), (2, True, v2d)],
                                    starts, crcs=crcs)
        outs.append((ts2d, v2d))
    _same(outs[0][0], outs[1][0])
    _same(outs[0][1], outs[1][1])
    for s, g in enumerate(groups):
        ts = np.concatenate([chunk.decode_chunkset(schema, cs)[0]
                             for cs in g])
        _same(outs[0][0][s, :len(ts)], ts)
    with pytest.raises(ValueError, match="C-contiguous"):
        nb.page_decode_into(blobs, counts,
                            [(0, False, np.empty((2, R), np.float64))],
                            starts)


def test_crc_span_check_fails_a_flipped_byte():
    jnb, nb = _decoders()
    schema, groups = _chunksets(n_parts=3)
    css = [cs for g in groups for cs in g]
    blobs = [pack_vectors(cs.vectors) for cs in css]
    crcs = [integrity.chunk_crc(b) for b in blobs]
    counts = [cs.info.num_rows for cs in css]
    bad = bytearray(blobs[1])
    bad[len(bad) // 2] ^= 0x10
    blobs[1] = bytes(bad)
    cols = [(0, False), (1, True)]
    assert nb.page_decode(blobs, counts, cols, crcs=crcs) is None
    assert jnb.page_decode(blobs, counts, cols, crcs=crcs) is None
    out = np.empty(sum(counts), np.int64)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    assert not nb.page_decode_into(blobs, counts, [(0, False, out)], starts,
                                   crcs=crcs)
    assert not jnb.page_decode_into(blobs, counts, [(0, False, out)],
                                    starts, crcs=crcs)
    # crc 0 marks a row written before checksums: it passes unchecked
    crcs[1] = 0
    assert (nb.page_decode(blobs[:1], counts[:1], cols, crcs=crcs[:1])
            is not None)


@pytest.mark.parametrize("decoder", ["native", "disabled"])
def test_decode_partitions_batch(decoder):
    schema, groups = _chunksets()
    jschema = J_SCHEMAS["ds-gauge"]
    if decoder == "disabled":
        native.disable()
        jnative.disable()
    try:
        got = chunk.decode_partitions_batch(schema, groups)
        want = jchunk.decode_partitions_batch(jschema, groups)
    finally:
        native.enable()
        jnative.enable()
    assert len(got) == len(want) == len(groups)
    for (gts, gcols), (wts, wcols), css in zip(got, want, groups):
        _same(gts, wts)
        assert len(gcols) == len(wcols) == len(schema.data.columns) - 1
        for g, w in zip(gcols, wcols):
            _same(g, w)
        one = [chunk.decode_chunkset(schema, cs) for cs in css]
        _same(gts, np.concatenate([o[0] for o in one]))


def _hist_groups(widen: bool):
    """prom-histogram partitions whose bucket scheme widens 8 -> 12 in
    the second chunk when ``widen``."""
    schema = DEFAULT_SCHEMAS["prom-histogram"]
    rng = np.random.default_rng(11)
    groups = []
    for p in range(3):
        css, t = [], T0
        for c, nb in enumerate((8, 12 if widen else 8)):
            n = 20
            ts = t + np.arange(1, n + 1, dtype=np.int64) * 10_000
            t = int(ts[-1])
            tops = histogram.GeometricBuckets(1.0, 2.0, nb)
            counts = np.cumsum(rng.integers(0, 5, (n, nb)), axis=1)
            counts = np.cumsum(counts, axis=0).astype(np.int64)
            css.append(chunk.encode_chunkset(
                schema, f"h{p}".encode(), ts,
                [np.cumsum(rng.random(n)), np.arange(n, dtype=np.float64),
                 (tops, counts)], ingestion_seq=c))
        groups.append(css)
    return schema, groups


@pytest.mark.parametrize("widen", [False, True])
def test_hist_partitions_and_concat_hist_parts(widen):
    schema, groups = _hist_groups(widen)
    got = chunk.decode_partitions_batch(schema, groups)
    want = jchunk.decode_partitions_batch(J_SCHEMAS["prom-histogram"],
                                          groups)
    for (gts, gcols), (wts, wcols) in zip(got, want):
        _same(gts, wts)
        _same(gcols[0], wcols[0])
        _same(gcols[1], wcols[1])
        gb, grows = gcols[2]
        wb, wrows = wcols[2]
        _same(gb.bucket_tops(), wb.bucket_tops())
        assert gb.num_buckets == (12 if widen else 8)
        _same(grows, wrows)
    # directly: the widest scheme wins, narrower rows edge-pad
    parts = [chunk.decode_chunkset(schema, cs)[1][2] for cs in groups[0]]
    b, rows = histogram.concat_hist_parts(parts)
    jb, jrows = jhistogram.concat_hist_parts(parts)
    _same(rows, jrows)
    if widen:
        np.testing.assert_array_equal(rows[:20, 8:],
                                      np.repeat(rows[:20, 7:8], 4, axis=1))
    with pytest.raises(ValueError):
        histogram.concat_hist_parts([])
