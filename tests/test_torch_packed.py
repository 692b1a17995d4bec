"""The port's XOR-class packed path against the JAX package's.

- ``filodb_tpu_torch.codecs.xorgrid.pack_vals`` must emit byte-identical
  planes, meta tiles and lane maps to ``filodb_tpu.codecs.xorgrid`` for
  the same numpy plane: the p8/p16/p32/raw classes, with and without a
  phase row.
- ``rate_grid_packed_ref``, fed the JAX package's pack through
  ``packed_to_torch``, must match the JAX ``rate_grid_packed`` kernel in
  Pallas interpret mode: bit-equal for the free ops (selection and the
  sequential window sums alike: both add the K rows in the same order),
  rtol 1e-6 for the phase-mode rate chain, whose correction prefix is a
  matmul in the Pallas kernel and a serial sum here (the bound
  tests/test_devicestore.py:1118 holds the JAX package to).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.codecs import xorgrid as jxorgrid
from filodb_tpu.ops import grid as jgrid
from filodb_tpu_torch.codecs import xorgrid as txorgrid
from filodb_tpu_torch.ops import grid as tgrid

# the shapes are small: one thread per test worker leaves the other
# workers of a parallel run their cores
torch.set_num_threads(1)

STEP = 60_000


def _counters(rng, B, L, dtype=np.float32):
    """Integer-valued counters with a pinned f32 exponent: residuals fit
    16 bits."""
    start = (2 ** 23 + 128 * rng.integers(0, 2 ** 15, L)).astype(dtype)
    inc = 128 * rng.integers(1, 8, (B, L))
    return (start[None, :] + np.cumsum(inc, axis=0)).astype(dtype)


def _mixed_plane(rng, B, L, dtype=np.float32):
    """Lanes of every class: constants (p8), counters (p16; p32 in f64),
    incompressible noise (raw), NaN lanes and partial fills."""
    v = np.empty((B, L), dtype)
    n = L // 16
    v[:, :4 * n] = 5.0
    v[:, 4 * n:10 * n] = _counters(rng, B, 6 * n, dtype)
    v[:, 10 * n:11 * n] = np.nan
    v[:, 11 * n:12 * n] = rng.random((B, n)) * 100
    # f64 view of f32-exact values: residuals fit 32 bits (p32 in f64)
    v[:, 12 * n:13 * n] = (rng.random((B, n)) * 100).astype(np.float32)
    v[:, 13 * n:] = _counters(rng, B, L - 13 * n, dtype)
    v[:B // 4, 13 * n:] = np.nan
    return v


@pytest.mark.parametrize("with_phase", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("L", [400, 1000, 1100])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_vals_byte_identical(seed, L, dtype, with_phase):
    rng = np.random.default_rng(seed)
    v = _mixed_plane(rng, 64, L, np.dtype(dtype).type)
    phase = rng.integers(1, STEP, L).astype(np.int32) if with_phase \
        else None
    want = jxorgrid.pack_vals(v, phase=phase)
    got = txorgrid.pack_vals(v, phase=phase)
    assert want is not None and got is not None
    assert sorted(got.planes) == sorted(want.planes)
    for key, arr in want.planes.items():
        assert got.planes[key].dtype == arr.dtype, key
        assert got.planes[key].tobytes() == arr.tobytes(), key
    np.testing.assert_array_equal(got.inv, want.inv)
    assert got.nbytes == want.nbytes


def test_pack_classes_covered():
    """The sweep above reaches every class plane."""
    rng = np.random.default_rng(0)
    seen = set()
    for dtype in (np.float32, np.float64):
        pk = txorgrid.pack_vals(_mixed_plane(rng, 64, 512, dtype))
        seen |= {k for k in ("p8", "p16", "p32", "raw")
                 if k in pk.planes and pk.planes[k].shape[1]}
    assert seen == {"p8", "p16", "p32", "raw"}


def _jax_pack(v, phase=None):
    pk = jxorgrid.pack_vals(v, phase=phase)
    assert pk is not None
    return pk, {k: jnp.asarray(a) for k, a in pk.planes.items()}


FREE_OPS = ("sum", "count", "avg", "min", "max", "last")


@pytest.mark.parametrize("dense,stride", [(True, 1), (False, 1), (True, 2)])
@pytest.mark.parametrize("op", FREE_OPS)
def test_free_ops_match_pallas_interpret(op, dense, stride):
    rng = np.random.default_rng(12)
    B, L = 64, 256
    v = _mixed_plane(rng, B, L) if not dense else _counters(rng, B, L)
    if dense:
        v[:, 40:60] = np.nan                      # empty lanes
    pk, jdev = _jax_pack(v)
    T, K, row0 = 10, 4, 3
    q = jgrid.GridQuery(nsteps=T, kbuckets=K, gstep_ms=STEP, op=op,
                        is_rate=False, dense=dense, stride=stride)
    want = np.asarray(jgrid.rate_grid_packed(jdev, 0, q, row0=row0,
                                             interpret=True))
    tdev = txorgrid.packed_to_torch(pk, "cpu")
    got = tgrid.rate_grid_packed(tdev, 0, tgrid.GridQuery(*q), row0=row0)
    assert got.shape == want.shape
    assert tgrid.packed_width(tdev) == want.shape[1]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("row0", [0, 9])
@pytest.mark.parametrize("op", ["rate", "increase", "delta"])
def test_phase_ops_match_pallas_interpret(op, row0, stride):
    rng = np.random.default_rng(11)
    B, L = 64, 256
    v = _counters(rng, B, L)
    v[:, 200:230] = np.nan
    phase = rng.integers(1, STEP, L).astype(np.int32)
    pk, jdev = _jax_pack(v, phase=phase)
    T, K = 20, 5
    q = jgrid.GridQuery(nsteps=T, kbuckets=K, gstep_ms=STEP,
                        is_rate=(op == "rate"), op=op, dense=True,
                        stride=stride)
    want = np.asarray(jgrid.rate_grid_packed(jdev, 0, q, row0=row0,
                                             interpret=True,
                                             use_phase=True))
    tdev = txorgrid.packed_to_torch(pk, "cpu")
    got = tgrid.rate_grid_packed(tdev, 0, tgrid.GridQuery(*q), row0=row0,
                                 use_phase=True).numpy()
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


def test_decode_bit_exact_against_jax_unpack():
    rng = np.random.default_rng(5)
    v = _mixed_plane(rng, 96, 512)
    pay = np.frombuffer(np.uint32(0x7fc01dea).tobytes(), np.float32)[0]
    v[:, 3] = pay                                 # a NaN payload survives
    pk, _ = _jax_pack(v)
    tdev = txorgrid.packed_to_torch(pk, "cpu")
    cols = [tgrid.decode_packed_plane(p, m)
            for p, m, _k in tgrid._packed_planes(tdev)]
    dec = torch.cat(cols, dim=1).numpy()[:, pk.inv]
    np.testing.assert_array_equal(dec.view(np.uint32),
                                  jxorgrid.unpack_vals(pk).view(np.uint32))


def test_packed_rejects_bad_queries():
    rng = np.random.default_rng(0)
    pk, _ = _jax_pack(_counters(rng, 32, 128),
                      phase=np.ones(128, np.int32))
    tdev = txorgrid.packed_to_torch(pk, "cpu")
    q = tgrid.GridQuery(nsteps=8, kbuckets=4, gstep_ms=STEP, op="rate",
                        dense=True)
    with pytest.raises(ValueError, match="rows"):
        tgrid.rate_grid_packed(tdev, 0, q, row0=30, use_phase=True)
    with pytest.raises(ValueError, match="ts plane"):
        tgrid.rate_grid_packed(tdev, 0, q, use_phase=False)
    with pytest.raises(ValueError, match="phase-eligible"):
        tgrid.rate_grid_packed(tdev, 0, q._replace(dense=False),
                               use_phase=True)
