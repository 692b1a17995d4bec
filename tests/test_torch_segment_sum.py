"""The port's fixed-order group sum (``filodb_tpu_torch.ops.aggregate.
segment_sum``): each group's rows added in ascending row order from 0.0.
On the CPU it must give the bits ``index_add_`` gave (which adds in row
order too), equal a plain left-to-right loop per group, and match the JAX
package's ``jax.ops.segment_sum`` on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import aggregate as jagg
from filodb_tpu_torch.memstore import devicestore
from filodb_tpu_torch.ops import aggregate

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


def _case(seed: int, shape: tuple, groups: int, nan_frac: float,
          empty_groups: int, dtype) -> tuple:
    """Values spanning nine decades (so the order of the adds shows in
    the bits), ``nan_frac`` of them NaN, and ids over the first
    ``groups - empty_groups`` groups in a random (permuted) order."""
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal(shape)
            * 10.0 ** rng.uniform(-3, 6, size=shape)).astype(dtype)
    vals[rng.random(shape) < nan_frac] = np.nan
    ids = rng.permutation(
        rng.integers(0, groups - empty_groups, shape[0])).astype(np.int64)
    return vals, ids


def _index_add(vals: np.ndarray, ids: np.ndarray, groups: int) -> np.ndarray:
    """The port's sum before it was made fixed-order: ``index_add_``."""
    v = torch.from_numpy(vals)
    return torch.zeros((groups,) + v.shape[1:], dtype=v.dtype).index_add_(
        0, torch.from_numpy(ids), v).numpy()


def _seg(vals: np.ndarray, ids: np.ndarray, groups: int) -> np.ndarray:
    return aggregate.segment_sum(torch.from_numpy(vals),
                                 torch.from_numpy(ids), groups).numpy()


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Bit for bit, NaN payloads aside (both sides' NaNs are NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = np.isnan(a)
    return bool(np.array_equal(nan, np.isnan(b))
                and np.array_equal(a[~nan].view(np.uint8),
                                   b[~nan].view(np.uint8)))


def _loop(vals: np.ndarray, ids: np.ndarray, groups: int) -> np.ndarray:
    """A plain left-to-right loop per group, in the operand's dtype."""
    out = np.zeros((groups,) + vals.shape[1:], dtype=vals.dtype)
    for g in range(groups):
        acc = np.zeros(vals.shape[1:], dtype=vals.dtype)
        for row in np.flatnonzero(ids == g):
            acc = (acc + vals[row]).astype(vals.dtype)
        out[g] = acc
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,groups,nan_frac,empty", [
    ((1, 4), 1, 0.0, 0),                 # one row, one group
    ((300, 23), 9, 0.0, 0),              # every group live
    ((300, 23), 9, 0.1, 3),              # NaN rows, three empty groups
    ((257, 5), 40, 0.3, 10),             # more groups than a warp
    ((64,), 7, 0.05, 2),                 # a 1-D operand
    ((0, 6), 5, 0.0, 0),                 # no rows: all groups empty
])
def test_equals_index_add(dtype, shape, groups, nan_frac, empty):
    """Bit for bit the sums ``index_add_`` gave on the CPU."""
    vals, ids = _case(11, shape, groups, nan_frac, min(empty, groups - 1),
                      DTYPES[dtype][0])
    got = _seg(vals, ids, groups)
    assert _bits_equal(got, _index_add(vals, ids, groups))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_nan_masked_rows_as_the_aggregator_sends_them(dtype):
    """The aggregator's operand: non-finite cells zeroed, and the finite
    count; both bit for bit to ``index_add_``."""
    vals, ids = _case(3, (500, 31), 12, 0.25, 2, DTYPES[dtype][0])
    fin = np.isfinite(vals)
    masked = np.where(fin, vals, 0).astype(vals.dtype)
    count = fin.astype(vals.dtype)
    for operand in (masked, count, masked * masked):
        assert _bits_equal(_seg(operand, ids, 12),
                           _index_add(operand, ids, 12))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hb", [1, 8, 20])
def test_histogram_operand(dtype, hb):
    """The 3-D ``[S, T, hb]`` operand of the histogram sum."""
    vals, ids = _case(7, (90, 13, hb), 6, 0.1, 1, DTYPES[dtype][0])
    vals = np.where(np.isfinite(vals), np.abs(vals), 0).astype(vals.dtype)
    got = _seg(vals, ids, 6)
    assert got.shape == (6, 13, hb)
    assert _bits_equal(got, _index_add(vals, ids, 6))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_equals_left_to_right_loop(dtype, seed):
    vals, ids = _case(seed, (120, 9), 8, 0.1, 2, DTYPES[dtype][0])
    assert _bits_equal(_seg(vals, ids, 8), _loop(vals, ids, 8))


def test_order_shows_in_the_bits():
    """The case set is one where the order of the adds matters: summing
    each group's rows in reverse order gives other bits somewhere."""
    vals, ids = _case(0, (120, 9), 8, 0.0, 0, np.float32)
    rev = np.arange(len(ids))[::-1]
    assert not _bits_equal(_seg(vals[rev], ids[rev], 8), _seg(vals, ids, 8))


def test_same_bits_every_run():
    vals, ids = _case(5, (400, 17), 10, 0.1, 2, np.float32)
    first = _seg(vals, ids, 10)
    for _ in range(3):
        assert _bits_equal(_seg(vals, ids, 10), first)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,groups", [((300, 23), 9), ((257, 5), 40),
                                          ((64,), 7), ((90, 13, 8), 6)])
def test_matches_jax_segment_sum(dtype, shape, groups):
    """``jax.ops.segment_sum`` on the CPU on the same numpy inputs: XLA's
    CPU scatter adds the updates in row order too, so bit for bit."""
    vals, ids = _case(21, shape, groups, 0.1, 2, DTYPES[dtype][0])
    vals = np.where(np.isfinite(vals), vals, 0).astype(vals.dtype)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids),
                                          groups))
    assert _bits_equal(_seg(vals, ids, groups), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_group_sum_matches_jax_seg_sum(dtype):
    """The masked sum and finite count the aggregator builds from it
    against the JAX package's ``seg_sum`` (NaN where a group has no
    finite value)."""
    vals, ids = _case(4, (200, 15), 11, 0.3, 3, DTYPES[dtype][0])
    v = torch.from_numpy(vals)
    fin = torch.isfinite(v)
    i = torch.from_numpy(ids)
    s = aggregate.segment_sum(torch.where(fin, v, torch.zeros_like(v)), i, 11)
    n = aggregate.segment_sum(fin.to(v.dtype), i, 11)
    got = torch.where(n > 0, s, torch.full_like(s, float("nan"))).numpy()
    want = np.asarray(jagg.seg_sum(jnp.asarray(vals), jnp.asarray(ids), 11))
    assert _bits_equal(got, want)


@pytest.mark.parametrize("op", ["sum", "count", "moments"])
@pytest.mark.parametrize("exact", [False, True])
def test_grid_reduce_past_onehot(op, exact):
    """The grid's reduce above ``_ONEHOT_MAX_G`` groups: bit for bit what
    its ``index_add_`` gave, the sums in f64 under ``exact`` and
    rounded once to f32."""
    G = devicestore._ONEHOT_MAX_G + 50
    rng = np.random.default_rng(9)
    lanes, T = 3 * G, 6
    stepped = (rng.standard_normal((T, lanes))
               * 10.0 ** rng.uniform(-2, 5, (T, lanes))).astype(np.float32)
    stepped[rng.random((T, lanes)) < 0.1] = np.nan
    garr = rng.permutation(np.arange(lanes) % (G + 1)).astype(np.int32)
    st, ga = torch.from_numpy(stepped), torch.from_numpy(garr)
    got = devicestore._grouped_reduce_impl(st, ga, G, op, exact=exact)
    v = st.T
    fin = torch.isfinite(v)
    vz = torch.where(fin, v, torch.zeros_like(v))
    planes = [vz, fin.to(v.dtype)] + ([vz * vz] if op == "moments" else [])
    acc = torch.float64 if exact else torch.float32
    want = torch.stack([
        torch.zeros((G + 1, T), dtype=acc).index_add_(
            0, ga.to(torch.int64), p.to(acc))[:G].to(torch.float32)
        for p in planes])
    assert _bits_equal(got.numpy(), want.numpy())
