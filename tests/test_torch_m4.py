"""The port's M4 selection (``filodb_tpu_torch.ops.grid.m4_grid`` on CPU
tensors, i.e. its plain version ``m4_grid_ref``) against the JAX package's
Pallas kernel in interpret mode and its portable reference, bit for bit,
and the port's ``DownsampleMapper`` against the JAX package's on the same
batch."""

import numpy as np
import pytest
import torch

from filodb_tpu.ops.grid import m4_grid as jm4_grid
from filodb_tpu.ops.grid import m4_grid_ref as jm4_grid_ref
from filodb_tpu.query.model import PeriodicBatch as JPeriodicBatch
from filodb_tpu.query.transformers import DownsampleMapper as JDownsample
from filodb_tpu_torch.ops import grid
from filodb_tpu_torch.ops.windows import StepRange
from filodb_tpu_torch.query.model import PeriodicBatch
from filodb_tpu_torch.query.transformers import DownsampleMapper

BASE = 1_700_000_000_000


def _cases():
    """The case set of tests/test_m4_downsample.py, plus a series count
    that is not a multiple of 8."""
    rng = np.random.default_rng(5)
    t, s = 103, 8
    gappy = rng.normal(0, 10, (t, s)).astype(np.float32)
    gappy[rng.random((t, s)) < 0.3] = np.nan     # NaN gaps
    const = np.ones((t, s), np.float32) * 7.5    # constant runs (ties)
    allnan = gappy.copy()
    allnan[:, 3] = np.nan                        # one all-NaN series
    allnan[40:80, :] = np.nan                    # empty bins mid-range
    exact = rng.normal(0, 1, (100, s)).astype(np.float32)  # t % P == 0
    odd = rng.normal(0, 3, (57, 13)).astype(np.float32)
    odd[rng.random(odd.shape) < 0.2] = np.nan
    odd[:, 5] = 2.0
    return [("gappy", gappy, 10), ("const", const, 10),
            ("allnan", allnan, 10), ("exact", exact, 10),
            ("partial-tail", gappy, 9),          # w*P > T: padded tile
            ("one-per-bin", exact, 100),         # w == 1
            ("s13", odd, 6), ("s13-empty-tail-bins", odd[:10], 9)]


def _bit_equal(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


@pytest.mark.parametrize("name,vals,pixels", _cases(),
                         ids=[c[0] for c in _cases()])
def test_m4_matches_jax_kernel_and_ref(name, vals, pixels):
    got = grid.m4_grid(torch.as_tensor(vals), pixels)
    assert got.shape == (pixels, 8, vals.shape[1])
    assert got.dtype == torch.float32
    want_ref = np.asarray(jm4_grid_ref(vals, pixels))
    assert _bit_equal(got.numpy(), want_ref), name
    # the Pallas kernel needs the series axis to tile by its lane width
    s = vals.shape[1]
    lanes = 8 if s % 8 == 0 else s
    want_kernel = np.asarray(jm4_grid(vals, pixels, lanes=lanes,
                                      interpret=True))
    assert _bit_equal(got.numpy(), want_kernel), name
    assert grid.m4_grid.launches == 0      # the CPU runs the plain version


def test_m4_ties_break_to_first_occurrence():
    vals = torch.tensor([[5], [1], [1], [5], [5]], dtype=torch.float32)
    got = grid.m4_grid(vals, 1)[0, :, 0]
    assert got[4] == 1.0 and got[5] == 0.0    # imin, imax
    assert got[6] == 0.0 and got[7] == 4.0    # ifirst, ilast


@pytest.mark.parametrize("first_negative", [True, False])
def test_m4_tied_zeros_keep_the_first_ones_bits(first_negative):
    """+0.0 and -0.0 tie: vmin, vmax and vfirst carry the first zero's
    sign bit, as the kernel's strict compares keep it."""
    zeros = np.zeros((6, 3), np.float32)
    zeros[0 if first_negative else 1::2] = -0.0
    got = grid.m4_grid(torch.as_tensor(zeros), 2)
    for p in range(2):
        first = np.signbit(zeros[3 * p, 0])
        assert (np.signbit(got[p, :3].numpy()) == first).all()
        assert (got[p, 4:7].numpy() == 0).all()   # imin, imax, ifirst


def test_m4_rejects_bad_input():
    with pytest.raises(ValueError):
        grid.m4_grid(torch.zeros((0, 4)), 3)
    with pytest.raises(ValueError):
        grid.m4_grid(torch.zeros((4, 4)), 0)


@pytest.mark.parametrize("pixels", [7, 50])
def test_downsample_mapper_matches_jax(pixels):
    rng = np.random.default_rng(pixels)
    s, t, step = 5, 700, 30_000
    vals = rng.normal(0, 5, (s, t))
    vals[rng.random((s, t)) < 0.1] = np.nan
    vals[2] = np.nan
    keys = [{"inst": f"i{i}"} for i in range(s)]
    steps = StepRange(BASE, BASE + (t - 1) * step, step)
    [want] = JDownsample(pixels).apply([JPeriodicBatch(keys, steps, vals)],
                                       None)
    [got] = DownsampleMapper(pixels).apply(
        [PeriodicBatch(keys, steps, torch.as_tensor(vals))], None)
    assert got.keys == want.keys
    assert _bit_equal(got.np_values(), want.np_values())
