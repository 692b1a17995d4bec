"""The port's fused grouped window kernels against the JAX package's.

The same numpy inputs go through ``filodb_tpu.ops.grid``'s Pallas
kernels in interpret mode and through ``filodb_tpu_torch.ops.grid``'s
wrappers on CPU tensors, which run the plain PyTorch versions the CUDA
kernels are held to on the card:

- ``rate_grid_grouped`` (B2) in free, phase and ts mode, dense and gappy
  lanes, strides 1 and 2, with a padded group of all-NaN lanes;
- the contract's ``ValueError``s, and the wrappers' refusal of a tensor
  that is on neither the CPU nor a card.

``tests/test_torch_grouped_packed.py`` holds the packed form (B4).

Tolerances: sums rtol 2e-5 (the JAX tests' own bound for the grouped
sums, tests/test_packed_kernel.py:483; the correction prefix is a matmul
or a log-step scan there and a cumulative sum here), counts and NaN
positions equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import grid as jgrid
from filodb_tpu_torch.ops import grid as tgrid

torch.set_num_threads(1)

STEP = 60_000
T0 = 600_000
B = 40
K = 5
G = 8                       # the JAX kernels need a multiple of 8 groups
GL = 32


def _grid_data(dense: bool, seed: int):
    """[B-1, G*GL] planes on the grid layout (per-lane phase, counter
    resets); gappy data has NaN holes; the last group is all-NaN
    padding."""
    rng = np.random.default_rng(seed)
    S = G * GL
    phase = rng.integers(1, STEP, S).astype(np.int64)
    ts = (np.arange(B, dtype=np.int64) * STEP + T0 - STEP)[:, None] + phase
    vals = np.cumsum(rng.random((B, S)) * 10.0, axis=0)
    for s in np.flatnonzero(rng.random(S) < 0.05):
        c = int(rng.integers(1, B))
        vals[c:, s] -= vals[c, s] * 0.9
    if not dense:
        vals[rng.random((B, S)) < 0.15] = np.nan
    vals[:, -GL:] = np.nan
    return (ts[1:].astype(np.int32), vals[1:].astype(np.float32),
            phase.astype(np.int32))


def _assert_grouped(got, want):
    (gs, gc), (ws, wc) = got, want
    gs, gc = gs.numpy(), gc.numpy()
    ws, wc = np.asarray(ws), np.asarray(wc)
    assert gs.shape == ws.shape and gc.shape == wc.shape
    np.testing.assert_array_equal(gc, wc)
    assert (np.isnan(gs) == np.isnan(ws)).all()
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=2e-5)


CASES = ([("phase", True, op) for op in ("rate", "increase", "delta")]
         + [("ts", dense, op) for dense in (True, False)
            for op in ("rate", "increase", "delta")]
         + [("free", dense, op) for dense in (True, False)
            for op in ("sum", "count", "avg", "min", "max", "last")])


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"{c[0]}-{'dense' if c[1] else 'gappy'}"
                                       f"-{c[2]}")
def test_grouped_matches_pallas_interpret(case, stride):
    mode, dense, op = case
    ts, vals, phase = _grid_data(dense, seed=3)
    jq = jgrid.GridQuery(nsteps=(B - 1 - K) // stride + 1, kbuckets=K,
                         gstep_ms=STEP, is_rate=(op == "rate"), op=op,
                         dense=dense, stride=stride)
    ph = phase if mode == "phase" else None
    steps0 = T0 + K * STEP
    want = jgrid.rate_grid_grouped(
        jnp.asarray(ts), jnp.asarray(vals), jnp.int32(steps0), jq,
        group_lanes=GL, interpret=True,
        phase=None if ph is None else jnp.asarray(ph))
    got = tgrid.rate_grid_grouped(
        torch.as_tensor(ts), torch.as_tensor(vals), steps0,
        tgrid.GridQuery(*jq), GL,
        phase=None if ph is None else torch.as_tensor(ph))
    _assert_grouped(got, want)
    # the padded group: nothing counted, nothing summed
    assert not got[1][-1].any() and not got[0][-1].any()
    assert got[1][0].min() > 0


def test_any_group_count():
    """The port takes any G >= 1 (the TPU's G % 8 rule is its output
    tile's): three groups match rate_grid_ref and a per-group sum."""
    ts, vals, phase = _grid_data(True, seed=4)
    n = 3 * GL
    ts, vals, phase = (torch.as_tensor(a[..., :n]) for a in (ts, vals, phase))
    q = tgrid.GridQuery(nsteps=20, kbuckets=K, gstep_ms=STEP, dense=True)
    s, c = tgrid.rate_grid_grouped(None, vals, 0, q, GL, phase=phase)
    per = tgrid.rate_grid_ref(None, vals, 0, q, phase=phase)
    assert s.shape == c.shape == (3, 20)
    for g in range(3):
        torch.testing.assert_close(s[g], per[:, g * GL:(g + 1) * GL].sum(1),
                                   rtol=1e-6, atol=0)
        assert (c[g] == GL).all()


def test_grouped_rejects():
    rng = np.random.default_rng(19)
    q = tgrid.GridQuery(nsteps=8, kbuckets=4, gstep_ms=STEP, dense=True)
    vals = torch.as_tensor(np.cumsum(rng.random((16, 96)), axis=0),
                           dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of group_lanes"):
        tgrid.rate_grid_grouped(None, vals, 0, q, 64,
                                phase=torch.ones(96, dtype=torch.int32))
    with pytest.raises(ValueError, match="rows"):
        tgrid.rate_grid_grouped(None, vals[:5], 0, q, 32,
                                phase=torch.ones(96, dtype=torch.int32))


def test_cuda_wrappers_never_fall_back():
    """On a non-CPU tensor the grouped wrappers validate and never run
    the plain version; a meta tensor stands in for a card and is
    refused."""
    q = tgrid.GridQuery(3, K, STEP, op="sum")
    vals = torch.empty((8, 64), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgrid.rate_grid_grouped(None, vals, 0, q, 32)
    planes = {"p16": torch.empty((8, 64), dtype=torch.int16, device="meta"),
              "m16": torch.empty((8, 64), dtype=torch.int32, device="meta")}
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgrid.rate_grid_grouped_packed(planes, 0, q, 32, use_phase=False)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgrid.hist_grid_grouped_packed(planes, 0, q, 4, 32, use_phase=False)
    assert tgrid.rate_grid_grouped.launches == 0
    assert tgrid.rate_grid_grouped_packed.launches == 0
    assert tgrid.hist_grid_grouped_packed.launches == 0
