"""The port's aligned-grid window functions against the JAX package's.

The same numpy inputs go through ``filodb_tpu.ops.grid`` (its portable
reference ``rate_grid_ref`` and its Pallas kernel in interpret mode) and
through ``filodb_tpu_torch.ops.grid.rate_grid_ref``, the plain PyTorch
version the CUDA kernel is held to on the card.  Every served op is
checked in every mode: phase (dense, uniform phase), ts dense, ts gappy,
free dense and free gappy, at strides 1 and 2.

Tolerances: in f64 the two references agree to rtol 1e-9 (only the
association of the correction prefix sum differs), selection ops
(last/min/max/count) bit for bit.  In f32 against the Pallas kernel,
whose correction prefix is a log-step scan or a matmul, the sums and the
rate chain hold to rtol 2e-5, the bound the JAX package holds its own
phase serving to; selection ops stay bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import grid as jgrid
from filodb_tpu_torch.ops import grid as tgrid

# the shapes are small: one thread per test worker leaves the other
# workers of a parallel run their cores
torch.set_num_threads(1)

STEP = 60_000
T0 = 600_000
B = 40
K = 5
N_SERIES = 128
SELECTION_OPS = ("last", "min", "max", "count")

# (mode, dense, op): the 21 op/mode cases of the slice
CASES = ([("phase", True, op) for op in ("rate", "increase", "delta")]
         + [("ts", dense, op) for dense in (True, False)
            for op in ("rate", "increase", "delta")]
         + [("free", dense, op) for dense in (True, False)
            for op in ("sum", "count", "avg", "min", "max", "last")])


def _case_id(case):
    mode, dense, op = case
    return f"{mode}-{'dense' if dense else 'gappy'}-{op}"


def _grid_data(dense: bool, seed: int = 0):
    """[B-1, S] planes honoring the grid layout (row 0 = first bucket of
    the first window): per-lane uniform phase, counter resets; gappy
    data gets NaN holes, dense data all-finite lanes plus 16 all-NaN
    lanes (the store's padding)."""
    rng = np.random.default_rng(seed)
    phase = rng.integers(1, STEP, N_SERIES).astype(np.int64)
    base = (np.arange(B, dtype=np.int64) * STEP + T0 - STEP)[:, None]
    ts = base + phase[None, :]
    vals = np.cumsum(rng.random((B, N_SERIES)) * 10.0, axis=0)
    resets = rng.random((B, N_SERIES)) < 0.06
    for s in range(N_SERIES):
        for c in np.where(resets[:, s])[0]:
            vals[c:, s] -= vals[c, s] * 0.9
    if dense:
        vals[:, N_SERIES - 16:] = np.nan
    else:
        vals[rng.random((B, N_SERIES)) < 0.15] = np.nan
    return (ts[1:].astype(np.int32), vals[1:],
            phase.astype(np.int32))


def _query(mode, dense, op, stride):
    nsteps = (B - 1 - K) // stride + 1
    return jgrid.GridQuery(nsteps=nsteps, kbuckets=K, gstep_ms=STEP,
                           is_rate=(op == "rate"), op=op, dense=dense,
                           stride=stride)


def _steps0():
    return T0 + K * STEP


def _assert_match(got, want, op, rtol):
    assert got.shape == want.shape
    assert (np.isfinite(got) == np.isfinite(want)).all(), op
    fin = np.isfinite(want)
    if op in SELECTION_OPS:
        np.testing.assert_array_equal(got[fin], want[fin], err_msg=op)
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                                   err_msg=op)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ref_matches_jax_ref_f64(case, stride):
    mode, dense, op = case
    ts, vals, phase = _grid_data(dense)
    jq = _query(mode, dense, op, stride)
    tq = tgrid.GridQuery(*jq)
    ph = phase if mode == "phase" else None
    want = np.asarray(jgrid.rate_grid_ref(
        jnp.asarray(ts), jnp.asarray(vals, jnp.float64), _steps0(), jq,
        phase=None if ph is None else jnp.asarray(ph)))
    got = tgrid.rate_grid_ref(
        torch.as_tensor(ts), torch.as_tensor(vals, dtype=torch.float64),
        _steps0(), tq, phase=None if ph is None else torch.as_tensor(ph))
    assert got.dtype == torch.float64
    _assert_match(got.numpy(), want, op, rtol=1e-9)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ref_matches_pallas_interpret_f32(case, stride):
    mode, dense, op = case
    ts, vals, phase = _grid_data(dense, seed=1)
    vals = vals.astype(np.float32)
    jq = _query(mode, dense, op, stride)
    ph = phase if mode == "phase" else None
    want = np.asarray(jgrid.rate_grid(
        jnp.asarray(ts), jnp.asarray(vals), jnp.int32(_steps0()), jq,
        lanes=128, interpret=True,
        phase=None if ph is None else jnp.asarray(ph)))
    # the wrapper on CPU tensors runs the plain version
    got = tgrid.rate_grid(
        torch.as_tensor(ts), torch.as_tensor(vals), _steps0(),
        tgrid.GridQuery(*jq),
        phase=None if ph is None else torch.as_tensor(ph))
    assert got.dtype == torch.float32
    _assert_match(got.numpy(), want, op, rtol=2e-5)


@pytest.mark.parametrize("op", sorted(tgrid.SERVED_OPS))
@pytest.mark.parametrize("dense", [True, False])
def test_predicates_match_jax_cpu_branch(op, dense):
    """max_k_for / supports_grid / phase_eligible / mode selection are
    the JAX package's CPU-branch predicates, case for case."""
    assert tgrid.max_k_for(op, dense) == jgrid.max_k_for(op, dense)
    for window, step, nsteps in ((300_000, 60_000, 10),
                                 (300_000, 120_000, 500),
                                 (290_000, 60_000, 1),
                                 (60_000 * 1024, 60_000, 5),
                                 (60_000 * 65, 60_000, 5),
                                 (300_000, 60_000, 16_380),
                                 (300_000, 60_000, 16_381),
                                 (300_000, 30_000, 3)):
        mk = jgrid.max_k_for(op, dense)
        assert tgrid.supports_grid(window, step, STEP, nsteps, mk) == \
            jgrid.supports_grid(window, step, STEP, nsteps, mk)
    for k in (1, 2, 5):
        jq = jgrid.GridQuery(4, k, STEP, op=op, dense=dense)
        tq = tgrid.GridQuery(*jq)
        assert tgrid.phase_eligible(tq) == jgrid.phase_eligible(jq)
        for ph in (None, np.zeros(8, np.int32)):
            assert tgrid._mode_for(tq, ph) == jgrid._mode_for(jq, ph)


def test_unserved_op_raises():
    q = tgrid.GridQuery(3, K, STEP, op="bogus")
    vals = torch.zeros((8, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="not served"):
        tgrid.rate_grid_ref(None, vals, 0, q)


def test_cuda_wrapper_checks_rows_before_launch():
    """On a non-CPU tensor the wrapper validates and never falls back;
    a meta tensor stands in for a card here and is refused outright."""
    vals = torch.empty((8, 4), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        tgrid.rate_grid(None, vals, 0, tgrid.GridQuery(3, K, STEP, op="sum"))
    assert tgrid.rate_grid.launches == 0
