"""The staged B1 kernel's launch plan, routing and shapes, on the CPU.

* ``series_staged_plan``, the plan the wrapper hands the staged
  ``rate_grid`` kernel (csrc/series_staged.cu: ring bytes a plane, shared
  bytes a CTA): the plans of the store's ten B1 launches, the least ring
  holding a step, the direct kernel where no ring holds the step and for
  irate and the moments, and every staged plan for K 1-1,024 and T
  1-4,096 within a CTA's 227 KB.
* The launcher's routing on a stand-in library: the staged entry at a
  staged plan with the plan's arguments, the direct entry (counted in
  ``rate_grid.direct``) where no ring holds the step and for the direct
  ops, and a failed launch raising.
* ``rate_grid`` at widths that cut the kernel's 128-lane tile (100 and
  260 lanes), in phase, ts-dense, ts-gappy and free mode: the same numpy
  inputs go through ``filodb_tpu.ops.grid``'s Pallas kernel in interpret
  mode (its lanes padded with NaN columns to its 128-lane tile) and
  through ``filodb_tpu_torch.ops.grid``'s wrapper on CPU tensors (the
  plain PyTorch version the CUDA kernels are held to on the card).
  Tolerances as in tests/test_torch_grid.py: rtol 2e-5, NaN positions
  equal, selection ops bit for bit.
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import grid as jgrid
from filodb_tpu_torch.ops import grid as tgrid

torch.set_num_threads(1)

STEP = 60_000
T0 = 600_000
K = 5
ROWS = 30
CTA_BYTES = 232_448         # shared memory a CTA may use (227 KB)
MBARRIERS = 64              # the kernel's static RingBars

# the store's ten B1 launches (lanes, T, mode, op; K = 5, stride 1) and
# their plans: an 8 KB ring a plane (four stages of 4 rows of 128
# lanes), which the tiles' 49-64 rows wrap, and one for the timestamps in
# ts mode; irate and stddev on the direct kernel
PATH = {
    "Q2 rate": (102_400, 45, "phase", "rate"),
    "Q5 irate": (102_400, 60, "ts", "irate"),
    "Q5 idelta": (102_400, 60, "ts", "idelta"),
    "Q5 deriv": (102_400, 60, "ts", "deriv"),
    "Q5 predict_linear": (102_400, 60, "ts", "predict_linear"),
    "Q5 timestamp": (102_400, 60, "ts", "timestamp"),
    "Q4 rate": (110_592, 45, "ts", "rate"),
    "Q6 stddev": (110_592, 45, "free", "stddev"),
    "Q6 deriv": (110_592, 45, "ts", "deriv"),
    "Q6 timestamp": (110_592, 45, "ts", "timestamp"),
}
DIRECT = tgrid.SeriesPlan(0, 0)
PATH_PLANS = {name: (DIRECT if op in ("irate", "stddev") else
                     tgrid.SeriesPlan(8192, 16384) if mode == "ts"
                     else tgrid.SeriesPlan(8192, 8192))
              for name, (_ns, _t, mode, op) in PATH.items()}


@pytest.mark.parametrize("name", sorted(PATH))
def test_plans_of_the_path(name):
    ns, nsteps, mode, op = PATH[name]
    assert tgrid.series_staged_plan(ns, nsteps, K, 1, mode, op) \
        == PATH_PLANS[name]


def test_the_tile_and_the_shared_bytes():
    """A CTA is 128 lanes; the rings (8 KB a stage of 4 rows up to
    64 KB), two in ts mode, and the 64 bytes of mbarriers fit a CTA;
    seven CTAs of two 8 KB rings fit an SM's 228 KB with their 1 KB of
    reserve each, seven of two 16 KB rings do not."""
    assert tgrid.SERIES_TILE == 128
    assert [tgrid.ring_stage_rows(b, 4, 128)
            for b in tgrid.SERIES_RING_BYTES] == [4, 8, 16, 32]
    assert tgrid.CTA_SHARED_BYTES + MBARRIERS == CTA_BYTES
    assert 2 * max(tgrid.SERIES_RING_BYTES) <= tgrid.CTA_SHARED_BYTES
    sm = 228 * 1024
    assert 7 * (2 * 8192 + MBARRIERS + 1024) <= sm
    assert 7 * (2 * 16384 + MBARRIERS + 1024) > sm


@pytest.mark.parametrize("kbuckets,stride,ring", [
    (1, 1, 8192), (5, 1, 8192), (11, 1, 8192), (12, 1, 16384),
    (5, 7, 8192), (5, 8, 16384), (23, 1, 16384), (24, 1, 32768),
    (47, 1, 32768), (48, 1, 65536), (95, 1, 65536), (94, 2, 65536),
    (96, 1, 0), (95, 2, 0), (1024, 1, 0)])
def test_least_ring_holding_a_step(kbuckets, stride, ring):
    """A step's stride + K rows take the least ring whose three stages
    hold them (4, 8, 16, 32 rows), one a plane (two in ts mode), at any
    lane count and T; past 96 rows the direct kernel (the K-free dense
    ops reach K = 1,024)."""
    for ns in (1, 8192, 102_400):
        for nsteps in (1, 3, 500):
            for mode, op, planes in (("ts", "idelta", 2),
                                     ("phase", "rate", 1),
                                     ("free", "last", 1)):
                plan = tgrid.series_staged_plan(ns, nsteps, kbuckets,
                                                stride, mode, op)
                assert plan == tgrid.SeriesPlan(ring, planes * ring)
                assert plan.staged is bool(ring)
                assert plan == tgrid.series_ring_plan(kbuckets, stride,
                                                      mode)


@pytest.mark.parametrize("ns", [1, 8192, 102_400])
@pytest.mark.parametrize("op,mode", [("irate", "ts"), ("stddev", "free"),
                                     ("stdvar", "free"), ("zscore", "free")])
def test_direct_ops_take_the_direct_kernel(op, mode, ns):
    """irate and the moments go to the direct kernel (faster there at
    the store's widths), though a ring holds the step; the staged
    kernel's plan for them is still there to hold it to the direct
    one."""
    assert tgrid.SERIES_DIRECT_OPS == {"irate", "stddev", "stdvar",
                                       "zscore"}
    for nsteps, k in ((60, 5), (10, 2), (500, 30)):
        assert tgrid.series_staged_plan(ns, nsteps, k, 1, mode, op) \
            == DIRECT
        assert tgrid.series_ring_plan(k, 1, mode).staged


def test_no_lanes_no_plan():
    assert tgrid.series_staged_plan(0, 45, K, 1, "ts", "rate") == DIRECT


@pytest.mark.parametrize("ns", [8192, 102_400])
def test_every_staged_plan_fits_a_cta(ns):
    """Over K 1-1,024, T 1-4,096, strides 1-3 and every mode: a staged
    plan's ring holds a step in three stages, its rings (two in ts mode)
    fit a CTA's shared memory, and a plan is direct only where no ring
    holds the step."""
    ks = sorted({1, 2, 5, 8, 11, 12, 31, 32, 46, 47, 64, 93, 94, 95, 96,
                 120, 1024})
    ts = sorted({1, 2, 12, 13, 45, 60, 100, 1000, 4096})
    for mode, op in (("phase", "rate"), ("ts", "rate"), ("ts", "deriv"),
                     ("free", "sum")):
        planes = 2 if mode == "ts" else 1
        for k in ks:
            for t in ts:
                for stride in (1, 2, 3):
                    plan = tgrid.series_staged_plan(ns, t, k, stride, mode,
                                                    op)
                    if not plan.staged:
                        assert stride + k > 3 * 32
                        continue
                    stage = tgrid.ring_stage_rows(plan.ring_bytes, 4, 128)
                    assert stride + k <= 3 * stage
                    assert plan.shared == planes * plan.ring_bytes
                    assert plan.shared <= tgrid.CTA_SHARED_BYTES


def _grid_data(width: int, dense: bool, seed: int):
    """[ROWS, width] planes on the grid layout (a scrape phase a lane,
    counter resets); gappy data has NaN holes; lane 3 is all-NaN."""
    rng = np.random.default_rng(seed)
    phase = rng.integers(1, STEP, width).astype(np.int64)
    ts = (np.arange(ROWS, dtype=np.int64) * STEP + T0)[:, None] + phase
    vals = np.cumsum(rng.random((ROWS, width)) * 10.0, axis=0)
    for s in np.flatnonzero(rng.random(width) < 0.05):
        c = int(rng.integers(1, ROWS))
        vals[c:, s] -= vals[c, s] * 0.9
    if not dense:
        vals[rng.random((ROWS, width)) < 0.15] = np.nan
    vals[:, 3] = np.nan
    return ts.astype(np.int32), vals.astype(np.float32), phase.astype(
        np.int32)


def _pad(a, lanes: int, fill):
    """``a`` with its last axis padded to a multiple of ``lanes``."""
    pad = -a.shape[-1] % lanes
    width = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
    return np.pad(a, width, constant_values=fill)


@pytest.mark.parametrize("mode,dense,op", [
    ("phase", True, "rate"), ("ts", True, "increase"), ("ts", False, "rate"),
    ("ts", True, "irate"), ("ts", False, "deriv"), ("free", False, "max")])
@pytest.mark.parametrize("width", [100, 260])
def test_cut_tiles_match_pallas_interpret(width, mode, dense, op):
    """A tile cut by the lane count (100 lanes; 260 = two tiles and 4
    lanes): the wrapper on CPU tensors against the Pallas kernel over the
    same lanes padded to its 128-lane tile."""
    ts, vals, phase = _grid_data(width, dense, seed=width)
    jq = jgrid.GridQuery(nsteps=ROWS - K + 1, kbuckets=K, gstep_ms=STEP,
                         is_rate=op == "rate", op=op, dense=dense)
    ph = phase if mode == "phase" else None
    steps0 = T0 + K * STEP
    want = np.asarray(jgrid.rate_grid(
        jnp.asarray(_pad(ts, 128, 0)),
        jnp.asarray(_pad(vals, 128, np.nan)), jnp.int32(steps0), jq,
        lanes=128, interpret=True,
        phase=None if ph is None else jnp.asarray(_pad(ph, 128, 1))))
    want = want[:, :width]
    got = tgrid.rate_grid(
        torch.as_tensor(ts), torch.as_tensor(vals), steps0,
        tgrid.GridQuery(*jq),
        phase=None if ph is None else torch.as_tensor(ph)).numpy()
    assert got.shape == want.shape == (jq.nsteps, width)
    assert (np.isnan(got) == np.isnan(want)).all()
    fin = np.isfinite(want)
    assert fin[:, 0].all() or not dense
    assert not fin[:, 3].any()
    if op == "max":
        np.testing.assert_array_equal(got[fin], want[fin])
    elif op == "deriv":
        # slopes cross 0: each lane within 2e-5 of its largest
        scale = np.abs(np.where(fin, want, 0)).max(axis=0, keepdims=True)
        assert (np.abs(got - want)[fin] <= 2e-5 * np.broadcast_to(
            scale, want.shape)[fin]).all()
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5)


def test_cpu_wrapper_runs_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's bits and
    nothing counts as a launch."""
    ts, vals, phase = (torch.as_tensor(a) for a in _grid_data(100, True, 5))
    q = tgrid.GridQuery(nsteps=9, kbuckets=K, gstep_ms=STEP, dense=True,
                        stride=2)
    tgrid.reset_launch_counts()
    want = tgrid.rate_grid_ref(ts, vals, 0, q, phase=phase)
    got = tgrid.rate_grid(ts, vals, 0, q, phase=phase)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert tgrid.rate_grid.launches == 0
    assert tgrid.rate_grid.direct == 0


def test_reset_launch_counts_resets_the_direct_count():
    tgrid.rate_grid.direct = 3
    tgrid.reset_launch_counts()
    assert tgrid.rate_grid.direct == 0


class _Library:
    """A stand-in for the kernel library: records each entry's call and
    returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.rc
        return entry


@pytest.fixture
def library(monkeypatch):
    """The launcher on CPU tensors against a stand-in library."""
    lib = _Library()
    monkeypatch.setattr(tgrid.kernels, "library", lambda: lib)
    monkeypatch.setattr(tgrid, "_stream", lambda: ctypes.c_void_p(0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    tgrid.reset_launch_counts()
    yield lib
    tgrid.reset_launch_counts()


def _ints(args) -> list:
    return [a.value for a in args if isinstance(a, ctypes.c_int)]


@pytest.mark.parametrize("mode", ["phase", "ts", "free"])
@pytest.mark.parametrize("kbuckets,staged", [(5, True), (120, False)])
def test_launcher_takes_the_plan(library, kbuckets, staged, mode):
    """The staged entry at a staged plan, with the plan's ring bytes
    after rate_grid_launch's arguments; the direct entry, counted in
    ``.direct``, where no ring holds the step.  One launch either way,
    into a [T, S] out."""
    ts, vals, phase = (torch.as_tensor(a) for a in _grid_data(260, True, 6))
    ts, vals = torch.cat([ts] * 5), torch.cat([vals] * 5)   # K = 120
    op = "sum" if mode == "free" else "rate"
    nsteps = 6
    q = tgrid.GridQuery(nsteps=nsteps, kbuckets=kbuckets, gstep_ms=STEP,
                        dense=True, is_rate=op == "rate", op=op)
    out = tgrid._series_launch(ts if mode == "ts" else None, vals, 0, q,
                               phase if mode == "phase" else None)
    assert out.shape == (nsteps, 260)
    (name, args), = library.calls
    base = [vals.shape[0], 260, nsteps, kbuckets, 1, STEP, 0,
            tgrid._OP_CODE[op], {"free": 0, "phase": 1, "ts": 2}[mode], 1,
            int(op == "rate")]
    plan = tgrid.series_staged_plan(260, nsteps, kbuckets, 1, mode, op)
    assert plan.staged is staged
    if staged:
        assert name == "series_staged_launch"
        assert _ints(args)[:12] == base + [plan.ring_bytes]
    else:
        assert name == "rate_grid_launch"
        assert _ints(args)[:11] == base
    # the planes the mode reads: ts in ts mode, the phase row in phase
    # mode, as null pointers otherwise
    assert (args[1].value is not None) is (mode == "ts")
    assert (args[2].value is not None) is (mode == "phase")
    assert tgrid.rate_grid.launches == 1
    assert tgrid.rate_grid.direct == int(not staged)


@pytest.mark.parametrize("op,mode", [("irate", "ts"), ("stddev", "free"),
                                     ("stdvar", "free"), ("zscore", "free"),
                                     ("idelta", "ts"), ("changes", "free")])
def test_launcher_sends_the_direct_ops_to_the_direct_entry(library, op,
                                                           mode):
    """irate and the moments launch the direct entry, counted in
    ``.direct``; their neighbours the staged one."""
    ts, vals, _ph = (torch.as_tensor(a) for a in _grid_data(64, True, 8))
    q = tgrid.GridQuery(nsteps=6, kbuckets=K, gstep_ms=STEP, dense=True,
                        op=op)
    tgrid._series_launch(ts if mode == "ts" else None, vals, 0, q, None)
    (name, _args), = library.calls
    direct = op in tgrid.SERIES_DIRECT_OPS
    assert name == ("rate_grid_launch" if direct else "series_staged_launch")
    assert tgrid.rate_grid.launches == 1
    assert tgrid.rate_grid.direct == int(direct)


def test_a_failed_launch_raises(library):
    library.rc = 1
    _ts, vals, phase = (torch.as_tensor(a) for a in _grid_data(64, True, 7))
    q = tgrid.GridQuery(nsteps=6, kbuckets=K, gstep_ms=STEP, dense=True)
    with pytest.raises(RuntimeError, match="rate_grid kernel"):
        tgrid._series_launch(None, vals, 0, q, phase)
    assert tgrid.rate_grid.launches == 1
