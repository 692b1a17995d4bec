"""The host side of the packed kernel's one launch, and the order
arguments its sort family rests on, on the CPU.

* ``packed_plane_table`` — the table ``rate_grid_packed`` hands its one
  kernel launch: every non-empty class plane in packed order with its
  width, output column and word kind, checked on packs of one, two and
  three class planes (and a p32 plane), and against the plain version's
  output columns.
* mad's deviations from the median of a sorted window are two monotone
  runs; the kernel merges them instead of sorting them again (a
  two-pointer merge for long windows, a bitonic merge of the window
  padded with +Inf for windows of up to 8 rows).  Plain PyTorch models of
  both merges, and of the register path's first sort (an odd-even
  transposition sort that swaps only pairs strictly out of order), are
  held bit for bit against ``torch.sort`` over random sorted windows,
  ties, signed zeros and infinities included.
"""

import math

import numpy as np
import pytest
import torch

from filodb_tpu_torch.codecs import xorgrid
from filodb_tpu_torch.ops import grid

STEP = 60_000
REG_K = 8            # the kernel's register window (kSortRegK)


def _counters(rng, rows, cols):
    """Integer counters with a pinned f32 exponent: XOR residuals in bits
    7-22, one 16-bit class."""
    start = 2 ** 23 + 128 * rng.integers(0, 2 ** 15, cols)
    inc = 128 * rng.integers(1, 8, (rows, cols))
    return (start[None, :] + np.cumsum(inc, axis=0)).astype(np.float32)


def _pack(rng, classes: str) -> dict:
    """CPU tensors of a pack whose class planes are ``classes``."""
    rows, cols = 64, 512
    v = _counters(rng, rows, cols)
    phase = rng.integers(1, STEP, cols).astype(np.int32)
    if classes == "p16":
        pk = xorgrid.pack_vals(v, phase=phase, min_width=16).planes
    elif classes == "p8+p16":
        v[:, :128] = 5.0
        pk = xorgrid.pack_vals(v, phase=phase).planes
    else:                                       # three planes
        v[:, :128] = 5.0
        v[:, 128:256] = (1e6 + np.cumsum(rng.random((rows, 128)) * 1e3,
                                         axis=0)).astype(np.float32)
        pk = dict(xorgrid.pack_vals(v, phase=phase).planes)
        if classes == "p8+p16+p32":             # raw lanes as a p32 plane
            pk["p32"] = pk["raw"].view(np.uint32).copy()
            m = pk["mraw"].copy()
            m[0] = 0
            pk["m32"] = m
            pk["raw"] = np.zeros((rows, 0), np.float32)
            pk["mraw"] = np.zeros((8, 0), np.int32)
    return xorgrid.packed_to_torch(pk, "cpu")


@pytest.mark.parametrize("classes,kinds", [
    ("p16", [1]), ("p8+p16", [0, 1]), ("p8+p16+raw", [0, 1, 3]),
    ("p8+p16+p32", [0, 1, 2])])
def test_plane_table_in_packed_order(classes, kinds):
    packed = _pack(np.random.default_rng(3), classes)
    table = grid.packed_plane_table(packed)
    assert [e.kind for e in table] == kinds
    keys = [grid._PLANES[k][0] for k in kinds]
    col = 0
    for e, key in zip(table, keys):
        assert e.plane is packed[key]
        assert e.meta is packed[grid._PLANES[e.kind][1]]
        assert e.n == packed[key].shape[1] > 0
        assert e.col == col
        col += e.n
    assert col == grid.packed_width(packed)
    # each entry's columns of the plain version's output are its plane's
    q = grid.GridQuery(nsteps=8, kbuckets=5, gstep_ms=STEP, is_rate=True,
                       op="rate", dense=True)
    whole = grid.rate_grid_packed(packed, 0, q, row0=2, use_phase=True)
    for e in table:
        alone = grid.rate_grid_packed_ref(
            {grid._PLANES[e.kind][0]: e.plane,
             grid._PLANES[e.kind][1]: e.meta}, 0, q, row0=2, use_phase=True)
        assert torch.equal(whole[:, e.col:e.col + e.n], alone)


def test_plane_table_skips_empty_planes_and_refuses_an_empty_pack():
    packed = _pack(np.random.default_rng(4), "p16")
    packed["p8"] = torch.zeros((64, 0), dtype=torch.uint8)
    packed["m8"] = torch.zeros((8, 0), dtype=torch.int32)
    assert [e.kind for e in grid.packed_plane_table(packed)] == [1]
    assert grid.packed_plane_table({}) == []
    q = grid.GridQuery(nsteps=4, kbuckets=5, gstep_ms=STEP, is_rate=False,
                       op="sum", dense=True)
    with pytest.raises(ValueError, match="no class planes"):
        grid.rate_grid_packed({}, 0, q)


# ---------------------------------------------------------------- sorting

def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _windows(kind: str, n: int, k: int, seed: int) -> torch.Tensor:
    """[n, k] f32 windows (unsorted)."""
    rng = np.random.default_rng([seed, k])
    if kind == "ties":
        w = rng.integers(-3, 4, (n, k)).astype(np.float32)
    elif kind == "floats":
        w = rng.normal(0, 1e3, (n, k)).astype(np.float32)
    elif kind == "signed_zeros":
        w = rng.integers(-1, 2, (n, k)).astype(np.float32)
        w[w == 0] = np.where(rng.random(int((w == 0).sum())) < 0.5, -0.0,
                             0.0)
    else:                                                   # infinities
        w = rng.normal(0, 10, (n, k)).astype(np.float32)
        w[rng.random((n, k)) < 0.1] = np.inf
        w[rng.random((n, k)) < 0.1] = -np.inf
    return torch.as_tensor(w)


def _median(s: torch.Tensor) -> torch.Tensor:
    """The kernel's interpolated median of sorted windows, in f32."""
    lo, hi, w_lo, w_hi, _fill = grid._interp_weights(0.5, s.shape[1])
    if lo == hi:
        return s[:, lo]
    return (s[:, lo] * torch.tensor(w_lo, dtype=torch.float32)
            + s[:, hi] * torch.tensor(w_hi, dtype=torch.float32))


def _order_pair(v: torch.Tensor, a: int, b: int) -> None:
    """The kernel's compare-exchange: swap only a pair strictly out of
    order."""
    swap = v[:, a] > v[:, b]
    lo = torch.where(swap, v[:, b], v[:, a])
    v[:, b] = torch.where(swap, v[:, a], v[:, b])
    v[:, a] = lo


def transposition_sort(w: torch.Tensor) -> torch.Tensor:
    """The register path's first sort: the window padded to REG_K with
    +Inf, REG_K rounds of odd-even transposition -> its first K."""
    n, k = w.shape
    v = torch.full((n, REG_K), math.inf)
    v[:, :k] = w
    for rnd in range(REG_K):
        for i in range(rnd & 1, REG_K - 1, 2):
            _order_pair(v, i, i + 1)
    return v[:, :k]


def merged_deviations_two_pointer(s: torch.Tensor, q: torch.Tensor):
    """|s - q| in ascending order by merging its two runs: from the last
    value below q down, and from the first value at or above q up."""
    n, k = s.shape
    dev = (s - q[:, None]).abs()
    below = (s < q[:, None]).sum(1)
    i, j = below - 1, below.clone()
    out = torch.empty_like(dev)
    for pos in range(k):
        left = dev.gather(1, i.clamp(min=0)[:, None])[:, 0]
        right = dev.gather(1, j.clamp(max=k - 1)[:, None])[:, 0]
        take_left = (i >= 0) & ((j >= k) | (left <= right))
        out[:, pos] = torch.where(take_left, left, right)
        i = torch.where(take_left, i - 1, i)
        j = torch.where(take_left, j, j + 1)
    return out


def merged_deviations_bitonic(s: torch.Tensor, q: torch.Tensor):
    """|s - q| padded to REG_K with +Inf (a V-shaped, so bitonic,
    sequence) through a bitonic merge -> its first K."""
    n, k = s.shape
    v = torch.full((n, REG_K), math.inf)
    v[:, :k] = (s - q[:, None]).abs()
    step = REG_K // 2
    while step:
        for i in range(REG_K):
            if i & step == 0:
                _order_pair(v, i, i + step)
        step //= 2
    return v[:, :k]


KINDS = ("ties", "floats", "signed_zeros", "infinities")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", (1, 2, 3, 5, 8, 9, 17, 32))
def test_two_pointer_merge_is_the_sort_of_the_deviations(kind, k):
    s = torch.sort(_windows(kind, 4000, k, 1), dim=1).values
    q = _median(s)
    dev = (s - q[:, None]).abs()
    keep = ~torch.isnan(dev).any(1)     # a NaN deviation sorts as before
    assert int(keep.sum()) > 2500
    want = torch.sort(dev[keep], dim=1).values
    got = merged_deviations_two_pointer(s[keep], q[keep])
    assert torch.equal(_bits(got), _bits(want))
    # the median of the deviations is the same float either way
    assert torch.equal(_bits(_median(got)), _bits(_median(want)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", (1, 2, 3, 5, 8))
def test_bitonic_merge_is_the_sort_of_the_deviations(kind, k):
    s = torch.sort(_windows(kind, 4000, k, 2), dim=1).values
    q = _median(s)
    keep = ~torch.isnan((s - q[:, None]).abs()).any(1)
    want = torch.sort((s[keep] - q[keep, None]).abs(), dim=1).values
    got = merged_deviations_bitonic(s[keep], q[keep])
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", (1, 2, 3, 5, 8))
def test_transposition_sort_is_the_stable_sort(kind, k):
    """Swapping only pairs strictly out of order keeps equal floats
    (+0.0 and -0.0) in their order, as the insertion sort the kernel ran
    before does: its floats are a stable sort's, bit for bit."""
    w = _windows(kind, 4000, k, 3)
    want = torch.sort(w, dim=1, stable=True).values
    assert torch.equal(_bits(transposition_sort(w)), _bits(want))


def test_signed_zero_windows_keep_their_order():
    """A window of -0.0 and +0.0 only: the sort moves nothing, and the
    deviations are all +0.0."""
    w = torch.tensor([[-0.0, 0.0, -0.0, 0.0, 0.0]])
    assert torch.equal(_bits(transposition_sort(w)), _bits(w))
    q = _median(w)
    for merge in (merged_deviations_two_pointer, merged_deviations_bitonic):
        assert torch.equal(_bits(merge(w, q)), _bits(torch.zeros(1, 5)))
