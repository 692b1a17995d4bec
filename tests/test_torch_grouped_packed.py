"""The port's fused grouped kernel over packed planes (B4,
``rate_grid_grouped_packed``) against the JAX package's.

The same numpy pack goes through ``filodb_tpu.ops.grid``'s Pallas kernel
in interpret mode and through ``filodb_tpu_torch.ops.grid``'s wrapper on
CPU tensors (the plain PyTorch version the CUDA kernel is held to on the
card): ``use_phase`` on and off, ``row0 > 0``, stride 2, over a pack of
two class planes (a p8 pack and a p16 pack of whole groups, merged into
one dict), so groups come back in plane order.  The JAX tests run no
grouped pack of more than one plane; this one holds both sides to it.
Then the pack contract's ``ValueError``s.

Tolerances: sums rtol 2e-5 (the JAX tests' bound for grouped sums,
tests/test_packed_kernel.py:483), counts and NaN positions equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.codecs import xorgrid as jxorgrid
from filodb_tpu.ops import grid as jgrid
from filodb_tpu_torch.codecs import xorgrid as txorgrid
from filodb_tpu_torch.ops import grid as tgrid

torch.set_num_threads(1)

STEP = 60_000
K = 5
GL = 32


def _assert_grouped(got, want):
    (gs, gc), (ws, wc) = got, want
    gs, gc = gs.numpy(), gc.numpy()
    ws, wc = np.asarray(ws), np.asarray(wc)
    assert gs.shape == ws.shape and gc.shape == wc.shape
    np.testing.assert_array_equal(gc, wc)
    assert (np.isnan(gs) == np.isnan(ws)).all()
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=2e-5)


def _counters(rng, rows, cols, small=False):
    """Integer counters with a pinned f32 exponent.  ``small``: residuals
    span bits 7-14, one 8-bit class; else bits 7-22, one 16-bit class."""
    if small:
        start = 2 ** 23 + 2 ** 15 * rng.integers(0, 2 ** 7, cols)
        inc = 128 * rng.integers(0, 2, (rows, cols))
    else:
        start = 2 ** 23 + 128 * rng.integers(0, 2 ** 15, cols)
        inc = 128 * rng.integers(1, 8, (rows, cols))
    return (start[None, :] + np.cumsum(inc, axis=0)).astype(np.float32)


def two_plane_pack(rng, rows, gl, groups_per_plane):
    """A p8 pack and a p16 pack, each of whole groups, merged into one
    dict: (planes, the [rows, width] values in packed order, phase)."""
    n = gl * groups_per_plane
    v8, v16 = _counters(rng, rows, n, small=True), _counters(rng, rows, n)
    v16[:, gl:gl + 5] = np.nan                 # dead lanes in a p16 group
    ph8, ph16 = (rng.integers(1, STEP, n).astype(np.int32) for _ in "ab")
    p8 = jxorgrid.pack_vals(v8, phase=ph8, min_width=8)
    p16 = jxorgrid.pack_vals(v16, phase=ph16, min_width=16)
    for pk, key in ((p8, "p8"), (p16, "p16")):
        assert [k for k in ("p8", "p16", "raw")
                if k in pk.planes and pk.planes[k].shape[1]] == [key]
    planes = {"p8": p8.planes["p8"], "m8": p8.planes["m8"],
              "z8": p8.planes["z8"], "p16": p16.planes["p16"],
              "m16": p16.planes["m16"], "z16": p16.planes["z16"],
              "raw": np.zeros((rows, 0), np.float32),
              "first": np.concatenate([p8.planes["first"],
                                       p16.planes["first"]]),
              "inv": np.concatenate([p8.inv, p16.inv + n]).astype(np.int32)}
    return planes, np.concatenate([v8, v16], axis=1), \
        np.concatenate([ph8, ph16])


@pytest.mark.parametrize("use_phase,op", [(True, "rate"), (True, "delta"),
                                          (False, "sum"), (False, "max"),
                                          (False, "last")])
@pytest.mark.parametrize("row0", [0, 3])
def test_grouped_packed_two_planes(use_phase, op, row0):
    rng = np.random.default_rng(17)
    planes, _v, _ph = two_plane_pack(rng, 64, GL, 8)
    q = jgrid.GridQuery(nsteps=20, kbuckets=K, gstep_ms=STEP, op=op,
                        is_rate=(op == "rate"), dense=True, stride=2)
    want = jgrid.rate_grid_grouped_packed(
        {k: jnp.asarray(a) for k, a in planes.items()}, 0, q,
        group_lanes=GL, row0=row0, interpret=True, use_phase=use_phase)
    tplanes = txorgrid.packed_to_torch(planes, "cpu")
    got = tgrid.rate_grid_grouped_packed(tplanes, 0, tgrid.GridQuery(*q),
                                         GL, row0=row0, use_phase=use_phase)
    assert got[0].shape == (16, 20)
    _assert_grouped(got, want)
    # groups in plane order: p8 groups first; the dead lanes count out
    assert (got[1][9] == GL - 5).all() and (got[1][8] == GL).all()


def test_grouped_packed_matches_decoded_grouped():
    """B4 over the two-plane pack equals B2 over the decoded planes in
    packed order (phase mode)."""
    rng = np.random.default_rng(18)
    planes, v, ph = two_plane_pack(rng, 64, GL, 8)
    q = tgrid.GridQuery(nsteps=20, kbuckets=K, gstep_ms=STEP, dense=True)
    got = tgrid.rate_grid_grouped_packed(
        txorgrid.packed_to_torch(planes, "cpu"), 0, q, GL, row0=2)
    want = tgrid.rate_grid_grouped(None, torch.as_tensor(v[2:2 + 24]), 0,
                                   q, GL, phase=torch.as_tensor(ph))
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=0)


def test_grouped_packed_rejects():
    rng = np.random.default_rng(19)
    q = tgrid.GridQuery(nsteps=8, kbuckets=4, gstep_ms=STEP, dense=True)
    # alignment pads decode to live 0.0 series: the fused kernels refuse
    pk = txorgrid.pack_vals(_counters(rng, 64, 896), min_width=16)
    planes = dict(pk.planes)
    for key in ("p16", "m16"):
        planes[key] = np.pad(planes[key], ((0, 0), (0, 128)))
    for key in ("z16", "first"):
        planes[key] = np.pad(planes[key], (0, 128))
    tplanes = txorgrid.packed_to_torch(planes, "cpu")
    with pytest.raises(ValueError, match="pad lanes"):
        tgrid.rate_grid_grouped_packed(tplanes, 0, q, 128)
    # a plane that is not a whole number of groups
    planes, _v, _ph = two_plane_pack(rng, 64, GL, 8)
    tplanes = txorgrid.packed_to_torch(planes, "cpu")
    with pytest.raises(ValueError, match="whole number"):
        tgrid.rate_grid_grouped_packed(tplanes, 0, q, 3 * GL)
    with pytest.raises(ValueError, match="ts plane"):
        tgrid.rate_grid_grouped_packed(tplanes, 0, q._replace(op="rate"),
                                       GL, use_phase=False)
