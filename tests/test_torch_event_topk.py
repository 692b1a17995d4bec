"""The port's columnar scan -> filter -> topK (``event_topk_grid_packed``)
against the JAX package's.

The same numpy packs go through ``filodb_tpu.ops.grid`` (its window ops
on the Pallas kernel in interpret mode) and through
``filodb_tpu_torch.ops.grid`` on CPU tensors (``rate_grid_packed``'s
plain version, then plain torch):

- the three group reduces: contiguous ``group_width`` lanes (a
  reshape-sum), a ``garr`` map through the one-hot f32 matmul, and a
  ``garr`` over more than 2,048 groups through ``index_add_``; with
  ``largest`` on and off;
- each of the six filter ops;
- a mixed-class value pack, whose ``garr`` is composed through ``inv``,
  and a filter column packed with another layout, reached through
  ``filt_pos``;
- a tie between two groups: ``jax.lax.top_k`` ranks the lower slot first,
  and so must the port (values and slots equal).

Tolerances: values rtol 2e-5 (sums of up to 64 window sums of ~1e7, in
another order), slots and NaN / -1 positions equal.
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
ROWS = 64
L = 512
G = 8
T, K = 12, 4


def _counters(rng, cols):
    """Integer counters, one 16-bit class."""
    start = (2 ** 23 + 128 * rng.integers(0, 2 ** 15, cols)).astype(
        np.float32)
    inc = 128 * rng.integers(1, 8, (ROWS, cols))
    return (start[None, :] + np.cumsum(inc, axis=0)).astype(np.float32)


def _queries(dense=True):
    qs = jgrid.GridQuery(nsteps=T, kbuckets=K, gstep_ms=STEP, op="sum",
                         is_rate=False, dense=dense)
    ql = jgrid.GridQuery(nsteps=T, kbuckets=K, gstep_ms=STEP, op="last",
                         is_rate=False, dense=True)
    return qs, ql


def _both(pv, pf, k, garr, num_groups, **kw):
    """The same call through the JAX function and the port: (want, got),
    each (values [T, k], slots [T, k]) as numpy."""
    qs, ql = _queries(kw.pop("dense", True))
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("filt_pos") is not None:
        jkw["filt_pos"] = jnp.asarray(kw["filt_pos"])
        tkw["filt_pos"] = torch.as_tensor(kw["filt_pos"])
    want = jgrid.event_topk_grid_packed(
        {n: jnp.asarray(a) for n, a in pv.planes.items()}, 0, qs, k,
        None if garr is None else jnp.asarray(garr), num_groups,
        filt_packed=None if pf is None else
        {n: jnp.asarray(a) for n, a in pf.planes.items()},
        filt_q=ql, interpret=True, **jkw)
    got = tgrid.event_topk_grid_packed(
        txorgrid.packed_to_torch(pv, "cpu"), 0, tgrid.GridQuery(*qs), k,
        None if garr is None else torch.as_tensor(garr), num_groups,
        filt_packed=None if pf is None else
        txorgrid.packed_to_torch(pf, "cpu"), filt_q=tgrid.GridQuery(*ql),
        **tkw)
    return ([np.asarray(a) for a in want], [a.numpy() for a in got])


def _assert_topk(want, got):
    (wv, wi), (gv, gi) = want, got
    assert gv.shape == wv.shape and gi.dtype == np.int32
    assert (np.isnan(gv) == np.isnan(wv)).all()
    np.testing.assert_array_equal(gi, wi)
    fin = np.isfinite(wv)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=2e-5)


def _filter_column(rng):
    """Constant lanes of value 1, 2 or 3: every op keeps some lanes at
    threshold 2."""
    fv = np.repeat(rng.integers(1, 4, L)[None, :], ROWS, axis=0)
    return fv.astype(np.float32)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("reduce", ["group_width", "onehot", "index_add"])
def test_group_reduces(reduce, largest):
    rng = np.random.default_rng(41)
    pv = jxorgrid.pack_vals(_counters(rng, L), min_width=16)
    pf = jxorgrid.pack_vals(_filter_column(rng))
    garr, groups, width = None, G, 0
    if reduce == "group_width":
        width = L // G
    elif reduce == "onehot":
        garr = (np.arange(L) % G).astype(np.int32)
    else:
        # 4,096 slots (> 2,048: index_add_), occupied every 512th; most
        # rank as exhausted
        garr = ((np.arange(L) % G) * 512).astype(np.int32)
        groups = 4096
    want, got = _both(pv, pf, 3, garr, groups, filt_op="ge",
                      filt_thresh=2.0, largest=largest, group_width=width)
    _assert_topk(want, got)
    assert np.isfinite(got[0]).all()


@pytest.mark.parametrize("filt_op", ["gt", "ge", "lt", "le", "eq", "ne"])
def test_filter_ops(filt_op):
    rng = np.random.default_rng(42)
    pv = jxorgrid.pack_vals(_counters(rng, L), min_width=16)
    pf = jxorgrid.pack_vals(_filter_column(rng))
    want, got = _both(pv, pf, 5, None, G, filt_op=filt_op, filt_thresh=2.0,
                      group_width=L // G)
    _assert_topk(want, got)


def _edge_plane(rng):
    """Lanes of every class: constants (p8), counters (p16), noise (raw),
    and NaN lanes."""
    v = _counters(rng, L)
    n = L // 8
    v[:, :2 * n] = 5.0
    v[:, 3 * n:4 * n] = rng.random((ROWS, n)) * 100
    v[:, 5 * n:5 * n + 10] = np.nan
    return v


@pytest.mark.parametrize("largest", [True, False])
def test_mixed_class_pack_through_inv_and_filt_pos(largest):
    """garr and filt_pos are in the VALUE pack's (non-identity) lane
    order; the filter column packed with another layout."""
    rng = np.random.default_rng(43)
    pv = jxorgrid.pack_vals(_edge_plane(rng))
    assert not (pv.inv == np.arange(L)).all()
    fv = _counters(rng, L)
    pf = jxorgrid.pack_vals(fv, min_width=16)
    npk = sum(pv.planes[k].shape[1] for k in ("p8", "p16", "raw")
              if k in pv.planes)
    garr = np.full(npk, G, np.int32)                 # pads drop out
    garr[pv.inv] = (np.arange(L) % G).astype(np.int32)
    filt_pos = np.zeros(npk, np.int64)
    filt_pos[pv.inv] = pf.inv                        # value pos -> filter pos
    want, got = _both(pv, pf, 3, garr, G, filt_op="gt",
                      filt_thresh=float(np.median(fv[ROWS // 2])),
                      filt_pos=filt_pos, largest=largest, dense=False)
    _assert_topk(want, got)


def test_tie_ranks_the_lower_slot_first():
    rng = np.random.default_rng(44)
    v = _counters(rng, L)
    width = L // G
    v[:, 2 * width:3 * width] += 2 ** 19                    # group 2 second
    v[:, 5 * width:6 * width] = v[:, 2 * width:3 * width]   # ... tied with 5
    v[:, 7 * width:] = v[:, 2 * width:3 * width] + 2 ** 20  # group 7 first
    pv = jxorgrid.pack_vals(v, min_width=16)
    want, got = _both(pv, None, 4, None, G, group_width=width)
    _assert_topk(want, got)
    assert (got[1][:, :3] == [7, 2, 5]).all()


def test_topk_rejects():
    rng = np.random.default_rng(45)
    pv = txorgrid.packed_to_torch(
        txorgrid.pack_vals(_counters(rng, L), min_width=16), "cpu")
    qs = tgrid.GridQuery(*_queries()[0])
    garr = torch.arange(L, dtype=torch.int32) % G
    with pytest.raises(ValueError, match="filter op"):
        tgrid.event_topk_grid_packed(pv, 0, qs, 2, garr, G, filt_packed=pv,
                                     filt_op="contains")
    with pytest.raises(ValueError, match="not both"):
        tgrid.event_topk_grid_packed(pv, 0, qs, 2, garr, G,
                                     group_width=L // G)
    with pytest.raises(ValueError, match="group_width"):
        tgrid.event_topk_grid_packed(pv, 0, qs, 2, None, G + 1,
                                     group_width=L // G)
    with pytest.raises(ValueError, match="k="):
        tgrid.event_topk_grid_packed(pv, 0, qs, G + 1, garr, G)
