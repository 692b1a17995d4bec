"""``filodb_tpu_torch.northstar``: the fused north-star path, on the CPU at
a small size.

Each variant's data, made by the port from a seed, goes through the JAX
package's function (its Pallas kernels in interpret mode) and through the
variant's ``query_*`` function (the wrappers' plain versions on CPU
tensors): grouped and bucket sums rtol 2e-5 with counts equal; quantiles
and topk values rtol 2e-5 with the NaN pattern equal, topk slots equal.
Then each gate of the variants' setups is fed a corrupted input and must
raise, so no gate is vacuous.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import grid as jgrid
from filodb_tpu.ops import histogram_ops as jhistogram_ops
from filodb_tpu_torch import northstar as ns
from filodb_tpu_torch.codecs import xorgrid
from filodb_tpu_torch.ops import grid as tgrid

torch.set_num_threads(1)

# the JAX grouped kernels need a multiple of 8 groups; 60 rows keep the
# 16-bit packs under 75% of the raw plane, as the packer demands
SMALL = ns.Widths(groups=8, per_group=30, group_lanes=32, rows=60,
                  hist_groups=8, hist_per_group=4, hist_buckets=4,
                  event_lanes=512, event_groups=16, event_k=3)


@pytest.fixture(scope="module")
def cases():
    return {"dense": ns.setup_dense(0, "cpu", SMALL),
            "packed": ns.setup_packed(0, "cpu", SMALL),
            "hist": ns.setup_hist(0, "cpu", SMALL),
            "topk": ns.setup_topk(0, "cpu", SMALL)}


def _jq(q):
    return jgrid.GridQuery(*q)


def _jplanes(pack):
    return {k: jnp.asarray(a) for k, a in pack.planes.items()}


def _assert_close(got, want, exact=False):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert (np.isnan(got) == np.isnan(want)).all()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        fin = np.isfinite(want)
        assert fin.any()
        np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5)


def test_widths_and_queries():
    assert ns.BENCH.groups * ns.BENCH.group_lanes == 1_024_000
    assert (ns.BENCH.hist_groups * ns.BENCH.hist_per_group
            * ns.BENCH.hist_buckets) == 1_048_576
    assert ns.nsteps(ns.BENCH) == 55 and ns.rows_used(ns.BENCH) == 59
    q = ns.query(ns.BENCH)
    assert (q.nsteps, q.kbuckets, q.op, q.dense) == (55, 5, "rate", True)


def test_dense_matches_jax(cases):
    c = cases["dense"]
    assert c.vals.shape == (59, 256) and c.samples == 8 * 30 * 59
    want = jgrid.rate_grid_grouped(
        None, jnp.asarray(c.vals.numpy()), ns.steps0(), _jq(c.q),
        group_lanes=32, interpret=True, phase=jnp.asarray(c.phase.numpy()))
    got = ns.query_dense(c)
    _assert_close(got[1], want[1], exact=True)
    _assert_close(got[0], want[0])
    assert (got[1] == 30).all()


def test_packed_matches_jax(cases):
    c = cases["packed"]
    want = jgrid.rate_grid_grouped_packed(
        _jplanes(c.pack), ns.steps0(), _jq(c.q), group_lanes=32,
        interpret=True)
    got = ns.query_packed(c)
    _assert_close(got[1], want[1], exact=True)
    _assert_close(got[0], want[0])


def test_hist_matches_jax(cases):
    """The bucket sums against the JAX kernel's, then the quantile against
    the JAX package's hist_quantile over the same sums: the benchmark's
    bucket columns are independent counters, so the interpolation divides
    differences of nearly equal sums, and sums added in two orders would
    differ there by more than any tolerance."""
    c = cases["hist"]
    ws, wc = jgrid.hist_grid_grouped_packed(
        _jplanes(c.pack), ns.steps0(), _jq(c.q), c.hb,
        group_lanes=c.group_lanes, interpret=True)
    gs, gc = tgrid.hist_grid_grouped_packed(c.planes, ns.steps0(), c.q,
                                            c.hb, c.group_lanes)
    _assert_close(gc, wc, exact=True)
    _assert_close(gs, ws)
    want = jhistogram_ops.hist_quantile(
        jnp.asarray(c.tops.numpy()),
        jnp.asarray(gs.reshape(8, c.hb, 55).permute(0, 2, 1).numpy()),
        ns.PHI)
    got = ns.query_hist(c)
    assert got.shape == (8, 55)
    _assert_close(got, want)


def test_topk_matches_jax(cases):
    c = cases["topk"]
    want = jgrid.event_topk_grid_packed(
        _jplanes(c.packs[0]), ns.steps0(), _jq(c.qs), c.k, None, c.groups,
        filt_packed=_jplanes(c.packs[1]), filt_op="gt",
        filt_thresh=c.thresh, filt_q=_jq(c.ql), interpret=True,
        group_width=c.group_width)
    got = ns.query_topk(c)
    _assert_close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ------------------------------------------------------------- the gates

def test_dense_contract_gate():
    _ts, vals, _ph = ns.gen_dense(ns.generator(1, "cpu"), SMALL)
    ns.check_dense_contract(vals, 59)
    vals[7, 3] = float("nan")                   # a missed scrape
    with pytest.raises(ns.GateError, match="dense-lane"):
        ns.check_dense_contract(vals, 59)


def test_phase_vs_ts_gate(cases):
    c = cases["dense"]
    assert ns.check_phase_vs_ts(c.ts, c.vals, c.phase, c.q, 32) < 2e-5
    with pytest.raises(ns.GateError, match="phase kernel"):
        ns.check_phase_vs_ts(c.ts, c.vals, c.phase // 2, c.q, 32)


def test_identity_pack_gate():
    rng = np.random.default_rng(2)
    v = ns.c16(ns.generator(2, "cpu"), 59, 256).numpy()
    ns.check_identity_pack(xorgrid.pack_vals(v, min_width=16), 256)
    with pytest.raises(ns.GateError, match="did not pack"):
        ns.check_identity_pack(None, 256)
    v[:, 5] = rng.random(59) * 100              # an incompressible lane
    with pytest.raises(ns.GateError, match="single identity-order"):
        ns.check_identity_pack(xorgrid.pack_vals(v, min_width=16), 256)


def test_unpack_gate(cases):
    c = cases["packed"]
    v = c.vals.numpy().copy()
    ns.check_unpack(c.pack, v)
    v[30, 4] += 128.0
    with pytest.raises(ns.GateError, match="bit-identical"):
        ns.check_unpack(c.pack, v)


def test_packed_vs_ts_gate(cases):
    c = cases["packed"]
    ns.check_packed_vs_ts(c.planes, c.ts, c.vals, c.q, 32)
    planes = dict(c.planes)
    planes["p16"] = planes["p16"].clone()
    planes["p16"][10, 0] ^= 1 << 12             # one corrupted word
    with pytest.raises(ns.GateError, match="compressed-resident"):
        ns.check_packed_vs_ts(planes, c.ts, c.vals, c.q, 32)


def test_hist_gate(cases):
    c = cases["hist"]
    ns.check_hist(c)
    vals = c.vals.clone()
    vals[30:, :c.hb] += 2.0 ** 16               # series 0's buckets jump
    with pytest.raises(ns.GateError, match="hist quantile"):
        ns.check_hist(c._replace(vals=vals))


def test_topk_gate(cases):
    c = cases["topk"]
    ns.check_topk(c)
    vals = c.vals.clone()
    vals[:, :c.group_width] += 2.0 ** 21        # group 0 would lead
    with pytest.raises(ns.GateError, match="event topk"):
        ns.check_topk(c._replace(vals=vals))


def test_query_functions_launch_nothing_on_the_cpu(cases):
    """On CPU tensors every wrapper runs its plain version: no launch is
    counted."""
    tgrid.reset_launch_counts()
    ns.query_dense(cases["dense"])
    ns.query_packed(cases["packed"])
    ns.query_hist(cases["hist"])
    ns.query_topk(cases["topk"])
    assert not any(tgrid.launch_counts().values())
