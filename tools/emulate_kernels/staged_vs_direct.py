"""Hold the staged hist_grid_grouped_packed kernel (B5), the staged
rate_grid_grouped_packed kernel (B4), the staged rate_grid_grouped
kernel (B2) or the staged rate_grid kernel (B1) against its direct
kernel, bit for bit, in the CPU emulation
of the CUDA source (build.py), and both against the plain PyTorch
version.

Every case runs the same class plane twice through the wrapper's
launcher: once at ``grid.hist_staged_plan``'s plan (the staged kernel:
the producer warp, the ring, the chunked bucket sum behind the consumers'
named barrier) and once with the plan forced to the direct kernel.  Sums
and counts must have the same bits.  Against the plain version counts are
equal and sums bit-equal, but rate and increase (the correction prefix:
rtol 2e-5) and stddev and zscore (torch's CPU sqrt is not correctly
rounded, the card's is: rtol 2e-5 here only).  Cases: hb 4, 16, 20 and
160 over p8 and p16 planes, groups of 16 series and of at most 128 lanes
(both lane tiles), row0 0, 3 and 40, strides 1 and 2, a dead series,
every op the kernel serves.  A protocol fault shows as a wrong sum, or as
an abort where a wait never ends (the emulated trap).

B4 (``b4``): the sweep's shapes (chip_smoke.b4_packs, B4_GROUPS) cut to
64 rows and two groups a plane: p8, p16 and p32 planes, groups of 64,
512 and 1,024 lanes (the 128-lane tile, and the 256-lane tile in 2 and 4
passes), row0 0, 3 and 40, strides 1 and 2, every op at one span of each
plane and group and rate, sum, mad and stddev at the others; each case
through the wrapper's launcher (staged: the producer warp, the ring,
the warp-shuffle group sum) at its plan and, where the plan takes the
linear ring layout, again forced to the wrapping one, and once through
the library's direct entry
(chip_smoke.grouped_packed_direct).  Sums and counts must have the same
bits; against the plain version counts are equal and sums within rtol
2e-5 (the plain version sums a group in another order).

B2 (``b2``): decoded f32 planes (chip_smoke._mid_planes, dense and
gappy lanes, a scrape phase a lane, ts rows) of 64 rows and two groups a
plane: groups of 64 and 38 lanes (the 128-lane tile; 38 lanes' rows are
not 16-byte aligned, so the producer copies them by plain loads) and of
512 and 1,024 lanes (the 256-lane tile in 2 and 4 passes), strides 1 and
2, a 20-step span, every op in every mode it serves (phase, free, ts:
chip_smoke.B2_OPS) at each group's first span and rate, sum, mad, stddev
and deriv at the others; each case through the wrapper's launcher at its
plan and, where that is linear, again forced to the wrapping layout, and
once through the library's direct entry (chip_smoke.grouped_dense_direct):
the same bits, and within rtol 2e-5 of the plain version.

B1's member axis (``b1_batch``): chip_smoke.b1_batch_cases at 100 and
130 lanes over chip_smoke.B1_ROWS rows, each batch of M = 8 or 3 members
(starting at even rows of the shared planes) through the batched launcher
at its plan and forced to the direct kernel, each member held bit for
bit against its own solo launch on its rows, and the batch within rtol
2e-5 of rate_grid_batch_ref.

B1 (``b1``): decoded f32 planes (chip_smoke.b1_planes, dense and gappy
lanes, a scrape phase a lane, ts rows, a reset at row 1, a missed row 0,
a dead lane) of 64 rows and 100
lanes (one tile cut by the lane count, 16-byte rows) and 130 lanes (a
full tile and one of 2 lanes, rows that are not 16-byte multiples: the
producer's plain loads), every op in every mode it serves
(chip_smoke.B1_OPS) at strides 1 and 2, and a few ops at T = 1 and 2
(chip_smoke.B1_SHORT_OPS); each case through the wrapper's launcher at
every plan of chip_smoke.b1_plans (the wrapper's, the staged kernel's
for the ops the wrapper sends to the direct kernel, the largest ring),
held bit for bit against the library's direct entry
(chip_smoke.series_direct) and within rtol 2e-5 of the plain version.

    python3 tools/emulate_kernels/staged_vs_direct.py [HB,...]
    python3 tools/emulate_kernels/staged_vs_direct.py b4
    python3 tools/emulate_kernels/staged_vs_direct.py b2
    python3 tools/emulate_kernels/staged_vs_direct.py b1
    python3 tools/emulate_kernels/staged_vs_direct.py b1_batch

Takes about 10 minutes for every hb, and about 12 for B4, one CPU thread
a CUDA thread.
"""
import contextlib
import ctypes
import itertools
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import build  # noqa: E402
import chip_smoke as cs  # noqa: E402
from filodb_tpu_torch.codecs import xorgrid  # noqa: E402
from filodb_tpu_torch.ops import grid, kernels  # noqa: E402

SERIES, GROUPS, T = 16, 3, 19
OPS = ([(True, True, o) for o in ("rate", "increase", "delta")]
       + [(False, True, o) for o in ("sum", "count", "avg", "min", "max",
                                     "last")]
       + [(False, True, o) for o in cs.FREE_SECOND_OPS]
       + [(False, False, o) for o in cs.MOMENT_OPS])
# the ops that also run at stride 2
STRIDE2 = ("rate", "sum", "mad", "stddev")
NOT_BITS = ("rate", "increase", "stddev", "zscore")


def emulate(so: str) -> None:
    """Point the wrapper's launcher at the emulated library on CPU
    tensors."""
    kernels._compile = lambda: so
    grid._cuda_device = lambda t, name: t.device
    grid._stream = lambda: ctypes.c_void_p(0)
    torch.cuda.device = lambda dev: contextlib.nullcontext()


def launch(pk, q, hb, group_lanes, row0, use_phase, direct: bool):
    """One call of the launcher, staged or forced direct; (sum, count)
    and whether the direct kernel ran."""
    real = grid.hist_staged_plan
    if direct:
        grid.hist_staged_plan = lambda *a: grid.HistPlan(0, 0, 0, False, 0)
    d0 = grid.hist_grid_grouped_packed.direct
    try:
        s, c = grid._grouped_packed_launch(grid.hist_grid_grouped_packed, pk,
                                           q, row0, use_phase, group_lanes,
                                           hb)
    finally:
        grid.hist_staged_plan = real
    return s, c, grid.hist_grid_grouped_packed.direct - d0 == 1


def main(hbs) -> int:
    emulate(build.build(os.path.join(build.REPO, "filodb_tpu_torch",
                                     "_build", "emu")))
    torch.set_num_threads(1)
    rng = np.random.default_rng(7)
    n, t0 = 0, time.time()
    for hb in hbs:
        # groups of 16 series (the large tile but at hb 4) and, where the
        # bucket count allows, of at most 128 lanes (the small tile)
        pers = sorted({SERIES} | ({128 // hb} if hb <= 64 else set()))
        cols = GROUPS * 32 * hb
        for small in (True, False):
            v = cs._counters_np(rng, 128, cols, small)
            v[:, hb:2 * hb] = np.nan                  # series 1 dead
            phase = np.repeat(rng.integers(1, cs.STEP, cols // hb), hb)
            hp = xorgrid.pack_vals(v, phase=phase.astype(np.int32),
                                   min_width=8 if small else 16, stride=hb)
            assert hp is not None and (hp.inv == np.arange(cols)).all()
            pk = xorgrid.packed_to_torch(hp, "cpu")
            for per, row0, ((use_phase, dense, op), stride) in \
                    itertools.product(pers, (0, 3, 40),
                                      itertools.product(OPS, (1, 2))):
                if stride == 2 and op not in STRIDE2:
                    continue
                gl = per * hb
                if cols % gl:
                    continue
                q = cs.sweep_query(op, dense, stride, T)
                case = (f"hb={hb} {'p8' if small else 'p16'} group={gl} "
                        f"row0={row0} stride={stride} {op}")
                ds, dc, d = launch(pk, q, hb, gl, row0, use_phase, True)
                ss, sc, sd = launch(pk, q, hb, gl, row0, use_phase, False)
                assert d and not sd, case + ": not one staged, one direct"
                assert torch.equal(ss.view(torch.int32),
                                   ds.view(torch.int32)), case + " sums"
                assert torch.equal(sc, dc), case + " counts"
                ws, wc = grid.hist_grid_grouped_packed_ref(
                    pk, 0, q, hb, gl, row0, use_phase)
                assert torch.equal(sc, wc), case + " counts != plain"
                if op in NOT_BITS:
                    cs.compare(ss, ws, op, cs.RTOL_KERNEL,
                               1 if op in cs.CROSSING else None)
                else:
                    cs.compare_bits(ss, ws, case)
                n += 1
            print(f"hb={hb} {'p8' if small else 'p16'}: {n} cases, "
                  f"{time.time() - t0:.1f} s", flush=True)
    print(f"staged == direct, bit for bit: {n} cases")
    return 0


# B4's ops at the spans after each plane and group's first
B4_SPAN_OPS = ("rate", "sum", "mad", "stddev")


def launch_b4(pk, q, group_lanes, row0, use_phase, wrap: bool):
    """One call of the launcher on the staged B4 kernel, at its plan or
    (``wrap``) forced to the wrapping ring layout; (sum, count) and
    whether the plan took the linear layout."""
    fn, real = grid.rate_grid_grouped_packed, grid.grouped_staged_plan
    plans = []

    def plan(gl, nsteps, k, stride, r0, word):
        p = real(gl, nsteps, k, stride, 1 << 20 if wrap else r0, word)
        plans.append(p)
        return p
    grid.grouped_staged_plan = plan
    d0 = fn.direct
    try:
        s, c = grid._grouped_packed_launch(fn, pk, q, row0, use_phase,
                                           group_lanes, 1)
    finally:
        grid.grouped_staged_plan = real
    assert fn.direct == d0 and plans[0].staged, "not staged"
    return s, c, plans[0].linear


def main_b4() -> int:
    emulate(build.build(os.path.join(build.REPO, "filodb_tpu_torch",
                                     "_build", "emu")))
    torch.set_num_threads(1)
    rows, rng = 64, np.random.default_rng(9)
    fn = grid.rate_grid_grouped_packed
    n, t0 = 0, time.time()
    for gl, spans in cs.B4_GROUPS:
        # two groups a plane (each CTA is emulated in turn)
        for word, pk in cs.b4_packs(rng, 2 * gl, rows).items():
            pk = xorgrid.packed_to_torch(pk, "cpu")
            for i, (row0, stride, nsteps) in enumerate(spans):
                nsteps = nsteps or (rows - row0 - cs.K) // stride + 1
                for use_phase, dense, op in OPS:
                    if i and op not in B4_SPAN_OPS:
                        continue
                    q = cs.sweep_query(op, dense, stride, nsteps)
                    ds, dc = cs.grouped_packed_direct(pk, q, gl, row0,
                                                      use_phase)
                    want = grid.rate_grid_grouped_packed_ref(
                        pk, 0, q, gl, row0, use_phase)
                    for wrap in (False, True):
                        case = (f"{word} group={gl} row0={row0} "
                                f"stride={stride} T={nsteps} {op} "
                                f"{'wrapping' if wrap else 'planned'}")
                        ss, sc, linear = launch_b4(pk, q, gl, row0,
                                                   use_phase, wrap)
                        cs.compare_grouped_bits((ss, sc), (ds, dc),
                                                f"{case} (direct)", "")
                        cs.compare_grouped((ss, sc), want, case, op)
                        n += 1
                        if not linear:
                            break
            print(f"{word} group={gl}: {n} cases, {time.time() - t0:.1f} s",
                  flush=True)
    print(f"staged B4 == direct B4, bit for bit: {n} cases")
    return 0


# B2's (group lanes, spans (stride, T)), T 0 for as many steps as the rows
# hold, and the ops at the spans after each group's first
B2_GROUPS = ((64, ((1, 0), (2, 0))), (38, ((1, 0), (2, 0))),
             (512, ((1, 0), (2, 0), (1, 20))),
             (1024, ((1, 0), (2, 0), (1, 20))))
B2_SPAN_OPS = ("rate", "sum", "mad", "stddev", "deriv")


def launch_b2(ts, vals, q, group_lanes, phase, wrap: bool):
    """One call of the launcher on the staged B2 kernel, at its plan or
    (``wrap``) forced to the wrapping ring layout; (sum, count) and
    whether the plan took the linear layout."""
    fn, real = grid.rate_grid_grouped, grid.dense_staged_plan
    plans = []

    def plan(*a):
        p = cs.wrapping_plan(*a) if wrap else real(*a)
        plans.append(p)
        return p
    grid.dense_staged_plan = plan
    d0 = fn.direct
    try:
        s, c = grid._grouped_dense_launch(ts, vals, q.kbuckets * cs.STEP, q,
                                          group_lanes, phase)
    finally:
        grid.dense_staged_plan = real
    assert fn.direct == d0 and plans[0].staged, "not staged"
    return s, c, plans[0].linear


def main_b2() -> int:
    emulate(build.build(os.path.join(build.REPO, "filodb_tpu_torch",
                                     "_build", "emu")))
    torch.set_num_threads(1)
    rows, rng = 64, np.random.default_rng(10)
    n, t0 = 0, time.time()
    for gl, spans in B2_GROUPS:
        # two groups a plane, every lane live but the gappy lanes' holes
        planes = {g: tuple(torch.as_tensor(a[..., :2 * gl].copy())
                           for a in cs._mid_planes(rng, rows, 2 * gl + 512,
                                                   g))
                  for g in (False, True)}
        for i, (stride, nsteps) in enumerate(spans):
            nsteps = nsteps or (rows - cs.K) // stride + 1
            for mode, dense, op in cs.B2_OPS:
                if i and op not in B2_SPAN_OPS:
                    continue
                q = cs.sweep_query(op, dense, stride, nsteps)
                ts, vals, ph = planes[not dense]
                phase = ph if mode == "phase" else None
                args = (ts, vals, q.kbuckets * cs.STEP, q, gl)
                direct = cs.grouped_dense_direct(*args, phase=phase)
                want = grid.rate_grid_grouped_ref(*args, phase=phase)
                for wrap in (False, True):
                    case = (f"group={gl} stride={stride} T={nsteps} {mode}-"
                            f"{'dense' if dense else 'gappy'}-{op} "
                            f"{'wrapping' if wrap else 'planned'}")
                    ss, sc, linear = launch_b2(ts, vals, q, gl, phase, wrap)
                    cs.compare_grouped_bits((ss, sc), direct,
                                            f"{case} (direct)", "")
                    cs.compare_grouped((ss, sc), want, case, op)
                    n += 1
                    if not linear:
                        break
            print(f"group={gl} stride={stride} T={nsteps}: {n} cases, "
                  f"{time.time() - t0:.1f} s", flush=True)
    print(f"staged B2 == direct B2, bit for bit: {n} cases")
    return 0


# B1's lane counts and rows
B1_WIDTHS = (100, 130)
B1_ROWS = 64


def launch_b1(ts, vals, q, phase, plan, steps0=None):
    """One call of rate_grid's launcher at ``plan``: on the staged B1
    kernel, or the direct one where the plan stages nothing; the first
    window ends at ``steps0`` (K steps past row 0 by default)."""
    fn, real = grid.rate_grid, grid.series_staged_plan
    grid.series_staged_plan = lambda *a, **k: plan
    d0 = fn.direct
    if steps0 is None:
        steps0 = q.kbuckets * cs.STEP
    try:
        out = grid._series_launch(ts, vals, steps0, q, phase)
    finally:
        grid.series_staged_plan = real
    assert fn.direct - d0 == int(not plan.staged), "not the plan's kernel"
    return out


def main_b1() -> int:
    emulate(build.build(os.path.join(build.REPO, "filodb_tpu_torch",
                                     "_build", "emu")))
    torch.set_num_threads(1)
    rng = np.random.default_rng(11)
    n, t0 = 0, time.time()
    for width in B1_WIDTHS:
        planes = {}
        for g in (False, True):
            ts, vals, ph = (a[..., :width].copy() for a in cs.b1_planes(
                rng, B1_ROWS, width + 512, g))
            vals[:, 7] = np.nan                       # a dead lane
            planes[g] = tuple(torch.as_tensor(a) for a in (ts, vals, ph))
        cases = [(mode, dense, op, stride, (B1_ROWS - cs.K) // stride + 1)
                 for mode, dense, op in cs.B1_OPS for stride in (1, 2)]
        cases += [(mode, dense, op, 1, nsteps)
                  for mode, dense, op in cs.B1_SHORT_OPS
                  for nsteps in (1, 2)]
        for mode, dense, op, stride, nsteps in cases:
            q = cs.sweep_query(op, dense, stride, nsteps)
            ts, vals, ph = planes[not dense]
            phase = ph if mode == "phase" else None
            args = (ts, vals, q.kbuckets * cs.STEP, q)
            direct = cs.series_direct(*args, phase=phase)
            want = grid.rate_grid_ref(*args, phase=phase)
            for which, plan in cs.b1_plans(width, q,
                                            grid._mode_for(q, phase)):
                case = (f"S={width} stride={stride} T={nsteps} {mode}-"
                        f"{'dense' if dense else 'gappy'}-{op} {which}")
                got = launch_b1(ts, vals, q, phase, plan)
                cs.compare_bits(got, direct, f"{case} (direct)")
                cs.compare(got, want, op, cs.RTOL_KERNEL,
                           0 if op in cs.CROSSING else None)
                n += 1
        print(f"S={width}: {n} cases, {time.time() - t0:.1f} s", flush=True)
    print(f"staged B1 == direct B1, bit for bit: {n} cases")
    return 0


def main_b1_batch() -> int:
    """B1's member axis: each case of chip_smoke.B1_BATCH_OPS at 100 and
    130 lanes, M = 8 and 3 members from chip_smoke.B1_BATCH_ROW0S,
    strides 1 and 2, through the batched launcher at the wrapper's plan
    and forced to the direct kernel: every member bit for bit its own
    solo launch (the same plan) on its rows, and within rtol 2e-5 of
    rate_grid_batch_ref."""
    emulate(build.build(os.path.join(build.REPO, "filodb_tpu_torch",
                                     "_build", "emu")))
    torch.set_num_threads(1)
    rng = np.random.default_rng(13)
    n, t0 = 0, time.time()
    direct = grid.SeriesPlan(0, 0)
    for width in B1_WIDTHS:
        planes = {}
        for g in (False, True):
            ts, vals, ph = (a[..., :width].copy() for a in cs.b1_planes(
                rng, cs.B1_ROWS, width + 512, g))
            vals[:, 7] = np.nan                       # a dead lane
            planes[g] = tuple(torch.as_tensor(a) for a in (ts, vals, ph))
        for w, mode, dense, op, k, stride, members in cs.b1_batch_cases():
            if w != cs.B1_WIDTHS[0]:
                continue                  # each case once a width here
            ts, vals, ph = planes[not dense]
            phase = ph if mode == "phase" else None
            row0s, steps0s, nrows, q = cs.b1_batch_members(
                members, cs.B1_ROWS, lambda r: cs.sweep_query(
                    op, dense, stride, (r - k) // stride + 1, k=k))
            plan = grid.series_staged_plan(width, q.nsteps, q.kbuckets,
                                           q.stride,
                                           grid._mode_for(q, phase), q.op)
            want = grid.rate_grid_batch_ref(ts, vals, row0s, steps0s, q,
                                            nrows, phase=phase)
            for which, p in (("planned", plan), ("direct", direct)):
                if which == "direct" and not plan.staged:
                    continue
                real = grid.series_staged_plan
                grid.series_staged_plan = lambda *a, _p=p, **kw: _p
                try:
                    got = grid._series_batch_launch(ts, vals, row0s,
                                                    steps0s, q, nrows, phase)
                    solos = [grid._series_launch(ts[r:r + nrows],
                                                 vals[r:r + nrows], st, q,
                                                 phase)
                             for r, st in zip(row0s, steps0s)]
                finally:
                    grid.series_staged_plan = real
                case = (f"S={width} M={members} stride={stride} K={k} "
                        f"T={q.nsteps} {mode}-"
                        f"{'dense' if dense else 'gappy'}-{op} {which}")
                for m, solo in enumerate(solos):
                    cs.compare_bits(got[m], solo, f"{case} member {m}")
                cs.compare(got, want, op, cs.RTOL_KERNEL,
                           1 if op in cs.CROSSING else None)
                n += 1
        print(f"S={width}: {n} batches, {time.time() - t0:.1f} s",
              flush=True)
    print(f"batched B1 == solo B1 member by member, bit for bit: {n} "
          f"batches")
    return 0


def _differing(a, b) -> int:
    """Cells whose bits differ (NaN cells equal)."""
    nan = torch.isnan(a) & torch.isnan(b)
    return int((~((a.view(torch.int32) == b.view(torch.int32)) | nan)).sum())


def main_b1_split() -> int:
    """What a result cache's segment split does to B1's bits on the card:
    the staged rate_grid (its plan at each width) over dense
    uniform-phase counter planes (a lane resetting at row 1) at rate and
    increase, stride 1, K 5, launched
    (a) over all B1_ROWS rows in phase mode, the unsplit query;
    (b) over the rows from R0 on, the later steps alone, in phase mode,
    a segment's run: each step it shares with (a) must have (a)'s bits;
    (c) over all rows in ts mode, the mode a launch over a tail block
    takes: its cells against (a)'s.
    Prints the differing cells of (b) and (c); exits 1 when (b) differs
    (a split would change the bits a step answers)."""
    emulate(build.build(os.path.join(build.REPO, "filodb_tpu_torch",
                                     "_build", "emu")))
    torch.set_num_threads(1)
    rng = np.random.default_rng(17)
    r0 = 16
    split_cells = mode_cells = total = 0
    for width in B1_WIDTHS:
        ts, vals, ph = (a[..., :width].copy()
                        for a in cs.b1_planes(rng, B1_ROWS, width + 512,
                                              False))
        vals[0, 12] = vals[1, 12]      # dense: the phase proof's lanes
        ts, vals, ph = (torch.as_tensor(a) for a in (ts, vals, ph))
        for op in ("rate", "increase"):
            full = cs.sweep_query(op, True, 1, B1_ROWS - cs.K + 1)
            sub = cs.sweep_query(op, True, 1, B1_ROWS - r0 - cs.K + 1)
            steps0 = cs.K * cs.STEP

            def run(q, rows, mode_phase, st0):
                plan = grid.series_staged_plan(
                    width, q.nsteps, q.kbuckets, q.stride,
                    grid._mode_for(q, mode_phase), q.op)
                return launch_b1(ts[rows], vals[rows], q, mode_phase,
                                 plan, st0)
            a = run(full, slice(0, None), ph, steps0)
            b = run(sub, slice(r0, None), ph, steps0 + r0 * cs.STEP)
            c = run(full, slice(0, None), None, steps0)
            d_split = _differing(b, a[r0:])
            d_mode = _differing(c, a)
            cs.compare(c, a, op, cs.RTOL_KERNEL)
            split_cells += d_split
            mode_cells += d_mode
            total += a.numel()
            print(f"S={width} {op}: a segment's later run differs from the "
                  f"unsplit launch in {d_split} of {b.numel()} cells; ts "
                  f"mode from phase mode in {d_mode} of {a.numel()}",
                  flush=True)
    print(f"B1 split: {split_cells} cells differ; B1 ts mode against phase "
          f"mode: {mode_cells} of {total} cells differ (within rtol "
          f"{cs.RTOL_KERNEL})")
    return 1 if split_cells else 0


if __name__ == "__main__":
    if sys.argv[1:] == ["b1_batch"]:
        sys.exit(main_b1_batch())
    if sys.argv[1:] == ["b1"]:
        sys.exit(main_b1())
    if sys.argv[1:] == ["b1_split"]:
        sys.exit(main_b1_split())
    if sys.argv[1:] == ["b4"]:
        sys.exit(main_b4())
    if sys.argv[1:] == ["b2"]:
        sys.exit(main_b2())
    sys.exit(main([int(x) for x in sys.argv[1].split(",")]
                  if len(sys.argv) > 1 else [4, 16, 20, 160]))
