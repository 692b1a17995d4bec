"""Hold the staged hist_grid_grouped_packed kernel against its direct
kernel, bit for bit, in the CPU emulation of the CUDA source (build.py),
and both against the plain PyTorch version.

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

    python3 tools/emulate_kernels/staged_vs_direct.py [HB,...]

Takes about 10 minutes for every hb, one CPU thread a CUDA thread.
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


if __name__ == "__main__":
    sys.exit(main([int(x) for x in sys.argv[1].split(",")]
                  if len(sys.argv) > 1 else [4, 16, 20, 160]))
