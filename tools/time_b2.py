#!/usr/bin/env python3
"""Time the staged B2 kernel (``rate_grid_grouped``,
``csrc/dense_staged.cu``) against its direct kernel
(``rate_grid_grouped_launch``) at the north-star dense widths, in
variants of its source and plan, on one CUDA card.

    python3 tools/time_b2.py [--variants base,ts_device,...] [--sweep]
                             [--out report.json]

Each variant is ``filodb_tpu_torch/csrc/`` with one change, copied into
``filodb_tpu_torch/_build/variants/<name>/`` and built into a library of
its own (``ops.kernels`` pointed at the copy), or the sources as they are
with the host's plan changed:

- ``base``: the sources and the plan as they are (at the north-star
  widths a pass's 59 rows linear in the 64 KB ring, three CTAs an SM by
  shared memory; the ops that read timestamps stage them in a second
  ring beside the values, both 16 KB and wrapping);
- ``wrapping``: the ring layout in which a pass wraps the ring (the 16 KB
  ring that holds a step: four CTAs an SM by the launch bounds);
- ``tile128``: the 128-lane tile for every group (``grid.staged_tile``):
  a 1,024-lane group in eight passes of four consumer warps, linear in
  the 32 KB ring, summed in another order than the direct kernel's (held
  to the plain version only);
- ``lb3``: the staged kernel at ``__launch_bounds__(288, 3)`` for ``(288,
  4)``: registers freed where shared memory caps a CTA at three an SM
  anyway;
- ``ts_ring32``: a launch that reads timestamps takes two 32 KB rings
  (8-row stages, wrapping) where its plan takes two 16 KB ones (4-row
  stages): fewer stage crossings a pass, three CTAs an SM;
- ``ballot_all``: every family counts a warp's lanes by a ballot (the
  source: the base family by a ballot, the others by shuffles);
- ``ts_lb5`` / ``ts_lb6``: the families that read timestamps only
  (irate, idelta, deriv, predict_linear, timestamp) at
  ``__launch_bounds__(288, 5)`` / ``(288, 6)``: their plan's two 16 KB
  rings leave room for six CTAs an SM;
- ``wrapping_lb6``: the wrapping layout at ``__launch_bounds__(288,
  6)``: six CTAs an SM (at most 32 registers a thread), about the
  occupancy of the direct kernels of the second op set (32-39
  registers);
- ``ts_device``: the ops that read timestamps read them from device
  memory, one load at a time as the direct kernel does, and take the
  plan of a launch that reads none (the first version of the source).

For each: the ``-Xptxas -v`` line of every ``dense_staged_kernel``
instantiation and of the direct kernels; then on the north-star dense
variant's data (``northstar.setup_dense``: 1,000 groups of 1,024 lanes,
59 rows, T = 55, K = 5) rate in phase mode and in ts mode, and the 13
ops of the second op set (the 5 that read timestamps over the variant's
ts plane), each
against the plain version (``chip_smoke.compare_grouped``), bit-equal to
the direct kernel (all but ``tile128``), and timed by CUDA events behind
a spin kernel with the L2 flushed (median of 20), in turns: direct,
staged, staged, direct.  ``--sweep`` runs ``chip_smoke.b2_sweep`` on the
first variant's build first.
"""

import argparse
import json
import os
import shutil
import sys
import time
from functools import partial

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

SOURCE = "dense_staged.cu"
LAUNCH_BOUNDS = "__launch_bounds__(kGroupTileMax + kProducers, 4)"
# each variant's source replacements (every occurrence; each must occur)
VARIANTS = {
    "base": {},
    "wrapping": {},
    "tile128": {},
    "ts_ring32": {},
    "lb3": {LAUNCH_BOUNDS: "__launch_bounds__(kGroupTileMax + kProducers, 3)"},
    "ballot_all": {"RingWarpSumSink<Tile, Fam == F_BASE> sink":
                   "RingWarpSumSink<Tile, true> sink"},
    "ts_lb5": {LAUNCH_BOUNDS: "__launch_bounds__(kGroupTileMax + kProducers, "
                              "Fam == F_PAIR || Fam == F_LINREG "
                              "|| Fam == F_STAMP ? 5 : 4)"},
    "ts_lb6": {LAUNCH_BOUNDS: "__launch_bounds__(kGroupTileMax + kProducers, "
                              "Fam == F_PAIR || Fam == F_LINREG "
                              "|| Fam == F_STAMP ? 6 : 4)"},
    "wrapping_lb6": {
        LAUNCH_BOUNDS: "__launch_bounds__(kGroupTileMax + kProducers, 6)"},
    # the ops that read timestamps read them from device memory, as the
    # direct kernel does (the plan of a launch that reads none)
    "ts_device": {
        "  const int planes = ts ? 2 : 1;": "  const int planes = 1;",
        "        if (ts)\n          stage_rows<int, Tile>":
            "        if (false)\n          stage_rows<int, Tile>",
        "static_cast<const int*>(ts_ring + at), Tile,":
            "ts ? ts + lane : nullptr, ns,",
        "RingTs<Tile>{ts_ring + j, mask, r0}, 0,":
            "ts ? ts + lane : nullptr, ns,",
        "(ts ? p.ring_bytes : 0)": "0",
    },
}


def plan_patch(grid, name: str) -> dict:
    """The variant's changes to the host's plan: {grid attribute: value}."""
    if name == "tile128":
        return {"staged_tile": lambda gl: grid.HIST_TILE_SMALL}
    if name.startswith("wrapping"):
        return {"dense_staged_plan": cs.wrapping_plan}
    if name == "ts_ring32":
        real = grid.dense_staged_plan

        def plan(gl, t, k, stride, reads_ts=False):
            p = real(gl, t, k, stride, reads_ts)
            if not reads_ts or not p.staged or p.ring_bytes >= 32 * 1024:
                return p
            return p._replace(ring_bytes=32 * 1024, linear=False,
                              shared=p.shared + 2 * 16 * 1024)
        return {"dense_staged_plan": plan}
    if name == "ts_device":
        real = grid.dense_staged_plan
        return {"dense_staged_plan": lambda gl, t, k, stride, reads_ts=False:
                real(gl, t, k, stride)}
    return {}


def variant_csrc(kernels, name: str) -> str:
    """A copy of csrc/ with the variant's text replaced (each must
    occur)."""
    out = os.path.join(kernels._BUILD, "variants", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "filodb_tpu_torch", "csrc"), out)
    path = os.path.join(out, SOURCE)
    with open(path) as f:
        src = f.read()
    for old, new in VARIANTS[name].items():
        if old not in src:
            raise AssertionError(f"{name}: {old!r} not in the source")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return out


def build(kernels, name: str) -> tuple:
    """Build the variant's library; (seconds, its dense_staged_kernel and
    direct B2 kernels' ptxas lines)."""
    kernels._CSRC = variant_csrc(kernels, name)
    kernels._lib = None
    kernels.build_log = ""          # stays empty where a build is reused
    t0 = time.perf_counter()
    kernels.library()
    secs = time.perf_counter() - t0
    lines = [x for x in cs.ptxas_summary(kernels.build_log)
             if "_dense_staged_cu_" in x or "rate_grid_grouped" in x]
    return secs, lines or ["the same sources' build, reused"]


# the timed ops: rate in phase mode and in ts mode ("rate_ts"), then the
# second op set
OPS = ("rate", "rate_ts") + cs.TS_SECOND_OPS + cs.FREE_SECOND_OPS


def time_ops(case, reps: int, flush, bits: bool) -> list:
    """Rate (phase and ts mode) and the 13 ops of the second op set on
    the case's data: staged and direct in turns (d, s, s, d)."""
    from filodb_tpu_torch import northstar as ns
    from filodb_tpu_torch.ops import grid
    s0, gl = ns.steps0(), case.group_lanes
    fn = grid.rate_grid_grouped
    out = []
    for name in OPS:
        op = "rate" if name == "rate_ts" else name
        farg, farg2 = cs.FARGS.get(op, (0.0, 0.0))
        q = case.q if op == "rate" else case.q._replace(
            op=op, is_rate=False, farg=farg, farg2=farg2)
        ts = case.ts if name == "rate_ts" or op in cs.TS_SECOND_OPS \
            else None
        phase = case.phase if name == "rate" else None
        args = (ts, case.vals, s0, q, gl)
        staged = partial(fn, *args, phase=phase)
        direct = partial(cs.grouped_dense_direct, *args, phase=phase)
        d0 = fn.direct
        got = staged()
        if fn.direct != d0:
            raise AssertionError(f"{op}: the staged kernel did not run")
        err = cs.compare_grouped(got, grid.rate_grid_grouped_ref(
            *args, phase=phase), f"b2 {op}", op)
        if bits:
            cs.compare_grouped_bits(got, direct(), f"b2 {op} (direct)", "")
        d1 = cs.cuda_ms(direct, reps, flush)
        s1 = cs.cuda_ms(staged, reps, flush)
        s2 = cs.cuda_ms(staged, reps, flush)
        d2 = cs.cuda_ms(direct, reps, flush)
        bms, by = cs.bound_ms(*cs.grouped_work(
            case.vals, q, phase, case.vals.shape[1] // gl))
        cs.log(f"  {name}: staged ms {s1:.4f} / {s2:.4f} direct ms {d1:.4f} / "
               f"{d2:.4f} bound_ms {bms:.4f} ({by}) max_abs_err {err:.3e}"
               + (" bit-equal to direct" if bits else ""))
        out.append({"op": name, "staged_ms": [s1, s2], "direct_ms": [d1, d2],
                    "bound_ms": bms, "max_abs_err": err})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants",
                    default="base,ts_device,wrapping,tile128,lb3")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_b2: no CUDA device", file=sys.stderr)
        return 3
    from filodb_tpu_torch import northstar as ns
    from filodb_tpu_torch.ops import grid, kernels
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    report = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": cs.nvidia_smi(), "variants": {}}
    cs.log(f"device {report['device']}; nvidia-smi: {report['nvidia_smi']}")
    flush = cs.make_flush(device)
    case = None
    for name in args.variants.split(","):
        secs, lines = build(kernels, name)
        cs.log(f"variant {name}: build seconds {secs:.3f}")
        for line in lines:
            cs.log(f"  ptxas: {line}")
        if case is None:            # its gates run on the first build
            case = ns.setup_dense(args.seed, device, ns.BENCH)
            torch.cuda.synchronize()
        if args.sweep and not report["variants"]:
            rows = []
            cs.b2_sweep(device, cs.REPS, args.seed, rows, flush)
            report["sweep"] = rows
        patch = plan_patch(grid, name)
        saved = {k: getattr(grid, k) for k in patch}
        for k, v in patch.items():
            setattr(grid, k, v)
        try:
            ops = time_ops(case, cs.REPS, flush, bits=name != "tile128")
        finally:
            for k, v in saved.items():
                setattr(grid, k, v)
        report["variants"][name] = {"build_seconds": secs, "ptxas": lines,
                                    "ops": ops}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    cs.log(f"nvidia-smi: {cs.nvidia_smi()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
