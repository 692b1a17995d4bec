#!/usr/bin/env python3
"""Time the staged B4 kernel (``rate_grid_grouped_packed``,
``csrc/grouped_staged.cu``) against its direct kernel
(``grouped_packed_launch``) at the north-star widths, in variants of its
source, on one CUDA card.

    python3 tools/time_b4.py [--variants base,lb5,...] [--sweep]
                             [--out report.json]

Each variant is ``filodb_tpu_torch/csrc/`` with one change, copied into
``filodb_tpu_torch/_build/variants/<name>/`` and built into a library of
its own (``ops.kernels`` pointed at the copy), or the sources as they are
with the host's plan changed:

- ``base``: the sources and the plan as they are;
- ``lb5``: the staged kernel at ``__launch_bounds__(288, 5)`` for ``(288,
  4)``, five CTAs an SM at most 40 registers a thread;
- ``tile128``: the 128-lane tile for every group (``grid.staged_tile``):
  a 1,024-lane group in eight passes of four consumer warps, summed in
  another order than the direct kernel's (held to the plain version
  only);
- ``wrapping``: the ring layout in which a pass wraps the ring
  (``SmemPackedSrc``, the least ring that holds a step) where the plan
  takes the linear one;
- ``shuffle_count`` / ``ballot_all``: every family counts a warp's lanes
  by ``WarpSumSink``'s shuffles / by a ballot (the source: the base
  family by a ballot, the others by shuffles);
- ``no_thresholds``: the sink calls ``RingWaits`` at every step, not
  only where a step crosses a stage.

For each: the ``-Xptxas -v`` line of every ``grouped_staged_kernel``
instantiation and of the direct kernels with ``WarpSumSink``; then on
the north-star packed variant's data
(``northstar.setup_packed``: 1,000 groups of 1,024 lanes, one p16 plane,
T = 55, K = 5) rate in phase mode and the 8 free ops of the second op
set, each against the plain version (``chip_smoke.compare_grouped``),
bit-equal to the direct kernel (all but ``tile128``), and timed by CUDA
events behind a spin kernel with the L2 flushed (median of 20), in turns:
direct, staged, staged, direct.  ``--sweep`` runs ``chip_smoke.b4_sweep``
on the first variant's build first.
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

LAUNCH_BOUNDS = "__launch_bounds__(kGroupTileMax + kProducers, 4)"
SINK = "RingWarpSumSink<Tile, Fam == F_BASE> sink"
THRESHOLDS = "    if (lo >= free_row || hi > ready_row) sync_rows(lo, hi);"
# each variant's source replacements
VARIANTS = {
    "base": {},
    "lb5": {LAUNCH_BOUNDS: "__launch_bounds__(kGroupTileMax + kProducers, 5)"},
    "tile128": {},
    "wrapping": {},
    "shuffle_count": {SINK: "RingWarpSumSink<Tile, false> sink"},
    "ballot_all": {SINK: "RingWarpSumSink<Tile, true> sink"},
    "no_thresholds": {THRESHOLDS: "    sync_rows(lo, hi);"},
}


def plan_patch(grid, name: str) -> dict:
    """The variant's changes to the host's plan: {grid attribute: value}."""
    if name == "tile128":
        return {"staged_tile": lambda gl: grid.HIST_TILE_SMALL}
    if name == "wrapping":
        real = grid.grouped_staged_plan
        # a pass of more rows than any ring's four stages: the plan of a
        # wrapping pass, whatever the query's row0
        return {"grouped_staged_plan": lambda gl, t, k, stride, row0, word:
                real(gl, t, k, stride, 1 << 20, word)}
    return {}


def variant_csrc(kernels, name: str) -> str:
    """A copy of csrc/ with the variant's text replaced (each must
    occur)."""
    out = os.path.join(kernels._BUILD, "variants", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "filodb_tpu_torch", "csrc"), out)
    path = os.path.join(out, "grouped_staged.cu")
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
    """Build the variant's library; (seconds, its grouped_staged_kernel
    ptxas lines)."""
    kernels._CSRC = variant_csrc(kernels, name)
    kernels._lib = None
    kernels.build_log = ""          # stays empty where a build is reused
    t0 = time.perf_counter()
    kernels.library()
    secs = time.perf_counter() - t0
    lines = [x for x in cs.ptxas_summary(kernels.build_log)
             if "_grouped_staged_cu_" in x or "WarpSumSink" in x]
    return secs, lines or ["the same sources' build, reused"]


def time_ops(case, reps: int, flush, bits: bool) -> list:
    """Rate (phase) and the 8 free ops on the case's data: staged and
    direct in turns (d, s, s, d)."""
    from filodb_tpu_torch import northstar as ns
    from filodb_tpu_torch.ops import grid
    s0, gl = ns.steps0(), case.group_lanes
    out = []
    for op in ("rate",) + cs.FREE_SECOND_OPS:
        use_phase = op == "rate"
        farg, farg2 = cs.FARGS.get(op, (0.0, 0.0))
        q = case.q if use_phase else case.q._replace(
            op=op, is_rate=False, farg=farg, farg2=farg2)
        args = (case.planes, s0, q, gl, 0, use_phase)
        staged = partial(grid.rate_grid_grouped_packed, *args)
        direct = partial(cs.grouped_packed_direct, case.planes, q, gl, 0,
                         use_phase)
        d0 = grid.rate_grid_grouped_packed.direct
        got = staged()
        if grid.rate_grid_grouped_packed.direct != d0:
            raise AssertionError(f"{op}: the staged kernel did not run")
        err = cs.compare_grouped(got, grid.rate_grid_grouped_packed_ref(
            *args), f"b4 {op}", op)
        if bits:
            cs.compare_grouped_bits(got, direct(), f"b4 {op} (direct)",
                                    "")
        d1 = cs.cuda_ms(direct, reps, flush)
        s1 = cs.cuda_ms(staged, reps, flush)
        s2 = cs.cuda_ms(staged, reps, flush)
        d2 = cs.cuda_ms(direct, reps, flush)
        bms, by = cs.bound_ms(*cs.grouped_packed_work(
            case.planes, q, 0, use_phase, case.vals.shape[1] // gl))
        cs.log(f"  {op}: staged ms {s1:.4f} / {s2:.4f} direct ms {d1:.4f} / "
               f"{d2:.4f} bound_ms {bms:.4f} ({by}) max_abs_err {err:.3e}"
               + (" bit-equal to direct" if bits else ""))
        out.append({"op": op, "staged_ms": [s1, s2], "direct_ms": [d1, d2],
                    "bound_ms": bms, "max_abs_err": err})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_b4: no CUDA device", file=sys.stderr)
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
            case = ns.setup_packed(args.seed, device, ns.BENCH)
            torch.cuda.synchronize()
        if args.sweep and not report["variants"]:
            rows = []
            cs.b4_sweep(device, cs.REPS, args.seed, rows, flush)
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
