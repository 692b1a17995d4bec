#!/usr/bin/env python3
"""Time the staged B1 kernel (``rate_grid``, ``csrc/series_staged.cu``)
against its direct kernel (``rate_grid_launch``) at the shapes of the
store's ten B1 launches (``chip_smoke.py``'s Q2, Q4, Q5 and Q6) and of
the moments (stddev, stdvar, zscore) over the same lanes, in variants of
its source and plan, on one CUDA card.

    python3 tools/time_b1.py [--variants base,staged,...] [--sweep]
                             [--out report.json]

Each variant is ``filodb_tpu_torch/csrc/`` with one change, copied into
``filodb_tpu_torch/_build/variants/<name>/`` and built into a library of
its own (``ops.kernels`` pointed at the copy), or the sources as they are
with the host's plan changed:

- ``base``: the sources and the plan (``grid.series_staged_plan``) as
  they are;
- ``staged``: every launch staged at the plan's ring, the ops the plan
  sends to the direct kernel (``grid.SERIES_DIRECT_OPS``) too;
- ``ring16``: every launch staged, rings of at least 16 KB (8-row
  stages) a plane: six CTAs an SM in ts mode;
- ``lb6`` / ``lb8``: the kernel at six / eight CTAs an SM in its
  ``__launch_bounds__`` for seven (more, fewer registers a thread).

For each: the ``-Xptxas -v`` line of every ``series_staged_kernel``
instantiation and of the direct B1 kernels; then, at each launch's shape
with ``chip_smoke._mid_planes`` data (dense lanes of a uniform phase;
gappy lanes with missed scrapes), the launch against the plain version
(``chip_smoke.compare``), bit-equal to the direct kernel, and timed by
CUDA events behind a spin kernel with the L2 flushed (median of 20), in
turns: direct, staged, staged, direct.  ``--sweep`` runs
``chip_smoke.b1_sweep`` on the first variant's build first.
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

SOURCE = "series_staged.cu"
CTAS = "constexpr int kSeriesCtas = 7;"
# each variant's source replacements (every occurrence; each must occur)
VARIANTS = {
    "base": {}, "staged": {}, "ring16": {},
    "lb6": {CTAS: "constexpr int kSeriesCtas = 6;"},
    "lb8": {CTAS: "constexpr int kSeriesCtas = 8;"},
}

# the store's B1 launches: (name, rows, lanes, mode, dense, op), T = rows
# - K + 1 at stride 1 (chip_smoke.queries: Q2 over req_total's 102,400
# lanes, Q5 over Q1's span of them, Q4 and Q6 over jit_total's gappy
# lanes beside them)
PATH = (("Q2 rate", 49, 102_400, "phase", True, "rate"),
        ("Q5 irate", 64, 102_400, "ts", True, "irate"),
        ("Q5 idelta", 64, 102_400, "ts", True, "idelta"),
        ("Q5 deriv", 64, 102_400, "ts", True, "deriv"),
        ("Q5 predict_linear", 64, 102_400, "ts", True, "predict_linear"),
        ("Q5 timestamp", 64, 102_400, "ts", True, "timestamp"),
        ("Q4 rate", 49, 110_592, "ts", False, "rate"),
        ("Q6 stddev", 49, 110_592, "free", False, "stddev"),
        ("Q6 deriv", 49, 110_592, "ts", False, "deriv"),
        ("Q6 timestamp", 49, 110_592, "ts", False, "timestamp"))
# the other moments at those widths, dense (Q5's span) and gappy (Q6's)
MOMENTS = (("stddev dense", 64, 102_400, "free", True, "stddev"),
           ("stdvar dense", 64, 102_400, "free", True, "stdvar"),
           ("zscore dense", 64, 102_400, "free", True, "zscore"),
           ("stdvar gappy", 49, 110_592, "free", False, "stdvar"),
           ("zscore gappy", 49, 110_592, "free", False, "zscore"))


def staged_plan(grid, ring_min: int = 0):
    """A plan function that stages every launch whose step a ring holds,
    in the least ring of at least ``ring_min`` bytes holding it."""
    def plan(ns, nsteps, kbuckets, stride, mode, op, **_):
        ring = next((b for b in grid.SERIES_RING_BYTES if b >= ring_min
                     and stride + kbuckets
                     <= 3 * grid.ring_stage_rows(b, 4, grid.SERIES_TILE)), 0)
        return grid.SeriesPlan(ring, (2 if mode == "ts" else 1) * ring)
    return plan


def plan_patch(grid, name: str):
    """The variant's plan function, or None for the plan as it is."""
    return {"staged": staged_plan(grid),
            "ring16": staged_plan(grid, 16 * 1024)}.get(name)


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
    """Build the variant's library; (seconds, its series_staged_kernel
    and direct B1 kernels' ptxas lines)."""
    kernels._CSRC = variant_csrc(kernels, name)
    kernels._lib = None
    kernels.build_log = ""          # stays empty where a build is reused
    t0 = time.perf_counter()
    kernels.library()
    secs = time.perf_counter() - t0
    lines = [x for x in cs.ptxas_summary(kernels.build_log)
             if "series_staged_kernel" in x or "rate_grid_kernel" in x
             or "rate_grid_ext_kernel" in x]
    return secs, lines or ["the same sources' build, reused"]


def path_inputs(device, seed: int) -> dict:
    """{(rows, lanes, gappy): (ts, vals, phase)} on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng([seed, 12])
    out = {}
    for _name, rows, lanes, _mode, dense, _op in PATH + MOMENTS:
        key = (rows, lanes, not dense)
        if key not in out:
            out[key] = tuple(torch.as_tensor(a, device=device)
                             for a in cs._mid_planes(rng, rows, lanes,
                                                     not dense))
    return out


def time_path(inputs, reps: int, flush, launches=PATH) -> list:
    """Each launch: staged and direct in turns (d, s, s, d), the staged
    one bit-equal to the direct one and within rtol 2e-5 of the plain
    version."""
    import torch
    from filodb_tpu_torch.ops import grid
    fn = grid.rate_grid
    out = []
    for name, rows, lanes, mode, dense, op in launches:
        ts, vals, ph = inputs[(rows, lanes, not dense)]
        q = cs.sweep_query(op, dense, 1, rows - cs.K + 1)
        phase = ph if mode == "phase" else None
        args = (ts if mode == "ts" else None, vals, q.kbuckets * cs.STEP, q)
        staged = partial(fn, *args, phase=phase)
        direct = partial(cs.series_direct, *args, phase=phase)
        plan = grid.series_staged_plan(lanes, q.nsteps, q.kbuckets,
                                       q.stride, mode, op)
        d0 = fn.direct
        got = staged()
        torch.cuda.synchronize()
        route = "direct" if fn.direct != d0 else "staged"
        err = cs.compare(got, grid.rate_grid_ref(*args, phase=phase), op,
                         cs.RTOL_KERNEL, 0 if op in cs.CROSSING else None)
        cs.compare_bits(got, direct(), f"b1 {name} (direct)")
        d1 = cs.cuda_ms(direct, reps, flush)
        s1 = cs.cuda_ms(staged, reps, flush)
        s2 = cs.cuda_ms(staged, reps, flush)
        d2 = cs.cuda_ms(direct, reps, flush)
        bms, by = cs.bound_ms(*cs.grid_work(ts, vals, q, phase))
        cs.log(f"  {name} [{rows}, {lanes}] {mode}: {route} {plan} ms "
               f"{s1:.4f} / {s2:.4f} direct ms {d1:.4f} / {d2:.4f} bound_ms "
               f"{bms:.4f} ({by}) max_abs_err {err:.3e} bit-equal to direct")
        out.append({"launch": name, "route": route, "plan": list(plan),
                    "staged_ms": [s1, s2], "direct_ms": [d1, d2],
                    "bound_ms": bms, "max_abs_err": err})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants",
                    default="base,staged,ring16,lb6,lb8")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_b1: no CUDA device", file=sys.stderr)
        return 3
    from filodb_tpu_torch.ops import grid, kernels
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    report = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": cs.nvidia_smi(), "variants": {}}
    cs.log(f"device {report['device']}; nvidia-smi: {report['nvidia_smi']}")
    flush = cs.make_flush(device)
    inputs = path_inputs(device, args.seed)
    for name in args.variants.split(","):
        secs, lines = build(kernels, name)
        if "ptxas" not in report:     # every kernel of the first build
            report["ptxas"] = cs.ptxas_summary(kernels.build_log)
        cs.log(f"variant {name}: build seconds {secs:.3f}")
        for line in lines:
            cs.log(f"  ptxas: {line}")
        if args.sweep and not report["variants"]:
            rows = []
            cs.b1_sweep(device, cs.REPS, args.seed, rows, flush)
            report["sweep"] = rows
        patch = plan_patch(grid, name)
        real = grid.series_staged_plan
        if patch is not None:
            grid.series_staged_plan = patch
        try:
            launches = time_path(inputs, cs.REPS, flush)
            moments = time_path(inputs, cs.REPS, flush, MOMENTS)
        finally:
            grid.series_staged_plan = real
        report["variants"][name] = {"build_seconds": secs, "ptxas": lines,
                                    "launches": launches,
                                    "moments": moments}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    cs.log(f"nvidia-smi: {cs.nvidia_smi()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
