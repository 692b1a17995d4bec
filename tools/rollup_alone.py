"""Run chip_smoke.py's rollup phase alone on the card.

Builds the kernels (``chip_smoke.KernelBuild``) while the durable
stream's hourly container sets are encoded (``chip_smoke.PodHours``),
then runs ``chip_smoke.rollup_phase`` over the first ROLLUP_HOURS hours:
the live tiers, the dashboard refreshed through the result cache, R1-R3
and their kernel timings, every check of the phase.  The phase's record
is written as JSON.  It needs one CUDA card and exits non-zero without
one.  The quickest way to iterate on phase 8 (about 6 minutes on one
H100) without the phases before it:

    python3 tools/rollup_alone.py [--seed N] [--out PATH]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the phase's record as JSON here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("rollup_alone: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as cs

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    encoding = cs.PodHours(args.seed, cs.REQ_PODS)
    try:
        build_s = cs.KernelBuild().join()
        hours, encode_s, _waited = encoding.get()
    finally:
        encoding.close()
    cs.log(f"build {build_s:.3f} s, encoding {encode_s:.3f} s; "
           f"{cs.nvidia_smi()}")
    hours = {p: hours[p][:cs.ROLLUP_HOURS] for p in range(cs.REQ_PODS)}
    report: dict = {}
    with cs.Phase("rollup"):
        cs.rollup_phase(device, args.seed, cs.REPS, hours, report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    cs.log(f"total {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    os._exit(rc)
