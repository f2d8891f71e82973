"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 [--control-seeds 1,2]

For each seed it runs the cell's window (``--seconds``, by default the
benchmark's ``run_seconds``) and prints the numbers compared, program
against the plain float32 reference: the lower readings. For each control
seed it also puts the reference computed in bfloat16 (the precision below
the configuration's float32) in the program's place, at the same pixels
and spp rounds, and prints its numbers: the upper readings. Every seed
runs in this one process, after one set-up. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import harness
from benchmark.run import judge, window_run


def _control_only(cell, seed: int, spp: int) -> dict:
    """The numbers of the bfloat16 reference against the float32 one at a
    run's pixels and ``spp`` rounds (for the sharded mix, ``spp`` launches
    of its ``launch_spp``)."""
    import torch

    from benchmark import check

    c = cell.config
    per = cell.mix.get("launch_spp") if cell.mix["launcher"] == "sharded" else None
    rounds = ([(i, s) for i in range(spp) for s in range(per)] if per else list(range(spp)))
    pixels = check.sample_pixels(c["width"] * c["height"], c["check"]["pixels"], seed)
    ref, rays = check.reference(c, harness.ROOT, seed, rounds, pixels, "cuda")
    low, low_rays = check.reference(c, harness.ROOT, seed, rounds, pixels, "cuda",
                                    torch.bfloat16)
    paths = len(pixels) * len(rounds)
    return check.compare(low, ref, low_rays / paths, rays / paths)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--spp", type=int, default=0,
                   help="control seeds only: skip the program and compare the two references "
                        "over this many spp rounds (launches of the mix's spp, sharded)")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    with open(f"{harness.ROOT}/BENCHMARK.json") as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    if args.spp:
        for seed in sorted(controls):
            print(json.dumps({"seed": seed, "side": "control_bf16", "spp": args.spp,
                              **_control_only(cell, seed, args.spp)}), flush=True)
        return 0
    for seed in (int(s) for s in (args.seeds or "").split(",") if s):
        m = window_run(cell, seed, seconds, False)
        numbers, checks, _, _ = judge(cell, m, seed)
        row = {"seed": seed, "side": "program", "launches": len(m.window.launches),
               "spp": len(m.rounds), **numbers}
        print(json.dumps(row), flush=True)
        if seed in controls:
            numbers, _, _, _ = judge(cell, m, seed, dtype=torch.bfloat16)
            print(json.dumps({"seed": seed, "side": "control_bf16", **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
