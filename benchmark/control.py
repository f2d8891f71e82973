"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 [--control-seeds 1,2]

For each seed it runs the cell's window (``--seconds``, by default the
benchmark's ``run_seconds``) and prints the numbers that the check of the
configuration's kind (``checks/<kind>.py``) compares, program against the
kind's reference: the lower readings. For each control seed it also puts
the kind's reference computed in bfloat16 (the precision below the
configuration's float32) in the program's place, on the same window, and
prints its numbers: the upper readings. Every seed runs in this one
process, after one set-up. With ``--spp n`` the program does not run: the
kind's ``control`` compares its two references over ``n`` units of its work
(the ``image`` kind: spp rounds, or launches of the mix's spp on the
sharded mix). The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import harness
from benchmark.run import window_run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--spp", type=int, default=0,
                   help="control seeds only: skip the program and compare the kind's two "
                        "references over this many units of its work (image: spp rounds, "
                        "launches of the mix's spp when sharded)")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    kind = harness.check_module(harness.check_kind(cell.config), cell.root)
    with open(f"{harness.ROOT}/BENCHMARK.json") as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    if args.spp:
        for seed in sorted(controls):
            print(json.dumps({"seed": seed, "side": "control_bf16", "spp": args.spp,
                              **kind.control(cell, seed, args.spp, "cuda")}), flush=True)
        return 0
    for seed in (int(s) for s in (args.seeds or "").split(",") if s):
        m = window_run(cell, seed, seconds, False)
        numbers, _, diag = kind.judge(cell, m, seed)
        row = {"seed": seed, "side": "program", "launches": len(m.window.launches), **diag,
               **numbers}
        print(json.dumps(row), flush=True)
        if seed in controls:
            numbers, _, _ = kind.judge(cell, m, seed, dtype=torch.bfloat16)
            print(json.dumps({"seed": seed, "side": "control_bf16", **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
