"""The readings that the limits of ``limits/<workload>.json`` are set from.

    python3 -m benchmark.control --workload medium.timit_b32 \\
        --seeds 101,102,103 --seconds 0 --side control

For each seed, one run of the cell (a warm-up pass and a window of at least
one pass, at the cell's own sizes), then the judge's numbers for the
program's outputs and, with ``--side control``, for the float8 control put
in the program's place on the same inputs. One JSON line a seed on standard
output. The benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time

from . import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, one run each")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--side", choices=("program", "control"),
                   default="control")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = harness.run(os.getcwd(), args.workload, seed, args.seconds,
                          False, t0=t0, side=args.side)
        line = {"seed": seed,
                "program": {k: c["value"] for k, c in out["checks"].items()},
                "control": out.get("control"),
                "utts_per_s": out["metrics"]["utts_per_s"]["value"],
                "seconds": time.time() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
