"""Run one cell of the port's benchmark and print its result line.

    python3 -m benchmark.run --workload medium.timit_b32 --seed 7 \\
        --seconds 30 --trace 0

Prints the result as the last line of standard output (one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit), and the same checks as the last lines of standard error.
Exits non-zero, with no result, without a CUDA card, or if JAX or the JAX
package was loaded.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()


def _env() -> None:
    # caches of the program's builds stay in the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, "build", "torch_extensions"))
    # a library the port may load must not load JAX by itself
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # load from one process with few threads
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _env()
    import torch

    from . import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    chips = cells[args.workload]["chips"] if args.workload in cells else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    out = harness.run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), t0=T0)
    found = harness.jax_loaded()
    if found:
        print(f"error: JAX was loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
