"""Time the row-invariant linear (``ops.rows_linear_cuda.rows_linear``) at
the main path's shapes on the card, beside ``F.linear`` and the bound.

    python whisper_char_alignment_tpu_torch/scripts/time_rows_linear.py \
        [--root DIR] [--label NAME] [--iters N]

``--root`` is the checkout whose package is imported and whose kernels are
built (default: the one that holds this file), so one program times two
builds, a parent's ``git archive`` and this tree, in turns within one call
(parent, change, change, parent). Each shape: the median device time of one
call's kernel records in a ``torch.profiler`` trace of ``--iters`` calls,
inputs rotated over copies of some 200 MB so that each call reads device
memory; ``F.linear`` on the same inputs the same way (bf16 out for the lm
head); the bound, the larger of the bytes (each input read once, the output
written once) at 3.35 TB/s and 2 M N K at 989 TFLOP/s. One JSON line on
stdout, with the card's name and power limit; no card, exit 1.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

# (label, M, N, K, bias, out f32): a decode step of 8 utterances (32: B=32;
# 40: beam 5 of 8) through the attention's and the MLP's linears and the
# lm head, the capture's rows (8 x 96) and the cross K/V's (8 x 1500), at
# Whisper-medium width
SHAPES = (("q/k/v/out", 8, 1024, 1024, True, False),
          ("q/k/v/out M=32", 32, 1024, 1024, True, False),
          ("q/k/v/out M=40", 40, 1024, 1024, True, False),
          ("mlp fc1", 8, 4096, 1024, True, False),
          ("mlp fc2", 8, 1024, 4096, True, False),
          ("lm head", 8, 51865, 1024, False, True),
          ("capture rows", 768, 1024, 1024, True, False),
          ("cross K/V rows", 12000, 1024, 1024, True, False))
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
ROTATE_BYTES = 200e6


def card_label(torch) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(0)


def traced_ms(torch, fn, iters: int) -> float:
    """Median device ms of one call: the call's kernel records (one a call
    when the trace holds as many records as calls, else their total over
    the calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [(e.time_range.end - e.time_range.start) / 1e3
             for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.time_range.start >= 0]
    if len(times) == iters:
        return statistics.median(times)
    return sum(times) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(Path(a.root).resolve()))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_rows_linear: needs a CUDA card", file=sys.stderr)
        return 1
    from whisper_char_alignment_tpu_torch.ops import rows_linear_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    rows = []
    for label, m, n, k, bias, out_f32 in SHAPES:
        def randn(*shape, mul=1.0):
            return (torch.randn(shape, generator=gen, device=dev)
                    * mul).to(bf16)

        args = [randn(m, k), randn(n, k, mul=k ** -0.5)]
        if bias:
            args.append(randn(n))
        in_bytes = sum(t.numel() * t.element_size() for t in args)
        copies = max(2, math.ceil(ROTATE_BYTES / in_bytes))
        pool = [tuple(args)] + [tuple(t.clone() for t in args)
                                for _ in range(copies - 1)]
        out_dtype = torch.float32 if out_f32 else None
        kern = itertools.cycle(pool)
        lib = itertools.cycle(pool)

        def call():
            x, w, *b = next(kern)
            return rows_linear_cuda.rows_linear(x, w, *b, out_dtype=out_dtype)

        def library():
            return F.linear(*next(lib))

        out_bytes = m * n * (4 if out_f32 else 2)
        ops = 2 * m * n * k
        by_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
        bound = max(by_bytes, ops / PEAK_BF16) * 1e3
        ms = traced_ms(torch, call, a.iters)
        lib_ms = traced_ms(torch, library, a.iters)
        rows.append(dict(label=label, m=m, n=n, k=k, ms=ms, flinear_ms=lib_ms,
                         bound_ms=bound,
                         bound_by=("bytes" if by_bytes * 1e3 >= ops / PEAK_BF16
                                   * 1e3 else "operations"),
                         tflops=ops / ms / 1e9))
        print(f"{a.label} {label} (M={m}, N={n}, K={k}): {ms:.4f} ms, "
              f"F.linear {lib_ms:.4f} ms, bound {bound:.5f} ms",
              file=sys.stderr)
    print(json.dumps(dict(program="time_rows_linear", label=a.label,
                          root=a.root, device=card_label(torch), rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
