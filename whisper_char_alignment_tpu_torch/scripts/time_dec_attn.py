"""Time the decoder attention (``ops.dec_attn_cuda.dec_attn``) on the card at
the decode's shapes, and keep its outputs for a bit-for-bit comparison with
another build.

    python whisper_char_alignment_tpu_torch/scripts/time_dec_attn.py \
        [--root DIR] [--label NAME] [--iters N] [--dump F] [--against F]

``--root`` is the checkout whose package is imported and whose kernels are
built (default: the one that holds this file), so one program times two
builds, a parent's ``git archive`` and this tree, in turns within one call
(parent, change, change, parent). Each shape of :data:`SHAPES`: the median
device time of one call's kernel records in a ``torch.profiler`` trace of
``--iters`` calls, inputs rotated over copies of some 200 MB so that each
call reads device memory, beside the bound (bytes at 3.35 TB/s: q, the K/V
columns some row sees, the mask, the output). ``--dump`` saves the output
and the scores of every case of :data:`BITS` (both dtypes) to a file;
``--against`` compares them, bit for bit, with a file another build dumped.
One JSON line on stdout, with the card's name and power limit; no card, exit
1; outputs that differ from ``--against``'s, exit 2.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import statistics
import sys
from pathlib import Path

# (label, B, P, S, K/V layout, masked): Whisper-medium's self step at the
# benchmark's caches (35 columns at TIMIT's cap of 32 steps, 99 at
# LibriSpeech's 96), the aligned lengths beside them, the chip smoke's
# self step, long form's cache (227, past one chunk), and the cross step
# over 1500 frames at both batches
SHAPES = (("self B=32 S=35", 32, 1, 35, "cache", True),
          ("self B=32 S=40", 32, 1, 40, "cache", True),
          ("self B=16 S=99", 16, 1, 99, "cache", True),
          ("self B=16 S=104", 16, 1, 104, "cache", True),
          ("self B=8 S=48", 8, 1, 48, "cache", True),
          ("self B=8 S=227", 8, 1, 227, "cache", True),
          ("cross B=16 S=1500", 16, 1, 1500, "cache", False),
          ("cross B=32 S=1500", 32, 1, 1500, "cache", False))
# (B, H, P, S, hd, layout, masked, scaled): tests/test_torch_cuda.py's
# test_dec_attn_kernel cases and the odd cache lengths
BITS = ((8, 16, 1, 448, 64, "cache", True, True),
        (8, 16, 5, 448, 64, "cache", True, True),
        (8, 16, 1, 1500, 64, "cache", False, True),
        (2, 4, 37, 1500, 64, "proj", False, False),
        (2, 4, 37, 37, 64, "proj", True, False),
        (1, 2, 9, 131, 16, "cache", True, True),
        (1, 2, 3, 300, 128, "cache", True, True),
        (1, 2, 4, 64, 8, "cache", True, True),
        (1, 16, 1, 1500, 64, "cache", False, True),
        (2, 4, 3, 127, 64, "cache", True, True),
        (2, 4, 3, 128, 64, "cache", True, True),
        (2, 4, 3, 129, 64, "proj", True, False),
        (2, 4, 1, 1540, 64, "cache", False, True),
        (8, 16, 96, 1500, 64, "proj", False, False),
        (8, 16, 96, 1500, 64, "cache", False, True),
        (2, 4, 96, 96, 64, "proj", True, False),
        (1, 2, 4, 64, 8, "proj", True, False),
        (1, 2, 17, 200, 16, "proj", True, False),
        (1, 2, 5, 129, 128, "proj", False, False),
        (1, 2, 5, 300, 256, "cache", True, True),
        (1, 2, 5, 300, 256, "proj", True, False),
        (32, 16, 1, 35, 64, "cache", True, True),
        (16, 16, 1, 99, 64, "cache", True, True),
        (8, 16, 1, 227, 64, "cache", True, True),
        (16, 16, 3, 99, 64, "cache", True, True),
        (2, 4, 5, 227, 128, "cache", True, True),
        (2, 4, 3, 35, 128, "cache", True, True),
        (2, 4, 3, 35, 8, "cache", True, True))
H, HD = 16, 64


def traced_ms(torch, fn, iters: int) -> float:
    """Median device ms of one call: the sum of the call's kernel records
    (one or two launches), the calls told apart by their order. Kept here,
    not taken from ``time_rows_linear``: what this program imports from
    the package comes from ``--root``, which may be an older checkout."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    recs = sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.time_range.start >= 0 and "dec_attn" in e.name)
    per = len(recs) // iters if len(recs) % iters == 0 else 0
    if per == 0:
        return sum(e - s for s, e in recs) / 1e3 / iters
    return statistics.median(
        sum(e - s for s, e in recs[i * per:(i + 1) * per]) / 1e3
        for i in range(iters))


def inputs(torch, gen, b, h, p, s, hd, layout, dtype):
    """q as the decode gives it (a (B, P, H, hd) projection seen as (B, H,
    P, hd)), K/V as the cache stores them or as transposed projections, the
    position mask of P rows ending 3 columns before S."""
    from whisper_char_alignment_tpu_torch.models import whisper as wm

    dev = torch.device("cuda")
    q = (torch.randn((b, p, h, hd), generator=gen, device=dev)
         * hd ** -0.25).to(dtype).transpose(1, 2)
    if layout == "cache":
        k, v = (torch.randn((b, h, hd, s), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
    else:
        k, v = (torch.randn((b, h, s, hd), generator=gen, device=dev)
                .to(dtype).transpose(-1, -2) for _ in range(2))
    start = max(0, s - 3 - p)
    mask = wm._position_mask(torch.arange(start, start + p, device=dev), s)
    return q, k, v, mask


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--against", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(Path(a.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_dec_attn: needs a CUDA card", file=sys.stderr)
        return 1
    from whisper_char_alignment_tpu_torch.ops import _lib, dec_attn_cuda
    from whisper_char_alignment_tpu_torch.scripts.time_rows_linear import (
        HBM_BYTES_PER_S, ROTATE_BYTES, card_label)
    from whisper_char_alignment_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, b, p, s, layout, masked in SHAPES:
        q, k, v, mask = inputs(torch, gen, b, H, p, s, HD, layout, bf16)
        mask = mask if masked else None
        in_bytes = sum(t.numel() * t.element_size() for t in (q, k, v))
        copies = max(2, math.ceil(ROTATE_BYTES / in_bytes))
        pool = itertools.cycle([(q, k, v)] + [
            tuple(t.clone() for t in (q, k, v)) for _ in range(copies - 1)])

        def call():
            qq, kk, vv = next(pool)
            return dec_attn_cuda.dec_attn(qq, kk, vv, dtype=bf16, mask=mask,
                                          k_scale=HD ** -0.25)

        seen = (s if mask is None else
                int((mask > float("-inf")).any(0).nonzero().max()) + 1)
        nbytes = (q.numel() * 2 * 2 + (k.numel() + v.numel()) * 2 * seen // s
                  + (0 if mask is None else mask.numel() * 4))
        before = _lib.launch_counts().get("dec_attn_unaligned", 0)
        call()
        unaligned = _lib.launch_counts().get("dec_attn_unaligned", 0) > before
        ms = traced_ms(torch, call, a.iters)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(dict(label=label, b=b, p=p, s=s, ms=ms, bound_ms=bound,
                         unaligned=unaligned,
                         kernels=list(dec_attn_cuda.kernels(s))))
        print(f"{a.label} {label}: {ms * 1e3:.2f} us, bound "
              f"{bound * 1e3:.2f} us ({nbytes / 1e6:.2f} MB)"
              f"{', unaligned' if unaligned else ''}", file=sys.stderr)
    outs = {}
    for dtype in (bf16, torch.float32):
        for case in BITS:
            b, h, p, s, hd, layout, masked, scaled = case
            g = torch.Generator(device="cuda").manual_seed(b * p + s + hd)
            q, k, v, mask = inputs(torch, g, b, h, p, s, hd, layout, dtype)
            out, sc = dec_attn_cuda.dec_attn(
                q, k, v, dtype=dtype, mask=mask if masked else None,
                k_scale=hd ** -0.25 if scaled else None, scores=True)
            outs[f"{str(dtype)[6:]} {case}"] = (out.cpu(), sc.cpu())
    torch.cuda.synchronize()
    if a.dump:
        torch.save(outs, a.dump)
    differ = None
    if a.against:
        other = torch.load(a.against)
        differ = sorted(
            key for key, (out, sc) in outs.items()
            if key not in other or not (
                torch.equal(out.view(torch.int16) if out.dtype == bf16
                            else out.view(torch.int32),
                            other[key][0].view(torch.int16)
                            if out.dtype == bf16
                            else other[key][0].view(torch.int32))
                and torch.equal(sc.view(torch.int32),
                                other[key][1].view(torch.int32))))
        print(f"{a.label}: {len(outs) - len(differ)} of {len(outs)} cases "
              f"bit-equal to {a.against}", file=sys.stderr)
    print(json.dumps(dict(program="time_dec_attn", label=a.label,
                          root=a.root, device=card_label(torch), rows=rows,
                          bit_cases=len(outs), differ=differ)))
    return 2 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
