"""Every kernel of the port on the device against its plain version (port
of the repository's ``scripts/verify_kernels_on_device.py``).

    python -m whisper_char_alignment_tpu_torch.scripts.verify_kernels_on_device
    WCA_PLATFORM=cpu python -m whisper_char_alignment_tpu_torch.scripts.verify_kernels_on_device

The unit tests hold each kernel's plain version against the JAX package on
the CPU; this program holds the built kernels (``csrc/*.cu``) against those
plain versions on the card, where a layout, a padded lane or a reduction
order could diverge. Run it after a kernel, CUDA or PyTorch change. The JAX
script's six checks, in its order and at its shapes:

1. kernel 2, the QK post-process (``whisper.qk_to_attention``), against
   ``qk_postprocess_plain`` at (8, 4, 96, 1500), widths 3 and 7, with equal
   DTW jump frames from ``ops/dtw.dtw_np``;
2. kernel 1 in the encoder (``whisper.encode_audio``, Whisper-medium, bf16)
   against the same encoder with the kernel's plain version;
3. kernel 7, the int8 decode cross-attention, against a NumPy dequantize
   oracle on uniform and peaked attention; (3b) the ``mxu`` step
   (``whisper._cross_attn_step_int8_mxu``, no kernel) against the same
   oracle at the JAX budgets (5% uniform, 1% peaked);
4. kernels 3a + 3b through ``align/timing.matrix_to_jump_frames`` against
   ``dtw_np`` at (9, 40, 300), exact;
5. kernel 6 and its clip (``ops/mel_cuda.log_mel``) against the plain mel
   (``audio/mel.log_mel_spectrogram``) within 1e-4, the bound
   ``chip_smoke.py`` holds: the kernel takes a real FFT where the plain
   version takes a DFT product, so the JAX check's bit-level equality of two
   DFTs does not carry over;
6. ``decode_prefill`` against sequential ``decode_step`` (medium, bf16).

Prints a PASS line for each check (a FAIL line stops the program, exit 1),
``ALL KERNELS PASS ON DEVICE``, then one JSON line: ``checks``, ``device``
(the card's name and power limit, or ``"cpu"``) and ``launches`` (the
kernel launches of the checks, ``ops/_lib``). Runs on ``cuda`` unless
``WCA_PLATFORM=cpu`` (then the kernels' plain versions run, and nothing
launches); without a card it exits non-zero and prints nothing on stdout.
"""

from __future__ import annotations

import contextlib
import json
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..align import timing
from ..audio.mel import log_mel_spectrogram
from ..bench import device_label, platform_device
from ..config import MODEL_DIMS
from ..models import whisper as wmodel
from ..ops import _lib, encoder_attn_cuda, mel_cuda
from ..ops.cross_attn_cuda import cross_attn_step_int8
from ..ops.dtw import dtw_np
from ..ops.qkpost_cuda import qk_postprocess_plain


def check(name: str, ok: bool, detail: str = "") -> None:
    print(f"{'PASS' if ok else 'FAIL'}  {name}  {detail}", flush=True)
    if not ok:
        raise SystemExit(f"on-device parity failure: {name}")


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def check_qkpost(model, device, rng) -> None:
    """(1) f32: expect ~1e-7, and the same DTW path on every item."""
    b, h, t, f = 8, 4, 96, 1500
    qk = _tensor(rng.normal(0, 2, (b, h, t, f)).astype(np.float32), device)
    fl = _tensor(rng.integers(40, f + 1, (b,)).astype(np.int32), device)
    tl = _tensor(rng.integers(10, t + 1, (b,)).astype(np.int32), device)
    for width in (3, 7):
        want = qk_postprocess_plain(qk, fl, tl, width, 1.0).cpu().numpy()
        got = wmodel.qk_to_attention(qk, fl, tl, width,
                                     qk_scale=1.0).cpu().numpy()
        d = float(np.abs(got - want).max())
        jumps_equal = all(
            np.array_equal(
                dtw_np(-want[i].mean(0)[:int(tl[i]), :int(fl[i])])[1],
                dtw_np(-got[i].mean(0)[:int(tl[i]), :int(fl[i])])[1])
            for i in range(b))
        check(f"qkpost width={width}", d < 1e-6 and jumps_equal,
              f"max|diff|={d:.1e} dtw_jumps_equal={jumps_equal}")


@contextlib.contextmanager
def _plain_encoder_attention():
    """The encoder's layers with the kernel's plain version in its place."""
    kernel = wmodel.encoder_self_attention
    wmodel.encoder_self_attention = \
        encoder_attn_cuda.encoder_self_attention_plain
    try:
        yield
    finally:
        wmodel.encoder_self_attention = kernel


def bf16_model(dims, device) -> wmodel.Whisper:
    """Random bf16 weights from a ``torch.Generator`` seeded 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    return wmodel.init_params(
        wmodel.Whisper(dims, device=device, dtype=torch.bfloat16), gen)


def check_encoder(model, device, rng) -> None:
    """(2) bf16 compute: reduction-order noise, a relative 5%."""
    dims = model.dims
    mel = _tensor(rng.normal(0, 1, (2, dims.n_mels, 2 * dims.n_audio_ctx)
                             ).astype(np.float32), device).to(torch.bfloat16)
    with _plain_encoder_attention():
        a = wmodel.encode_audio(model, mel, device=device).float()
    c = wmodel.encode_audio(model, mel, device=device).float()
    rel = float((a - c).abs().max() / (a.abs().max() + 1e-9))
    check(f"encoder attention ({dims.n_audio_layer} layers, bf16)",
          rel < 0.05, f"rel_max_diff={rel:.3f} (bf16 reduction-order level)")


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def check_cross_attn(model, device, rng) -> None:
    """(3) kernel 7 and (3b) the ``mxu`` step against the dequantize oracle
    (f32), on N(0, 1) scores (near-uniform softmax over 1500 frames) and on
    a peaked softmax (q along K's column 123, scaled so that its score,
    about +45, dwarfs the N(0, 2.3) background). Uniform attention is the
    ``mxu`` step's worst case: 1500 independent roundings of its
    probability row against a tiny sum (the JAX script measured ~2.4%)."""
    bh, hd, fr = 4, 64, 1500
    q = rng.normal(0, 1, (bh, 16, 1, hd)).astype(np.float32)
    k = rng.normal(0, 1, (bh, 16, hd, fr)).astype(np.float32)
    v = rng.normal(0, 1, (bh, 16, hd, fr)).astype(np.float32)

    def quant(x):
        # per-frame-column scale over hd: (B, H, 1, F), the kernel's layout
        amax = np.abs(x).max(axis=2, keepdims=True)
        s = np.where(amax == 0, 1.0, amax / 127.0)
        return (np.clip(np.round(x / s), -127, 127).astype(np.int8),
                s.astype(np.float32))

    (k8, ks), (v8, vs) = quant(k), quant(v)
    scale = hd ** -0.25
    k_dq = k8.astype(np.float32) * ks
    v_dq = v8.astype(np.float32) * vs
    ck = (_tensor(k8, device), _tensor(ks, device))
    cv = (_tensor(v8, device), _tensor(vs, device))

    def oracle(qn):
        w = _softmax(np.einsum("bhtd,bhdf->bhtf", qn, k_dq * scale))
        return np.einsum("bhtf,bhdf->bhtd", w, v_dq)

    q_peak = k_dq[:, :, :, 123][:, :, None, :] * 20.0
    for label, qn in (("uniform", q), ("peaked", q_peak)):
        want = oracle(qn)
        qt = _tensor(qn, device)
        got = cross_attn_step_int8(qt, ck[0], ck[1], cv[0], cv[1],
                                   k_scale=float(scale)).cpu().numpy()
        d = float(np.abs(got - want).max())
        check(f"int8 cross-attention decode kernel ({label})", d < 1e-4,
              f"max|diff|={d:.1e}")
        got_mxu = wmodel._cross_attn_step_int8_mxu(
            qt, ck, cv, float(scale), torch.float32).cpu().numpy()
        rel = float(np.abs(got_mxu - want).max() / (np.abs(want).max() + 1e-9))
        budget = 0.05 if label == "uniform" else 0.01
        check(f"int8-product (mxu) cross-attn ({label})", rel < budget,
              f"rel_max_diff={rel:.4f}")


def check_dtw(model, device, rng) -> None:
    """(4) exact integer paths: rows [sot_len : token_len - 1] as the
    pipeline slices them."""
    x = rng.normal(0, 1, (9, 40, 300)).astype(np.float32)
    n_rows = 38
    token_len = torch.full((9,), n_rows + 1, dtype=torch.int32, device=device)
    m = torch.full((9,), 280, dtype=torch.int32, device=device)
    jf = timing.matrix_to_jump_frames(_tensor(-x, device), token_len, m,
                                      0).cpu().numpy()
    ok = True
    for i in range(9):
        ti, tj = dtw_np(x[i, :n_rows, :280])
        first = np.pad(np.diff(ti), (1, 0), constant_values=1).astype(bool)
        ok &= np.array_equal(jf[i][:n_rows], tj[first])
    check("DTW wavefront + backtrace vs NumPy oracle", bool(ok))


def check_mel(model, device, rng) -> None:
    """(5) the two mel kernels against the plain frontend."""
    audio = _tensor(rng.normal(0, 0.1, (2, 480000)).astype(np.float32),
                    device)
    a = log_mel_spectrogram(audio)
    p = mel_cuda.log_mel(audio)
    d = float((a - p).abs().max())
    check("mel kernels vs plain mel", d < 1e-4, f"max|diff|={d:.1e}")


def check_prefill(model, device, rng) -> None:
    """(6) cache columns and the continued step's logits agree to
    reduction-order noise (the two paths span the same masked ctx-wide
    reductions; only the order may differ)."""
    dims = model.dims
    bf16 = torch.bfloat16
    xa = _tensor(rng.normal(0, 1, (4, dims.n_audio_ctx, dims.n_audio_state)
                            ).astype(np.float32), device)
    cross_kv = wmodel.precompute_cross_kv(model, xa)
    prompt = _tensor(rng.integers(0, dims.n_vocab, (4, 4)).astype(np.int64),
                     device)
    cache_a = wmodel.init_kv_cache(dims, 4, 40, dtype=bf16, device=device)
    for i in range(4):
        _, cache_a = wmodel.decode_step(model, prompt[:, i:i + 1], i,
                                        cache_a, cross_kv)
    cache_b = wmodel.init_kv_cache(dims, 4, 40, dtype=bf16, device=device)
    _, cache_b = wmodel.decode_prefill(model, prompt, cache_b, cross_kv)
    nxt = torch.full((4, 1), 7, dtype=torch.long, device=device)
    lg_a, _ = wmodel.decode_step(model, nxt, 4, cache_a, cross_kv)
    lg_b, _ = wmodel.decode_step(model, nxt, 4, cache_b, cross_kv)
    cd = max(float((cache_a[k].float() - cache_b[k].float()).abs().max())
             for k in ("k", "v"))
    ld = float((lg_a - lg_b).abs().max())
    scale_l = float(lg_a.abs().max())
    check("decode prefill vs stepwise", cd < 1e-1 and ld < 0.02 * scale_l,
          f"max|cache_diff|={cd:.1e} max|logit_diff|={ld:.2e} "
          f"(|logits|max={scale_l:.1f})")


# the JAX script's order; each takes (model, device, rng), and checks 2
# and 6 run the model
CHECKS: List[Tuple[str, Callable]] = [
    ("qkpost", check_qkpost), ("encoder", check_encoder),
    ("cross_attn", check_cross_attn), ("dtw", check_dtw),
    ("mel", check_mel), ("prefill", check_prefill)]


@torch.no_grad()
def run(dims, device) -> dict:
    """Every check on ``device``, checks 2 and 6 on a random bf16 model of
    ``dims``; returns the JSON line's payload. A failure raises
    ``SystemExit``."""
    rng = np.random.default_rng(0)
    model = bf16_model(dims, device)
    before = _lib.launch_counts()
    for _, fn in CHECKS:
        fn(model, device, rng)
    after = _lib.launch_counts()
    print("ALL KERNELS PASS ON DEVICE", flush=True)
    return {"program": "verify_kernels_on_device", "checks": len(CHECKS),
            "device": device_label(device),
            "launches": {k: after[k] - before[k] for k in after}}


def main() -> None:
    device = platform_device()
    print(f"device: {device_label(device)}", flush=True)
    print(json.dumps(run(MODEL_DIMS["medium"], device)), flush=True)


if __name__ == "__main__":
    main()
