"""Golden end-to-end fixture of the port (counterpart of
``tests/test_golden.py``): the README-pinned alignment of sample/test.wav
("Artificial intelligence is for real") with Whisper-medium, char units,
topk=10, medfilt 3 (reference README.md:134-140 and BASELINE.md), through
``api.load_model`` -> ``api.align`` on the device ``WCA_PLATFORM`` selects
(the card unless ``cpu``).

Requires real assets, gated on the JAX suite's variables:
    WCA_CHECKPOINT      medium weights (.pt, .npz or .safetensors)
    WCA_TOKENIZER_DIR   dir with multilingual.tiktoken
    WCA_SAMPLE_WAV      path to the sample wav (default: the repository's
                        sample/test.wav)

It imports nothing of JAX, so it also runs where JAX is not installed:
``python -m pytest tests/test_torch_golden.py -q --noconftest`` (the asset
runbook's gate 1, ``scripts/asset_gates.py``).
"""

import os

import pytest

CHECKPOINT = os.environ.get("WCA_CHECKPOINT")
TOKENIZER_DIR = os.environ.get("WCA_TOKENIZER_DIR")
SAMPLE_WAV = os.environ.get("WCA_SAMPLE_WAV", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sample",
    "test.wav"))

GOLDEN = [
    ("Artificial", 0.00, 0.70),
    ("intelligence", 0.70, 1.38),
    ("is", 1.38, 1.52),
    ("for", 1.52, 1.76),
    ("real", 1.76, 2.06),
]

pytestmark = pytest.mark.skipif(
    not (CHECKPOINT and TOKENIZER_DIR and os.path.exists(SAMPLE_WAV)),
    reason="golden test needs real weights/tokenizer assets "
           "(WCA_CHECKPOINT, WCA_TOKENIZER_DIR)")


def test_readme_golden_alignment():
    from whisper_char_alignment_tpu_torch import api
    from whisper_char_alignment_tpu_torch.cli.common import apply_platform_env

    device = apply_platform_env()
    model = api.load_model("medium", checkpoint=CHECKPOINT,
                           tokenizer_dir=TOKENIZER_DIR, device=device)
    res = api.align(model, SAMPLE_WAV, aligned_unit_type="char",
                    aggregation="topk", topk=10, medfilt_width=3,
                    device=device)
    got = [(w.strip(), float(s), float(e))
           for w, s, e in zip(res.words[:-1], res.start_times, res.end_times)]
    assert len(got) == len(GOLDEN)
    tol = 0.02  # one mel frame, the north-star parity bound (BASELINE.md)
    for (w, s, e), (gw, gs, ge) in zip(got, GOLDEN):
        assert w.lower() == gw.lower()
        assert abs(s - gs) <= tol, f"{w}: start {s} vs {gs}"
        assert abs(e - ge) <= tol, f"{w}: end {e} vs {ge}"
