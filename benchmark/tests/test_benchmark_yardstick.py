"""The yardstick: byte and FLOP counts against hand counts at one small
shape, the model FLOPs against the port's own count, the reference's DTW
and logit rules, and the control that has to come out not correct."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import costs, harness, judge
from benchmark.reference import whisper as ref

from conftest import REPO, TINY_LIMITS, make_root

DIMS = {"d_model": 8, "encoder_layers": 1, "decoder_layers": 1,
        "encoder_attention_heads": 2, "decoder_attention_heads": 2,
        "num_mel_bins": 4, "vocab_size": 10, "max_source_positions": 5,
        "max_target_positions": 16, "frames": 5}
BATCH = costs.Batch(rows=1, token_lens=[3], t_bucket=4, sample_begin=3,
                    steps=2)


def test_linear_and_attention_by_hand():
    w = costs.Work()
    costs.linear(w, 2, 3, 4)
    assert (w.flops, w.bytes) == (48, 2 * (6 + 12 + 4) + 2 * 8)
    w = costs.Work()
    costs.attention(w, 2, 3, 5, 4)
    assert (w.flops, w.bytes) == (4 * 2 * 15 * 4, 2 * 2 * 4 * (6 + 10))
    w = costs.Work()
    costs.attention(w, 2, 3, 3, 4, pairs=6, score_bytes=4)
    assert (w.flops, w.bytes) == (4 * 2 * 6 * 4,
                                  2 * 2 * 4 * 12 + 4 * 2 * 9)


def test_dec_attn_by_hand():
    w = costs.dec_attn(DIMS, BATCH)
    # prefill self (2 positions, 3 causal pairs), prefill cross, step self
    # over 3 then 4 keys, step cross twice, capture self (3 tokens, 6
    # pairs) and cross with its float32 scores
    flops = 96 + 320 + 96 + 128 + 160 + 160 + 192 + 480
    nbytes = 128 + 224 + 128 + 160 + 192 + 192 + 192 + (256 + 120)
    assert (w.flops, w.bytes) == (flops, nbytes)


def test_rows_linear_by_hand():
    w = costs.rows_linear(DIMS, BATCH)

    def layer(m):  # six d x d (one without bias), fc1, fc2 over m rows
        return 1792 * m, 352 * m + 1952
    kv = (640 + 640, 288 + 304)
    parts = [kv, layer(2), layer(1), layer(1), layer(3), (480, 648)]
    assert (w.flops, w.bytes) == (sum(p[0] for p in parts),
                                  sum(p[1] for p in parts))


def test_encoder_attn_by_hand():
    w = costs.encoder_attn(DIMS, BATCH)
    assert (w.flops, w.bytes) == (800, 320)


def test_roofline_takes_the_larger_bound():
    w = costs.Work(flops=989e12, bytes=3.35e12 * 2)
    peak = costs.peaks("NVIDIA H100 80GB HBM3")
    assert w.seconds(peak) == pytest.approx(2.0)
    assert costs.peaks("some other card") is None


def test_model_flops_are_the_ports_count_over_live_rows_and_steps_run():
    from whisper_char_alignment_tpu_torch.config import ModelDims
    from whisper_char_alignment_tpu_torch.utils import flops

    pd = ModelDims(n_mels=4, n_audio_ctx=5, n_audio_state=8, n_audio_head=2,
                   n_audio_layer=1, n_vocab=10, n_text_ctx=16,
                   n_text_state=8, n_text_head=2, n_text_layer=1)
    per = (flops.mel_flops(pd) + flops.encoder_flops(pd)
           + flops.decode_flops(pd, prompt_len=3, steps=2)
           + flops.capture_flops(pd, t_tokens=4))
    assert costs.model_flops(DIMS, [BATCH], 3) == per
    three = costs.Batch(rows=3, token_lens=[3, 3, 3], t_bucket=4,
                        sample_begin=3, steps=2)
    assert costs.model_flops(DIMS, [three], 3) == 3 * per


def test_dtw_cost_and_path_match_the_published_recurrence():
    rng = np.random.default_rng(0)
    x = rng.random((5, 9))
    cost, tr = ref.dtw(torch.from_numpy(-x)[None], [5], [9], trace=True)
    # the published recurrence, cell by cell
    c = np.full((6, 10), np.inf)
    c[0, 0] = 0
    for j in range(1, 10):
        for i in range(1, 6):
            c0, c1, c2 = c[i - 1, j - 1], c[i - 1, j], c[i, j - 1]
            best = (c0 if c0 < c1 and c0 < c2 else
                    c1 if c1 < c0 and c1 < c2 else c2)
            c[i, j] = -x[i - 1, j - 1] + best
    assert float(cost[0]) == pytest.approx(c[5, 9])
    first = ref.first_visits(tr[0].numpy(), 5, 9)
    assert first[0] == 0 and np.all(np.diff(first) >= 0)


def test_dtw_through_its_own_boundaries_costs_nothing_more():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(-rng.random((1, 6, 20)))
    best, tr = ref.dtw(x, [6], [20], trace=True)
    first = ref.first_visits(tr[0].numpy(), 6, 20)
    big, enter = x.clone(), torch.ones(x.shape, dtype=torch.bool)
    for row, col in enumerate(first):
        big[0, row, :col] = float("inf")
        enter[0, row, col + 1:] = False
    held = ref.dtw(big, [6], [20], enter_ok=enter)
    assert float(held[0]) == pytest.approx(float(best[0]))
    enter[0, 3, :] = False
    enter[0, 3, first[3] + 2] = True  # another first visit of row 3
    big[0, 3, :first[3] + 2] = float("inf")
    assert float(ref.dtw(big, [6], [20], enter_ok=enter)[0]) > float(best[0])


SPEC = {"timestamp_begin": 6, "eot": 3, "no_timestamps": 5, "suppress": [4],
        "blank": [0, 3], "max_initial_timestamp_index": 2}


def test_logit_rules_and_gaps():
    step = [5.0, 1.0, 0.0, 0.0, 9.0, 9.0, 0.5, 0.4, 3.0, 0.1]
    logits = torch.tensor([step] * 4)
    seq = [8, 1, 9, 1]
    # step 0: a timestamp of at most ts_begin + 2 (8 is the pick); step 1
    # after it: no timestamp, so text or eot (0 the pick); step 2: stamps
    # from 9 up, text allowed (0 the pick); step 3, a stamp after text:
    # eot or a stamp from 9, whose mass rules the text out (9 the pick)
    assert ref.picks(logits, seq, SPEC).tolist() == [8, 0, 0, 9]
    g = ref.gaps(logits, seq, torch.tensor(seq), SPEC)
    assert g[0] == 0 and g[1] == 4.0
    assert g[2] == pytest.approx(4.9)  # 9 needs 0.1 raised past 5.0
    assert g[3] == float("inf")  # text is ruled out there
    wrong = ref.gaps(logits, seq, torch.tensor([7, 0, 0, 9]), SPEC)
    assert wrong.tolist()[1:] == [0.0, 0.0, 0.0]
    assert wrong[0] == pytest.approx(3.0 - 0.4)


@pytest.fixture
def tiny(tmp_path):
    return make_root(tmp_path)


def test_the_float8_control_is_not_correct_on_the_tiny_cell(tiny):
    out = harness.run(tiny, "tiny.timit_b4", 2, 0.0, False, device="cpu",
                      side="control")
    program = {k: out["checks"][k]["value"] for k in judge.NAMES}
    assert all(program[k] <= TINY_LIMITS[k] for k in judge.NAMES)
    failed = [k for k in judge.NAMES
              if out["control"][k] > TINY_LIMITS[k]
              and out["control"][k] >= 3 * program[k]]
    assert failed, (program, out["control"])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["medium.timit_b32", "turbo.timit_b32",
                                      "medium.libri_b16"])
def test_the_float8_control_fails_the_cells_limits(workload):
    """At the cell's own sizes, on the card: the program passes its limits
    and the control put in its place fails one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        if workload not in {w["name"] for w in json.load(f)["workloads"]}:
            pytest.skip(f"{workload} is not a cell")
    out = harness.run(REPO, workload, 424242, 0.0, False, side="control")
    assert out["correct"], out["checks"]
    assert any(out["control"][k] > out["checks"][k]["limit"]
               for k in judge.NAMES), out["control"]
