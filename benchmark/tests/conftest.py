"""A tiny cell of the benchmark, added from new files alone, for the CPU.

``tiny_root`` builds a checkout-like folder: ``BENCHMARK.json`` with one cell
``tiny.timit_b4`` whose configuration, traffic and limits are new files, and
the benchmark's own metric readers beside them. The harness's code is the
repository's.
"""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_CONFIG = {
    "name": "whisper-tiny-test", "source": "a test size", "model": "tiny-test",
    "reference": "whisper", "dtype": "float32", "d_model": 32,
    "encoder_layers": 2, "decoder_layers": 2, "encoder_attention_heads": 2,
    "decoder_attention_heads": 2, "num_mel_bins": 80, "vocab_size": 1874,
    "max_source_positions": 64, "max_target_positions": 96}

TINY_TRAFFIC = {
    "name": "tiny_b4", "layout": "TIMIT", "utterances": 8, "batch_size": 4,
    "duration_s": {"median": 0.8, "sigma": 0.3, "min": 0.4, "max": 1.2},
    "words_per_second": 3.0, "words_min": 2, "words_max": 4,
    "word_letters": [3, 2, 4], "decode_sample_len": 6,
    "recipe": {"aggr": "topk", "topk": 3, "aligned_unit_type": "char",
               "medfilt_width": 3, "use_gt_transcript": True,
               "sort_by_duration": True, "pipeline_depth": 2,
               "reuse_cross_kv": True}}

# the tiny cell's limits: on the CPU the port runs its float32 plain
# versions, so every stage reads within float32 rounding of the reference
# (the mel's log near its floor the most, about 4e-5)
TINY_LIMITS = {"mel_err": 1e-3, "enc_err": 1e-5, "decode_gap": 1e-6,
               "head_regret": 1e-6, "dtw_regret": 1e-6}


def make_root(path, config=TINY_CONFIG, traffic=TINY_TRAFFIC,
              limits=TINY_LIMITS, name="tiny.timit_b4"):
    """A checkout-like root at ``path`` with one new cell ``name``."""
    bench_dir = os.path.join(path, "benchmark")
    shutil.copytree(os.path.join(REPO, "benchmark", "metrics"),
                    os.path.join(bench_dir, "metrics"))
    for sub, fname, payload in (
            ("configs", config["name"] + ".json", config),
            ("traffic", traffic["name"] + ".json", traffic),
            ("limits", name + ".json", limits)):
        os.makedirs(os.path.join(bench_dir, sub), exist_ok=True)
        with open(os.path.join(bench_dir, sub, fname), "w") as f:
            json.dump(payload, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{
        "name": config["name"], "source": config["source"],
        "file": f"benchmark/configs/{config['name']}.json", "reduced": [],
        "why": "test"}]
    bench["workloads"] = [{"name": name, "config": config["name"],
                           "traffic": traffic["name"], "chips": 1,
                           "why": "test"}]
    for m in bench["per_layer"]:
        m["workloads"] = [name]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
