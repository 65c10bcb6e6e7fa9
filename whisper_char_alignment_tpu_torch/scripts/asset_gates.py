"""The asset-arrival runbook of the port: one command that fires every
quality gate that needs real assets, the day they exist, and writes the
accuracy scoreboard as one JSON artifact (port of the repository's
``scripts/asset_gates.py``).

    export WCA_CHECKPOINT=/path/to/medium.pt        # or .npz/.safetensors
    export WCA_TOKENIZER_DIR=/path/with/multilingual.tiktoken
    python -m whisper_char_alignment_tpu_torch.scripts.asset_gates \\
        [--timit_scp /path/to/timit_test.scp] [--librispeech_scp ...] \\
        [--librispeech_alignments ...] [--reference_repo /path/to/ref] \\
        [--artifact asset_gates_results.json]

Every gate runs the port in a child process, on the card unless
``WCA_PLATFORM=cpu`` (the children read it). Gates, in BASELINE.json config
order (each prints PASS/FAIL; the exit code is the number of failures;
gates whose inputs are absent are skipped loudly):

1. **Golden sample** (config #1): ``pytest tests/test_torch_golden.py``, the
   README-pinned word boundaries of sample/test.wav (reference
   README.md:134-140). ``--noconftest``: the port's test needs none of the
   JAX suite's set-up, and the card's machine has no JAX.
2. **TIMIT F1@50ms, recommended recipe** (config #2, needs --timit_scp):
   ``cli.infer_ali`` with char units, topk=10, medfilt 3, strict, tolerance
   0.05, ``--save_prediction``; 2b re-scores its pkl with ``cli.eval_ali``
   at 0.1 s.
3. **TIMIT subword/mean recipe** (config #3, needs --timit_scp).
4. **LibriSpeech vs Kaldi alignments** (config #4, needs --librispeech_scp
   and --librispeech_alignments).
5. **probe_oracle sweep** (config #5, needs --timit_scp): per-head
   alignment eval across all layers and heads, hit_rate + best-head F1.
6. **Default whisper timing baseline** (needs --timit_scp):
   ``--default_whisper_timing`` on the strict protocol.
7. **Boundary parity vs the PyTorch reference** (needs --reference_repo and
   ``openai-whisper``): ``scripts.parity_vs_reference`` fails unless every
   word boundary agrees within one mel frame (20 ms) with zero word
   mismatches.

**Rehearsal** (``--rehearse``): the whole runbook offline, today. A random
checkpoint in the real ``.pt`` format and a ``multilingual.tiktoken``
tokenizer directory (``rehearse_asset_day.make_assets``; the JAX runbook
also writes a safetensors file no gate reads, which the card's machine
could not write), synthetic TIMIT and LibriSpeech corpora in the reference
on-disk layouts, and every gate's real command through the production
``WCA_CHECKPOINT`` / ``WCA_TOKENIZER_DIR`` loader path. Metric values mean
nothing with random weights (the gates align the ground-truth transcript,
so the alignment stage sees multi-word token workloads); the rehearsal
asserts that every command exits 0 and prints a parseable metrics line, so
that on asset day the runbook can fail only on weight values, never on
formats, flags or plumbing. Gate 1 becomes the HF-twin parity rehearsal
(``scripts.rehearse_asset_day``, which needs ``transformers`` and
``safetensors``); gate 7 stays skipped (it needs ``openai-whisper``, the
reference repository and its weights, which an offline rehearsal has not;
gate 1's twin carries the same 20 ms bound).
``--only 2,2b,5`` restricts either mode to the named gates (by leading
token).

Without ``WCA_PLATFORM=cpu`` and without a card it exits non-zero and
prints nothing on stdout, before any gate.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile

from ..bench import platform_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = "whisper_char_alignment_tpu_torch"


def _flush_artifact(results: dict):
    """Write the scoreboard after every gate: the TIMIT gates can run for
    hours, and an operator who kills a seemingly hung runbook must not lose
    the completed gates' results."""
    path = results.get("_artifact")
    if path:
        clean = {k: v for k, v in results.items() if not k.startswith("_")}
        with open(path, "w") as f:
            json.dump(clean, f, indent=2)


def run(name, cmd, results: dict, cwd=None, parse_stdout=False,
        require_metrics=False):
    """Run one gate; record rc (and any metrics dict the CLI printed).
    ``require_metrics`` (rehearsal mode) fails the gate when the command
    exits 0 but its stdout metrics line doesn't parse: the print contract
    is part of the plumbing being rehearsed."""
    only = results.get("_only")
    if only and name.split()[0] not in only:
        results.setdefault("skipped", []).append(f"{name} (--only)")
        return 0
    print(f"\n=== {name} ===\n$ {' '.join(cmd)}", flush=True)
    if parse_stdout:
        # capture stdout only (the metrics line); stderr streams live so the
        # long gates show their progress as they run
        proc = subprocess.run(cmd, cwd=cwd or REPO, text=True,
                              stdout=subprocess.PIPE)
        sys.stdout.write(proc.stdout)
        rc = proc.returncode
        metrics = _parse_metrics(proc.stdout)
        if rc == 0 and require_metrics and metrics is None:
            print("(gate exited 0 but printed no parseable metrics line)")
            rc = 97
    else:
        rc = subprocess.call(cmd, cwd=cwd or REPO)
        metrics = None
    print(f"=== {name}: {'PASS' if rc == 0 else f'FAIL (rc={rc})'} ===",
          flush=True)
    results[name] = {"rc": rc, **({"metrics": metrics} if metrics else {})}
    _flush_artifact(results)
    return rc


def _parse_metrics(stdout: str):
    """The CLIs print their results dict as the last stdout line (repr,
    possibly with np.float64 wrappers); extract the numeric fields. eval_ali
    instead prints the reference's two-decimal 'precision: 0.23' block
    (reference eval_ali.py:48-53), parsed as the fallback."""
    for line in reversed(stdout.strip().splitlines()):
        if line.startswith("{") and ("precision" in line or "hit_rate" in line):
            pairs = re.findall(r"'(\w+)':\s*(?:np\.float64\()?([-0-9.e+]+)",
                               line)
            if pairs:
                return {k: float(v) for k, v in pairs}
    pairs = re.findall(r"^(precision|recall|f1|r value):\s*([-0-9.e+]+)\s*$",
                       stdout, re.MULTILINE)
    if pairs:
        return {k.replace(" ", "_"): float(v) for k, v in pairs}
    return None


def rehearsal_dims():
    """The rehearsal's model. Its contexts fit the probe gate's >=18-word
    utterances (~110 char tokens + specials < n_text_ctx) and the 2.0-3.4 s
    corpus (a 3.84 s window); its heads are 16 wide, the narrowest the
    encoder kernel takes (the JAX runbook's state 32 gives 8)."""
    from ..config import tiny_test_dims
    from .rehearse_asset_day import toy_vocab_size

    return tiny_test_dims(n_vocab=toy_vocab_size(), n_audio_ctx=192,
                          n_text_ctx=192, state=64, head=4, layers=2)


def setup_rehearsal(args) -> str:
    """Generate real-format synthetic assets and corpora and point the
    runbook at them (an offline dress rehearsal of every gate's
    plumbing)."""
    from ..data.synthetic import make_librispeech_corpus, make_timit_corpus
    from .rehearse_asset_day import make_assets

    work = args.rehearse_dir or tempfile.mkdtemp(prefix="wca_asset_gates_")
    os.makedirs(work, exist_ok=True)
    assets = make_assets(work, rehearsal_dims(), seed=args.rehearse_seed,
                         formats=("pt",))
    print(f"rehearsal assets: {assets}", flush=True)
    args.timit_scp = make_timit_corpus(
        os.path.join(work, "timit"), n_utts=args.rehearse_utts,
        seconds=(2.0, 3.4), words_per_utt=(18, 20), seed=0)
    args.librispeech_scp, args.librispeech_alignments = \
        make_librispeech_corpus(os.path.join(work, "librispeech"),
                                n_utts=max(2, args.rehearse_utts // 2),
                                seconds=(2.0, 3.4), words_per_utt=(4, 7),
                                seed=0)
    os.environ["WCA_CHECKPOINT"] = assets["pt"]
    os.environ["WCA_TOKENIZER_DIR"] = assets["tokenizer_dir"]
    # an unknown model name: get_alignment_heads falls back to the last-half
    # layer heads, so gate 6's baseline path works at rehearsal dims
    args.model = "wca-rehearsal"
    args.batch_size = min(args.batch_size, 4)
    return work


def module(name: str) -> list:
    """``python -m`` of one of the port's modules."""
    return [sys.executable, "-m", f"{PACKAGE}.{name}"]


def main(argv=None):
    from .rehearse_asset_day import SEED

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--timit_scp", default=os.environ.get("WCA_TIMIT_SCP"))
    p.add_argument("--librispeech_scp",
                   default=os.environ.get("WCA_LIBRISPEECH_SCP"))
    p.add_argument("--librispeech_alignments",
                   default=os.environ.get("WCA_LIBRISPEECH_ALI"))
    p.add_argument("--reference_repo",
                   default=os.environ.get("WCA_REFERENCE_REPO"))
    p.add_argument("--model", default="medium")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--artifact", default="asset_gates_results.json",
                   help="where the one-file accuracy scoreboard is written")
    p.add_argument("--only", default=None,
                   help="comma-separated gate numbers (e.g. 2,2b,5): run "
                        "only those gates, skip the rest loudly")
    p.add_argument("--rehearse", action="store_true",
                   help="offline dress rehearsal: synthetic real-format "
                        "assets + corpora through every gate's real command")
    p.add_argument("--rehearse_dir", default=None,
                   help="keep rehearsal assets/corpora here (default: tmp)")
    p.add_argument("--rehearse_utts", type=int, default=6)
    # the rehearsal's seed: gate 1's --seed, whose default transcribes to
    # several words (rehearse_asset_day.main; the JAX runbook's 10 does so
    # for its own weights)
    p.add_argument("--rehearse_seed", type=int, default=SEED)
    args = p.parse_args(argv)

    if not args.rehearse:
        if not os.environ.get("WCA_CHECKPOINT"):
            sys.exit("WCA_CHECKPOINT is not set: this runbook needs real "
                     "weights (.pt/.npz/.safetensors); or run --rehearse "
                     "for the offline dress rehearsal")
        if not os.environ.get("WCA_TOKENIZER_DIR"):
            sys.exit("WCA_TOKENIZER_DIR is not set: this runbook needs the "
                     "published tokenizer assets (or run --rehearse)")
    # the children run where WCA_PLATFORM says; without a card, stop here
    platform_device()
    if args.rehearse:
        work = setup_rehearsal(args)
        out_root = os.path.join(work, "asset_gates_out")
    else:
        out_root = os.path.abspath("asset_gates_out")

    results: dict = {"model": args.model, "rehearse": args.rehearse,
                     "skipped": [], "_artifact": args.artifact,
                     "_only": ([s.strip() for s in args.only.split(",")]
                               if args.only else None)}
    os.makedirs(out_root, exist_ok=True)

    def common(gate):
        d = os.path.join(out_root, gate)
        os.makedirs(d, exist_ok=True)
        flags = ["--model", args.model, "--batch_size", str(args.batch_size),
                 "--compute_dtype", "bfloat16", "--output_dir", d]
        if args.rehearse:
            # random weights transcribe to garbage: GT-fed alignment keeps
            # every gate's alignment stage on realistic multi-word token
            # workloads (decode still runs); 8 steps bound the decode
            flags += ["--use_gt_transcript", "--decode_sample_len", "8"]
        return flags

    strict = ["--strict", "--tolerance", "0.05"]
    failures = 0
    rm = args.rehearse  # rehearsal: the metrics print contract is the gate

    if args.rehearse:
        # the golden boundaries need real weights; the rehearsal's stand-in
        # is the HF-twin end-to-end parity run on the same serializers
        failures += run(
            "1 golden-style parity rehearsal (HF twin, real-format assets)",
            module("scripts.rehearse_asset_day")
            + ["--seed", str(args.rehearse_seed)], results) != 0
    else:
        failures += run("1 golden sample boundaries",
                        [sys.executable, "-m", "pytest",
                         "tests/test_torch_golden.py", "-q", "--noconftest"],
                        results) != 0

    def infer(gate, extra):
        return (module("cli.infer_ali")
                + ["--dataset", "TIMIT", "--scp", args.timit_scp,
                   *common(gate), *strict, *extra])

    if args.timit_scp:
        failures += run(
            "2 TIMIT F1@50ms (recommended recipe)",
            infer("2_timit_recipe",
                  ["--aggr", "topk", "--topk", "10", "--aligned_unit_type",
                   "char", "--medfilt_width", "3", "--save_prediction"]),
            results, parse_stdout=True, require_metrics=rm) != 0
        pkls = glob.glob(os.path.join(out_root, "2_timit_recipe",
                                      "*-predictions.pkl"))
        if pkls:
            failures += run(
                "2b eval_ali re-score of gate 2's pkl at 0.1s",
                module("cli.eval_ali")
                + ["--pred", max(pkls, key=os.path.getmtime),
                   "--tolerance", "0.1"],
                results, parse_stdout=True, require_metrics=rm) != 0
        else:
            results["skipped"].append("2b eval_ali (no gate-2 pkl)")
        failures += run(
            "3 TIMIT subword/mean recipe",
            infer("3_subword_mean",
                  ["--aggr", "mean", "--aligned_unit_type", "subword",
                   "--medfilt_width", "7"]),
            results, parse_stdout=True, require_metrics=rm) != 0
        failures += run(
            "5 probe_oracle sweep",
            module("cli.probe_oracle")
            + ["--dataset", "TIMIT", "--scp", args.timit_scp,
               *common("5_probe"), *strict,
               "--aligned_unit_type", "char", "--medfilt_width", "3",
               # rehearsal dims have 8 heads in all; keep the hit_rate
               # non-vacuous by asking for the top-2, not the top-10
               *(["--hit_within", "2"] if args.rehearse else [])],
            results, parse_stdout=True, require_metrics=rm) != 0
        failures += run(
            "6 default whisper timing baseline",
            infer("6_default_timing",
                  ["--default_whisper_timing", "--aligned_unit_type",
                   "subword"]),
            results, parse_stdout=True, require_metrics=rm) != 0
    else:
        results["skipped"] += ["2 TIMIT recipe", "3 subword/mean recipe",
                               "5 probe sweep", "6 default timing"]
        print("\n(skipping TIMIT gates 2/3/5/6: no --timit_scp / "
              "WCA_TIMIT_SCP)")

    if args.librispeech_scp and args.librispeech_alignments:
        failures += run(
            "4 LibriSpeech vs Kaldi alignments",
            module("cli.infer_ali")
            + ["--dataset", "LibriSpeech", "--scp", args.librispeech_scp,
               "--alignment_file", args.librispeech_alignments,
               *common("4_librispeech"), *strict,
               "--aggr", "topk", "--topk", "10",
               "--aligned_unit_type", "char", "--medfilt_width", "3"],
            results, parse_stdout=True, require_metrics=rm) != 0
    else:
        results["skipped"].append("4 LibriSpeech")
        print("\n(skipping LibriSpeech gate: needs --librispeech_scp AND "
              "--librispeech_alignments)")

    if args.reference_repo and not args.rehearse:
        failures += run(
            "7 boundary parity vs PyTorch reference (20 ms bound)",
            module("scripts.parity_vs_reference")
            + ["--scp", args.timit_scp or os.path.join(REPO,
                                                        "sample/test.scp"),
               "--reference_repo", args.reference_repo,
               "--model", args.model], results) != 0
    elif args.rehearse:
        results["skipped"].append("7 reference parity (rehearsal: gate 1's "
                                  "HF twin carries the 20 ms bound offline)")
        print("\n(skipping reference parity in rehearsal: it needs "
              "openai-whisper and the reference's weights; gate 1's HF twin "
              "asserts the same 20 ms boundary bound)")
    else:
        results["skipped"].append("7 reference parity")
        print("\n(skipping reference parity: no --reference_repo / "
              "WCA_REFERENCE_REPO; needs openai-whisper)")

    results["failures"] = failures
    _flush_artifact(results)
    print(f"\nscoreboard -> {args.artifact}")
    print(f"{'ALL GATES PASS' if failures == 0 else f'{failures} GATE(S) FAILED'}")
    sys.exit(failures)


if __name__ == "__main__":
    main()
