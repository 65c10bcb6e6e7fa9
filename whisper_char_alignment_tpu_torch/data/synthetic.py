"""Synthetic TIMIT-style corpus generation (shared by tests and bench.py).

Copy of ``whisper_char_alignment_tpu/data/synthetic.py`` for the PyTorch port, which
imports nothing of the JAX package; only imports changed.

No real speech assets exist in this image, so end-to-end plumbing (scp parsing,
WAV decode, batching, alignment bookkeeping, eval) is exercised on generated
sine+noise utterances with evenly spaced ground-truth word boundaries, in the
reference's TIMIT on-disk layout: ``<fid> <wav path>`` scp lines plus sibling
``.wrd`` files with ``<start_sample> <end_sample> <word>`` rows
(reference dataset.py:21-64).
"""

from __future__ import annotations

import os

import numpy as np

from ..audio import wav

_WORD_POOL = ["she", "had", "your", "dark", "suit", "in", "greasy", "wash",
              "water", "all", "year", "artificial", "intelligence", "is",
              "for", "real"]


def make_timit_corpus(root: str, n_utts: int = 5, seconds=1.0,
                      words_per_utt=(3, 5), sample_rate: int = 16000,
                      seed: int = 0) -> str:
    """Write a synthetic TIMIT corpus under ``root``; returns the scp path.

    ``seconds`` may be a float (fixed duration) or a (lo, hi) range sampled per
    utterance. ``words_per_utt`` is an inclusive (lo, hi) range.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    scp_lines = []
    for i in range(n_utts):
        if isinstance(seconds, (tuple, list)):
            dur = float(rng.uniform(seconds[0], seconds[1]))
        else:
            dur = float(seconds)
        n = int(sample_rate * dur)
        audio = (0.2 * np.sin(2 * np.pi * (200 + 50 * (i % 16))
                              * np.arange(n) / sample_rate)
                 + rng.normal(0, 0.01, n)).astype(np.float32)
        path = os.path.join(root, f"utt{i}.wav")
        wav.save(path, audio, sample_rate)
        n_words = int(rng.integers(words_per_utt[0], words_per_utt[1] + 1))
        bounds = np.linspace(0, n, n_words + 1).astype(int)
        with open(os.path.join(root, f"utt{i}.wrd"), "w") as f:
            for w in range(n_words):
                word = _WORD_POOL[(i + w) % len(_WORD_POOL)]
                f.write(f"{bounds[w]} {bounds[w + 1]} {word}\n")
        scp_lines.append(f"dr1-utt{i} {path}")
    scp = os.path.join(root, "test.scp")
    with open(scp, "w") as f:
        f.write("\n".join(scp_lines) + "\n")
    return scp


def make_librispeech_corpus(root: str, n_utts: int = 4, seconds=2.0,
                            words_per_utt=(3, 5), sample_rate: int = 16000,
                            seed: int = 0):
    """Write a synthetic LibriSpeech corpus under ``root``; returns
    ``(scp_path, alignment_path)``.

    On-disk layout matches what ``data.dataset.LibriSpeech`` (and the
    reference's parser, reference dataset.py:67-122) discovers from the scp
    paths: ``<root>/<split>/<speaker>/<chapter>/<fid>.wav`` with a sibling
    ``<speaker>-<chapter>.trans.txt``, plus a Kaldi-style alignment file whose
    lines are ``<fid> [("word", start, end), ...]`` — including empty-word
    silence entries, which the loader must skip.
    """
    rng = np.random.default_rng(seed)
    split = "test-clean"
    scp_lines, ali_lines = [], []
    trans: dict = {}
    for i in range(n_utts):
        speaker, chapter = "1", str(100 + i)
        d = os.path.join(root, split, speaker, chapter)
        os.makedirs(d, exist_ok=True)
        if isinstance(seconds, (tuple, list)):
            dur = float(rng.uniform(seconds[0], seconds[1]))
        else:
            dur = float(seconds)
        n = int(sample_rate * dur)
        audio = (0.2 * np.sin(2 * np.pi * (180 + 40 * (i % 16))
                              * np.arange(n) / sample_rate)
                 + rng.normal(0, 0.01, n)).astype(np.float32)
        fid = f"{speaker}-{chapter}-{i:04d}"
        path = os.path.join(d, fid + ".wav")
        wav.save(path, audio, sample_rate)
        n_words = int(rng.integers(words_per_utt[0], words_per_utt[1] + 1))
        bounds = np.linspace(0.0, dur, n_words + 1)
        words = [_WORD_POOL[(i + w) % len(_WORD_POOL)] for w in range(n_words)]
        entries = [(w, round(float(bounds[k]), 3), round(float(bounds[k + 1]), 3))
                   for k, w in enumerate(words)]
        # a mid-list silence entry: the loader must drop empty-word rows
        entries.insert(1, ("", entries[0][2], entries[0][2]))
        ali_lines.append(f"{fid} {entries!r}")
        trans.setdefault((speaker, chapter), []).append(
            f"{fid} {' '.join(words).upper()}")
        scp_lines.append(f"{fid} {path}")
    for (speaker, chapter), lines in trans.items():
        tpath = os.path.join(root, split, speaker, chapter,
                             f"{speaker}-{chapter}.trans.txt")
        with open(tpath, "w") as f:
            f.write("\n".join(lines) + "\n")
    scp = os.path.join(root, "librispeech.scp")
    with open(scp, "w") as f:
        f.write("\n".join(scp_lines) + "\n")
    ali = os.path.join(root, f"ls_alignment_{split}.txt")
    with open(ali, "w") as f:
        f.write("\n".join(ali_lines) + "\n")
    return scp, ali
