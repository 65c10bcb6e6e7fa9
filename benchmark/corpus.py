"""The one traffic generator: a corpus job of fixed work, written to disk.

A traffic file (``traffic/<name>.json``) gives the corpus's layout (TIMIT or
LibriSpeech), its number of utterances and the distribution of their
durations. The durations are evenly spaced quantiles of a log-normal
distribution cut to ``[min, max]`` seconds, and each utterance's word count
and the letters of each word follow from its duration alone, so the multiset
of (duration, words, characters) is the same for every seed. The seed only
permutes that multiset over the file names and draws the audio (a tone and
noise), the letters and the weights: sorted by duration, every run's batches
have the same shapes.

The files go under a directory the caller gives (the run's ``TMPDIR``), in
the on-disk layout the port's loaders (``data/dataset.py``) read.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import wave
from typing import List

import numpy as np

SAMPLE_RATE = 16_000
LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


@dataclasses.dataclass
class Item:
    """One utterance as written: its id, WAV path, samples and text."""
    fid: str
    path: str
    n_samples: int
    text: str


def durations(traffic: dict) -> np.ndarray:
    """The traffic's durations in seconds, ascending: ``utterances`` evenly
    spaced quantiles ((k + 0.5) / n) of a log-normal with the given median
    and sigma, cut to [min, max]."""
    d = traffic["duration_s"]
    n = int(traffic["utterances"])
    norm = statistics.NormalDist(np.log(d["median"]), d["sigma"])
    lo, hi = norm.cdf(np.log(d["min"])), norm.cdf(np.log(d["max"]))
    qs = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return np.array([np.exp(norm.inv_cdf(q)) for q in qs])


def word_lengths(traffic: dict, seconds: float) -> List[int]:
    """Letters of each word of an utterance of ``seconds``: the word count is
    ``words_per_second`` x seconds, rounded and cut to [words_min,
    words_max]; word k has ``word_letters[k % len]`` letters."""
    n = int(round(traffic["words_per_second"] * seconds))
    n = min(max(n, traffic["words_min"]), traffic["words_max"])
    cycle = traffic["word_letters"]
    return [int(cycle[k % len(cycle)]) for k in range(n)]


def shapes(traffic: dict) -> List[tuple]:
    """(samples, characters) of every utterance, ascending by duration: what
    fixes the work of a pass, whatever the seed."""
    out = []
    for s in durations(traffic):
        lens = word_lengths(traffic, s)
        out.append((int(round(s * SAMPLE_RATE)), sum(lens) + len(lens) - 1))
    return out


def _write_wav(path: str, pcm: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.astype("<i2").tobytes())


def read_wav(path: str) -> np.ndarray:
    """A mono 16-bit WAV's samples as int16."""
    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")


def _audio(rng: np.random.Generator, n: int) -> np.ndarray:
    """int16 PCM: a tone of a drawn pitch with a slow tremolo, and noise."""
    t = np.arange(n) / SAMPLE_RATE
    f0 = rng.uniform(120.0, 400.0)
    trem = 1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(2.0, 6.0) * t)
    x = (0.15 * trem * np.sin(2 * np.pi * f0 * t)
         + rng.normal(0.0, 0.02, n))
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def write(traffic: dict, root: str, seed: int) -> List[Item]:
    """Write the corpus under ``root`` and return its items in file order
    (the seed's permutation of the durations)."""
    rng = np.random.default_rng(seed % 2**63)
    secs = durations(traffic)
    perm = rng.permutation(len(secs))
    layout = traffic["layout"]
    os.makedirs(root, exist_ok=True)
    items = []
    for i, k in enumerate(perm):
        n = int(round(secs[k] * SAMPLE_RATE))
        lens = word_lengths(traffic, secs[k])
        text = " ".join("".join(rng.choice(LETTERS, size=m)) for m in lens)
        if layout == "TIMIT":
            fid = f"dr1-u{i:04d}"
            path = os.path.join(root, f"u{i:04d}.wav")
        elif layout == "LibriSpeech":
            fid = f"1-{100 + i // 64}-{i:04d}"
            d = os.path.join(root, "test-clean", "1", str(100 + i // 64))
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, fid + ".wav")
        else:
            raise ValueError(f"unknown corpus layout {layout!r}")
        _write_wav(path, _audio(rng, n))
        items.append(Item(fid, path, n, text))
    if layout == "TIMIT":
        for it in items:
            words = it.text.split()
            bounds = np.linspace(0, it.n_samples, len(words) + 1).astype(int)
            with open(it.path[:-4] + ".wrd", "w") as f:
                for w, word in enumerate(words):
                    f.write(f"{bounds[w]} {bounds[w + 1]} {word}\n")
    else:
        trans, ali = {}, []
        for it in items:
            words = it.text.split()
            sec = it.n_samples / SAMPLE_RATE
            b = np.linspace(0.0, sec, len(words) + 1)
            entries = [(w, round(float(b[k]), 3), round(float(b[k + 1]), 3))
                       for k, w in enumerate(words)]
            ali.append(f"{it.fid} {entries!r}")
            chapter = os.path.dirname(it.path)
            trans.setdefault(chapter, []).append(
                f"{it.fid} {it.text.upper()}")
        for chapter, lines in trans.items():
            spk, ch = chapter.split(os.sep)[-2:]
            with open(os.path.join(chapter, f"{spk}-{ch}.trans.txt"),
                      "w") as f:
                f.write("\n".join(lines) + "\n")
        with open(alignment_path(root), "w") as f:
            f.write("\n".join(ali) + "\n")
    with open(scp_path(root), "w") as f:
        f.write("".join(f"{it.fid} {it.path}\n" for it in items))
    return items


def scp_path(root: str) -> str:
    return os.path.join(root, "corpus.scp")


def alignment_path(root: str) -> str:
    return os.path.join(root, "ls_alignment_test-clean.txt")
