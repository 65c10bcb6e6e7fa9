"""scp-driven datasets: TIMIT and LibriSpeech with ground-truth word alignments.

Copy of ``whisper_char_alignment_tpu/data/dataset.py`` for the PyTorch port, which
imports nothing of the JAX package; only imports changed.

Re-implements the reference's dataset module (reference: dataset.py). Differences by
design: loading is lazy with an optional background prefetch thread instead of the
reference's eager decode-everything-into-RAM ``__init__`` (dataset.py:25-36), labels
are parsed with ``ast.literal_eval`` instead of ``eval`` (fixing the unsafe parse at
dataset.py:87), and the mel spectrogram is NOT computed per item on the host — the
batched runner computes mels on device for whole batches at once.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import queue
import threading
from glob import glob
from typing import Iterator, List, Optional

import numpy as np

from ..audio import wav

SAMPLE_RATE = 16_000


@dataclasses.dataclass
class Utterance:
    audio: np.ndarray  # float32 (samples,)
    duration: int  # samples (pre-padding), drives frame_len = duration // 320
    text: str
    starts: List[float]  # ground-truth word start times (s)
    ends: List[float]  # ground-truth word end times (s)
    fid: str


def _read_scp(scp_file: str) -> List[tuple]:
    entries = []
    with open(scp_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                entries.append((parts[0], parts[1]))
    return entries


class TIMIT:
    """TIMIT via scp: ``<fid> <path/to/x.wav>``; labels in sibling ``x.wrd`` files
    with ``<start_sample> <end_sample> <word>`` lines (reference dataset.py:21-64)."""

    def __init__(self, scp_file: str, n_mels: int = 80, device=None):
        del n_mels, device  # kept for signature parity; mel is computed on device
        self.entries = _read_scp(scp_file)
        self.sample_rate = SAMPLE_RATE

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> Utterance:
        fid, path = self.entries[i]
        audio, sr = wav.load(path)
        assert sr == self.sample_rate, f"{path}: sample rate {sr} != 16000"
        audio = audio.reshape(-1) if audio.shape[0] == 1 else audio.mean(0)
        # rsplit: a directory component containing ".wav" (corpus.wav_16k/...)
        # must not truncate the label path at the FIRST occurrence
        text_file = path.rsplit(".wav", 1)[0] + ".wrd"
        texts, starts, ends = [], [], []
        with open(text_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                starts.append(float(parts[0]) / self.sample_rate)
                ends.append(float(parts[1]) / self.sample_rate)
                texts.append(parts[2])
        return Utterance(audio=audio.astype(np.float32), duration=audio.size,
                         text=" ".join(texts), starts=starts, ends=ends, fid=fid)


class LibriSpeech:
    """LibriSpeech via scp, with Kaldi word alignments from
    ``ls_alignment_{split}.txt`` (reference dataset.py:67-122): each line is
    ``<fid> [("word", start, end), ...]``; empty-word entries are silences."""

    def __init__(self, scp_file: str, n_mels: int = 80, device=None,
                 alignment_file: Optional[str] = None):
        del n_mels, device
        self.entries = _read_scp(scp_file)
        self.sample_rate = SAMPLE_RATE
        first_path = self.entries[0][1]
        split = first_path.split("/")[-4]
        root = first_path.split(split)[0]
        self.label_dict = {}
        for trans in sorted(glob(os.path.join(root, split, "**/*.trans.txt"),
                                 recursive=True)):
            with open(trans) as f:
                for l in f:
                    fid, text = l.split(" ", 1)
                    self.label_dict[fid] = text.strip()
        self.alignment_dict = {}
        alignment_file = alignment_file or f"ls_alignment_{split}.txt"
        with open(alignment_file) as f:
            for line in f:
                fname, payload = line.split(" ", 1)
                # safe parse of the [("word", s, e), ...] literal (the reference
                # used eval(); see SURVEY.md §2a known bugs)
                self.alignment_dict[fname] = ast.literal_eval(payload.strip())

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> Utterance:
        fid, path = self.entries[i]
        audio, sr = wav.load(path)
        assert sr == self.sample_rate
        audio = audio.reshape(-1) if audio.shape[0] == 1 else audio.mean(0)
        ali = self.alignment_dict[fid]
        starts, ends, words = [], [], []
        for item in ali:
            if item[0] == "":
                continue
            words.append(item[0])
            starts.append(float(item[1]))
            ends.append(float(item[2]))
        return Utterance(audio=audio.astype(np.float32), duration=audio.size,
                         text=" ".join(words), starts=starts, ends=ends, fid=fid)


DATASETS = {"TIMIT": TIMIT, "LibriSpeech": LibriSpeech}


def iter_utterances(dataset, prefetch: int = 8,
                    order: Optional[List[int]] = None) -> Iterator[Utterance]:
    """Iterate a dataset with a background prefetch thread (WAV decode + label
    parse overlap with device compute). ``order`` optionally permutes indices."""
    indices = order if order is not None else range(len(dataset))
    if prefetch <= 0:
        for i in indices:
            yield dataset[i]
        return

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = object()
    cancelled = threading.Event()

    def put_unless_cancelled(item) -> bool:
        # a plain q.put would block FOREVER if the consumer abandons the
        # generator with the queue full (break / exception mid-run), pinning
        # the worker thread plus `prefetch` decoded utterances for the life
        # of the process; poll the cancellation flag instead
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        # a worker exception must reach the CONSUMER: swallowing it here
        # silently truncated the dataset and reported metrics over a partial
        # corpus as if the run succeeded (the eager reference crashes instead)
        try:
            for i in indices:
                if not put_unless_cancelled(dataset[i]):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            put_unless_cancelled((stop, e))
        else:
            put_unless_cancelled((stop, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is stop:
                if item[1] is not None:
                    raise item[1]
                break
            yield item
    finally:
        cancelled.set()


def duration_order(dataset) -> Optional[List[int]]:
    """Indices sorted by WAV file size (a decode-free duration proxy).

    Length-sorted batches cut real-weight decode cost: the loop runs until the
    LONGEST transcript in a batch emits eot, so mixing 2 s and 30 s utterances
    makes every short one pay the long one's steps. Metrics are
    order-insensitive; output order changes (hence opt-in via
    --sort_by_duration)."""
    entries = getattr(dataset, "entries", None)
    if not entries:
        return None
    sizes = []
    for i, (_, path) in enumerate(entries):
        try:
            sizes.append((os.path.getsize(path), i))
        except OSError:
            sizes.append((0, i))
    return [i for _, i in sorted(sizes)]


def batch_iter(dataset, batch_size: int, prefetch: int = 8,
               order: Optional[List[int]] = None
               ) -> Iterator[List[Utterance]]:
    """Yield lists of up to ``batch_size`` utterances (optionally reordered)."""
    batch: List[Utterance] = []
    for utt in iter_utterances(dataset, prefetch, order=order):
        batch.append(utt)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
