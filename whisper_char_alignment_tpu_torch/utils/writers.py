"""Transcription result writers: txt / srt / vtt / tsv / json.

A copy of ``whisper_char_alignment_tpu/utils/writers.py`` (jax-free), so
the port's files are byte-equal to the JAX package's for one result dict.
The ``whisper.utils`` writer family for :func:`transcribe` results — the
published output formats users pipe into subtitle tooling. Each writer takes
the transcribe() result dict and a file path (or file object). ``get_writer``
mirrors the published factory (``"all"`` writes every format).

Timestamps: srt uses ``HH:MM:SS,mmm`` (comma), vtt uses ``HH:MM:SS.mmm``
(dot), tsv uses integer milliseconds — the published conventions.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, TextIO, Union


def format_timestamp(seconds: float, always_include_hours: bool = False,
                     decimal_marker: str = ".") -> str:
    """Published format_timestamp: milliseconds rendered exactly."""
    assert seconds >= 0, "non-negative timestamp expected"
    milliseconds = round(seconds * 1000.0)
    hours = milliseconds // 3_600_000
    milliseconds -= hours * 3_600_000
    minutes = milliseconds // 60_000
    milliseconds -= minutes * 60_000
    secs = milliseconds // 1_000
    milliseconds -= secs * 1_000
    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return (f"{hours_marker}{minutes:02d}:{secs:02d}"
            f"{decimal_marker}{milliseconds:03d}")


def _open(file: Union[str, TextIO]):
    if isinstance(file, str):
        return open(file, "w", encoding="utf-8"), True
    return file, False


def write_txt(result: dict, file: Union[str, TextIO]) -> None:
    f, close = _open(file)
    try:
        for segment in result["segments"]:
            print(segment["text"].strip(), file=f, flush=True)
    finally:
        if close:
            f.close()


def write_srt(result: dict, file: Union[str, TextIO]) -> None:
    f, close = _open(file)
    try:
        for i, segment in enumerate(result["segments"], start=1):
            start = format_timestamp(segment["start"],
                                     always_include_hours=True,
                                     decimal_marker=",")
            end = format_timestamp(segment["end"], always_include_hours=True,
                                   decimal_marker=",")
            text = segment["text"].strip().replace("-->", "->")
            print(f"{i}\n{start} --> {end}\n{text}\n", file=f, flush=True)
    finally:
        if close:
            f.close()


def write_vtt(result: dict, file: Union[str, TextIO]) -> None:
    f, close = _open(file)
    try:
        print("WEBVTT\n", file=f)
        for segment in result["segments"]:
            start = format_timestamp(segment["start"])
            end = format_timestamp(segment["end"])
            text = segment["text"].strip().replace("-->", "->")
            print(f"{start} --> {end}\n{text}\n", file=f, flush=True)
    finally:
        if close:
            f.close()


def write_tsv(result: dict, file: Union[str, TextIO]) -> None:
    f, close = _open(file)
    try:
        print("start", "end", "text", sep="\t", file=f)
        for segment in result["segments"]:
            print(round(1000 * segment["start"]),
                  round(1000 * segment["end"]),
                  segment["text"].strip().replace("\t", " "),
                  sep="\t", file=f, flush=True)
    finally:
        if close:
            f.close()


def write_json(result: dict, file: Union[str, TextIO]) -> None:
    f, close = _open(file)
    try:
        json.dump(result, f, ensure_ascii=False)
    finally:
        if close:
            f.close()


_WRITERS = {"txt": write_txt, "srt": write_srt, "vtt": write_vtt,
            "tsv": write_tsv, "json": write_json}


def get_writer(output_format: str,
               output_dir: str) -> Callable[[dict, str], None]:
    """Published factory: returns writer(result, audio_path) that writes
    ``<output_dir>/<audio stem>.<ext>``; ``"all"`` writes every format."""
    os.makedirs(output_dir, exist_ok=True)

    def one(fmt):
        def writer(result: dict, audio_path: str,
                   _fmt=fmt) -> None:
            stem = os.path.splitext(os.path.basename(audio_path))[0]
            _WRITERS[_fmt](result, os.path.join(output_dir,
                                                f"{stem}.{_fmt}"))
        return writer

    if output_format == "all":
        writers = [one(fmt) for fmt in _WRITERS]

        def write_all(result: dict, audio_path: str) -> None:
            for w in writers:
                w(result, audio_path)

        return write_all
    if output_format not in _WRITERS:
        raise ValueError(f"unknown output format: {output_format!r} "
                         f"(choose from {sorted(_WRITERS)} or 'all')")
    return one(output_format)
