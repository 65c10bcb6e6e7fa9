"""Attention-matrix visualization.

Copy of ``whisper_char_alignment_tpu/viz/plot.py`` (NumPy and matplotlib,
imported when a figure is drawn). Renders the aggregated token x frame
alignment matrix with boundary overlays and saves ``{path}/{fid}.png``. The
style constants below pin pixel parity with the reference's published example
image (reference: plot.py:22-59, imgs/test.png): change them and the golden
image changes.
"""

from __future__ import annotations

import os

import numpy as np

from ..text.retokenize import split_tokens_on_spaces

#: seconds of audio per attention frame (2 * HOP_LENGTH / SAMPLE_RATE = 20 ms)
SECONDS_PER_FRAME = 0.02

#: pixel-parity style table — these values reproduce the reference's figure
#: (figsize/linewidths/colors/label text/dpi are part of the pinned output)
STYLE = {
    "figsize": (8, 3.5),
    "gt_line": dict(linewidth=2, color="white"),
    "pred_line": dict(linewidth=3, ls="dotted"),  # color depends on unit type
    "pred_color": {"subword": "cyan", "char": "red"},
    "word_rule": dict(linewidth=1.5, color="gray", ls="--"),
    "ytick_fontsize": 9,
    "xlabel": r"${time} (\rightarrow)$",
    "xlabel_fontsize": 18,
    "dpi": 400,
}


def _to_frame(seconds: float) -> int:
    return int(seconds / SECONDS_PER_FRAME)


def _overlay_boundaries(ax, gt_alignment, pred_alignment, unit_type) -> None:
    """Vertical rules: solid white at GT word ends, dotted colored at
    predictions (cyan for subword units, red for char units)."""
    if gt_alignment is not None:
        for end in gt_alignment:
            ax.axvline(_to_frame(end), **STYLE["gt_line"])
    pred_color = STYLE["pred_color"].get(unit_type, "red")
    for end in pred_alignment:
        ax.axvline(_to_frame(end), color=pred_color, **STYLE["pred_line"])


def _label_token_axis(ax, matrix, text_tokens, tokenizer, unit_type) -> None:
    """Horizontal rules between word groups + one decoded label per token row.

    The y axis is drawn bottom-up: ticks are emitted in descending row order and
    labels reversed to match (same convention as the reference figure)."""
    _, word_tokens = split_tokens_on_spaces(
        list(text_tokens) + [tokenizer.eot], tokenizer, unit_type)
    group_edges = np.cumsum([len(g) for g in word_tokens[:-1]])
    for edge in group_edges:
        ax.axhline(edge - 0.5, **STYLE["word_rule"])

    n_rows = len(matrix)
    ax.set_yticks(np.arange(n_rows - 1, -1, -1))
    row_labels = [tokenizer.decode([t]) for t in text_tokens] + [""]
    ax.set_yticklabels(row_labels[::-1], fontsize=STYLE["ytick_fontsize"])
    ax.set_xticks([])


def plot_attn(weights, text_tokens, tokenizer, gt_alignment, pred_alignment,
              fid, aligned_unit_type, path, dpi=None):
    """Save the alignment matrix figure for one utterance; returns the path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(path, exist_ok=True)
    matrix = np.asarray(weights)

    fig, ax = plt.subplots(figsize=STYLE["figsize"])
    ax.imshow(matrix, aspect="auto")
    _overlay_boundaries(ax, gt_alignment, pred_alignment, aligned_unit_type)
    _label_token_axis(ax, matrix, text_tokens, tokenizer, aligned_unit_type)
    plt.xlabel(STYLE["xlabel"], fontsize=STYLE["xlabel_fontsize"])
    plt.tight_layout()

    out_path = os.path.join(path, f"{fid}.png")
    plt.savefig(out_path, bbox_inches="tight", dpi=dpi or STYLE["dpi"])
    plt.close(fig)
    return out_path
