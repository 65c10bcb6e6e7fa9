"""Errors for the options that the port does not carry yet.

Each names the ``ROADMAP.md`` item that will port it, so an option the port
lacks is refused loudly and never silently ignored.
"""

from __future__ import annotations

ROADMAP_ITEMS = {
    "quantized": "ROADMAP.md queue 1, item 7 (int8 encoder)",
    "parallel": "ROADMAP.md queue 1, item 9 (multi-GPU)",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet: see "
        f"{ROADMAP_ITEMS[item]}")
