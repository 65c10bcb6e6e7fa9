"""Device milliseconds an utterance of the card's idle time during host-only
work: the device seconds between the CUDA events of the port's ``host``
spans on the thread that owns the stream (``utils/profiling.StageTimers``).
Those spans launch nothing and the port issues on one stream, so their
event pairs read the card's idle time on its own clock: all of the span if
the queue had run dry, what was left once it drained, or 0. Summed over
the window, over the utterances aligned. None where the window's snapshot
carries no spans or no device seconds (off a card)."""


def read(ctx):
    spans = getattr(ctx.stage_s, "spans", None)
    if spans is None or ctx.utts == 0:
        return None
    idle = [s.device_s for s in spans.values()
            if s.kind == "host" and s.device_s is not None]
    if not idle:
        return None
    return 1000.0 * sum(idle) / ctx.utts
