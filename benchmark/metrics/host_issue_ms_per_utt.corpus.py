"""Host milliseconds an utterance in which the pipeline's main thread queued
device work: the self seconds, on the thread that owns the stream, of the
port's ``issue`` spans (``utils/profiling.StageTimers``: mel, encoder,
decode dispatch and its prefill and replays, capture pack, capture, align,
output copies), summed over the window, over the utterances aligned. None
where the window's snapshot carries no spans."""


def read(ctx):
    spans = getattr(ctx.stage_s, "spans", None)
    if spans is None or ctx.utts == 0:
        return None
    return 1000.0 * sum(s.main_s for s in spans.values()
                        if s.kind == "issue") / ctx.utts
