"""Host milliseconds an utterance of host-only work on the pipeline's main
thread: the seconds, on the thread that owns the stream, of the port's
``host`` spans (``utils/profiling.StageTimers``: batch read, wire wait,
retokenize, word times, loop; not the wire prep of its own thread), summed
over the window, over the utterances aligned. None where the window's
snapshot carries no spans."""


def read(ctx):
    spans = getattr(ctx.stage_s, "spans", None)
    if spans is None or ctx.utts == 0:
        return None
    return 1000.0 * sum(s.main_s for s in spans.values()
                        if s.kind == "host") / ctx.utts
