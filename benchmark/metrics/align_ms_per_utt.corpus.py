"""Device milliseconds an utterance of head aggregation and DTW (`align/timing.force_align_batch`): the port's
``StageTimers`` stage ``align`` (CUDA events around the stage's
launches) summed over the window, over the utterances aligned. The span
holds the device's idle time inside the stage too."""


def read(ctx):
    seconds = ctx.stage_s.get("align")
    if seconds is None or ctx.utts == 0:
        return None
    return 1000.0 * seconds / ctx.utts
