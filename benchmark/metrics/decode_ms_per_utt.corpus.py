"""Device milliseconds an utterance of the greedy decode (`models/decoding.decode`, its CUDA graphs): the port's
``StageTimers`` stage ``decode dispatch`` (CUDA events around the stage's
launches) summed over the window, over the utterances aligned. The span
holds the device's idle time inside the stage too."""


def read(ctx):
    seconds = ctx.stage_s.get("decode dispatch")
    if seconds is None or ctx.utts == 0:
        return None
    return 1000.0 * seconds / ctx.utts
