"""Device milliseconds an utterance of the teacher-forced capture (`whisper.decode_text` with the QK post-process): the port's
``StageTimers`` stage ``capture`` (CUDA events around the stage's
launches) summed over the window, over the utterances aligned. The span
holds the device's idle time inside the stage too."""


def read(ctx):
    seconds = ctx.stage_s.get("capture")
    if seconds is None or ctx.utts == 0:
        return None
    return 1000.0 * seconds / ctx.utts
