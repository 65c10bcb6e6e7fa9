"""Device milliseconds an utterance of the encoder (`models/whisper.encode_audio`): the port's
``StageTimers`` stage ``encoder`` (CUDA events around the stage's
launches) summed over the window, over the utterances aligned. The span
holds the device's idle time inside the stage too."""


def read(ctx):
    seconds = ctx.stage_s.get("encoder")
    if seconds is None or ctx.utts == 0:
        return None
    return 1000.0 * seconds / ctx.utts
