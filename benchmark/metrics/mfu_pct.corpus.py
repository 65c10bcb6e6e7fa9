"""The whole step's share of the card's bf16 peak: the model FLOPs of the
work the window completed (``costs.model_flops``: live utterances, decode
steps actually run) over the window's wall time and the published peak."""

from benchmark import costs


def read(ctx):
    if ctx.peak is None or ctx.wall_s <= 0:
        return None
    flops = costs.model_flops(ctx.dims, ctx.window_batches, ctx.prompt_len)
    return 100.0 * flops / ctx.wall_s / ctx.peak["flops"]
