"""Share of the roofline of the encoder's self-attention kernel (`csrc/encoder_attn.cu`), in the traced pass: the least
time of that pass's work (``costs.encoder_attn``, from the shapes its batches ran)
over the device time of the records whose name holds ``encoder_attn``."""

from benchmark import costs

PATTERNS = ("encoder_attn",)


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    seconds = ctx.trace.kernel_s(PATTERNS)
    if seconds <= 0:
        return None
    bound = costs.work("encoder_attn", ctx.dims, ctx.traced_batches).seconds(ctx.peak)
    return 100.0 * bound / seconds
