"""Share of the roofline of the decoder attention kernels (`csrc/dec_attn.cu`: `dec_attn_one`, `dec_attn_qk`, `dec_attn_pv`), in the traced pass: the least
time of that pass's work (``costs.dec_attn``, from the shapes its batches ran)
over the device time of the records whose name holds ``dec_attn``."""

from benchmark import costs

PATTERNS = ("dec_attn",)


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    seconds = ctx.trace.kernel_s(PATTERNS)
    if seconds <= 0:
        return None
    bound = costs.work("dec_attn", ctx.dims, ctx.traced_batches).seconds(ctx.peak)
    return 100.0 * bound / seconds
