"""Share of the roofline of the decoder's row-invariant linears (`csrc/rows_linear.cu`), in the traced pass: the least
time of that pass's work (``costs.rows_linear``, from the shapes its batches ran)
over the device time of the records whose name holds ``rows_linear``."""

from benchmark import costs

PATTERNS = ("rows_linear",)


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    seconds = ctx.trace.kernel_s(PATTERNS)
    if seconds <= 0:
        return None
    bound = costs.work("rows_linear", ctx.dims, ctx.traced_batches).seconds(ctx.peak)
    return 100.0 * bound / seconds
