"""K2, the quality contexts and their histogram (``csrc/hist_ctx.cu``):
every quality symbol in, one byte each; the histogram out is a few
kilobytes a block and is left out, so this stays below.  Bytes alone."""

KERNEL = "hist_ctx_kernel"
SIDE = "compress"


def bytes_moved(counts, stream_bytes):
    return counts["qual_symbols"]
