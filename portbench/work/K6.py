"""K6, the data-parallel group's context histogram
(``csrc/histogram.cu``): every quality symbol's context in, counted at
one byte a symbol; the histogram out is left out.  Bytes alone."""

KERNEL = "histogram_kernel"
SIDE = "compress"


def bytes_moved(counts, stream_bytes):
    return counts["qual_symbols"]
