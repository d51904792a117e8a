"""The quality stream's bits per quality symbol:
``RunStats.stream_bytes["q"]`` of a compress, times 8, over the input's
quality symbols."""

from portbench import layers


def read(ctx):
    return layers.bits_per(ctx, "q", "qual_symbols")
