"""The sequence stream's bits per base: ``RunStats.stream_bytes["r"]``
of a compress, times 8, over the input's bases."""

from portbench import layers


def read(ctx):
    return layers.bits_per(ctx, "r", "bases")
