"""Milliseconds of the program's ``K4 inputs`` span inside the
decompress calls, per block: the host build of a card-decode group's
K4 inputs (each block's words copied into the group's zero-padded
``[D, N, W]`` array, the states, tables and lengths stacked), on the
decompress main thread before the group's upload."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "K4 inputs", "decompress")
