"""Milliseconds of the program's ``host delta`` span inside the compress calls,
per block: the host delta match (pipeline/encode.py, native), on the assembly workers."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "host delta", "compress")
