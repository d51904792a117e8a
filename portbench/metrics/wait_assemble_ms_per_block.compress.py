"""Milliseconds of the program's ``wait assemble`` span inside the
compress calls, per block: the main thread waiting for the oldest
block's host half on the ``-T`` workers (quality encode, payloads)."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "wait assemble", "compress")
