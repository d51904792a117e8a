"""Milliseconds of the program's ``wait input`` span inside the compress
calls, per block: the main thread waiting for the next parsed and
uploaded block (the parse, or the upload's host packing, sets the pace)."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "wait input", "compress")
