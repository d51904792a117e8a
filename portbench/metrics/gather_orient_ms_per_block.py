"""Milliseconds of the program's ``gather orient`` span inside the
compress calls, per block: the host rebuild of a block's sorted,
oriented rows from the parsed reads (native ``gather_orient``), the first
half of the ``host delta`` span on the assembly workers."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "gather orient", "compress")
