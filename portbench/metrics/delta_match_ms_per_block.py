"""Milliseconds of the program's ``delta match`` span inside the compress
calls, per block: the native predecessor match over the rebuilt rows
(``delta_match_runs`` for mate 1, ``delta_match`` for a later mate), the
second half of the ``host delta`` span on the assembly workers."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "delta match", "compress")
