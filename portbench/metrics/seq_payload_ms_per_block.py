"""Milliseconds of the program's ``seqs.payload`` span inside the compress calls,
per block: the sequence stream's payload (streams/seqs.py), on the assembly workers."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "seqs.payload", "compress")
