"""Milliseconds of the program's ``seqs.parse`` span inside the decompress calls,
per block: the sequence stream's parse and host delta walk (pipeline/decode.py), on the decode workers."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "seqs.parse", "decompress")
