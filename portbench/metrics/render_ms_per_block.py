"""Milliseconds of the program's ``render FASTQ`` span inside the decompress calls,
per block: the FASTQ render (io/fastq.py), on the decode workers."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "render FASTQ", "decompress")
