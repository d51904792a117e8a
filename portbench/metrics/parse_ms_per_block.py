"""Milliseconds of the program's ``parse FASTQ`` span inside the compress calls,
per block: the FASTQ parse (io/fastq.py), on the parse prefetch thread."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "parse FASTQ", "compress")
