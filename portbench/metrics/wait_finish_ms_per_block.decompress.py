"""Milliseconds of the program's ``wait finish`` span inside the
decompress calls, per block: the main thread waiting for the oldest
group's finish and render (quality decode, ``_finish``, render FASTQ)
on the workers."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "wait finish", "decompress")
