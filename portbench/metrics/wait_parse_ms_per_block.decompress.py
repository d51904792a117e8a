"""Milliseconds of the program's ``wait parse`` span inside the
decompress calls, per block: the main thread waiting for the oldest
block's payload parse (``seqs.parse``) on the workers."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "wait parse", "decompress")
