"""Milliseconds of the program's ``quality encode (host)`` span inside the compress calls,
per block: the host quality codec's encode (streams/qualities_host.py), on the assembly workers."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "quality encode (host)", "compress")
