"""Milliseconds of the program's ``quality decode (host)`` span inside the
decompress calls, per block, summed over threads: the host quality
decode (``qualities_host.decode_host``) on the workers."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "quality decode (host)",
                                    "decompress")
