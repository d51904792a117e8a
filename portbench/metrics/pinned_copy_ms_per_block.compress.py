"""Device milliseconds of copies to or from page-locked host memory
(``transfer.Link``) inside the compress calls, per block."""

from portbench import layers


def read(ctx):
    return layers.pinned_copy_ms_per_block(ctx, "compress")
