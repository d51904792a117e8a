"""Milliseconds of the program's ``wait download`` span inside the
compress calls, per block, summed over threads: waits for a block's
copies from the card (``transfer.Fetched.wait``, and ``Link.download``'s
wait for the oldest download in flight)."""

from portbench import layers


def read(ctx):
    return layers.span_ms_per_block(ctx, "wait download", "compress")
