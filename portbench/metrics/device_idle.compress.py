"""Percent of the compress calls' time in which the card ran nothing:
the union of its kernels, copies and memsets inside the harness's compress
spans, over those spans, averaged over the cards that ran any."""

from portbench import layers


def read(ctx):
    return layers.device_idle(ctx, "compress")
