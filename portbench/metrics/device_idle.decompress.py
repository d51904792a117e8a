"""Percent of the decompress calls' time in which the card ran
nothing (as ``device_idle.compress``, inside the decompress spans)."""

from portbench import layers


def read(ctx):
    return layers.device_idle(ctx, "decompress")
