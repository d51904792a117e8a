"""K4's share of its roofline: the bytes its work needs
(``work/K4.py``) at the card's HBM bandwidth, over its device time."""

from portbench import layers


def read(ctx):
    return layers.roofline(ctx, "K4")
