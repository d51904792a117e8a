"""Device milliseconds of the program's ``quality decode`` (the
decompress's quality decode on the card: the streams' upload, K4 and
the grids' download), per decompress block:
``timing.counters()["device_us"]`` over the window's decompress
blocks."""


def read(ctx):
    from scalce_tpu_torch import timing
    counters = getattr(timing, "counters", None)     # absent: no reading
    us = (counters() if counters else {}).get("device_us", {}).get(
        "quality decode")
    if not us or not ctx.blocks["decompress"]:
        return None
    return us / 1e3 / ctx.blocks["decompress"]
