"""Device milliseconds of the program's ``pass B`` (on the data-parallel
path, each card's group quality encode: K5 and K8 after it), per
compress block: ``timing.counters()["device_us"]``, summed over the
cards, over the window's compress blocks."""


def read(ctx):
    from scalce_tpu_torch import timing
    counters = getattr(timing, "counters", None)     # absent: no reading
    us = (counters() if counters else {}).get("device_us", {}).get(
        "pass B")
    if not us or not ctx.blocks["compress"]:
        return None
    return us / 1e3 / ctx.blocks["compress"]
