"""Megabytes (1e6 B) the compress calls copy from the host to the card,
per block: the program's ``h2d_bytes`` counter over the window (what
``Link.upload`` hands over, at the widths the arrays cross in)."""


def read(ctx):
    from scalce_tpu_torch import timing
    counters = getattr(timing, "counters", None)     # absent: no reading
    n = (counters() if counters else {}).get("compress", {}).get(
        "h2d_bytes")
    if not n or not ctx.blocks["compress"]:
        return None
    return n / 1e6 / ctx.blocks["compress"]
