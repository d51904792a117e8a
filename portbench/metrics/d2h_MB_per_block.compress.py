"""Megabytes (1e6 B) the compress calls copy from the card to the host,
per block: the program's ``d2h_bytes`` counter over the window (every
tensor of every group ``Link.download`` queues)."""


def read(ctx):
    from scalce_tpu_torch import timing
    counters = getattr(timing, "counters", None)     # absent: no reading
    n = (counters() if counters else {}).get("compress", {}).get(
        "d2h_bytes")
    if not n or not ctx.blocks["compress"]:
        return None
    return n / 1e6 / ctx.blocks["compress"]
