"""Device milliseconds of the program's ``stage A+B`` (the data-parallel
group's stage 1 on every card: K1, the sort, K7, K2's grids and K6),
per compress block: ``timing.counters()["device_us"]``, the profiler's
own events given to the innermost stage around each launch, summed over
the cards, over the window's compress blocks."""


def read(ctx):
    from scalce_tpu_torch import timing
    counters = getattr(timing, "counters", None)     # absent: no reading
    us = (counters() if counters else {}).get("device_us", {}).get(
        "stage A+B")
    if not us or not ctx.blocks["compress"]:
        return None
    return us / 1e3 / ctx.blocks["compress"]
