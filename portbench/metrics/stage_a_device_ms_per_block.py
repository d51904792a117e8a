"""Device milliseconds of the program's ``stage A``, per compress block:
the card's kernels, copies and memsets that the stage's spans queued
(``timing.counters()["device_us"]``, the profiler's own events given to
the innermost stage around each launch), over the window."""


def read(ctx):
    from scalce_tpu_torch import timing
    counters = getattr(timing, "counters", None)     # absent: no reading
    us = (counters() if counters else {}).get("device_us", {}).get(
        "stage A")
    if not us or not ctx.blocks["compress"]:
        return None
    return us / 1e3 / ctx.blocks["compress"]
