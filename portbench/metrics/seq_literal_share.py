"""Percent of the compressed bases that the sequence delta leaves as
literals: the program's ``literals`` counter (each block's ``n_lits`` as
it reaches the host) over the window's compress calls' bases."""


def read(ctx):
    from scalce_tpu_torch import timing
    counters = getattr(timing, "counters", None)     # absent: no reading
    n = (counters() if counters else {}).get("compress", {}).get("literals")
    bases = ctx.counts.get("bases", 0) * ctx.calls["compress"]
    if n is None or not bases:
        return None
    return 100.0 * n / bases
