"""Percent of the window's compress blocks that went through a full
data-parallel group (``ShardedEncoder.dispatch``'s counter
``grouped_blocks``), the rest being tail groups on the one-card
fallback: the witness that the cards shared the work."""


def read(ctx):
    from scalce_tpu_torch import timing
    counters = getattr(timing, "counters", None)     # absent: no reading
    got = (counters() if counters else {}).get("compress", {}).get(
        "grouped_blocks")
    if got is None or not ctx.blocks["compress"]:
        return None
    return 100.0 * got / ctx.blocks["compress"]
