"""Mate blocks whose delta the host matched per hundred of the window's
compress blocks: the program's counter ``host_delta_blocks`` (one a mate
block, in the host delta and host core assembly) over the blocks.  100
when every single-end block took the host match; None when none did
(the counter is then absent, as in a program that does not keep it); a
pair's two mates count twice against one block."""


def read(ctx):
    from scalce_tpu_torch import timing
    counters = getattr(timing, "counters", None)     # absent: no reading
    got = (counters() if counters else {}).get("compress", {}).get(
        "host_delta_blocks")
    if got is None or not ctx.blocks["compress"]:
        return None
    return 100.0 * got / ctx.blocks["compress"]
