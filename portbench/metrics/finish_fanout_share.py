"""Finish tasks per hundred finished blocks in the decompress calls: the
program's counters ``finish_tasks`` (one for each finish and render
task the decode pipeline submits) over ``finish_blocks`` (the blocks
those tasks finish, every mate's).  100 when each block is a task of
its own; 25 when a group of four blocks shares one."""


def read(ctx):
    from scalce_tpu_torch import timing
    counters = getattr(timing, "counters", None)     # absent: no reading
    got = (counters() if counters else {}).get("decompress", {})
    tasks, blocks = got.get("finish_tasks"), got.get("finish_blocks")
    if tasks is None or not blocks:
        return None
    return 100.0 * tasks / blocks
