"""Percent by which the busiest card's device time on the data-parallel
group path exceeds the cards' mean: per card, the device time that
``timing.counters()["device_us_by_card"]`` gives to the stages a full
group queues on every card (:data:`GROUP_STAGES`), then 100 x (largest
/ mean - 1).  0 when every card does the same work in the same time;
the decompress, which runs on one card, and the tail groups, which run
on the first, are left out."""

#: the stages of ``ShardedEncoder``'s full group on each card
GROUP_STAGES = ("upload", "stage A+B", "pass B", "download")


def read(ctx):
    from scalce_tpu_torch import timing
    counters = getattr(timing, "counters", None)     # absent: no reading
    by_card = (counters() if counters else {}).get("device_us_by_card")
    if not by_card:
        return None
    # every card that ran anything in the window, a card that ran none
    # of the group's stages at 0
    busy = [sum(per.get(s, 0.0) for s in GROUP_STAGES)
            for per in by_card.values()]
    if not sum(busy):
        return None
    return 100.0 * (max(busy) / (sum(busy) / len(busy)) - 1.0)
