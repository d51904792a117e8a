"""Published peaks of the card the benchmark runs on.

NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet): 3.35 TB/s of HBM3
bandwidth, at the card's full power limit of 700 W; a run prints the
card's name and limit beside the shares it computes from these."""

#: HBM bytes per second
HBM_BYTES_PER_S = 3.35e12
