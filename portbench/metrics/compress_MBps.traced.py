"""The compress rate of the traced window: FASTQ megabytes (1e6 B) that
every compress call read, over the summed durations of the harness's
spans around those calls (each ends with the cards synchronized), under
the program's profiler."""

from portbench import layers


def read(ctx):
    return layers.rate_MBps(ctx, "compress")
