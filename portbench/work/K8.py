"""K8, pass B's emission compaction (``csrc/compact.cu``): the emitted
words in and the same words out, compacted (the quality stream's bytes
stand for them).  Bytes alone."""

KERNEL = "compact_kernel"
SIDE = "compress"


def bytes_moved(counts, stream_bytes):
    return 2 * stream_bytes["q"]
