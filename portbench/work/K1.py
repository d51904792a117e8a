"""K1, the core rank (``csrc/core_rank.cu``): per read, the k-mer window
of least rank on either strand.  The least bytes any implementation
moves: every base in, at 2 bits (the four letters; the rare N is left
out, so this stays below), and per read the chosen core's 4-byte rank
out.  Bytes alone: no operation count is a lower bound that every
ranking must reach."""

KERNEL = "core_rank_kernel"
SIDE = "compress"


def bytes_moved(counts, stream_bytes):
    return counts["bases"] / 4 + 4 * counts["reads"]
