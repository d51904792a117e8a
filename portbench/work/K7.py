"""K7, stage B's sequence delta (``csrc/delta_seq.cu``: its match and
literal-placement launches): every base of the sorted reads in, at 2
bits.  The literals and match fields out depend on the program's own
match and are left out, so this stays below.  Bytes alone."""

KERNEL = "delta_seq_"
SIDE = "compress"


def bytes_moved(counts, stream_bytes):
    return counts["bases"] / 4
