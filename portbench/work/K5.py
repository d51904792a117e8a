"""K5, the data-parallel group's quality rANS encode
(``csrc/rans_encode_flat.cu``): as K3, every quality symbol in and the
emitted words out.  Bytes alone."""

KERNEL = "rans_encode_flat_kernel"
SIDE = "compress"


def bytes_moved(counts, stream_bytes):
    return counts["qual_symbols"] + stream_bytes["q"]
