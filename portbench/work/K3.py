"""K3, the quality rANS encode (``csrc/rans_encode.cu``): every quality
symbol in, one byte each, and the emitted words out, which are the
quality stream's rANS bytes (the stream's bytes, tables included, stand
for them).  Bytes alone."""

KERNEL = "rans_encode_kernel"
SIDE = "compress"


def bytes_moved(counts, stream_bytes):
    return counts["qual_symbols"] + stream_bytes["q"]
