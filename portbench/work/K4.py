"""K4, the quality rANS decode (``csrc/rans_decode.cu``): the emitted
words in (the quality stream's bytes) and every quality symbol out, one
byte each.  Bytes alone."""

KERNEL = "rans_decode_kernel"
SIDE = "decompress"


def bytes_moved(counts, stream_bytes):
    return stream_bytes["q"] + counts["qual_symbols"]
