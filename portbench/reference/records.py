"""The plain reference: FASTQ records as a multiset.

A decompress need not keep the input's order (the codec reorders reads
by design), so what it must give back is the input's records as a
multiset: every record byte for byte (name, sequence, '+' line,
qualities), each as often as the input holds it, and, for a pair, every
mate-1 record beside its own mate-2 record.  This module imports nothing
but the standard library.
"""

from __future__ import annotations

import collections
from typing import List, Sequence


def lines(data: bytes) -> List[bytes]:
    """A FASTQ file's lines; ValueError unless they are whole four-line
    records."""
    if data and not data.endswith(b"\n"):
        raise ValueError("FASTQ does not end with a newline")
    out = data.split(b"\n")[:-1] if data else []
    if len(out) % 4:
        raise ValueError(f"FASTQ has {len(out)} lines, not a multiple of 4")
    return out


def records(files: Sequence[bytes]) -> List[bytes]:
    """The records of one FASTQ file, or of a pair's two files read in
    lockstep (record i of the first beside record i of the second), each
    as its lines joined by newlines.  ValueError when a file is not
    whole records or a pair's files differ in length."""
    cols = []
    for data in files:
        ls = lines(data)
        cols += [ls[0::4], ls[1::4], ls[2::4], ls[3::4]]
    if len({len(c) for c in cols}) > 1:
        raise ValueError("mate files hold different numbers of records")
    return list(map(b"\n".join, zip(*cols)))


def mismatched(want: List[bytes], got: List[bytes]) -> int:
    """Records of ``want`` missing from ``got`` plus records of ``got``
    that ``want`` lacks, counted as multisets (0: the same records, as
    often each)."""
    if sorted(want) == sorted(got):
        return 0
    a, b = collections.Counter(want), collections.Counter(got)
    return sum((a - b).values()) + sum((b - a).values())
