"""The plain reference: records, pairs, the multiset comparison."""

import pytest

from portbench.reference import records as ref

A = b"@r1\nACGT\n+\nIIII\n"
B = b"@r2\nGGTT\n+\n#I#I\n"
C = b"@r3\nNNAC\n+\n!!!!\n"


def test_records_and_multiset():
    want = ref.records([A + B + C])
    assert want == [A[:-1], B[:-1], C[:-1]]
    assert ref.mismatched(want, ref.records([C + A + B])) == 0
    assert ref.mismatched(want, ref.records([A + B])) == 1
    assert ref.mismatched(want, ref.records([A + B + C + C])) == 1
    assert ref.mismatched(want, ref.records([A + B + C.replace(
        b"NNAC", b"NNAA")])) == 2
    assert ref.mismatched(ref.records([A + A]), ref.records([A + B])) == 2


def test_pairs_stay_pairs():
    want = ref.records([A + B, C + A])
    assert ref.mismatched(want, ref.records([B + A, A + C])) == 0
    # the same records on each side, paired otherwise
    assert ref.mismatched(want, ref.records([A + B, A + C])) == 4


@pytest.mark.parametrize("files", [[A[:-1]], [A + b"@x\n"],
                                   [A + B, A]])
def test_not_records(files):
    with pytest.raises(ValueError):
        ref.records(files)


def test_empty():
    assert ref.records([b""]) == []
    assert ref.mismatched([], ref.records([b""])) == 0
