"""The frozen generator against the program's, byte for byte, and a
mix's files from the seed."""

import pytest

from portbench import manifest
from portbench.gen import synth, traffic
from scalce_tpu_torch.utils import synth as program_synth


@pytest.mark.parametrize("kw", [
    dict(qual_model="hiseq", name_style="sra", rc_rate=0.5, n_rate=0.001,
         genome_len=4_641_652),
    dict(qual_model="illumina", name_style="illumina", mate=2,
         var_len=True),
    dict(qual_model="binned", name_style="plain", genome_len=1000),
    dict(qual_model="uniform", name_style="sra", n_rate=0.0),
    dict(qual_model="const", name_style="illumina", rc_rate=1.0),
])
@pytest.mark.parametrize("n,seed", [(1, 3), (777, 2**40 + 5)])
def test_frozen_copy_matches_the_program(kw, n, seed):
    assert synth.synth_fastq(n, 101, seed=seed, **kw) == \
        program_synth.synth_fastq(n, 101, seed=seed, **kw)


def test_first_index_numbers_the_names():
    a = synth.synth_fastq(3, 20, seed=1, first_index=1000)
    names = a.split(b"\n")[0::4][:3]
    assert names == [b"@SRR000001.1000 1000 length=20",
                     b"@SRR000001.1001 1001 length=20",
                     b"@SRR000001.1002 1002 length=20"]


@pytest.mark.parametrize("paired", [False, True])
def test_files_from_the_seed(paired):
    mix = manifest.load_json(manifest.HERE + "/traffic/bact.json")
    mix = {**mix, "chunk_reads": 300}
    a = traffic.make_files(mix, 2**33 + 1, paired, 1000, workers=3)
    b = traffic.make_files(mix, 2**33 + 1, paired, 1000, workers=1)
    c = traffic.make_files(mix, 2**33 + 2, paired, 1000)
    assert a == b and a != c
    assert len(a) == (2 if paired else 1)
    per_mate = 1000 // len(a)
    for chunks in a:
        data = b"".join(chunks)
        lines = data.split(b"\n")[:-1]
        assert len(lines) == 4 * per_mate
        assert all(len(s) == 101 for s in lines[1::4])
    names = b"".join(a[0]).split(b"\n")[0::4][:-1]
    assert len(set(names)) == per_mate       # numbered across chunks
    if paired:
        n1 = [x.split(b" ")[0] for x in names]
        n2 = [x.split(b" ")[0] for x in b"".join(a[1]).split(b"\n")[0::4][:-1]]
        assert n1 == n2                      # mates share their names


def test_negative_and_huge_seeds():
    mix = {**manifest.load_json(manifest.HERE + "/traffic/human.json"),
           "genome_len": 5000, "chunk_reads": 50}
    assert traffic.make_files(mix, -7, False, 100) != traffic.make_files(
        mix, 2**64 + 9, False, 100)
