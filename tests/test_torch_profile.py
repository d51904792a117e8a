"""scalce_tpu_torch's stage timing: off it records nothing; on it records
every stage of the compress and decompress paths, and the profile script
accounts for each run's wall clock.  ``--profile DIR`` writes a
torch.profiler trace that names the stages, on every thread that runs
them, and changes no byte of the triplet."""

import glob
import json
import os

import pytest
import torch

from scalce_tpu_torch import cli, stage_profile, timing
from scalce_tpu_torch.utils.synth import synth_fastq

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

COMPRESS_STAGES = {"parse FASTQ", "upload", "stage A", "stage B", "pass B",
                   "quality payload", "download", "seqs.payload",
                   "names payload", "write", "other"}
DECOMPRESS_STAGES = {"seqs.parse", "qualities.parse", "quality decode",
                     "_finish", "render FASTQ", "write", "other"}


def test_stage_records_only_inside_collect():
    with timing.stage("outside"):
        pass
    with timing.collect("cpu") as seconds:
        for _ in range(3):
            with timing.stage("a"):
                pass
        with pytest.raises(ValueError):
            with timing.stage("b"):
                raise ValueError
    with timing.stage("after"):
        pass
    assert set(seconds) == {"a", "b"}
    assert all(s >= 0 for s in seconds.values())


def test_stage_profile_cpu(capsys):
    result = stage_profile.profile("cpu", reads=1500, block_reads=1024)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == result
    bare = COMPRESS_STAGES - {"pass B"} | {"quality encode (host)"}
    compress = {"single": COMPRESS_STAGES,
                "lossy": COMPRESS_STAGES | {"lossy preamble"},
                "paired": COMPRESS_STAGES | {"stage A (mate 2)",
                                             "stage B (mate 2)"},
                "dp": COMPRESS_STAGES - {"stage A", "stage B"}
                | {"stage A+B"},
                "bare": bare,
                "host delta": bare - {"stage B"} | {"host delta"},
                "host core": bare - {"upload", "stage A", "stage B",
                                     "download"} | {"host core",
                                                    "host delta"},
                "delta device": COMPRESS_STAGES}
    decompress = {"delta device": DECOMPRESS_STAGES
                  | {"delta decode (device)"}}
    assert set(result["cases"]) == set(compress)
    assert "dp_functions_ms" not in result       # timed on a card only
    for case, res in result["cases"].items():
        assert res["input_bytes"] > 0 and "profiled" not in res
        for name, want in (("compress", compress[case]),
                           ("decompress", decompress.get(
                               case, DECOMPRESS_STAGES))):
            run = res["staged"][name]
            assert set(run["stages_s"]) == want
            assert all(s >= 0 for k, s in run["stages_s"].items()
                       if k != "other")
            assert sum(run["stages_s"].values()) \
                == pytest.approx(run["wall_s"])
            for run in ("untimed", "untimed_T4", "untimed_Tdef"):
                assert res[run][name]["wall_s"] > 0
                assert res[run][name]["stages_s"] == {}
    assert result["cases"]["paired"]["input_bytes"] \
        > result["cases"]["single"]["input_bytes"]


@pytest.mark.parametrize("lossy,got,ok", [
    (False, b"@a\nACGT\n+\nIIII\n", True),
    (False, b"@a\nACGT\n+\nIIIH\n", False),
    (True, b"@a\nACGT\n+\n5555\n", True),
    (True, b"@a\nACGA\n+\nIIII\n", False),
    (True, b"@a\nACGT\n+\nIII\n", False),
])
def test_profile_checks_the_decompress(lossy, got, ok):
    want = b"@a\nACGT\n+\nIIII\n"
    if ok:
        stage_profile._check(got, want, lossy)
    else:
        with pytest.raises(AssertionError):
            stage_profile._check(got, want, lossy)


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0, 10)], 10e-6),
    ([(0, 10), (5, 20), (30, 40)], 30e-6),
    ([(30, 40), (0, 10), (2, 3)], 20e-6),
])
def test_union_of_device_spans(spans, want):
    assert stage_profile._union_s(spans) == pytest.approx(want)


@pytest.mark.parametrize("name,kind", [
    ("core_rank_kernel(unsigned int const*, ...)", "K1"),
    ("hist_ctx_kernel(unsigned int const*, ...)", "K2"),
    ("rans_encode_kernel(unsigned int const*, ...)", "K3"),
    ("rans_decode_kernel(unsigned int const*, ...)", "K4"),
    ("void (anonymous namespace)::rans_encode_flat_kernel<true>(...)", "K5"),
    ("void (anonymous namespace)::histogram_kernel<true, true>(...)", "K6"),
    ("void (anonymous namespace)::delta_seq_match_kernel<8>(unsigned char "
     "const*, ...)", "K7"),
    ("void (anonymous namespace)::delta_seq_place_kernel<8>(unsigned int "
     "const*, ...)", "K7"),
    ("void (anonymous namespace)::compact_kernel<true>(short const*, ...)",
     "K8"),
    ("Memcpy DtoH (Device -> Pageable)", "pageable copies"),
    ("Memcpy HtoD (Pageable -> Device)", "pageable copies"),
    ("Memcpy HtoD (Pinned -> Device)", "pinned copies"),
    ("Memcpy DtoH (Device -> Pinned)", "pinned copies"),
    ("Memcpy DtoD (Device -> Device)", "other copies"),
    ("Memset (Device)", "other copies"),
    ("void at::native::vectorized_gather_kernel<16, long>(...)",
     "torch kernels"),
])
def test_device_event_kinds(name, kind):
    assert stage_profile._kind(name) == kind


def _spans(trace_dir):
    """{span name: thread ids} of the user spans of the one trace in
    ``trace_dir``."""
    (path,) = glob.glob(os.path.join(trace_dir, "*.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], set()).add(e["tid"])
    return spans


def _triplet(prefix):
    out = {}
    for path in sorted(glob.glob(prefix + ".*.scalce[nrq]")):
        with open(path, "rb") as f:
            out[path[len(prefix):]] = f.read()
    return out


@pytest.mark.parametrize("flags,stages", [
    ([], {"parse FASTQ", "upload", "stage A", "stage B", "download",
          "quality encode (host)", "quality payload", "seqs.payload",
          "names payload", "write"}),
    (["--core-placement", "host"], {"parse FASTQ", "host core",
                                    "host delta", "quality encode (host)",
                                    "seqs.payload", "write"})])
def test_profile_trace_names_the_stages(tmp_path, flags, stages):
    """The CLI's --profile on the CPU: one Chrome trace per run whose
    spans name the compress's stages (the assembly workers' too) and
    the decompress's; the triplet equals the one without --profile."""
    src = str(tmp_path / "in.fastq")
    with open(src, "wb") as f:
        f.write(synth_fastq(3000, 100, seed=3, var_len=True, n_rate=0.01))
    base = ["--device", "cpu", "-c", "gz", "--block-reads", "1024",
            "-T", "2", *flags, src]
    prof = str(tmp_path / "prof")
    assert cli.main(base + ["-o", str(tmp_path / "plain")]) == 0
    assert cli.main(base + ["-o", str(tmp_path / "p"), "--profile",
                            prof]) == 0
    assert _triplet(str(tmp_path / "p")) == _triplet(str(tmp_path / "plain"))
    spans = _spans(prof)
    assert stages <= set(spans), stages - set(spans)
    assert len(set().union(*spans.values())) >= 3    # main, parse, workers
    dprof = str(tmp_path / "dprof")
    assert cli.main(["--device", "cpu", "-d", "--keep-order", "-o",
                     str(tmp_path / "d"), "--profile", dprof,
                     str(tmp_path / "p.00.scalcen")]) == 0
    assert {"seqs.parse", "qualities.parse", "_finish",
            "render FASTQ", "write"} <= set(_spans(dprof))
    with open(tmp_path / "d.fastq", "rb") as a, open(src, "rb") as b:
        assert a.read() == b.read()


def test_profile_off_writes_nothing(tmp_path):
    with timing.profile(None, "cpu"):
        with timing.stage("a"):
            pass
    assert not timing._profiling and os.listdir(tmp_path) == []
    with pytest.raises(ValueError):
        with timing.profile(str(tmp_path / "t"), "cpu"):
            with timing.stage("b"):
                raise ValueError
    assert not timing._profiling and set(_spans(str(tmp_path / "t"))) \
        == {"b"}
