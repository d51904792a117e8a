"""scalce_tpu_torch's tracing: off, stages and counts record nothing;
under ``--profile DIR`` a torch.profiler trace names every stage and
every wait of the compress and decompress paths, on every thread that
runs them, the link's bytes and the delta's literals are counted, the
card's time is given to the stage that queued it, and no byte of the
triplet changes; the device-busy helpers split a card's events by
kind."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from scalce_tpu_torch import cli, container, timing
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.pipeline import driver
from scalce_tpu_torch.streams import seqs
from scalce_tpu_torch.transfer import Link
from scalce_tpu_torch.utils.synth import synth_fastq

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

#: the compress's and the decompress's waits (host core: no link)
COMPRESS_WAITS = {"wait input", "wait assemble", "wait download"}
DECOMPRESS_WAITS = {"wait parse", "wait finish"}


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0, 10)], 10e-6),
    ([(0, 10), (5, 20), (30, 40)], 30e-6),
    ([(30, 40), (0, 10), (2, 3)], 20e-6),
])
def test_union_of_device_spans(spans, want):
    assert timing.union_s(spans) == pytest.approx(want)


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
    assert timing.device_event_kind(name) == kind


def test_device_busy_without_device_events_is_none():
    """A call that queues nothing on a card runs once under
    ``timing.device_busy``, which then reports no busy time at all."""
    ran = []
    assert timing.device_busy(lambda: ran.append(torch.ones(4).sum())) \
        is None
    assert len(ran) == 1


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
          "names payload", "write"} | COMPRESS_WAITS),
    (["--core-placement", "host"], {"parse FASTQ", "host core",
                                    "host delta", "quality encode (host)",
                                    "seqs.payload", "write"}
     | COMPRESS_WAITS - {"wait download"})])
def test_profile_trace_names_the_stages(tmp_path, flags, stages):
    """The CLI's --profile on the CPU: one Chrome trace per run whose
    spans name the compress's stages and waits (the assembly workers'
    too) and the decompress's; the triplet equals the one without
    --profile."""
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
    assert {"seqs.parse", "qualities.parse", "quality decode (host)",
            "_finish", "render FASTQ", "write"} | DECOMPRESS_WAITS \
        <= set(_spans(dprof))
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


def test_counters_only_inside_profile(tmp_path):
    """Counts outside a profile record nothing; a profile's counters are
    the last profile's, written beside its trace only when asked."""
    with timing.profile(str(tmp_path / "a"), "cpu"):
        timing.begin("compress")
        timing.count("x", 2)
        timing.count("x", 3)
        with timing.stage("s"):
            timing.begin("decompress")
            timing.count("y", 1)
    want = {"compress": {"x": 5}, "decompress": {"y": 1}, "device_us": {},
            "device_us_by_card": {}}
    assert timing.counters() == want
    assert not timing.recording()
    timing.count("x", 7)
    with timing.profile(None, "cpu"):
        timing.count("x", 11)
    assert timing.counters() == want
    assert not glob.glob(str(tmp_path / "a" / "*.counters.json"))
    with timing.profile(str(tmp_path / "b"), "cpu", write_counters=True):
        timing.begin("compress")
        timing.count("z", 4)
    (path,) = glob.glob(str(tmp_path / "b" / "*.counters.json"))
    with open(path) as f:
        assert json.load(f) == timing.counters() == {
            "compress": {"z": 4}, "device_us": {}, "device_us_by_card": {}}
    src = str(tmp_path / "in.fastq")
    with open(src, "wb") as f:
        f.write(synth_fastq(500, 100, seed=4))
    assert cli.main(["--device", "cpu", "-c", "gz", "-o",
                     str(tmp_path / "p"), src]) == 0
    assert timing.counters()["compress"] == {"z": 4}
    assert glob.glob(str(tmp_path / "**" / "*.counters.json"),
                     recursive=True) == [path]


@pytest.mark.parametrize("threads", [1, 3])
def test_link_and_literal_counters(tmp_path, monkeypatch, threads):
    """Under a profile a compress counts the bytes of every array it
    hands the link each way, the literals its triplet holds and, under
    Config's default host delta, every block it matched on the host."""
    handed = {"h2d_bytes": 0, "d2h_bytes": 0}
    up, down = Link.upload, Link.download

    def upload(self, arrays):
        # at the widths they cross in: u16 as int32, u32 as int64
        handed["h2d_bytes"] += sum(
            a.size * {"uint16": 4, "uint32": 8}.get(a.dtype.name, a.itemsize)
            for a in map(np.asarray, arrays.values()))
        return up(self, arrays)

    def download(self, *groups):
        handed["d2h_bytes"] += sum(t.numel() * t.element_size()
                                   for g in groups for t in g.values())
        return down(self, *groups)

    monkeypatch.setattr(Link, "upload", upload)
    monkeypatch.setattr(Link, "download", download)
    src = str(tmp_path / "in.fastq")
    with open(src, "wb") as f:
        f.write(synth_fastq(3000, 100, seed=5, var_len=True, n_rate=0.01,
                            genome_len=20_000))
    out = str(tmp_path / "p")
    cfg = Config(inputs=(src,), output=out, block_reads=1024, backend="gz",
                 threads=threads, qual_on_device=False,
                 qual_context_order=0)
    with timing.profile(str(tmp_path / "t"), "cpu"):
        driver.compress(cfg, "cpu")
    got = timing.counters()["compress"]
    reader = container.TripletReader(out + ".00.scalcen")
    B, L = (int(reader.meta[k]) for k in ("block_reads", "max_read_len"))
    payloads = [p for _, p in reader.iter_blocks()]
    lits = sum(seqs.parse_fields(p["r"], B, L)[0]["lits"].size
               for p in payloads)
    assert handed["h2d_bytes"] > 0 and handed["d2h_bytes"] > 0 and lits > 0
    assert got == {**handed, "literals": lits,
                   "host_delta_blocks": len(payloads)}


#: (spans (name, thread, start, end), launches {correlation: (thread,
#: time)}, device events (correlation, duration), the stages' sums)
ATTRIBUTION = {
    "nested": (
        [("A", 1, 0, 100), ("B", 1, 10, 50), ("C", 1, 20, 30),
         ("B", 1, 60, 70)],
        {1: (1, 5), 2: (1, 15), 3: (1, 25), 4: (1, 40), 5: (1, 55),
         6: (1, 65), 7: (1, 100)},
        [(1, 1.0), (2, 2.0), (3, 4.0), (4, 8.0), (5, 16.0), (6, 32.0),
         (7, 64.0)],
        {"A": 1.0 + 16.0 + 64.0, "B": 2.0 + 8.0 + 32.0, "C": 4.0}),
    "two threads": (
        [("A", 1, 0, 100), ("B", 2, 0, 100), ("C", 2, 40, 60)],
        {1: (1, 50), 2: (2, 50), 3: (2, 70), 4: (3, 50)},
        [(1, 1.0), (2, 2.0), (3, 4.0), (4, 8.0)],
        {"A": 1.0, "C": 2.0, "B": 4.0, timing.NO_STAGE: 8.0}),
    "outside every span": (
        [("A", 1, 10, 20), ("B", 1, 30, 40), ("C", 1, 32, 34)],
        {1: (1, 5), 2: (1, 25), 3: (1, 36), 4: (1, 45)},
        [(1, 1.0), (2, 2.0), (3, 4.0), (4, 8.0), (4, 16.0)],
        {timing.NO_STAGE: 1.0 + 2.0 + 8.0 + 16.0, "B": 4.0}),
    "unknown launch": (
        [("A", 1, 0, 100)],
        {1: (1, 50)},
        [(1, 1.0), (2, 2.0), (3, 4.0)],
        {"A": 1.0, timing.NO_STAGE: 6.0}),
}


@pytest.mark.parametrize("case", sorted(ATTRIBUTION))
def test_device_time_by_stage(case):
    """Each device event's time goes once to the innermost stage around
    its launch on the launch's thread, else to no stage: the sums add
    up to the events' total."""
    spans, launches, device, want = ATTRIBUTION[case]
    got = timing.device_time_by_stage(device, launches, spans)
    assert got == want
    assert sum(got.values()) == sum(d for _, d in device)
    # the spans' order does not matter
    assert timing.device_time_by_stage(device, launches,
                                       spans[::-1]) == want


@pytest.mark.parametrize("case", sorted(ATTRIBUTION))
def test_device_time_by_card(case):
    """The same events spread over two cards: each card's events go to
    the stages as they would alone, and the cards' sums add up to the
    stages' sums."""
    spans, launches, device, want = ATTRIBUTION[case]
    cards = [(corr, dur, i % 2) for i, (corr, dur) in enumerate(device)]
    got = timing.device_time_by_card(cards, launches, spans)
    for card in (0, 1):
        mine = [(corr, dur) for corr, dur, c in cards if c == card]
        assert got.get(card, {}) == timing.device_time_by_stage(
            mine, launches, spans)
    summed = {}
    for per in got.values():
        for name, t in per.items():
            summed[name] = summed.get(name, 0.0) + t
    assert summed == pytest.approx(want) and set(summed) == set(want)
    assert timing.device_time_by_stage(device, launches, spans) == want


@pytest.mark.gpu
def test_device_time_by_stage_on_the_card(tmp_path):
    """On the card, stage A and stage B get device time, stage B at
    least K7's, and the stages' sums add up to the trace's device
    events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src = str(tmp_path / "in.fastq")
    with open(src, "wb") as f:
        f.write(synth_fastq(20000, 100, seed=6, genome_len=200_000,
                            n_rate=0.001))
    # the bare command's placement: K1 in stage A, K7 in stage B
    cfg = Config(inputs=(src,), output=str(tmp_path / "p"),
                 block_reads=4096, backend="gz", threads=2,
                 core_on_device=True, delta_on_device=True,
                 qual_on_device=False, qual_context_order=0)
    driver.compress(cfg, "cuda")             # builds the kernels
    with timing.profile(str(tmp_path / "t"), "cuda"):
        driver.compress(cfg, "cuda")
        torch.cuda.synchronize()
    dev = timing.counters()["device_us"]
    (card,) = timing.counters()["device_us_by_card"].values()
    assert card == pytest.approx(dev) and set(card) == set(dev)
    (path,) = glob.glob(str(tmp_path / "t" / "*.trace.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    k7 = sum(e["dur"] for e in events if e["cat"] == "kernel"
             and "delta_seq_" in e["name"])
    assert dev.get("stage A", 0) > 0, dev
    assert dev.get("stage B", 0) >= k7 > 0, (dev, k7)
    assert sum(dev.values()) == pytest.approx(
        sum(e["dur"] for e in events), rel=0.005)
