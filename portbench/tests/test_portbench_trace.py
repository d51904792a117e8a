"""The trace arithmetic on hand-made events."""

import pytest

from portbench import layers
from portbench import trace as tr


def _ev(cat, name, ts, dur, **kw):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": kw.pop("pid", 1), "tid": kw.pop("tid", 1)}
    if kw:
        e["args"] = kw
    return e


EVENTS = [
    _ev("user_annotation", "portbench.window", 0, 1000),
    _ev("user_annotation", "portbench.compress", 0, 400),
    _ev("user_annotation", "portbench.decompress", 500, 400),
    _ev("user_annotation", "parse FASTQ", 10, 50, tid=2),
    _ev("user_annotation", "parse FASTQ", 450, 20, tid=2),   # outside
    _ev("user_annotation", "render FASTQ", 600, 100, tid=3),
    _ev("cpu_op", "aten::add", 5, 1),
    _ev("kernel", "void core_rank_kernel<false>(unsigned char const*)",
        100, 40, device=0),
    _ev("kernel", "void core_rank_kernel<false>(unsigned char const*)",
        120, 40, device=0),                                  # overlaps
    _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 300, 20, device=0),
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 380, 40,
        device=0),                                           # half inside
    _ev("kernel", "void rans_decode_kernel(int)", 600, 10, device=1),
    {"ph": "M", "name": "process_name"},
]


@pytest.fixture
def ctx():
    t = tr.from_events(EVENTS)
    return layers.Context(
        trace=t,
        windows={"compress": [(0.0, 400.0)], "decompress": [(500.0, 900.0)]},
        calls={"compress": 1, "decompress": 1},
        blocks={"compress": 2, "decompress": 4},
        counts={"reads": 10, "bases": 1000, "kmer_windows": 900,
                "qual_symbols": 1000},
        stream_bytes={"n": 5, "r": 250, "q": 500})


def test_parse():
    t = tr.from_events(EVENTS)
    assert len(t.spans) == 6 and len(t.device) == 5
    assert [e.device for e in t.device] == [0, 0, 0, 0, 1]


def test_union_and_clip():
    assert tr.union_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert tr.merged([(5, 15), (0, 10), (20, 30)]) == [(0, 15), (20, 30)]
    assert tr.clip([(0, 10), (15, 30)], [(5, 20)]) == [(5, 10), (15, 20)]


def test_idle_share(ctx):
    # compress: busy 100-160, 300-320, 380-400 = 100 of 400 us
    assert layers.device_idle(ctx, "compress") == pytest.approx(75.0)
    # decompress: only device 1 ran, 10 of 400 us
    assert layers.device_idle(ctx, "decompress") == pytest.approx(97.5)
    assert tr.idle_share([], [(0, 1)]) is None


def test_spans_and_copies(ctx):
    assert layers.span_ms_per_block(ctx, "parse FASTQ", "compress") == \
        pytest.approx(0.050 / 2)
    assert layers.span_ms_per_block(ctx, "render FASTQ", "decompress") == \
        pytest.approx(0.100 / 4)
    assert layers.span_ms_per_block(ctx, "host delta", "compress") is None
    assert layers.pinned_copy_ms_per_block(ctx, "compress") == \
        pytest.approx(0.020 / 2)


def test_counters(ctx):
    assert layers.bits_per(ctx, "r", "bases") == pytest.approx(2.0)
    assert layers.bits_per(ctx, "q", "qual_symbols") == pytest.approx(4.0)


def test_traced_rates(ctx):
    # 2000 bytes over a 400-us compress span: 5 MB/s; nothing read
    # without the window's bytes
    assert layers.rate_MBps(ctx, "compress") is None
    ctx.nbytes = {"compress": 2000, "decompress": 1000}
    assert layers.rate_MBps(ctx, "compress") == pytest.approx(5.0)
    assert layers.rate_MBps(ctx, "decompress") == pytest.approx(2.5)
    ctx.windows["decompress"] = []
    assert layers.rate_MBps(ctx, "decompress") is None


def test_roofline(ctx):
    # K1: 1000 bases / 4 + 4 * 10 reads = 290 bytes in its launches' 80
    # us (each launch's own time, also where two overlap)
    want = 100 * 290 / 3.35e12 / 80e-6
    assert layers.roofline(ctx, "K1") == pytest.approx(want)
    # K4: 500 + 1000 bytes in 10 us, on the decompress side
    assert layers.roofline(ctx, "K4") == pytest.approx(
        100 * 1500 / 3.35e12 / 10e-6)
    assert layers.roofline(ctx, "K3") is None     # never ran


def test_breakdown(ctx):
    t = ctx.trace
    ops = tr.top_device_ops(t.device, (0, 1000))
    assert ops[0] == ["core_rank_kernel<false>", pytest.approx(80e-6)]
    assert [o[0] for o in ops[1:]] == ["Memcpy DtoH (Device -> Pageable)",
                                       "Memcpy HtoD (Pinned -> Device)",
                                       "rans_decode_kernel"]
    gaps = tr.idle_gaps(t, (0, 1000))
    # (610, 1000) holds 90 us of the render; (420, 600) 20 us of a parse
    # span; (160, 300) nothing; (0, 100) 50 us of the other parse span
    assert gaps[0] == ["decompress: render FASTQ", pytest.approx(390e-6)]
    assert [g[0] for g in gaps[1:4]] == ["decompress: parse FASTQ",
                                         "compress: no stage",
                                         "compress: parse FASTQ"]
    assert sum(g[1] for g in gaps) == pytest.approx((1000 - 130) / 1e6)
