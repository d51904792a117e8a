"""Every short-read placement of scalce_tpu_torch against scalce_tpu's:
host core, host delta (single-end, paired, --data-parallel) and AUTO
with the link probe below and above 200 MB/s.  Each triplet equals
scalce_tpu's for the same Config and the port's device-placement
triplet, RunStats.placement agrees, and spies show that the placement
really ran (the native matcher, the packed host-delta buffer, no device
delta)."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scalce_tpu
import scalce_tpu.cli as ref_cli
from scalce_tpu.config import Config as RefConfig
from scalce_tpu.pipeline import encode as ref_encode
from scalce_tpu.utils.synth import synth_fastq, synth_pair
from scalce_tpu_torch import cli, convert, native, transfer
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.ops import core_match
from scalce_tpu_torch.pipeline import driver, encode
from scalce_tpu_torch.pipeline.encode import BlockEncoder

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

#: host qualities (every host placement needs them), gz, one thread
BASE = dict(block_reads=1024, max_read_len=128, backend="gz", threads=1,
            qual_on_device=False, qual_context_order=0)
HOST_CORE = dict(core_on_device=False, delta_on_device=False)
HOST_DELTA = dict(core_on_device=True, delta_on_device=False)
AUTO = dict(core_on_device=None, delta_on_device=False)
DEVICE = dict(core_on_device=True, delta_on_device=True)


def _triplet(prefix):
    out = {}
    for path in sorted(glob.glob(prefix + ".*.scalce[nrq]")):
        with open(path, "rb") as f:
            out[path[len(prefix):]] = f.read()
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A ragged single-end file with N bases (3 full blocks and a tail)
    and a ragged pair (2 blocks)."""
    d = str(tmp_path_factory.mktemp("placement"))
    src = os.path.join(d, "in.fastq")
    with open(src, "wb") as f:
        f.write(synth_fastq(3500, 100, seed=3, var_len=True, n_rate=0.01,
                            rc_rate=0.3))
    mates = [os.path.join(d, f"m{m}.fastq") for m in (1, 2)]
    for path, data in zip(mates, synth_pair(2048, 100, seed=4,
                                            var_len=True, n_rate=0.01)):
        with open(path, "wb") as f:
            f.write(data)
    return {"dir": d, "single": (src,), "pair": tuple(mates), "ref": {}}


class _Spy:
    """Counts the calls of the functions that tell the placements apart:
    the device delta (``_delta_seq``), the host-delta stage A (once a
    mate), and the native core matcher and delta matches."""

    def __init__(self, monkeypatch):
        self.calls = {}
        for mod, name in ((encode, "_delta_seq"),
                          (encode, "stage_a_hd"),
                          (native, "core_match_block"),
                          (native, "delta_match_runs"),
                          (native, "delta_match")):
            monkeypatch.setattr(mod, name, self._wrap(name,
                                                      getattr(mod, name)))

    def _wrap(self, name, fn):
        self.calls[name] = 0

        def counted(*a, **kw):
            self.calls[name] += 1
            return fn(*a, **kw)
        return counted


def _probe(monkeypatch, mbps):
    """Both packages' AUTO link probe answers ``mbps`` (the reference's
    background probe never starts)."""
    monkeypatch.setattr(ref_encode, "device_link_mbps", lambda: mbps)
    monkeypatch.setattr(ref_encode, "start_link_probe", lambda: None)
    monkeypatch.setattr(encode, "device_link_mbps", lambda dev: mbps)


def _compress_both(files, inputs, kw, tag):
    """``(triplet, placement)`` of scalce_tpu's compress (once per
    ``tag``) and of the port's on the CPU."""
    d = files["dir"]
    paired = len(inputs) == 2
    ref = files["ref"].get(tag)
    if ref is None:
        stats = scalce_tpu.compress(RefConfig(
            inputs=inputs, output=os.path.join(d, "ref_" + tag),
            paired=paired, **kw))
        ref = (_triplet(os.path.join(d, "ref_" + tag)), stats.placement)
        files["ref"][tag] = ref
    stats = driver.compress(Config(inputs=inputs, output=os.path.join(
        d, "port_" + tag), paired=paired, **kw), "cpu")
    return ref, (_triplet(os.path.join(d, "port_" + tag)), stats.placement)


#: name -> (input, Config change, AUTO probe MB/s, placement, expected
#: spy counts per block or pair: host core matches both mates' cores)
CASES = {
    "host core": ("single", HOST_CORE, None, "host",
                  dict(core_match_block=1, delta_match_runs=1)),
    "host delta": ("single", HOST_DELTA, None, "device",
                   dict(stage_a_hd=1, delta_match_runs=1)),
    "auto, slow link": ("single", AUTO, 30.0, "host",
                        dict(core_match_block=1, delta_match_runs=1)),
    "auto, fast link": ("single", AUTO, 5000.0, "device",
                        dict(stage_a_hd=1, delta_match_runs=1)),
    "host core, pair": ("pair", HOST_CORE, None, "host",
                        dict(core_match_block=2, delta_match_runs=1,
                             delta_match=1)),
    "host delta, pair": ("pair", HOST_DELTA, None, "device",
                         dict(stage_a_hd=2, delta_match_runs=1,
                              delta_match=1)),
    "auto, slow link, pair": ("pair", AUTO, 30.0, "host",
                              dict(core_match_block=2, delta_match_runs=1,
                                   delta_match=1)),
    "auto, fast link, pair": ("pair", AUTO, 5000.0, "device",
                              dict(stage_a_hd=2, delta_match_runs=1,
                                   delta_match=1)),
    "host delta, --data-parallel": (
        "single", dict(HOST_DELTA, data_parallel=True), None, "device",
        dict(stage_a_hd=1, delta_match_runs=1)),
    "host delta, --data-parallel pair": (
        "pair", dict(HOST_DELTA, data_parallel=True), None, "device",
        dict(stage_a_hd=2, delta_match_runs=1, delta_match=1)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_placement_writes_the_reference_bytes(files, monkeypatch, name):
    which, change, mbps, placement, per_block = CASES[name]
    inputs = files[which]
    kw = {**BASE, **change}
    if mbps is not None:
        _probe(monkeypatch, mbps)
    device_kw = {**kw, **DEVICE, "data_parallel": False}
    dev_ref, dev_port = _compress_both(files, inputs, device_kw,
                                       "dev_" + which)
    assert dev_port == dev_ref
    spy = _Spy(monkeypatch)
    tag = name.replace(" ", "_").replace(",", "")
    ref, port = _compress_both(files, inputs, kw, tag)
    assert port == ref == (dev_port[0], placement)
    n_blocks = 4 if which == "single" else 2
    want = {k: 0 for k in spy.calls}
    want.update({k: v * n_blocks for k, v in per_block.items()})
    assert spy.calls == want


def test_host_core_encoder_touches_no_device(files):
    """A host-core encoder makes no Link and uploads nothing; its
    dispatch queues nothing (the driver's upload stage is skipped)."""
    enc = BlockEncoder(Config(inputs=files["single"], **BASE, **HOST_CORE),
                       "cpu")
    assert enc.host_core and enc.placement == "host"
    assert enc.link is None and enc.rank_lut is None
    from scalce_tpu_torch.io import fastq
    block = next(iter(fastq.iter_blocks(files["single"][0], 1024, 128)))
    assert enc.upload([(block,)]) is None
    assert enc.dispatch([(block,)]) == [[encode.HOST_CORE]]
    assert driver._encoder(Config(inputs=files["single"], **BASE,
                                  **HOST_CORE), "cpu", None).on_host


def _hd_arrays(seed, B=300):
    """Sorted-frame host-delta fields: runs of equal cores with NO_CORE
    rows, a permutation, positions and lengths up to 15 bits."""
    rng = np.random.default_rng(seed)
    ck = np.sort(rng.integers(0, 40, B)).astype(np.uint32) * 977
    ck[rng.random(B) < 0.1] = np.uint32(core_match.NO_CORE)
    ck[:3] = ck[3]                      # row 0 inside a run
    return {"len_s": rng.integers(0, 32753, B).astype(np.int32),
            "ck_s": ck,
            "cp_s": rng.integers(0, 32752, B).astype(np.int32),
            "rc_s": rng.random(B) < 0.5,
            "perm": rng.permutation(B).astype(np.int32)}


@pytest.mark.parametrize("mate", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_hd_pack_and_unpack_match_reference(mate, seed):
    a = _hd_arrays(seed)
    names = ["len_s", "ck_s", "cp_s", "rc_s"] + (["perm"] if mate == 1
                                                  else [])
    want = np.asarray(ref_encode._hd_pack(*(jnp.asarray(a[n])
                                            for n in names)))
    t = convert.from_reference({n: a[n] for n in names}, "cpu")
    got = encode._hd_pack(*(t[n] for n in names))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    B = a["len_s"].shape[0]
    # a later mate's buffer carries no permutation: it follows mate 1's
    follow = None if mate == 1 else a["perm"].astype(np.int64)
    for g, w in zip(encode._hd_unpack(got.numpy().view(np.uint32), B,
                                      follow),
                    ref_encode._hd_unpack(want, B, mate == 1)):
        if w is None:
            assert g is follow
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_link_probe_measures_once_and_refuses_bad_bytes(monkeypatch):
    """The probe caches per device; a round trip that changes the bytes
    raises (no quiet fallback to the host)."""
    monkeypatch.setattr(encode, "_LINK_MBPS", {})
    first = encode.device_link_mbps("cpu")
    assert first > 0 and encode.device_link_mbps("cpu") == first
    assert encode.host_core_available() and encode.host_delta_available()

    class BadLink(transfer.Link):
        def download(self, *groups):
            return [transfer.Fetched({k: np.zeros_like(t.numpy())
                                      for k, t in g.items()})
                    for g in groups]
    monkeypatch.setattr(encode, "_LINK_MBPS", {})
    monkeypatch.setattr(encode, "Link", BadLink)
    with pytest.raises(RuntimeError, match="link probe"):
        encode.device_link_mbps("cpu")
    with pytest.raises(RuntimeError, match="link probe"):
        BlockEncoder(Config(inputs=("x",), **BASE, **AUTO), "cpu")


def test_host_core_with_data_parallel_is_refused():
    for cfg in (Config, RefConfig):
        with pytest.raises(ValueError, match="data-parallel"):
            cfg(inputs=("x",), data_parallel=True, **BASE, **HOST_CORE)


@pytest.mark.parametrize("placement", ["host", "auto"])
def test_cli_core_placement_writes_the_reference_bytes(files, monkeypatch,
                                                       placement):
    """``--core-placement host|auto`` through both CLIs (the port's delta
    follows the cores to the host, as the reference's default does)."""
    _probe(monkeypatch, 5000.0)
    d, (src,) = files["dir"], files["single"]
    args = [src, "-c", "gz", "--block-reads", "1024", "-T", "1",
            "--core-placement", placement]
    spy = _Spy(monkeypatch)
    ref_cli.main(args + ["-o", os.path.join(d, "cli_ref_" + placement)])
    cli.main(args + ["-o", os.path.join(d, "cli_port_" + placement),
                     "--device", "cpu"])
    assert _triplet(os.path.join(d, "cli_port_" + placement)) == \
        _triplet(os.path.join(d, "cli_ref_" + placement))
    assert spy.calls["_delta_seq"] == 0 and spy.calls["delta_match_runs"]
