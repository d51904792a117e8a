"""The explicit core dictionaries (dict_mode lut / lcp) in
scalce_tpu_torch against scalce_tpu: the copied LUT builders, the core
matcher ranking by a LUT (K1's plain version), and end-to-end triplets
under the placements that take a LUT, exactly."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scalce_tpu
import scalce_tpu_torch
from scalce_tpu.config import Config as RefConfig
from scalce_tpu.models import core_dict as ref_core_dict
from scalce_tpu.ops import core_match as ref_core_match
from scalce_tpu.pipeline import encode as ref_encode
from scalce_tpu.utils.synth import synth_fastq, synth_pair
from scalce_tpu_torch import convert
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.models import core_dict
from scalce_tpu_torch.ops import core_match, core_rank
from scalce_tpu_torch.pipeline import encode

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

BUILDERS = {"lut": ("build_rank_lut",), "lcp": ("build_rank_lut_lcp",)}


@pytest.fixture(autouse=True)
def _no_reference_probe(monkeypatch):
    """scalce_tpu's AUTO compress starts its link probe in a child
    process; a LUT never takes host core, so the probe is not needed."""
    monkeypatch.setattr(ref_encode, "start_link_probe", lambda: None)


def _triplet(prefix):
    out = {}
    for path in sorted(glob.glob(prefix + ".*.scalce[nrq]")):
        with open(path, "rb") as f:
            out[path[len(prefix):]] = f.read()
    return out


@pytest.mark.parametrize("k", [6, 8, 10])
@pytest.mark.parametrize("mode", ["lut", "lcp"])
def test_rank_lut_matches_reference(mode, k):
    (name,) = BUILDERS[mode]
    got = getattr(core_dict, name)(k, 0x5CA1CE)
    want = getattr(ref_core_dict, name)(k, 0x5CA1CE)
    assert got.dtype == want.dtype == np.uint32 and got.shape == (4 ** k,)
    np.testing.assert_array_equal(got, want)
    cfg = Config(inputs=("x",), dict_mode=mode, core_k=k)
    np.testing.assert_array_equal(encode.build_rank_lut(cfg),
                                  getattr(core_dict, name)(k, cfg.dict_seed))


def _reads(seed, B=200, L=112):
    """Ragged reads with N bases, homopolymer runs (ties and the LUT's
    demoted classes) and empty and all-N rows."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[: B // 4, 10:40] = 0
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[::17] = 0
    exc = rng.random((B, L)) < 0.02
    exc[5::23] = True
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return codes, lengths, exc


@pytest.mark.parametrize("k", [8, 10])
@pytest.mark.parametrize("mode", ["lut", "lcp"])
def test_find_cores_with_lut_matches_reference(mode, k):
    """The port's canonical matcher through the plain K1 with a LUT
    equals the reference's XLA path with the same LUT."""
    (name,) = BUILDERS[mode]
    lut = getattr(core_dict, name)(k, 7)
    codes, lengths, exc = _reads(k)
    want = ref_core_match.find_cores_canonical(
        jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(exc), k, 7,
        rank_lut=jnp.asarray(lut))
    t = convert.from_reference({"codes": codes, "lengths": lengths,
                                "exc": exc}, "cpu")
    got = core_match.find_cores_canonical(
        t["codes"], t["lengths"], t["exc"], k, 7,
        torch.from_numpy(lut.view(np.int32)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    # the LUT changes the cores (else this test would not see it)
    hashed = core_match.find_cores_canonical(t["codes"], t["lengths"],
                                             t["exc"], k, 7)
    assert not torch.equal(hashed[0], got[0])


def test_plain_k1_with_lut_ranks_by_the_table():
    """rank_argmin_plain with a LUT: the forward rank is the table's
    minimum over valid windows, first position on ties."""
    k = 6
    lut = core_dict.build_rank_lut(k, 3)
    codes, lengths, exc = (torch.from_numpy(a) for a in _reads(1, 50, 48))
    bf, pf, *_ = core_rank.core_rank_codes(codes, exc, lengths, k, 3,
                                           torch.from_numpy(lut.view(
                                               np.int32)))
    kmers = core_rank.rolling_kmers(codes, k).numpy()
    invalid = core_rank.window_invalid(exc, lengths, k).numpy()
    ranks = np.where(invalid, 0xFFFFFFFF, lut[kmers].astype(np.int64))
    np.testing.assert_array_equal(bf.numpy(), ranks.min(axis=1))
    np.testing.assert_array_equal(pf.numpy(), ranks.argmin(axis=1))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dict"))
    src = os.path.join(d, "in.fastq")
    data = synth_fastq(2500, 96, seed=21, var_len=True, n_rate=0.01)
    with open(src, "wb") as f:
        f.write(data)
    mates = [os.path.join(d, f"m{m}.fastq") for m in (1, 2)]
    for path, mate in zip(mates, synth_pair(1200, 96, seed=22)):
        with open(path, "wb") as f:
            f.write(mate)
    return {"dir": d, "single": (src,), "pair": tuple(mates), "data": data}


#: placements that take a LUT (host core takes the hash only)
PLACEMENTS = {
    "device": dict(core_on_device=True, delta_on_device=True,
                   qual_on_device=True, qual_context_order=1),
    "host delta": dict(core_on_device=True, delta_on_device=False),
    "auto": dict(core_on_device=None, delta_on_device=False),
    "host delta, pair": dict(core_on_device=True, delta_on_device=False,
                             paired=True),
    "device, --data-parallel": dict(core_on_device=True,
                                    delta_on_device=True,
                                    data_parallel=True),
    "host delta, --data-parallel pair": dict(
        core_on_device=True, delta_on_device=False, data_parallel=True,
        paired=True),
}


@pytest.mark.parametrize("placement", list(PLACEMENTS))
@pytest.mark.parametrize("mode", ["lut", "lcp"])
def test_dict_mode_triplets_match_reference(files, mode, placement):
    """``dict_mode`` lut / lcp at core_k 8 (as tests/test_core_match.py's
    end-to-end case): the port's triplet equals scalce_tpu's."""
    change = PLACEMENTS[placement]
    inputs = files["pair" if change.get("paired") else "single"]
    kw = dict(block_reads=1024, max_read_len=96, backend="gz", threads=1,
              dict_mode=mode, core_k=8, **change)
    tag = f"{mode}_{placement}".replace(" ", "_").replace(",", "")
    d = files["dir"]
    scalce_tpu.compress(RefConfig(inputs=inputs, output=os.path.join(
        d, "ref_" + tag), **kw))
    stats = scalce_tpu_torch.compress(Config(
        inputs=inputs, output=os.path.join(d, "port_" + tag), **kw), "cpu")
    assert stats.placement == "device"       # a LUT never takes host core
    assert _triplet(os.path.join(d, "port_" + tag)) == \
        _triplet(os.path.join(d, "ref_" + tag))


def test_lut_round_trip(files):
    """The lut triplet decompresses (keep-order) to the input."""
    d = files["dir"]
    kw = dict(block_reads=1024, max_read_len=96, backend="gz",
              dict_mode="lut", core_k=8)
    scalce_tpu_torch.compress(Config(inputs=files["single"],
                                     output=os.path.join(d, "rt"), **kw),
                              "cpu")
    scalce_tpu_torch.decompress(Config(
        mode="decompress", inputs=(os.path.join(d, "rt.00.scalcen"),),
        output=os.path.join(d, "rt_out"), keep_order=True), "cpu")
    with open(os.path.join(d, "rt_out.fastq"), "rb") as f:
        assert f.read() == files["data"]


def test_encoder_builds_and_uploads_the_lut_once(files, monkeypatch):
    """One LUT per encoder (the host build), one upload per device; the
    blocks reuse it."""
    builds = []
    real = core_dict.build_rank_lut
    monkeypatch.setattr(core_dict, "build_rank_lut",
                        lambda *a: builds.append(a) or real(*a))
    kw = dict(block_reads=1024, max_read_len=96, backend="gz",
              dict_mode="lut", core_k=8)
    enc = encode.BlockEncoder(Config(inputs=files["single"], **kw), "cpu")
    assert builds == [(8, enc.cfg.dict_seed)]
    assert enc.rank_lut.dtype == torch.int32
    np.testing.assert_array_equal(enc.rank_lut.numpy().view(np.uint32),
                                  enc.rank_lut_np)
    scalce_tpu_torch.compress(Config(
        inputs=files["single"], output=os.path.join(files["dir"], "once"),
        **kw), "cpu")
    assert len(builds) == 2                    # that run's one encoder
