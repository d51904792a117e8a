"""Lossy qualities (-p) on the CPU: the port's quantizer equals the
reference's, its lossy triplets (single-end, paired, and both under
--data-parallel on two devices with a tail group) equal scalce_tpu's
byte for byte, a lossy round trip keeps names and sequences and maps
every quality through the sampled map, and the lossy histogram
all-reduce equals the reference's psum."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scalce_tpu
import scalce_tpu_torch
from scalce_tpu import container
from scalce_tpu.config import Config as RefConfig
from scalce_tpu.io import fastq
from scalce_tpu.models import lossy as ref_lossy
from scalce_tpu.parallel import mesh as ref_mesh
from scalce_tpu.utils.synth import synth_fastq, synth_pair
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.models import lossy
from scalce_tpu_torch.parallel import mesh

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

SLICE = dict(block_reads=1024, max_read_len=128, qual_T_target=2048,
             core_on_device=True, delta_on_device=True, qual_on_device=True,
             qual_context_order=1, dict_mode="hash", backend="gz",
             threads=1, lossy_pct=30, sample_size=1000)


def _triplets(prefix):
    out = {}
    for path in sorted(glob.glob(prefix + ".*.scalce[nrq]")):
        with open(path, "rb") as f:
            out[path[len(prefix):]] = f.read()
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """2.5 blocks of 1024 ragged reads with N bases: one file and one
    pair."""
    d = str(tmp_path_factory.mktemp("lossy"))
    one = synth_fastq(2560, 100, seed=41, genome_len=50_000, var_len=True,
                      n_rate=0.01)
    a, b = synth_pair(2560, 100, seed=43, genome_len=50_000, var_len=True,
                      n_rate=0.01)
    paths = {}
    for name, data in (("one", one), ("a", a), ("b", b)):
        paths[name] = os.path.join(d, name + ".fastq")
        with open(paths[name], "wb") as f:
            f.write(data)
    return {"dir": d, "single": (paths["one"],),
            "paired": (paths["a"], paths["b"]), "data": one}


@pytest.mark.parametrize("pct", [0, 10, 30, 100])
def test_quant_map_matches_reference(pct):
    rng = np.random.default_rng(pct)
    for hist in (rng.integers(0, 1000, 94),
                 np.bincount(rng.normal(30, 6, 5000).clip(0, 93).astype(int),
                             minlength=94),
                 np.zeros(94, np.int64)):
        lut = lossy.build_quant_map(hist, pct)
        np.testing.assert_array_equal(lut, ref_lossy.build_quant_map(hist,
                                                                     pct))
        assert lossy.max_abs_error(lut) == ref_lossy.max_abs_error(lut)
    qual = rng.integers(33, 127, (64, 48)).astype(np.uint8)
    lengths = rng.integers(0, 49, 64).astype(np.int32)
    np.testing.assert_array_equal(
        lossy.sample_histogram(qual, lengths, 50),
        ref_lossy.sample_histogram(qual, lengths, 50))


@pytest.fixture(scope="module")
def compressed(inputs):
    """Each input (single-end, paired) compressed once by each of: the
    reference (lossy), the port on one device (lossy), the port
    lossless.  -> {paired: {"ref"|"port"|"lossless": prefix}}."""
    out = {}
    for paired in (False, True):
        src = inputs["paired" if paired else "single"]
        tag = "p" if paired else "s"
        prefixes = {k: os.path.join(inputs["dir"], f"{k}_{tag}")
                    for k in ("ref", "port", "lossless")}
        scalce_tpu.compress(RefConfig(inputs=src, paired=paired,
                                      output=prefixes["ref"], **SLICE))
        stats = scalce_tpu_torch.compress(Config(
            inputs=src, paired=paired, output=prefixes["port"], **SLICE),
            "cpu")
        assert stats.device == "cpu"
        scalce_tpu_torch.compress(Config(
            inputs=src, paired=paired, output=prefixes["lossless"],
            **{**SLICE, "lossy_pct": 0}), "cpu")
        out[paired] = prefixes
    return out


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("data_parallel", [False, True])
def test_lossy_triplets_match_reference(inputs, compressed, monkeypatch,
                                        paired, data_parallel):
    """``lossy_pct=30, sample_size=1000``; under --data-parallel the
    port runs on two CPU devices (one group of 2 and a tail of 1)."""
    prefixes = compressed[paired]
    port = prefixes["port"]
    if data_parallel:
        cpus = mesh.local_mesh(2, "cpu")
        monkeypatch.setattr(mesh, "local_mesh",
                            lambda n=None, device=None: cpus)
        port = os.path.join(inputs["dir"], f"port_dp_{int(paired)}")
        stats = scalce_tpu_torch.compress(Config(
            inputs=inputs["paired" if paired else "single"], paired=paired,
            output=port, data_parallel=True, **SLICE), "cpu")
        assert stats.device == "cpu,cpu"
    want = _triplets(prefixes["ref"])
    assert len(want) == (6 if paired else 3)
    assert _triplets(port) == want
    for mate in ("_1", "_2") if paired else ("",):
        got, plain = (list(container.TripletReader(
            f"{prefix}.00{mate}.scalcen").iter_blocks())
            for prefix in (port, prefixes["lossless"]))
        assert [bid for bid, _ in got] == [bid for bid, _ in plain]
        for (_, g), (_, p) in zip(got, plain):
            assert g["n"] == p["n"] and g["r"] == p["r"]  # names, sequences
            assert len(g["q"]) < len(p["q"])             # fewer symbols


def test_lossy_round_trip_maps_every_quality(inputs, compressed):
    """Keep-order decompress of the port's lossy triplet: names,
    sequences and '+' lines come back exactly; every quality byte is the
    sampled map's image of the input's, within the 30% budget."""
    d = inputs["dir"]
    (src,) = inputs["single"]
    out = compressed[False]["port"]
    first = next(fastq.iter_blocks(src, 1024, 128))
    lut = lossy.build_quant_map(
        lossy.sample_histogram(first.qual, first.lengths, first.n_reads), 30)
    assert 0 < lossy.max_abs_error(lut) <= 0.3 * 93
    scalce_tpu_torch.decompress(Config(
        mode="decompress", inputs=(out + ".00.scalcen",),
        output=os.path.join(d, "rt_out"), keep_order=True,
        qual_on_device=True), "cpu")
    with open(os.path.join(d, "rt_out.fastq"), "rb") as f:
        got = f.read().split(b"\n")
    want = inputs["data"].split(b"\n")
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == (w.translate(lut.tobytes()) if i % 4 == 3 else w)
    assert got != want


def test_lossy_hist_allreduce_matches_reference():
    """Two CPU devices, two blocks each, ragged lengths: the port's
    one-K6-launch-per-device histogram summed on the first device equals
    make_lossy_hist_allreduce's psum and a numpy bincount."""
    rng = np.random.default_rng(5)
    D, B, L = 4, 64, 32
    qual = rng.integers(30, 80, (D, B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, (D, B)).astype(np.int32)
    got = mesh.lossy_hist_allreduce(qual, lengths, mesh.local_mesh(2, "cpu"))
    want = ref_mesh.make_lossy_hist_allreduce(ref_mesh.local_mesh(2), 94)(
        jnp.asarray(qual), jnp.asarray(lengths))
    valid = np.arange(L)[None, None, :] < lengths[:, :, None]
    sym = np.clip(qual.astype(np.int64) - 33, 0, 93)[valid]
    assert got.dtype == torch.int32 and got.shape == (94,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(sym, minlength=94))
    with pytest.raises(ValueError, match="do not split"):
        mesh.lossy_hist_allreduce(qual[:3], lengths[:3],
                                  mesh.local_mesh(2, "cpu"))
