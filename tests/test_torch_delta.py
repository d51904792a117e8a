"""scalce_tpu_torch stage A (cores, sort, permute) and stage B sequence
side (predecessor delta, rc bits) against scalce_tpu's device stages on
the same parsed blocks (JAX on CPU).  Every comparison is exact.  L =
4096 is left out: the reference's delta unrolls with W = L/16 and takes
minutes to compile on the CPU at W = 256."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalce_tpu.io import fastq
from scalce_tpu.pipeline import encode as ref_encode
from scalce_tpu.utils.synth import synth_fastq
from scalce_tpu_torch import convert
from scalce_tpu_torch.pipeline import encode

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

K, SEED = 12, 0x5CA1CE
B = 256


def _parsed_block(tmp_path, L, ragged):
    """A partial block (230 of 256 rows) of overlapping reads from a
    small genome (deep buckets: best-of-4 choices, shifts, ties), with N
    bases and, when ragged, variable lengths."""
    data = synth_fastq(230, L - 28, seed=L + ragged, genome_len=3 * L,
                       var_len=ragged, n_rate=0.01, rc_rate=0.3)
    path = os.path.join(tmp_path, "in.fastq")
    with open(path, "wb") as f:
        f.write(data)
    return next(fastq.iter_blocks(path, B, L))


@pytest.mark.parametrize("L,ragged", [(128, False), (128, True),
                                      (512, False), (512, True)])
def test_stage_a_and_delta_match_reference(tmp_path, L, ragged):
    block = _parsed_block(tmp_path, L, ragged)
    n = block.n_reads
    packed = ref_encode._host_pack(block.seq)
    ref_a = ref_encode._device_stage_a(
        jnp.asarray(packed), jnp.asarray(block.qual),
        jnp.asarray(block.lengths), jnp.int32(n),
        jnp.asarray(ref_encode._pad_exc(block.exc_pos.astype(np.int32),
                                        B * L)),
        jnp.zeros(1, jnp.uint32), K, SEED)
    x = convert.from_reference({"seq": packed, "qual": block.qual,
                                "len": block.lengths, "exc": block.exc_pos},
                               "cpu")
    got_a = encode._device_stage_a(x["seq"], x["qual"], x["len"], n,
                                   x["exc"], K, SEED)
    names = ("perm", "codes_s", "qual_s", "len_s", "ck_s", "cp_s", "rc_s")
    for name, g, r in zip(names, got_a, ref_a):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)
    assert np.asarray(ref_a[6]).any()                  # both strands occur

    ref_delta = ref_encode._delta_seq(ref_a[1], ref_a[3], ref_a[4],
                                      ref_a[5], jnp.int32(n))
    ref_delta["rc_bits"] = ref_encode._pack_bits(ref_a[6])
    got_delta = encode._delta_seq(got_a[1], got_a[3], got_a[4], got_a[5], n)
    got_delta["rc_bits"] = encode._pack_bits(got_a[6])
    for name in ("mask_bits", "shifts", "pred_k", "lit_packed", "n_lits",
                 "rc_bits"):
        np.testing.assert_array_equal(
            got_delta[name].numpy(), np.asarray(ref_delta[name]),
            err_msg=name)
    shifts = np.asarray(ref_delta["shifts"])
    assert (shifts != 0).any() and (np.asarray(ref_delta["pred_k"]) > 0).any()
    assert 0 < int(ref_delta["n_lits"]) < int(block.lengths.sum())
