"""K1: six per-row reductions over the core matcher's rank grid.

Port of ``scalce_tpu/ops/core_pallas.py::rank_argmin_pallas``; the CUDA
kernel is ``csrc/core_rank.cu``.  Same signature as the Pallas function:
``(kmers [B, P], invalid [B, P], k, seed) -> (bf, pf, br, pfw, kf, kr)``,
u32 values in int64 tensors (``ops/bitops.py``).
"""

from __future__ import annotations

import torch

from scalce_tpu_torch.ops import _cuda
from scalce_tpu_torch.ops.bitops import (U32_MAX, from_u32_bits, mix32,
                                         rev_lanes_u32, to_u32_bits)

SOURCE = "scalce_tpu_torch/csrc/core_rank.cu"
REPLACES = "scalce_tpu/ops/core_pallas.py:130"


def revcomp_kmer(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of 2-bit big-endian k-mers (u32 in int64)."""
    return rev_lanes_u32((~kmers) & 0xFFFFFFFF) >> (32 - 2 * k)


def rank_argmin_plain(kmers: torch.Tensor, invalid: torch.Tensor, k: int,
                      seed: int):
    """Plain torch version of :func:`rank_argmin`."""
    P = kmers.shape[1]
    rkm = revcomp_kmer(kmers, k)
    rank_f = torch.where(invalid, U32_MAX, mix32(kmers, seed))
    rank_r = torch.where(invalid, U32_MAX, mix32(rkm, seed))
    pos = torch.arange(P, dtype=torch.int64, device=kmers.device)[None, :]
    bf = rank_f.min(dim=1).values
    br = rank_r.min(dim=1).values
    # forward ties -> FIRST position; RC ties -> LAST forward position
    # (the first one in the RC frame)
    pf = torch.where(rank_f == bf[:, None], pos, P).min(dim=1).values
    pfw = torch.where(rank_r == br[:, None], pos, -1).max(dim=1).values
    kf = kmers.gather(1, pf[:, None])[:, 0]
    kr = rkm.gather(1, pfw[:, None])[:, 0]
    return bf, pf, br, pfw, kf, kr


def prepare(kmers: torch.Tensor, invalid: torch.Tensor, k: int, seed: int):
    """The CUDA path of :func:`rank_argmin` up to the launch.  Returns
    ``(launch, result)``: each ``launch()`` runs the kernel once;
    ``result()`` gives :func:`rank_argmin`'s return value."""
    B, P = kmers.shape
    if P < 1:
        raise ValueError("rank_argmin: no k-mer positions")
    km = to_u32_bits(kmers)
    bad = invalid.contiguous()
    _cuda.require(km, "kmers", torch.int32, (B, P))
    _cuda.require(bad, "invalid", torch.bool, (B, P), km.device)
    outs = [torch.empty(B, dtype=torch.int32, device=km.device)
            for _ in range(6)]

    def launch():
        _cuda.launch("scalce_core_rank", km.device, km.data_ptr(),
                     bad.data_ptr(), B, P, k, seed & 0xFFFFFFFF,
                     *(o.data_ptr() for o in outs))
    return launch, lambda: tuple(from_u32_bits(o) for o in outs)


def rank_argmin(kmers: torch.Tensor, invalid: torch.Tensor, k: int,
                seed: int):
    """Per row of the rank grid: (min forward rank, its first position,
    min reverse-complement rank, its last forward position, forward
    k-mer at pf, RC k-mer at pfw).  CPU tensors take the plain version;
    CUDA tensors launch ``csrc/core_rank.cu``."""
    if kmers.device.type == "cpu":
        return rank_argmin_plain(kmers, invalid, k, seed)
    launch, result = prepare(kmers, invalid, k, seed)
    launch()
    rank_argmin.launches += 1
    return result()


rank_argmin.launches = 0
