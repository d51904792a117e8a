"""K1: the canonical core rank of each read, from its bases.

Port of ``scalce_tpu/ops/core_pallas.py::rank_argmin_pallas`` together
with its producers, the rolling k-mer grid and the window mask
(``core_match.rolling_kmers`` and ``window_invalid`` in the reference,
which leaves them to fused XLA elementwise ops).  The CUDA kernel is
``csrc/core_rank.cu``; :func:`core_rank_codes` takes the uint8 ``[B, L]``
codes, the bool ``[B, L]`` exception mask and the lengths, and returns
the Pallas function's six values ``(bf, pf, br, pfw, kf, kr)``, u32 in
int64 tensors (``ops/bitops.py``).  :func:`rank_argmin_plain` keeps the
Pallas function's contract on the k-mer grid.

With ``rank_lut`` (the explicit dictionaries of ``models/core_dict.py``,
``dict_mode`` lut or lcp: u32 ranks of all ``4^k`` k-mers as int32 bits,
k <= 12) a k-mer ranks ``rank_lut[kmer]`` in place of ``mix32``, as the
reference's XLA path does (``scalce_tpu/ops/core_match.py:181-196``; its
Pallas kernel takes the hash only).  The kernel's LUT variant is a
compile-time branch of the same kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from scalce_tpu_torch.ops import _cuda
from scalce_tpu_torch.ops.bitops import (U32_MAX, from_u32_bits, mix32,
                                         rev_lanes_u32)

SOURCE = "scalce_tpu_torch/csrc/core_rank.cu"
REPLACES = "scalce_tpu/ops/core_pallas.py:130"


def rolling_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """uint8 ``[B, L]`` codes -> big-endian 2-bit k-mer at every start
    position, u32 in int64 ``[B, L - k + 1]``."""
    P = codes.shape[1] - k + 1
    acc = torch.zeros((codes.shape[0], P), dtype=torch.int64,
                      device=codes.device)
    for i in range(k):
        acc |= codes[:, i:i + P].to(torch.int64) << (2 * (k - 1 - i))
    return acc


def window_invalid(exc: torch.Tensor, lengths: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Bool ``[B, P]``: the window at p runs past the read's end or
    covers a non-ACGT exception."""
    B, L = exc.shape
    P = L - k + 1
    csum = torch.zeros((B, L + 1), dtype=torch.int32, device=exc.device)
    csum[:, 1:] = torch.cumsum(exc.to(torch.int32), dim=1)
    any_exc = (csum[:, k:] - csum[:, :P]) > 0
    pos = torch.arange(P, dtype=torch.int64, device=exc.device)[None, :]
    return any_exc | (pos > (lengths.to(torch.int64)[:, None] - k))


def revcomp_kmer(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of 2-bit big-endian k-mers (u32 in int64)."""
    return rev_lanes_u32((~kmers) & 0xFFFFFFFF) >> (32 - 2 * k)


def rank_argmin_plain(kmers: torch.Tensor, invalid: torch.Tensor, k: int,
                      seed: int, rank_lut: Optional[torch.Tensor] = None):
    """Per row of the k-mer grid ``[B, P]`` (the Pallas function's
    contract): (min forward rank, its first position, min
    reverse-complement rank, its last forward position, forward k-mer at
    pf, RC k-mer at pfw); invalid windows rank ``U32_MAX``.  Ranks are
    ``mix32``, or ``rank_lut``'s entries when it is given."""
    P = kmers.shape[1]
    rkm = revcomp_kmer(kmers, k)
    if rank_lut is None:
        rf, rr = mix32(kmers, seed), mix32(rkm, seed)
    else:
        rf = from_u32_bits(rank_lut[kmers])
        rr = from_u32_bits(rank_lut[rkm])
    rank_f = torch.where(invalid, U32_MAX, rf)
    rank_r = torch.where(invalid, U32_MAX, rr)
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


def core_rank_codes_plain(codes: torch.Tensor, exc: torch.Tensor,
                          lengths: torch.Tensor, k: int, seed: int,
                          rank_lut: Optional[torch.Tensor] = None):
    """Plain torch version of :func:`core_rank_codes`."""
    return rank_argmin_plain(rolling_kmers(codes, k),
                             window_invalid(exc, lengths, k), k, seed,
                             rank_lut)


def prepare(codes: torch.Tensor, exc: torch.Tensor, lengths: torch.Tensor,
            k: int, seed: int, rank_lut: Optional[torch.Tensor] = None):
    """The CUDA path of :func:`core_rank_codes` up to the launch.
    Returns ``(launch, result)``: each ``launch()`` runs the kernel once;
    ``result()`` gives :func:`core_rank_codes`'s return value."""
    B, L = codes.shape
    if not 1 <= k <= 16:
        raise ValueError(f"core_rank_codes: k = {k} outside 1..16")
    if L - k + 1 < 1:
        raise ValueError("core_rank_codes: no k-mer positions")
    ln = lengths.to(torch.int64)
    _cuda.require(codes, "codes", torch.uint8, (B, L))
    _cuda.require(exc, "exc", torch.bool, (B, L), codes.device)
    _cuda.require(ln, "lengths", torch.int64, (B,), codes.device)
    if rank_lut is not None:
        if k > 12:
            raise ValueError(f"core_rank_codes: a rank LUT needs k <= 12, "
                             f"got {k}")
        _cuda.require(rank_lut, "rank_lut", torch.int32, (4 ** k,),
                      codes.device)
    out = torch.empty((6, B), dtype=torch.int64, device=codes.device)

    def launch():
        if rank_lut is None:
            _cuda.launch("scalce_core_rank", codes.device, codes.data_ptr(),
                         exc.data_ptr(), ln.data_ptr(), B, L, k,
                         seed & 0xFFFFFFFF, out.data_ptr())
        else:
            _cuda.launch("scalce_core_rank_lut", codes.device,
                         codes.data_ptr(), exc.data_ptr(), ln.data_ptr(), B,
                         L, k, rank_lut.data_ptr(), out.data_ptr())
    return launch, lambda: tuple(out)


def core_rank_codes(codes: torch.Tensor, exc: torch.Tensor,
                    lengths: torch.Tensor, k: int, seed: int,
                    rank_lut: Optional[torch.Tensor] = None):
    """Per read: (min forward rank, its first position, min
    reverse-complement rank, its last forward position, forward k-mer at
    pf, RC k-mer at pfw) over the k-mer windows of uint8 ``codes`` (0..3)
    that lie inside the read and cover no ``exc`` cell; ranks are
    ``mix32`` with ``seed``, or ``rank_lut``'s (int32 ``[4^k]``).  CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/core_rank.cu``."""
    if codes.device.type == "cpu":
        return core_rank_codes_plain(codes, exc, lengths, k, seed, rank_lut)
    launch, result = prepare(codes, exc, lengths, k, seed, rank_lut)
    launch()
    core_rank_codes.launches += 1
    return result()


core_rank_codes.launches = 0
