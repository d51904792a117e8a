"""K3: interleaved rANS encode of a quality grid.

Port of ``scalce_tpu/ops/rans_pallas.py::encode_scan_tbl_pallas``; the
CUDA kernel is ``csrc/rans_encode.cu``.  Takes the grids and tables
directly — the reference's ``build_encode_slabs`` bf16 byte planes
existed only for the TPU's matrix unit.
"""

from __future__ import annotations

import torch

from scalce_tpu_torch.ops import _cuda, rans
from scalce_tpu_torch.ops.bitops import from_u32_bits, to_u32_bits
from scalce_tpu_torch.ops.rans_encode_flat import encode_scan_flat_plain

SOURCE = "scalce_tpu_torch/csrc/rans_encode.cu"
REPLACES = "scalce_tpu/ops/rans_pallas.py:164"


def encode_scan_plain(sym: torch.Tensor, ctx: torch.Tensor,
                      freq: torch.Tensor, cum: torch.Tensor, T: int):
    """Plain torch version of :func:`encode_scan`."""
    return encode_scan_flat_plain(*rans.gather_tables(
        sym.reshape(-1), ctx.reshape(-1), freq.reshape(-1), cum.reshape(-1),
        freq.shape[1], T))


def encode_scan(sym: torch.Tensor, ctx: torch.Tensor, freq: torch.Tensor,
                cum: torch.Tensor, T: int):
    """rANS-encode ``[B, L]`` symbol/context grids (u32 in int64) with
    ``[C, n_syms]`` tables in ``N = B*L/T`` lanes of T symbols.  Returns
    ``(states u32 [N], words u16 [T, N] (int32), emits bool [T, N])``,
    time in decode order — what ``rans.rans_encode`` returns.  CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/rans_encode.cu``."""
    if sym.device.type == "cpu":
        return encode_scan_plain(sym, ctx, freq, cum, T)
    B, L = sym.shape
    C, n_syms = freq.shape
    if (B * L) % T:
        raise ValueError("encode_scan: B*L must be a multiple of T")
    N = B * L // T
    s32, c32 = to_u32_bits(sym), to_u32_bits(ctx)
    f32, cm32 = to_u32_bits(freq), to_u32_bits(cum)
    dev = s32.device
    _cuda.require(s32, "sym", torch.int32, (B, L))
    _cuda.require(c32, "ctx", torch.int32, (B, L), dev)
    _cuda.require(f32, "freq", torch.int32, (C, n_syms), dev)
    _cuda.require(cm32, "cum", torch.int32, (C, n_syms), dev)
    states = torch.empty(N, dtype=torch.int32, device=dev)
    words = torch.empty((T, N), dtype=torch.int16, device=dev)
    emits = torch.empty((T, N), dtype=torch.bool, device=dev)
    _cuda.launch("scalce_rans_encode", dev, s32.data_ptr(), c32.data_ptr(),
                 f32.data_ptr(), cm32.data_ptr(), n_syms, N, T,
                 states.data_ptr(), words.data_ptr(), emits.data_ptr())
    encode_scan.launches += 1
    return (from_u32_bits(states), words.to(torch.int32) & 0xFFFF, emits)


encode_scan.launches = 0
