"""K2: the quality model's (context, symbol) histogram.

Port of ``scalce_tpu/ops/hist_pallas.py::hist_ctx_slab_pallas``; the
CUDA kernel is ``csrc/hist_ctx.cu``.
"""

from __future__ import annotations

import torch

from scalce_tpu_torch.ops import _cuda
from scalce_tpu_torch.ops.bitops import to_u32_bits

SOURCE = "scalce_tpu_torch/csrc/hist_ctx.cu"
REPLACES = "scalce_tpu/ops/hist_pallas.py:207"


def hist_ctx_plain(sym: torch.Tensor, ctx: torch.Tensor, R: int, PB: int,
                   n_syms: int = 94) -> torch.Tensor:
    """Plain torch version of :func:`hist_ctx`."""
    n_cells = (1 + PB * R) * n_syms
    idx = torch.where(ctx == 0, 0, ctx * n_syms + sym).reshape(-1)
    return torch.bincount(idx, minlength=n_cells).to(torch.int32)


def hist_ctx(sym: torch.Tensor, ctx: torch.Tensor, R: int, PB: int,
             col_div: int, n_syms: int = 94) -> torch.Tensor:
    """(ctx, sym) histogram of ``[B, L]`` grids (u32 in int64): i32
    ``[(1 + PB*R) * n_syms]``.  ctx = 0 marks padding, counted into cell
    (0, 0); otherwise ctx = 1 + min(col // col_div, PB - 1)*R + prev_idx.
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/hist_ctx.cu``."""
    if sym.device.type == "cpu":
        return hist_ctx_plain(sym, ctx, R, PB, n_syms)
    launch, hist = prepare(sym, ctx, R, PB, col_div, n_syms)
    launch()
    hist_ctx.launches += 1
    return hist


def prepare(sym: torch.Tensor, ctx: torch.Tensor, R: int, PB: int,
            col_div: int, n_syms: int = 94):
    """The CUDA path of :func:`hist_ctx` up to the launch.  Returns
    ``(launch, hist)``: each ``launch()`` zeroes ``hist`` and runs the
    kernel once into it."""
    B, L = sym.shape
    s32, c32 = to_u32_bits(sym), to_u32_bits(ctx)
    _cuda.require(s32, "sym", torch.int32, (B, L))
    _cuda.require(c32, "ctx", torch.int32, (B, L), s32.device)
    n_ctx = 1 + PB * R
    hist = torch.empty(n_ctx * n_syms, dtype=torch.int32, device=s32.device)

    def launch():
        hist.zero_()
        _cuda.launch("scalce_hist_ctx", s32.device, s32.data_ptr(),
                     c32.data_ptr(), B, L, R, PB, col_div, n_syms, n_ctx,
                     hist.data_ptr())
    return launch, hist


hist_ctx.launches = 0
