"""K2: quality pass A — symbol and context grids and their (context,
symbol) histogram, from the quality bytes.

Port of ``scalce_tpu/ops/hist_pallas.py::hist_ctx_slab_pallas`` together
with its producers (the reference's ``sym_ctx_hist`` grids and lossy
remap); the CUDA kernel is ``csrc/hist_ctx.cu``.  The public function is
``streams/qualities.py::sym_ctx_hist``, which owns the context model and
the plain version; this module launches the kernel and keeps
:func:`hist_ctx_plain`, the Pallas function's contract on the grids.
"""

from __future__ import annotations

import torch

from scalce_tpu_torch.ops import _cuda

SOURCE = "scalce_tpu_torch/csrc/hist_ctx.cu"
REPLACES = "scalce_tpu/ops/hist_pallas.py:207"


def hist_ctx_plain(sym: torch.Tensor, ctx: torch.Tensor, R: int, PB: int,
                   n_syms: int = 94) -> torch.Tensor:
    """(ctx, sym) histogram of ``[B, L]`` grids (u32 in int64): i32
    ``[(1 + PB*R) * n_syms]``; ctx = 0 marks padding, counted into cell
    (0, 0)."""
    n_cells = (1 + PB * R) * n_syms
    idx = torch.where(ctx == 0, 0, ctx * n_syms + sym).reshape(-1)
    return torch.bincount(idx, minlength=n_cells).to(torch.int32)


def prepare(qual: torch.Tensor, lengths: torch.Tensor, order: int, R: int,
            PB: int, qual_map=None, histogram: bool = True, out=None):
    """The CUDA path of pass A up to the launch, for context ``order``
    with slab spec ``(R, PB)``.  Returns ``(launch, (sym, ctx, counts))``:
    each ``launch()`` zeroes ``counts`` (None without ``histogram``) and
    runs the kernel once into the three outputs; the grids are ``out =
    (sym, ctx)`` when given (int64 ``[B, L]``, contiguous: a block's
    slices of a group's grids)."""
    B, L = qual.shape
    dev = qual.device
    ln = lengths.to(torch.int64)
    _cuda.require(qual, "qual", torch.uint8, (B, L))
    _cuda.require(ln, "lengths", torch.int64, (B,), dev)
    if qual_map is not None:
        _cuda.require(qual_map, "qual_map", torch.uint8, (256,), dev)
    if out is None:
        out = tuple(torch.empty((B, L), dtype=torch.int64, device=dev)
                    for _ in range(2))
    sym, ctx = out
    _cuda.require(sym, "sym", torch.int64, (B, L), dev)
    _cuda.require(ctx, "ctx", torch.int64, (B, L), dev)
    counts = (torch.empty((1 + PB * R) * 94, dtype=torch.int32, device=dev)
              if histogram else None)

    def launch():
        if counts is not None:
            counts.zero_()
        _cuda.launch("scalce_hist_ctx", dev, qual.data_ptr(), ln.data_ptr(),
                     None if qual_map is None else qual_map.data_ptr(), B, L,
                     order, R, PB, sym.data_ptr(), ctx.data_ptr(),
                     None if counts is None else counts.data_ptr())
    return launch, (sym, ctx, counts)
