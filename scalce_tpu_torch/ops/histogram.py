"""K6: histogram of D blocks' (context, symbol) cells, and the flat
histogram of cell indices.

Port of ``scalce_tpu/ops/hist_pallas.py::histogram_pallas`` together with
what fed it on the data-parallel path; the CUDA kernel is
``csrc/histogram.cu``.  :func:`grid_histogram` counts a group's blocks
straight from their int64 grids, each block into its own table
(``streams/qualities.py::group_histogram``, ``rans.context_histogram``);
:func:`histogram` counts flat int64 indices (the lossy histogram
all-reduce, ``parallel/mesh.py::lossy_hist_allreduce``).
"""

from __future__ import annotations

import torch

from scalce_tpu_torch.ops import _cuda
from scalce_tpu_torch.ops.rans import stacked_rows

SOURCE = "scalce_tpu_torch/csrc/histogram.cu"
REPLACES = "scalce_tpu/ops/hist_pallas.py:90"


def histogram_plain(idx: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Plain torch version of :func:`histogram`: the Pallas function's
    contract."""
    return torch.bincount(idx.reshape(-1), minlength=n_cells).to(torch.int32)


def histogram(idx: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Count each cell index: i32 ``[n_cells]`` from int64 indices in
    ``[0, n_cells)`` (any shape) — ``zeros.at[idx].add(1)``.  CPU tensors
    take the plain version; CUDA tensors launch ``csrc/histogram.cu``."""
    if idx.device.type == "cpu":
        return histogram_plain(idx, n_cells)
    launch, hist = prepare(idx, n_cells)
    launch()
    histogram.launches += 1
    return hist


histogram.launches = 0


def prepare(idx: torch.Tensor, n_cells: int):
    """The CUDA path of :func:`histogram` up to the launch.  Returns
    ``(launch, hist)``: each ``launch()`` zeroes ``hist`` and runs the
    kernel once into it."""
    flat = idx.reshape(-1)
    dev = flat.device
    _cuda.require(flat, "idx", torch.int64, device=dev)
    hist = torch.empty(n_cells, dtype=torch.int32, device=dev)

    def launch():
        hist.zero_()
        _cuda.launch("scalce_histogram", dev, flat.data_ptr(), flat.numel(),
                     n_cells, hist.data_ptr())
    return launch, hist


def grid_histogram_plain(sym: torch.Tensor, ctx: torch.Tensor, n_ctx: int,
                         n_syms: int) -> torch.Tensor:
    """Plain torch version of :func:`grid_histogram`: the flat histogram
    of the stacked cells."""
    D = sym.shape[0]
    idx = stacked_rows(ctx, n_ctx) * n_syms + sym
    return histogram_plain(idx, D * n_ctx * n_syms)


def grid_histogram(sym: torch.Tensor, ctx: torch.Tensor, n_ctx: int,
                   n_syms: int) -> torch.Tensor:
    """(ctx, sym) histograms of D blocks' grids ``[D, ...]`` (u32 in
    int64, ``ctx < n_ctx`` and ``sym < n_syms``) -> i32
    ``[D * n_ctx * n_syms]``, block d's cell (c, s) at
    ``(d * n_ctx + c) * n_syms + s``.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/histogram.cu`` once, on the
    grids as they are."""
    if sym.device.type == "cpu":
        return grid_histogram_plain(sym, ctx, n_ctx, n_syms)
    launch, hist = prepare_grids(sym, ctx, n_ctx, n_syms)
    launch()
    grid_histogram.launches += 1
    return hist


grid_histogram.launches = 0


def prepare_grids(sym: torch.Tensor, ctx: torch.Tensor, n_ctx: int,
                  n_syms: int):
    """The CUDA path of :func:`grid_histogram` up to the launch.  Returns
    ``(launch, hist)``: each ``launch()`` zeroes ``hist`` and runs the
    kernel once into it."""
    D = sym.shape[0]
    dev = sym.device
    _cuda.require(sym, "sym", torch.int64, device=dev)
    _cuda.require(ctx, "ctx", torch.int64, sym.shape, dev)
    hist = torch.empty(D * n_ctx * n_syms, dtype=torch.int32, device=dev)

    def launch():
        hist.zero_()
        _cuda.launch("scalce_histogram_grids", dev, sym.data_ptr(),
                     ctx.data_ptr(), D, sym.numel() // max(D, 1), n_ctx,
                     n_syms, hist.data_ptr())
    return launch, hist
