"""K6: flat histogram of cell indices.

Port of ``scalce_tpu/ops/hist_pallas.py::histogram_pallas``; the CUDA
kernel is ``csrc/histogram.cu``.  ``ops/rans.py::context_histogram``
counts (context, symbol) cells with it; the data-parallel quality path
counts a whole group of blocks in one launch
(``streams/qualities.py::group_histogram``).
"""

from __future__ import annotations

import torch

from scalce_tpu_torch.ops import _cuda

SOURCE = "scalce_tpu_torch/csrc/histogram.cu"
REPLACES = "scalce_tpu/ops/hist_pallas.py:90"


def histogram_plain(idx: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Plain torch version of :func:`histogram`."""
    return torch.bincount(idx.reshape(-1), minlength=n_cells).to(torch.int32)


def histogram(idx: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Count each cell index: i32 ``[n_cells]`` from indices in
    ``[0, n_cells)`` (any shape, int64) — ``zeros.at[idx].add(1)``.  CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/histogram.cu``."""
    if idx.device.type == "cpu":
        return histogram_plain(idx, n_cells)
    launch, hist = prepare(idx, n_cells)
    launch()
    histogram.launches += 1
    return hist


def prepare(idx: torch.Tensor, n_cells: int):
    """The CUDA path of :func:`histogram` up to the launch.  Returns
    ``(launch, hist)``: each ``launch()`` zeroes ``hist`` and runs the
    kernel once into it."""
    i32 = idx.reshape(-1).to(torch.int32).contiguous()
    dev = i32.device
    _cuda.require(i32, "idx", torch.int32, device=dev)
    hist = torch.empty(n_cells, dtype=torch.int32, device=dev)

    def launch():
        hist.zero_()
        _cuda.launch("scalce_histogram", dev, i32.data_ptr(), i32.numel(),
                     n_cells, hist.data_ptr())
    return launch, hist


histogram.launches = 0
