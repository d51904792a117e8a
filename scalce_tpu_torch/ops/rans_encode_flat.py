"""K5: interleaved rANS encode over pre-gathered (f, cum).

Port of ``scalce_tpu/ops/rans_pallas.py::encode_scan_pallas``; the CUDA
kernel is ``csrc/rans_encode_flat.cu``.  ``ops/rans.py::rans_encode``
gathers each symbol's (f, cum) from any flat table and encodes them here;
the data-parallel quality path encodes a whole group of blocks as one set
of lanes (``streams/qualities.py::group_encode``).
"""

from __future__ import annotations

import torch

from scalce_tpu_torch.ops import _cuda, rans
from scalce_tpu_torch.ops.bitops import from_u32_bits, to_u32_bits

SOURCE = "scalce_tpu_torch/csrc/rans_encode_flat.cu"
REPLACES = "scalce_tpu/ops/rans_pallas.py:248"


def encode_scan_flat_plain(f_all: torch.Tensor, c_all: torch.Tensor):
    """Plain torch version of :func:`encode_scan_flat`."""
    T, N = f_all.shape
    x = torch.full((N,), rans.RANS_L, dtype=torch.int64, device=f_all.device)
    words = torch.empty((T, N), dtype=torch.int32, device=f_all.device)
    emits = torch.empty((T, N), dtype=torch.bool, device=f_all.device)
    for t in range(T - 1, -1, -1):
        f = f_all[t]
        # renorm: emit the low 16 bits while x >= f << 20
        emit = (x >> 20) >= f
        words[t] = (x & 0xFFFF).to(torch.int32)
        emits[t] = emit
        x = torch.where(emit, x >> 16, x)
        x = ((x // f) << rans.PROB_BITS) + x % f + c_all[t]
    return x, words, emits


def encode_scan_flat(f_all: torch.Tensor, c_all: torch.Tensor):
    """rANS-encode N lanes of T symbols given each symbol's frequency and
    cumulative frequency, u32 ``[T, N]`` (int64) in data order.  Returns
    ``(states u32 [N], words u16 [T, N] (int32), emits bool [T, N])``,
    time in decode order; the encoder walks t = T-1 .. 0.  CPU tensors
    take the plain version; CUDA tensors launch
    ``csrc/rans_encode_flat.cu``."""
    if f_all.device.type == "cpu":
        return encode_scan_flat_plain(f_all, c_all)
    launch, result = prepare(f_all, c_all)
    launch()
    encode_scan_flat.launches += 1
    return result()


def prepare(f_all: torch.Tensor, c_all: torch.Tensor):
    """The CUDA path of :func:`encode_scan_flat` up to the launch.
    Returns ``(launch, result)``: each ``launch()`` runs the kernel once;
    ``result()`` gives :func:`encode_scan_flat`'s return value."""
    T, N = f_all.shape
    f32, c32 = to_u32_bits(f_all), to_u32_bits(c_all)
    dev = f32.device
    _cuda.require(f32, "f_all", torch.int32, (T, N), dev)
    _cuda.require(c32, "c_all", torch.int32, (T, N), dev)
    states = torch.empty(N, dtype=torch.int32, device=dev)
    words = torch.empty((T, N), dtype=torch.int16, device=dev)
    emits = torch.empty((T, N), dtype=torch.bool, device=dev)

    def launch():
        _cuda.launch("scalce_rans_encode_flat", dev, f32.data_ptr(),
                     c32.data_ptr(), N, T, states.data_ptr(),
                     words.data_ptr(), emits.data_ptr())
    return launch, lambda: (from_u32_bits(states),
                            words.to(torch.int32) & 0xFFFF, emits)


encode_scan_flat.launches = 0
