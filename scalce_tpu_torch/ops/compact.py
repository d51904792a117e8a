"""K8: per-lane compaction of interleaved rANS emissions.

Port of ``scalce_tpu/ops/rans.py::compact_emissions``, which the
reference leaves to XLA inside its pass-B jit (no ``pallas_call``).  The
CUDA kernel is ``csrc/compact.cu``; both pass-B paths call it through
``ops/rans.py::compact_emissions``: ``streams/qualities.py::pass_b``
after K3 (one block) and ``group_encode`` after K5 (a group's lanes).
On the card both encoders hand it their words as int16 holding the u16
bits, and it writes ``packed`` in the same form, the one the download
takes; the plain version takes either width.
"""

from __future__ import annotations

from typing import Tuple

import torch

from scalce_tpu_torch.ops import _cuda

SOURCE = "scalce_tpu_torch/csrc/compact.cu"
REPLACES = "scalce_tpu/ops/rans.py:157"


def compact_emissions_plain(words: torch.Tensor, emits: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`compact_emissions` (``packed`` in
    ``words``' dtype: int32 from the plain encoders, int16 from the
    kernels).  A cumsum gives each emitted word its slot; one scatter
    places it (non-emitted words go to a discarded column)."""
    T, N = words.shape
    et = emits.T
    dst = torch.where(et, torch.cumsum(et, dim=1) - 1, T)
    out = torch.zeros((N, T + 1), dtype=words.dtype, device=words.device)
    out.scatter_(1, dst, words.T)
    return out[:, :T].contiguous(), et.sum(dim=1, dtype=torch.int32)


def compact_emissions(words: torch.Tensor, emits: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane compaction of ``[T, N]`` emissions (u16 words, bool
    emits): ``(packed [N, T], counts i32 [N])`` with lane n's words in
    decode order at ``packed[n, :counts[n]]`` and zeros beyond.  CPU
    tensors take the plain version; CUDA tensors (int16 words holding
    the u16 bits, as K3 and K5 write them) launch ``csrc/compact.cu``,
    which writes ``packed`` in the same form (``qualities.for_download``'s
    narrowing)."""
    if words.device.type == "cpu":
        return compact_emissions_plain(words, emits)
    launch, out = prepare(words, emits)
    launch()
    compact_emissions.launches += 1
    return out


compact_emissions.launches = 0


def prepare(words: torch.Tensor, emits: torch.Tensor):
    """The CUDA path of :func:`compact_emissions` up to the launch.
    Returns ``(launch, (packed, counts))``: each ``launch()`` runs the
    kernel once into them."""
    T, N = words.shape
    dev = words.device
    _cuda.require(words, "words", torch.int16, device=dev)
    _cuda.require(emits, "emits", torch.bool, (T, N), dev)
    packed = torch.empty((N, T), dtype=torch.int16, device=dev)
    counts = torch.empty(N, dtype=torch.int32, device=dev)

    def launch():
        _cuda.launch("scalce_compact", dev, words.data_ptr(),
                     emits.data_ptr(), T, N, packed.data_ptr(),
                     counts.data_ptr())
    return launch, (packed, counts)
