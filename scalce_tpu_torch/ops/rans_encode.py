"""K3: interleaved rANS encode of a quality grid.

Port of ``scalce_tpu/ops/rans_pallas.py::encode_scan_tbl_pallas``; the
CUDA kernel is ``csrc/rans_encode.cu``.  Takes the grids and tables
directly — the reference's ``build_encode_slabs`` bf16 byte planes
existed only for the TPU's matrix unit.  On the card the words come out
as int16 holding the u16 bits, K8's feed; the plain version keeps the
reference's int32.
"""

from __future__ import annotations

import torch

from scalce_tpu_torch.ops import _cuda, rans
from scalce_tpu_torch.ops.bitops import from_u32_bits, to_u32_bits
from scalce_tpu_torch.ops.rans_encode_flat import encode_scan_flat_plain

SOURCE = "scalce_tpu_torch/csrc/rans_encode.cu"
REPLACES = "scalce_tpu/ops/rans_pallas.py:164"


def encode_scan_plain(sym: torch.Tensor, ctx: torch.Tensor,
                      freq: torch.Tensor, cum: torch.Tensor, T: int,
                      order: int):
    """Plain torch version of :func:`encode_scan` (any context grid:
    ``order`` is not needed; words as int32)."""
    return encode_scan_flat_plain(*rans.gather_tables(
        sym.reshape(-1), ctx.reshape(-1), freq.reshape(-1), cum.reshape(-1),
        freq.shape[1], T))


def staged_table(freq: torch.Tensor, cum: torch.Tensor, order: int
                 ) -> torch.Tensor:
    """The table the kernel stages: each row's exclusive cumulative
    frequencies and its total as int16 (96 per row, one pad), in the
    layout of ``rans.bucket_slabs``: ``[C*96]``.  The kernel takes f as
    the difference of neighbours, so ``cum`` must be ``freq``'s exclusive
    prefix sums, as ``entropy.device_normalize`` gives them."""
    # imported here: streams/qualities.py imports this module
    from scalce_tpu_torch.streams.qualities import _slab_spec
    C, n_syms = freq.shape
    tab = torch.zeros((C, 96), dtype=torch.int16, device=freq.device)
    tab[:, :n_syms] = cum
    tab[:, n_syms] = cum[:, -1] + freq[:, -1]
    return rans.bucket_slabs(tab, _slab_spec(order)[0])


def prepare(sym: torch.Tensor, ctx: torch.Tensor, freq: torch.Tensor,
            cum: torch.Tensor, T: int, order: int):
    """The CUDA path of :func:`encode_scan` up to the launch: checks,
    the staged table, the outputs.  Returns ``(launch, result)``: each
    ``launch()`` runs the kernel once; ``result()`` gives
    :func:`encode_scan`'s return value."""
    # imported here: streams/qualities.py imports this module
    from scalce_tpu_torch.streams.qualities import _slab_spec
    B, L = sym.shape
    C, n_syms = freq.shape
    if (B * L) % T or T % L or n_syms != 94:
        raise ValueError("encode_scan: need L | T, T | B*L, 94 symbols")
    N = B * L // T
    dev = sym.device
    R, PB, cw = _slab_spec(order)
    if C != 1 + PB * R:
        raise ValueError(f"encode_scan: {C} contexts, order {order} has "
                         f"{1 + PB * R}")
    tab = staged_table(freq, cum, order)
    for name, g in (("sym", sym), ("ctx", ctx)):
        # the int64 grids as stage B leaves them; the kernel reads cell
        # pairs with 16-byte loads
        _cuda.require(g, name, torch.int64, (B, L), dev)
        if g.data_ptr() % 16:
            raise ValueError(f"encode_scan: {name} not 16-byte aligned")
    _cuda.require(tab, "freq", torch.int16, (C * 96,), dev)
    states = torch.empty(N, dtype=torch.int32, device=dev)
    words = torch.empty((T, N), dtype=torch.int16, device=dev)
    emits = torch.empty((T, N), dtype=torch.bool, device=dev)

    def launch():
        _cuda.launch("scalce_rans_encode", dev, sym.data_ptr(),
                     ctx.data_ptr(), tab.data_ptr(), N, T, L, R, PB, cw,
                     states.data_ptr(), words.data_ptr(), emits.data_ptr())
    return launch, lambda: (from_u32_bits(states), words, emits)


def encode_scan(sym: torch.Tensor, ctx: torch.Tensor, freq: torch.Tensor,
                cum: torch.Tensor, T: int, order: int):
    """rANS-encode ``[B, L]`` symbol/context grids (u32 in int64) of the
    quality context model of ``order`` with ``[C, n_syms]`` tables in
    ``N = B*L/T`` lanes of T symbols.  Returns ``(states u32 [N], words
    u16 [T, N], emits bool [T, N])``, time in decode order — what
    ``rans.rans_encode`` returns.  CPU tensors take the plain version
    (words as int32); CUDA tensors launch ``csrc/rans_encode.cu``, which
    writes the words as int16 holding the u16 bits, the form K8
    (``ops/compact.py``) reads and the download takes."""
    if sym.device.type == "cpu":
        return encode_scan_plain(sym, ctx, freq, cum, T, order)
    launch, result = prepare(sym, ctx, freq, cum, T, order)
    launch()
    encode_scan.launches += 1
    return result()


encode_scan.launches = 0


def divmod_recip(x: torch.Tensor, f: torch.Tensor):
    """``(x // f, x % f)`` for u32 ``x < f << 20`` and ``1 <= f <= 4096``
    (int64 tensors on a card) through K3's reciprocal divide: what the
    kernel computes in place of ``x / f``."""
    x32, f32 = to_u32_bits(x), to_u32_bits(f)
    dev = x32.device
    _cuda.require(x32, "x", torch.int32, device=dev)
    _cuda.require(f32, "f", torch.int32, x32.shape, dev)
    q = torch.empty_like(x32)
    r = torch.empty_like(x32)
    _cuda.launch("scalce_divmod_recip", dev, x32.data_ptr(), f32.data_ptr(),
                 x32.numel(), q.data_ptr(), r.data_ptr())
    return from_u32_bits(q), from_u32_bits(r)
