"""K5: interleaved rANS encode of D blocks' grids, each block against its
own flat table.

Port of ``scalce_tpu/ops/rans_pallas.py::encode_scan_pallas`` together
with what fed it (the reference's ``rans.rans_encode``: the table gather
and its transposes); the CUDA kernel is ``csrc/rans_encode_flat.cu``.
The data-parallel quality path encodes a whole group of blocks as one set
of lanes (``streams/qualities.py::group_encode``); ``rans.rans_encode``
is the one-block case.  :func:`encode_scan_flat_plain` keeps the Pallas
function's contract on pre-gathered (f, cum), words as int32; on the card
the words come out as int16 holding the u16 bits, K8's feed.
"""

from __future__ import annotations

import torch

from scalce_tpu_torch.ops import _cuda, rans
from scalce_tpu_torch.ops.bitops import from_u32_bits

SOURCE = "scalce_tpu_torch/csrc/rans_encode_flat.cu"
REPLACES = "scalce_tpu/ops/rans_pallas.py:248"


def encode_scan_flat_plain(f_all: torch.Tensor, c_all: torch.Tensor):
    """rANS-encode N lanes of T symbols given each symbol's frequency and
    cumulative frequency, u32 ``[T, N]`` (int64) in data order (the
    Pallas function's contract).  Returns ``(states u32 [N], words u16
    [T, N] (int32), emits bool [T, N])``, time in decode order; the
    encoder walks t = T-1 .. 0."""
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


def encode_grids_plain(sym: torch.Tensor, ctx: torch.Tensor,
                       freq: torch.Tensor, cum: torch.Tensor, T: int):
    """Plain torch version of :func:`encode_grids`: the gather from the
    stacked tables, then the Pallas contract."""
    _, C, n_syms = freq.shape
    return encode_scan_flat_plain(*rans.gather_tables(
        sym.reshape(-1), rans.stacked_rows(ctx, C).reshape(-1),
        freq.reshape(-1), cum.reshape(-1), n_syms, T))


def encode_grids(sym: torch.Tensor, ctx: torch.Tensor, freq: torch.Tensor,
                 cum: torch.Tensor, T: int):
    """rANS-encode D blocks' symbol and context grids ``[D, ...]`` (u32 in
    int64, S cells per block, T | S) in ``D*S/T`` lanes of T cells, block
    d's cells against its tables ``freq[d]``, ``cum[d]`` (u32 ``[D, C,
    n_syms]``, ``cum`` the exclusive prefix sums of ``freq``).  Returns
    ``(states u32 [D*S/T], words u16 [T, D*S/T], emits bool [T,
    D*S/T])``, time in decode order — ``rans.rans_encode`` over the
    stacked tables.  CPU tensors take the plain version (words as
    int32); CUDA tensors launch ``csrc/rans_encode_flat.cu`` once, on
    the grids as they are, which writes the words as int16 holding the
    u16 bits (what K8 reads)."""
    if sym.device.type == "cpu":
        return encode_grids_plain(sym, ctx, freq, cum, T)
    launch, result = prepare(sym, ctx, freq, cum, T)
    launch()
    encode_grids.launches += 1
    return result()


encode_grids.launches = 0


def packed_table(freq: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """The table the kernel reads: ``f << 16 | cum`` per entry, int32
    ``[D*C*n_syms]`` (a pass over the tables, not over the grids)."""
    return ((freq << 16) | cum).to(torch.int32).reshape(-1)


def prepare(sym: torch.Tensor, ctx: torch.Tensor, freq: torch.Tensor,
            cum: torch.Tensor, T: int):
    """The CUDA path of :func:`encode_grids` up to the launch: checks,
    the packed table, the outputs.  Returns ``(launch, result)``: each
    ``launch()`` runs the kernel once; ``result()`` gives
    :func:`encode_grids`' return value."""
    D = sym.shape[0]
    _, C, n_syms = freq.shape
    cells = sym.numel() // D
    if cells % T or tuple(freq.shape) != (D, C, n_syms) \
            or freq.shape != cum.shape:
        raise ValueError("encode_grids: need T | cells per block and "
                         "tables [D, C, n_syms]")
    dev = sym.device
    for name, g in (("sym", sym), ("ctx", ctx)):
        # the int64 grids as stage B leaves them; with T even the kernel
        # reads cell pairs with 16-byte loads
        _cuda.require(g, name, torch.int64, sym.shape, dev)
        if g.data_ptr() % 16:
            raise ValueError(f"encode_grids: {name} not 16-byte aligned")
    tab = packed_table(freq, cum)
    n_lanes = D * cells // T
    states = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    words = torch.empty((T, n_lanes), dtype=torch.int16, device=dev)
    emits = torch.empty((T, n_lanes), dtype=torch.bool, device=dev)

    def launch():
        _cuda.launch("scalce_rans_encode_flat", dev, sym.data_ptr(),
                     ctx.data_ptr(), tab.data_ptr(), n_lanes, T, cells, C,
                     n_syms, states.data_ptr(), words.data_ptr(),
                     emits.data_ptr())
    return launch, lambda: (from_u32_bits(states), words, emits)
