"""K4: quality rANS decode over D stacked blocks.

Port of ``scalce_tpu/ops/rans_decode_pallas.py::decode_scan_pallas``;
the CUDA kernel is ``csrc/rans_decode.cu``.  :func:`decode_quals` gives
the blocks' uint8 quality grids directly (what the decompress path
needs); :func:`decode_scan` keeps the Pallas function's signature and
output (decoded symbols ``[D, T, N]``).
"""

from __future__ import annotations

import torch

from scalce_tpu_torch.ops import _cuda, rans
from scalce_tpu_torch.ops.bitops import to_u32_bits

SOURCE = "scalce_tpu_torch/csrc/rans_decode.cu"
REPLACES = "scalce_tpu/ops/rans_decode_pallas.py:230"
QUAL_OFFSET = 33


def decode_scan_plain(states: torch.Tensor, words: torch.Tensor,
                      freq: torch.Tensor, lengths: torch.Tensor,
                      order: int, T: int, L: int) -> torch.Tensor:
    """Plain torch version of :func:`decode_scan`: the generic lane
    decoder of ``ops/rans.py`` driven by the quality context model."""
    # imported here: streams/qualities.py imports this module
    from scalce_tpu_torch.streams.qualities import _ctx_from, _pos_bucket
    D, N = states.shape
    C = freq.shape[1]
    k = T // L
    dev = states.device
    cum = rans.cum_rows(freq).reshape(D * C, -1)
    lane_lens = lengths.to(torch.int64).reshape(D * N, k)
    row0 = (torch.arange(D, device=dev) * C).repeat_interleave(N)
    cols = torch.arange(L, dtype=torch.int64, device=dev)
    pbs = _pos_bucket(cols, order)

    def row_fn(t, prev1, prev2):
        col = t % L
        valid = col < lane_lens[:, t // L]
        c = cols[col]
        ctx = _ctx_from(prev1, prev2, pbs[col], c == 0, c == 1, valid, order)
        return row0 + ctx, valid

    words = words.reshape(D * N, -1).to(torch.int64) & 0xFFFF
    syms = rans.rans_decode(states.reshape(-1), words, cum, row_fn,
                            T)                               # [T, D*N]
    return syms.reshape(T, D, N).permute(1, 0, 2).contiguous()


def decode_quals_plain(states: torch.Tensor, words: torch.Tensor,
                       freq: torch.Tensor, lengths: torch.Tensor,
                       order: int, T: int, L: int) -> torch.Tensor:
    """Plain torch version of :func:`decode_quals`."""
    from scalce_tpu_torch.streams.qualities import _qual_from_syms
    D, N = states.shape
    B = N * T // L
    syms = decode_scan_plain(states, words, freq, lengths, order, T, L)
    return _qual_from_syms(syms, lengths, T, B, L).reshape(D, B * L)


def staged_table(freq: torch.Tensor, order: int) -> torch.Tensor:
    """The table the kernel stages, from freq ``[D, C, 94]``: each row's
    exclusive cumulative frequencies, its total and a pad as int16, in
    the layout of ``rans.bucket_slabs``: ``[D, C*96]``."""
    # imported here: streams/qualities.py imports this module
    from scalce_tpu_torch.streams.qualities import _slab_spec
    D, C, n_syms = freq.shape
    cum16 = torch.zeros((D, C, 96), dtype=torch.int16, device=freq.device)
    cum16[..., 1:n_syms + 1] = torch.cumsum(freq, dim=-1)
    return rans.bucket_slabs(cum16, _slab_spec(order)[0])


def prepare(states: torch.Tensor, words: torch.Tensor, freq: torch.Tensor,
            lengths: torch.Tensor, order: int, T: int, L: int):
    """The CUDA path of :func:`decode_quals` up to the launch: checks,
    the staged tables, the output.  Returns ``(launch, out)``: each
    ``launch()`` runs the kernel once into ``out``."""
    D, N = states.shape
    W = words.shape[2]
    C, n_syms = freq.shape[1:]
    if order not in (1, 2, 3) or T % L or n_syms != 94 or W % 4 or W < 4:
        raise ValueError("decode_quals: need order 1/2/3, L | T, 94 "
                         "symbols, a word stride W >= 4, W % 4 == 0")
    st = to_u32_bits(states)
    dev = st.device
    w16 = words.to(torch.int16).contiguous()       # no copy if int16
    lens = lengths.to(torch.int32).contiguous()
    cum16 = staged_table(freq, order)
    _cuda.require(st, "states", torch.int32, (D, N))
    _cuda.require(w16, "words", torch.int16, (D, N, W), dev)
    _cuda.require(cum16, "freq", torch.int16, (D, C * 96), dev)
    _cuda.require(lens, "lengths", torch.int32, (D, N * T // L), dev)
    out = torch.empty((D, N * T), dtype=torch.uint8, device=dev)

    def launch():
        _cuda.launch("scalce_rans_decode", dev, st.data_ptr(),
                     w16.data_ptr(), cum16.data_ptr(), lens.data_ptr(), D, N,
                     W, C, T, L, order, out.data_ptr())
    return launch, out


def decode_quals(states: torch.Tensor, words: torch.Tensor,
                 freq: torch.Tensor, lengths: torch.Tensor, order: int,
                 T: int, L: int) -> torch.Tensor:
    """Decode D blocks' quality grids.

    states u32 ``[D, N]`` (int64); words u16 ``[D, N, W]`` (int16 or
    int32) per-lane streams; freq u32 ``[D, C, 94]`` (int64) stored tables;
    lengths ``[D, B]`` with ``B = N*T/L``.  Returns uint8 ``[D, B*L]``:
    block d's ``[B, L]`` quality grid, quality + 33 on a read's cells and
    0 past its length.  CPU tensors take the plain version; CUDA tensors
    launch ``csrc/rans_decode.cu``."""
    if states.device.type == "cpu":
        return decode_quals_plain(states, words, freq, lengths, order, T, L)
    launch, out = prepare(states, words, freq, lengths, order, T, L)
    launch()
    decode_quals.launches += 1
    return out


decode_quals.launches = 0


def decode_scan(states: torch.Tensor, words: torch.Tensor,
                freq: torch.Tensor, lengths: torch.Tensor, order: int,
                T: int, L: int) -> torch.Tensor:
    """Decode D blocks' quality symbols (the Pallas function's contract):
    sym u32 ``[D, T, N]`` (int64), 0 on padding.  CPU tensors take the
    plain version; CUDA tensors go through :func:`decode_quals`."""
    if states.device.type == "cpu":
        return decode_scan_plain(states, words, freq, lengths, order, T, L)
    D, N = states.shape
    q = decode_quals(states, words, freq, lengths, order, T, L)
    q = q.reshape(D, N, T).to(torch.int64)
    return torch.where(q > 0, q - QUAL_OFFSET, 0).transpose(1, 2).contiguous()
