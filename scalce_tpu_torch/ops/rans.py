"""Interleaved rANS, plain torch (port of ``scalce_tpu/ops/rans.py``).

A block's S symbols are split into ``N = S // T`` lanes, lane n owning
the contiguous span ``[n*T, (n+1)*T)``; every lane is an independent u32
rANS coder with 12-bit probabilities and 16-bit renormalization words.
The generic coder API (:func:`rans_encode` over any flat table,
:func:`context_histogram`) runs kernels K5 (``ops/rans_encode_flat.py``)
and K6 (``ops/histogram.py``), which also take D blocks' grids against
:func:`stacked_rows` of their tables at once; the quality stream's
table-resident scans are K3 (``ops/rans_encode.py``) and K4
(``ops/rans_decode.py``), and :func:`compact_emissions` (either encode's
words per lane) is K8 (``ops/compact.py``).  The TPU's two-step f32
divide and lax.scan formulation are not carried over — torch divides
int64 exactly.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from scalce_tpu_torch.ops.compact import compact_emissions  # noqa: F401 (K8)

PROB_BITS = 12
M_TOTAL = 1 << PROB_BITS
RANS_L = 1 << 16                      # state lower bound
_MASK12 = M_TOTAL - 1


def gather_tables(sym: torch.Tensor, ctx: torch.Tensor,
                  freq_lut: torch.Tensor, cum_lut: torch.Tensor,
                  n_syms: int, T: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each symbol's (f, cum) from flat ``[C * n_syms]`` tables (row =
    ctx), as u32 ``[T, N]`` in data order: lane n's step t at ``[t, n]``
    (sym, ctx: u32 ``[N*T]``, lane-major)."""
    N = sym.shape[0] // T
    idx = ctx * n_syms + sym
    return (freq_lut[idx].reshape(N, T).T.contiguous(),
            cum_lut[idx].reshape(N, T).T.contiguous())


def stacked_rows(ctx: torch.Tensor, n_ctx: int) -> torch.Tensor:
    """Context grids of D blocks ``[D, ...]`` -> rows of the stacked
    ``[D*n_ctx, ...]`` table: block d's context c is row ``d*n_ctx + c``."""
    D = ctx.shape[0]
    off = n_ctx * torch.arange(D, dtype=torch.int64, device=ctx.device)
    return ctx + off.reshape(D, *([1] * (ctx.dim() - 1)))


def rans_encode(sym: torch.Tensor, ctx: torch.Tensor,
                freq_lut: torch.Tensor, cum_lut: torch.Tensor,
                n_syms: int, T: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode ``S = N*T`` symbols in N interleaved lanes.

    sym, ctx: u32 ``[S]`` (int64), lane-major.  freq_lut, cum_lut: u32
    ``[C * n_syms]`` tables (row = ctx).  Returns ``(states u32 [N],
    words u16 [T, N], emits bool [T, N])`` with the time axis in DECODE
    order: kernel K5 on one block (words as int32 on the CPU, as int16
    holding the u16 bits on the card)."""
    # K5's module imports this one for the coder constants
    from scalce_tpu_torch.ops.rans_encode_flat import encode_grids
    C = freq_lut.numel() // n_syms
    return encode_grids(sym[None], ctx[None],
                        freq_lut.reshape(1, C, n_syms),
                        cum_lut.reshape(1, C, n_syms), T)


def context_histogram(sym: torch.Tensor, ctx: torch.Tensor, n_ctx: int,
                      n_syms: int) -> torch.Tensor:
    """Histogram of (ctx, sym) pairs -> i32 ``[n_ctx * n_syms]``: kernel
    K6 on one block."""
    # K6's module imports this one for stacked_rows
    from scalce_tpu_torch.ops.histogram import grid_histogram
    return grid_histogram(sym[None], ctx[None], n_ctx, n_syms)


def cum_rows(freq: torch.Tensor) -> torch.Tensor:
    """``[..., n_syms]`` frequencies -> ``[..., n_syms + 1]`` exclusive
    cumulative frequencies ending in the row total (M_TOTAL)."""
    cum = torch.zeros(freq.shape[:-1] + (freq.shape[-1] + 1,),
                      dtype=freq.dtype, device=freq.device)
    cum[..., 1:] = torch.cumsum(freq, dim=-1)
    return cum


def bucket_slabs(table: torch.Tensor, R: int) -> torch.Tensor:
    """A per-context table ``[..., C, E]`` (row 0, then position buckets
    of R rows: the quality context model) in the layout the quality
    kernels stage: row 0 as it is, then each bucket transposed to
    ``[E, R]``.  The lanes of a warp read one entry each of different rows
    of one bucket, mostly at nearby entries, so they read neighbouring
    shared-memory words instead of rows 192 bytes apart in the same few
    banks.  Returns ``[..., C*E]``."""
    *lead, C, E = table.shape
    buckets = table[..., 1:, :].reshape(*lead, (C - 1) // R, R, E)
    return torch.cat([table[..., 0, :],
                      buckets.transpose(-1, -2).reshape(*lead, -1)], dim=-1)


def rans_decode(states: torch.Tensor, words: torch.Tensor,
                cum: torch.Tensor,
                row_fn: Callable[[int, torch.Tensor, torch.Tensor],
                                 Tuple[torch.Tensor, torch.Tensor]],
                T: int) -> torch.Tensor:
    """Decode T symbols in each of M lanes.

    states: u32 ``[M]`` final encoder states (int64).  words: ``[M, W]``
    per-lane 16-bit streams in decode order.  cum: ``[rows, n_syms+1]``
    table rows from :func:`cum_rows`.  ``row_fn(t, prev1, prev2)``
    returns each lane's table row at step t and whether the lane holds a
    symbol there; prev1/prev2 are the lane's last two decoded symbols.
    The symbol owns ``slot = x & 4095`` among the row's cumulative
    frequencies; a cell that holds no symbol decodes 0 and leaves state
    and cursor alone; a state below 2^16 pulls the lane's next word (0
    past the end of its stream).  Returns sym ``[T, M]`` (int64)."""
    M, W = words.shape
    dev = states.device
    lanes = torch.arange(M, device=dev)
    x = states.clone()
    cursor = torch.zeros(M, dtype=torch.int64, device=dev)
    prev1 = torch.zeros(M, dtype=torch.int64, device=dev)
    prev2 = torch.zeros(M, dtype=torch.int64, device=dev)
    syms = torch.empty((T, M), dtype=torch.int64, device=dev)
    for t in range(T):
        row, valid = row_fn(t, prev1, prev2)
        c = cum[row]                                   # [M, n_syms + 1]
        slot = x & _MASK12
        s = (c[:, 1:-1] <= slot[:, None]).sum(dim=1)
        cm = c.gather(1, s[:, None])[:, 0]
        f = c.gather(1, (s + 1)[:, None])[:, 0] - cm
        x_new = f * (x >> PROB_BITS) + slot - cm
        pull = (x_new < RANS_L) & valid
        w = torch.where(cursor < W, words[lanes, cursor.clamp(max=W - 1)], 0)
        x_new = torch.where(pull, (x_new << 16) | w, x_new)
        x = torch.where(valid, x_new, x)
        cursor = cursor + pull
        s = torch.where(valid, s, 0)
        syms[t] = s
        prev2, prev1 = prev1, s
    return syms
