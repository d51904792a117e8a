"""Quality stream codec: context-modelled interleaved rANS (port of
``scalce_tpu/streams/qualities.py``, device placement).

Pass A (:func:`sym_ctx_hist`) builds the symbol and context grids and
their histogram from the quality bytes, through the lossy map if any
(kernel K2, one launch); the tables are normalized on the device;
pass B (:func:`pass_b`) rANS-encodes the grids (kernel K3) and compacts
the emitted words, and :func:`encoded_from_host` gathers each lane's
words once they are on the host; :func:`decode_batch_dispatch` decodes
D blocks' quality grids in one launch (kernel K4) and queues their
download, which :func:`decode_batch_fetch` waits for.  A data-parallel group of D
blocks takes the generic coder path instead: one histogram
(:func:`group_histogram`, kernel K6) and one encode
(:func:`group_encode`, kernel K5), each on the group's grids as K2 wrote
them and each block against its own table.  The host placement (the
CLI's default) is ``streams/qualities_host.py``.  The
container half — :class:`EncodedQuals`, :func:`payload`, :func:`parse`
— is a copy of the reference's.

Context model (shared bit-exactly by encode and decode):

  PAD (ctx 0)  padding cells past a read's length (all mass on symbol 0)
  order 1      ctx = 1 + pos_bucket(col/16, 8)*95 + prev1 (94 = start)
  order 2      8 pos buckets x 25-level prev1 quant x 7-level prev2 quant
  order 3      ctx = 1 + pos_bucket(col/4, 32)*95 + prev1

Lane layout: ``[B, L]`` flattened row-major is lane-major with
``T = k*L``, so every lane owns k whole reads and contexts never cross
lanes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scalce_tpu_torch import container, convert, timing
from scalce_tpu_torch.device import resolve_device
from scalce_tpu_torch.io.fastq import ragged_gather, ragged_scatter
from scalce_tpu_torch.models import entropy
from scalce_tpu_torch.ops import hist, rans
from scalce_tpu_torch.ops.bitops import to_u32_bits
from scalce_tpu_torch.ops.histogram import grid_histogram
from scalce_tpu_torch.ops.rans_decode import decode_quals
from scalce_tpu_torch.ops.rans_encode import encode_scan
from scalce_tpu_torch.ops.rans_encode_flat import encode_grids
from scalce_tpu_torch.transfer import Fetched, Link

N_SYMS = 94          # printable FASTQ quality range
QUAL_OFFSET = 33
_POS_BUCKETS = 8
_PREV1_FULL = 94
_PREV_LEVELS = 24
_PREV2_LEVELS = 7
_POS_BUCKETS32 = 32


def n_contexts(order: int) -> int:
    if order == 1:
        return 1 + _POS_BUCKETS * (_PREV1_FULL + 1)
    if order == 3:
        return 1 + _POS_BUCKETS32 * (_PREV1_FULL + 1)
    return 1 + _POS_BUCKETS * (_PREV_LEVELS + 1) * _PREV2_LEVELS


def pick_T(B: int, L: int, target: int = 1024) -> int:
    """Span length: a multiple of L so lanes own whole reads."""
    k = max(1, target // L)
    k = 1 << (k.bit_length() - 1)          # power of two
    while B % k:
        k >>= 1
    return k * L


def _pos_bucket(col: torch.Tensor, order: int) -> torch.Tensor:
    if order == 3:
        return torch.clamp(col // 4, max=_POS_BUCKETS32 - 1)
    return torch.clamp(col // 16, max=_POS_BUCKETS - 1)


def _ctx_from(prev1, prev2, pb, c0, c1, valid, order: int) -> torch.Tensor:
    """The one context function of the encode grid and the plain decode
    (tensors broadcast; u32 values in int64)."""
    if order == 2:
        pq = torch.where(c0, _PREV_LEVELS,
                         torch.clamp(prev1 >> 2, max=_PREV_LEVELS - 1))
        ctx = pb * (_PREV_LEVELS + 1) + pq
        p2 = torch.where(c0 | c1, _PREV2_LEVELS - 1,
                         torch.clamp(prev2 >> 4, max=_PREV2_LEVELS - 2))
        ctx = ctx * _PREV2_LEVELS + p2
    else:
        pq = torch.where(c0, _PREV1_FULL,
                         torch.clamp(prev1, max=_PREV1_FULL - 1))
        ctx = pb * (_PREV1_FULL + 1) + pq
    return torch.where(valid, ctx + 1, 0)


def _slab_spec(order: int) -> Tuple[int, int, int]:
    """(rows per position bucket R, bucket count PB, bucket column
    width) — ctx = 1 + pos_bucket(col)*R + pidx."""
    if order == 2:
        return ((_PREV_LEVELS + 1) * _PREV2_LEVELS, _POS_BUCKETS, 16)
    if order == 3:
        return (_PREV1_FULL + 1, _POS_BUCKETS32, 4)
    return (_PREV1_FULL + 1, _POS_BUCKETS, 16)


def remap_qualities(qual: torch.Tensor, qual_map: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """A uint8 quality grid through the lossy map (uint8 ``[256]``): one
    gather from the LUT with int32 indices.  None is the identity."""
    if qual_map is None:
        return qual
    idx = qual.reshape(-1).to(torch.int32)
    return qual_map.index_select(0, idx).reshape(qual.shape)


def sym_ctx_grids(qual: torch.Tensor, lengths: torch.Tensor, order: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symbol grid and context grid (u32 in int64 ``[B, L]``) of a
    block's qualities."""
    B, L = qual.shape
    col = torch.arange(L, dtype=torch.int64, device=qual.device)[None, :]
    valid = col < lengths.to(torch.int64)[:, None]
    sym = torch.clamp(qual.to(torch.int64) - QUAL_OFFSET, 0, N_SYMS - 1)
    sym = torch.where(valid, sym, 0)
    prev1 = torch.nn.functional.pad(sym[:, :-1], (1, 0))
    prev2 = torch.nn.functional.pad(sym[:, :-2], (2, 0))
    ctx = _ctx_from(prev1, prev2, _pos_bucket(col, order), col == 0,
                    col == 1, valid, order)
    return sym, ctx


def sym_ctx_hist_plain(qual: torch.Tensor, lengths: torch.Tensor,
                       order: int, qual_map: Optional[torch.Tensor] = None,
                       histogram: bool = True):
    """Plain torch version of :func:`sym_ctx_hist`."""
    sym, ctx = sym_ctx_grids(remap_qualities(qual, qual_map), lengths,
                             order)
    R, PB, _ = _slab_spec(order)
    return sym, ctx, (hist.hist_ctx_plain(sym, ctx, R, PB, N_SYMS)
                      if histogram else None)


def sym_ctx_hist(qual: torch.Tensor, lengths: torch.Tensor, order: int,
                 qual_map: Optional[torch.Tensor] = None,
                 histogram: bool = True, out=None):
    """Pass A of a block's uint8 ``[B, L]`` qualities, through the lossy
    map ``qual_map`` (uint8 ``[256]``; None: lossless): symbol grid and
    context grid (u32 in int64 ``[B, L]``, written into ``out = (sym,
    ctx)`` when given) and, with ``histogram``, their (ctx, sym)
    histogram (i32 ``[n_contexts(order) * 94]``; else None).  CPU
    tensors take the plain version; CUDA tensors launch kernel K2
    (``csrc/hist_ctx.cu``) once."""
    if qual.device.type == "cpu":
        sym, ctx, counts = sym_ctx_hist_plain(qual, lengths, order,
                                              qual_map, histogram)
        if out is None:
            return sym, ctx, counts
        out[0].copy_(sym)
        out[1].copy_(ctx)
        return out[0], out[1], counts
    launch, result = prepare_pass_a(qual, lengths, order, qual_map,
                                    histogram, out)
    launch()
    sym_ctx_hist.launches += 1
    return result


sym_ctx_hist.launches = 0


def prepare_pass_a(qual: torch.Tensor, lengths: torch.Tensor, order: int,
                   qual_map: Optional[torch.Tensor] = None,
                   histogram: bool = True, out=None):
    """:func:`sym_ctx_hist`'s CUDA path up to the launch (``ops/hist.py``
    ``prepare``): ``(launch, (sym, ctx, counts))``."""
    R, PB, _ = _slab_spec(order)
    return hist.prepare(qual, lengths, order, R, PB, qual_map, histogram,
                        out)


def group_histogram(sym: torch.Tensor, ctx: torch.Tensor, order: int
                    ) -> torch.Tensor:
    """(ctx, sym) histograms of D blocks' grids ``[D, B, L]`` -> i32
    ``[D, C*N_SYMS]`` in ONE launch of kernel K6 on the grids as they
    are: the reference's generic ``_ctx_histogram`` branch
    (``rans.context_histogram``) over the stacked table."""
    D = sym.shape[0]
    C = n_contexts(order)
    return grid_histogram(sym, ctx, C, N_SYMS).reshape(D, C * N_SYMS)


@dataclasses.dataclass
class EncodedQuals:
    """Host-side encoded quality stream for one block."""
    freq: np.ndarray        # uint32 [C, N_SYMS] normalized tables
    states: np.ndarray      # uint32 [N]
    counts: np.ndarray      # int32  [N]
    words: np.ndarray       # uint16 [total] per-lane concatenated
    B: int
    L: int
    T: int
    order: int


def pass_b(sym: torch.Tensor, ctx: torch.Tensor, counts: torch.Tensor,
           B: int, L: int, order: int, T_target: int = 1024
           ) -> Dict[str, torch.Tensor]:
    """Pass B on the device: tables, rANS encode (K3), compaction; the
    outputs as :func:`for_download` narrows them."""
    T = pick_T(B, L, T_target)
    freq, cum = entropy.device_normalize(counts, n_contexts(order), N_SYMS)
    states, words, emits = encode_scan(sym, ctx, freq, cum, T, order)
    packed, wcounts = rans.compact_emissions(words, emits)
    return for_download(freq, states, packed, wcounts)


def encode_from_grids(sym: torch.Tensor, ctx: torch.Tensor,
                      counts: torch.Tensor, B: int, L: int, order: int,
                      T_target: int = 1024) -> EncodedQuals:
    """Pass B: device tables, rANS encode (K3), compaction, download."""
    out = pass_b(sym, ctx, counts, B, L, order, T_target)
    return encoded_from_host({k: t.cpu().numpy() for k, t in out.items()},
                             B, L, pick_T(B, L, T_target), order)


def group_encode(sym: torch.Tensor, ctx: torch.Tensor, counts: torch.Tensor,
                 T: int, order: int):
    """Pass B of D blocks' grids ``[D, B, L]`` with their histograms
    ``[D, C*N_SYMS]``: per-block tables, then ONE K5 launch over the
    group's ``D*N`` lanes on the grids as they are (each block's lanes
    read its own table), then the compaction (the reference's
    ``_encode_pass`` over the stacked tables).  Returns ``(freq [D, C,
    N_SYMS], states [D, N], packed [D, N, T], wcounts [D, N])``, each
    block's equal to its single-block pass B."""
    D, B, L = sym.shape
    freq, cum = entropy.device_normalize(counts, n_contexts(order), N_SYMS)
    states, words, emits = encode_grids(sym, ctx, freq, cum, T)
    packed, wcounts = rans.compact_emissions(words, emits)
    N = B * L // T
    return (freq, states.reshape(D, N), packed.reshape(D, N, T),
            wcounts.reshape(D, N))


def for_download(freq: torch.Tensor, states: torch.Tensor,
                 packed: torch.Tensor, wcounts: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """Pass B's outputs as they cross to the host, narrowed on the
    device: the u32 tables and states as their 32 bits (int32), the u16
    words ``[N, T]`` as their 16 bits (int16), the word counts (int32).
    The whole word matrix crosses (the words in use are each lane's
    first ``wcounts``, known on the host only once they land)."""
    return {"freq": to_u32_bits(freq), "states": to_u32_bits(states),
            "packed": packed.to(torch.int16), "wcounts": wcounts}


def encoded_from_host(a: Dict[str, np.ndarray], B: int, L: int, T: int,
                      order: int) -> EncodedQuals:
    """Host half of pass B, from :func:`for_download`'s arrays on the
    host: the lanes' words by a ragged gather."""
    wcounts = a["wcounts"].astype(np.int64)
    packed = a["packed"].view(np.uint16)
    row_starts = np.arange(packed.shape[0], dtype=np.int64) * packed.shape[1]
    words = ragged_gather(packed.reshape(-1), row_starts, wcounts)
    return EncodedQuals(freq=a["freq"].view(np.uint32),
                        states=a["states"].view(np.uint32),
                        counts=wcounts, words=words, B=B, L=L, T=T,
                        order=order)


def finish_encoded(freq: torch.Tensor, states: torch.Tensor,
                   packed: torch.Tensor, wcounts: torch.Tensor, B: int,
                   L: int, T: int, order: int) -> EncodedQuals:
    """Download and host half of pass B (blocking)."""
    a = for_download(freq, states, packed, wcounts)
    return encoded_from_host({k: t.cpu().numpy() for k, t in a.items()},
                             B, L, T, order)


def _qual_from_syms(syms: torch.Tensor, lengths: torch.Tensor, T: int,
                    B: int, L: int) -> torch.Tensor:
    """``[D, T, N]`` decoded symbols -> uint8 ``[D, B, L]`` grids."""
    D = syms.shape[0]
    grid = syms.transpose(1, 2).reshape(D, B, L)
    col = torch.arange(L, device=syms.device)
    valid = col[None, None, :] < lengths.to(torch.int64)[:, :, None]
    return torch.where(valid, grid + QUAL_OFFSET, 0).to(torch.uint8)


def decode_inputs_host(encs: List[EncodedQuals], lengths_list
                       ) -> Dict[str, np.ndarray]:
    """Stack D blocks' streams into K4's inputs on the host: states
    ``[D, N]``, words ``[D, N, W]`` (u16 bits in int16, half the bytes
    to upload of the int32 widening; W = the widest power-of-two bucket of
    the group, floored at max(64, T/8)), freq ``[D, C, 94]``, lengths
    ``[D, B]``.  Blocks must share (B, L, T, order).  Counts each block
    (``k4_input_blocks``) and each whose words took the native row copy
    (``k4_input_native_blocks``)."""
    if len({(e.B, e.L, e.T, e.order) for e in encs}) != 1:
        raise ValueError("decode_batch requires uniform (B, L, T, order)")
    e0 = encs[0]
    N = e0.states.shape[0]
    W = max(64, e0.T // 8)
    wmax = max((int(e.counts.max()) if len(e.counts) else 0) for e in encs)
    while W < wmax:
        W <<= 1
    words = np.zeros((len(encs), N, W), np.uint16)
    for d, e in enumerate(encs):
        native = ragged_scatter(words[d].reshape(-1),
                                np.arange(N, dtype=np.int64) * W, e.words,
                                e.counts.astype(np.int64))
        timing.count("k4_input_blocks", 1)
        timing.count("k4_input_native_blocks", native)
    return {
        "states": np.stack([e.states for e in encs]),
        "words": words.view(np.int16),
        "freq": np.stack([e.freq.reshape(-1, N_SYMS) for e in encs]),
        "lengths": np.stack([np.asarray(ln, np.int32)
                             for ln in lengths_list]),
    }


def decode_inputs(encs: List[EncodedQuals], lengths_list, device
                  ) -> Dict[str, torch.Tensor]:
    """:func:`decode_inputs_host` on ``device`` (a blocking copy)."""
    return convert.from_reference(decode_inputs_host(encs, lengths_list),
                                  device)


def decode_batch_dispatch(encs: List[EncodedQuals], lengths_list,
                          link: Link) -> Fetched:
    """ONE K4 launch for several blocks' quality grids, which it writes
    in their final uint8 form: the inputs go up and the grids come down
    through ``link``'s copy streams.  Returns the queued download; pair
    with :func:`decode_batch_fetch`, which a host worker may run while
    the caller launches the next group."""
    e0 = encs[0]
    with timing.stage("K4 inputs"):
        host = decode_inputs_host(encs, lengths_list)
    x = link.upload(host).wait()
    qual = decode_quals(x["states"], x["words"], x["freq"], x["lengths"],
                        e0.order, e0.T, e0.L)
    return link.download({"qual": qual.reshape(len(encs), e0.B, e0.L)})[0]


def decode_batch_fetch(fetched: Fetched) -> List[np.ndarray]:
    """The uint8 ``[B, L]`` grids of :func:`decode_batch_dispatch`."""
    return list(fetched.wait()["qual"])


def decode_batch(encs: List[EncodedQuals], lengths_list, device
                 ) -> List[np.ndarray]:
    """Decode several blocks' quality grids in ONE K4 launch."""
    return decode_batch_fetch(decode_batch_dispatch(
        encs, lengths_list, Link(resolve_device(device))))


# ---------------------------------------------------------------------------
# container payload: copies of the reference's

def payload(enc: EncodedQuals, level: int = 6, backend: str = "gz") -> bytes:
    return container.pack_arrays({
        "dims": np.asarray([enc.B, enc.L, enc.T, enc.order], np.int64),
        "freq": enc.freq.astype(np.uint16),
        "states": enc.states,
        "counts": enc.counts.astype(np.uint16 if enc.T <= 65535
                                    else np.uint32),
        "words": enc.words,
    }, deflate=("freq", "counts"), level=level, backend=backend)


def parse(blob: bytes) -> EncodedQuals:
    a = container.unpack_arrays(blob)
    if a.get("dims") is None or a["dims"].shape != (4,):
        raise ValueError("corrupt quality stream: bad dims")
    for field in ("freq", "states", "counts", "words"):
        if field not in a:
            raise ValueError(f"corrupt quality stream: missing {field}")
    B, L, T, order = (int(x) for x in a["dims"])
    enc = EncodedQuals(freq=a["freq"].astype(np.uint32),
                       states=a["states"],
                       counts=a["counts"].astype(np.int32),
                       words=a["words"], B=B, L=L, T=T, order=order)
    _validate_enc(enc)
    return enc


def _validate_enc(enc: EncodedQuals) -> None:
    """Reject structurally corrupt quality streams before any decode."""
    B, L, T, order = enc.B, enc.L, enc.T, enc.order
    if order not in (1, 2, 3):
        raise ValueError("corrupt quality stream: bad order")
    if not (0 <= B <= 1 << 26 and 1 <= L <= 1 << 20 and T >= 1):
        raise ValueError("corrupt quality stream: bad dims")
    if T % L != 0 or (B and ((B * L) % T != 0 or T > B * L)):
        raise ValueError("corrupt quality stream: inconsistent T")
    N = (B * L) // T if B else 0
    C = n_contexts(order)
    if enc.freq.ndim not in (1, 2) or enc.freq.size != C * N_SYMS:
        raise ValueError("corrupt quality stream: bad table size")
    if enc.states.ndim != 1 or enc.states.shape[0] != N:
        raise ValueError("corrupt quality stream: bad states")
    if enc.counts.ndim != 1 or enc.counts.shape[0] != N:
        raise ValueError("corrupt quality stream: bad counts")
    if enc.words.ndim != 1:
        raise ValueError("corrupt quality stream: bad words")
    if N and (int(enc.counts.min()) < 0
              or int(enc.counts.astype(np.int64).sum()) != enc.words.size):
        raise ValueError("corrupt quality stream: words/counts mismatch")
