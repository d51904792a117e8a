"""Single-host data parallelism (port of ``scalce_tpu/parallel/mesh.py``,
full-device placement).

Blocks are independent, so a group of ``D = len(mesh) * group`` blocks
is split over the devices, ``group`` consecutive blocks each.  Each
device runs stages A and B per block, then counts its blocks' quality
grids in ONE launch of kernel K6 and rANS-encodes them in ONE launch of
kernel K5 over the stacked per-block tables: the reference's
``jax.vmap`` over a device's blocks, written out as one flat problem.
There is no traffic between devices.  A tail group (fewer than D blocks)
takes the single-device :class:`BlockEncoder` per block, as the
reference's does.  Every payload byte equals the single-device path's:
bytes are a pure function of (block, Config).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from scalce_tpu.config import Config, resolve_read_len
from scalce_tpu.io.fastq import ReadBlock
from scalce_tpu.streams.seqs import _pack2bit_np
from scalce_tpu_torch import convert
from scalce_tpu_torch.device import resolve_device
from scalce_tpu_torch.pipeline import encode
from scalce_tpu_torch.streams import qualities
from scalce_tpu_torch.timing import stage


def local_mesh(n: Optional[int] = None, device="cuda") -> List[torch.device]:
    """The devices of this host that a group is split over: ``"cuda"``
    gives every visible card (the first ``n``); ``"cuda:N"`` or ``"cpu"``
    gives that one device, ``n`` times (default once)."""
    want = torch.device(device)
    if want.type == "cuda" and want.index is None:
        resolve_device(want)                       # raises without a card
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(want)] * (n or 1)
    return devs[:n]


def upload_blocks(blocks: Sequence[ReadBlock], device
                  ) -> Dict[str, torch.Tensor]:
    """H2D of one device's blocks, stacked (the reference's
    ``_stack_blocks``): 2-bit packed sequences ``[g, B, L/16]``,
    qualities ``[g, B, L]``, lengths ``[g, B]``, and a tuple of each
    block's flat exception positions."""
    t = convert.from_reference({
        "seq": np.stack([_pack2bit_np(b.seq).reshape(b.seq.shape[0], -1)
                         for b in blocks]),
        "qual": np.stack([b.qual for b in blocks]),
        "len": np.stack([b.lengths for b in blocks]),
        "exc": np.concatenate([b.exc_pos for b in blocks])}, device)
    t["exc"] = torch.split(t["exc"], [b.exc_pos.size for b in blocks])
    return t


def stage1(pre: Dict[str, torch.Tensor], n_reads: Sequence[int], k: int,
           seed: int, order: int):
    """One device's share of a group (the reference's
    ``make_sharded_stage1`` on one device): stages A and B per block,
    then ONE K6 launch over the stacked grids.  Returns per-block lists
    ``perm``, ``delta``, ``len_s``, then ``sym`` and ``ctx`` ``[g, B,
    L]`` and ``counts`` ``[g, C*94]``."""
    outs = [encode._encode_core(pre["seq"][j], pre["qual"][j], pre["len"][j],
                                n, pre["exc"][j], k, seed, order)
            for j, n in enumerate(n_reads)]
    perm, delta, len_s, sym, ctx = map(list, zip(*outs))
    sym, ctx = torch.stack(sym), torch.stack(ctx)
    return (perm, delta, len_s, sym, ctx,
            qualities.group_histogram(sym, ctx, order))


class ShardedEncoder:
    """Data-parallel block encoder over the devices of one host.

    ``device`` names them (see :func:`local_mesh`) unless ``mesh`` lists
    them; ``group`` blocks go to each device per step (default 1).
    Payloads are byte-identical to :class:`BlockEncoder`'s."""

    def __init__(self, cfg: Config, device, mesh=None,
                 group: Optional[int] = None):
        cfg = resolve_read_len(cfg)
        self.mesh = list(mesh) if mesh is not None \
            else local_mesh(device=device)
        self.group = group or 1
        self.D = len(self.mesh) * self.group
        self._fallback = encode.BlockEncoder(cfg, self.mesh[0])
        self.cfg = cfg

    def _shares(self, blocks: Sequence[ReadBlock]) -> List[Sequence]:
        g = self.group
        return [blocks[i * g:(i + 1) * g] for i in range(len(self.mesh))]

    def upload_group(self, blocks: Sequence[ReadBlock]):
        """Per-device stacked uploads of a full group; None for a tail
        group (it takes the per-block path)."""
        if len(blocks) != self.D:
            return None
        with stage("upload"):
            return [upload_blocks(share, dev) for share, dev
                    in zip(self._shares(blocks), self.mesh)]

    def encode_device(self, blocks: Sequence[ReadBlock], pre=None):
        """Device work of a full group: every device's stage 1 is queued
        before any pass B, so the devices run side by side.  Returns one
        ``(perm, delta, len_s, freq, states, packed, wcounts)`` per
        device."""
        if len(blocks) != self.D:
            raise ValueError(f"encode_device takes a group of {self.D} "
                             f"blocks, got {len(blocks)}")
        cfg = self.cfg
        order = cfg.qual_context_order
        pre = pre if pre is not None else self.upload_group(blocks)
        B, L = blocks[0].seq.shape
        T = qualities.pick_T(B, L, cfg.qual_T_target)
        with stage("stage A+B"):
            s1 = [stage1(p, [b.n_reads for b in share], cfg.core_k,
                         cfg.dict_seed, order)
                  for p, share in zip(pre, self._shares(blocks))]
        with stage("pass B"):
            return [(perm, delta, len_s)
                    + qualities.group_encode(sym, ctx, counts, T, order)
                    for perm, delta, len_s, sym, ctx, counts in s1]

    def assemble(self, blocks: Sequence[ReadBlock], devout
                 ) -> List[encode.EncodedBlock]:
        """Per-block download and payload bytes, in input order."""
        cfg = self.cfg
        B, L = blocks[0].seq.shape
        T = qualities.pick_T(B, L, cfg.qual_T_target)
        out = []
        for share, (perm, delta, len_s, freq, states, packed,
                    wcounts) in zip(self._shares(blocks), devout):
            for j, block in enumerate(share):
                with stage("pass B"):
                    enc_q = qualities.finish_encoded(
                        freq[j], states[j], packed[j], wcounts[j], B, L, T,
                        cfg.qual_context_order)
                out.append(self._fallback.assemble_encoded(
                    block, perm[j], delta[j], len_s[j], enc_q))
        return out

    def encode_blocks(self, blocks: Sequence[ReadBlock]
                      ) -> List[encode.EncodedBlock]:
        """Encode up to D blocks; a tail group goes block by block
        through the single-device encoder (identical bytes)."""
        if len(blocks) < self.D:
            return [self._fallback.encode_block(b) for b in blocks]
        return self.assemble(blocks, self.encode_device(blocks))
