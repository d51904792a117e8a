"""Single-host data parallelism (port of ``scalce_tpu/parallel/mesh.py``,
cores and delta on the device).

Blocks are independent, so a group of ``D = len(mesh) * group`` blocks
is split over the devices, ``group`` consecutive blocks each.  Each
device runs stages A and B per block, then, with device-placed
qualities, counts its blocks' quality grids in ONE launch of kernel K6
and rANS-encodes them in ONE launch of kernel K5, each block's cells
against its own table: the reference's ``jax.vmap`` over a device's
blocks, written out as one flat problem.  With host-placed qualities
the host codec encodes each block's at assembly; under host delta
(``delta_on_device`` False with host qualities) each device runs stage
A only and downloads each block's packed buffer, and the host runs the
delta match at assembly (:func:`stage1_hd`).  The explicit dictionaries'
rank LUT is uploaded once to each device.  Host core does not shard
(``Config`` refuses it with ``--data-parallel``).
A group of D pairs runs mate 1's stage 1, then mate 2's following each
block's permutation, then each mate's pass B.  The encoder sends nothing
between devices; the one collective is :func:`lossy_hist_allreduce`
(the lossy map's histogram summed over devices), which the
single-host driver does not need.  A tail group (fewer than D blocks or
pairs) takes the single-device :class:`BlockEncoder`, as the
reference's does.  Every payload byte equals the single-device path's:
bytes are a pure function of (block, Config).  Under ``--profile`` the
dispatch counts the blocks (pairs) of full groups, ``grouped_blocks``,
and of tail groups, ``tail_blocks``.

As :class:`BlockEncoder`'s, a group goes through :meth:`upload_group`
(any thread), :meth:`ShardedEncoder.dispatch` (the thread that owns the
devices: every kernel and each device's downloads, queued) and
:meth:`ShardedEncoder.assemble` (any thread: each block's host half).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from scalce_tpu_torch.config import Config, resolve_read_len
from scalce_tpu_torch.io.fastq import ReadBlock
from scalce_tpu_torch.streams.seqs import _pack2bit_np
from scalce_tpu_torch.device import resolve_device
from scalce_tpu_torch.ops.histogram import histogram
from scalce_tpu_torch.pipeline import encode
from scalce_tpu_torch.streams import qualities
from scalce_tpu_torch.timing import count, stage
from scalce_tpu_torch.transfer import Fetched, Link, Staged


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


def upload_blocks(blocks: Sequence[ReadBlock], device, qual: bool = True,
                  link: Optional[Link] = None) -> Staged:
    """H2D of one device's blocks, stacked (the reference's
    ``_stack_blocks``), through ``link`` (default: a new one for
    ``device``): 2-bit packed sequences ``[g, B, L/16]``, qualities
    ``[g, B, L]`` (with ``qual``), lengths ``[g, B]``, and a tuple of each
    block's flat exception positions."""
    host = {"seq": np.stack([_pack2bit_np(b.seq).reshape(b.seq.shape[0], -1)
                             for b in blocks]),
            "len": np.stack([b.lengths for b in blocks]),
            "exc": np.concatenate([b.exc_pos for b in blocks])}
    if qual:
        host["qual"] = np.stack([b.qual for b in blocks])
    t = (link or Link(resolve_device(device))).upload(host)
    t["exc"] = torch.split(t["exc"], [b.exc_pos.size for b in blocks])
    return t


def stage1(pre: Staged, n_reads: Sequence[int], k: int,
           seed: int, order: int, qual_map: Optional[torch.Tensor] = None,
           perms: Optional[Sequence[torch.Tensor]] = None,
           rank_lut: Optional[torch.Tensor] = None):
    """One device's share of a group (the reference's
    ``make_sharded_stage1`` on one device), from its
    :func:`upload_blocks`: stages A and B per block (K2 writes each
    block's grids, without counting them, into its slices of the share's
    ``[g, B, L]`` grids), then ONE K6 launch counts them.  With ``perms``
    (mate 1's permutations) the blocks are mate 2's, each following its
    mate-1 block's permutation (``make_sharded_stage_mate2``).  Returns
    per-block lists ``perm``, ``delta``, ``len_s``, then ``sym`` and
    ``ctx`` ``[g, B, L]`` and ``counts`` ``[g, C*94]``; without qualities
    in ``pre`` (host placement: ``make_sharded_stage1_nq``) the last
    three are None.  ``rank_lut``: the explicit dictionary's ranks on
    this device (None: the hash)."""
    pre = pre.wait()
    qual = pre.get("qual")
    sym = ctx = None
    if qual is not None:
        sym = torch.empty(qual.shape, dtype=torch.int64, device=qual.device)
        ctx = torch.empty_like(sym)
    outs = []
    for j, n in enumerate(n_reads):
        q, grids = (None, None) if qual is None else (qual[j],
                                                      (sym[j], ctx[j]))
        if perms is None:
            outs.append(encode._encode_core(
                pre["seq"][j], q, pre["len"][j], n, pre["exc"][j], k, seed,
                order, qual_map, grids, rank_lut))
        else:
            outs.append(encode._encode_core_mate2(
                pre["seq"][j], q, pre["len"][j], n, pre["exc"][j], perms[j],
                k, seed, order, qual_map, grids, rank_lut))
    perm, delta, len_s = map(list, zip(*outs))
    counts = None if qual is None else qualities.group_histogram(sym, ctx,
                                                                 order)
    return perm, delta, len_s, sym, ctx, counts


def stage1_hd(pre: Staged, n_reads: Sequence[int], k: int, seed: int,
              rank_lut: Optional[torch.Tensor] = None,
              perms: Optional[Sequence[torch.Tensor]] = None):
    """One device's share of a group under host delta (the reference's
    ``make_sharded_stage1_hd`` on one device; with ``perms``, mate 1's
    permutations, ``make_sharded_stage_mate2_hd``): per block, stage A
    and its packed buffer (``encode._hd_pack``).  Returns per-block
    lists ``bufs`` and ``perms``."""
    pre = pre.wait()
    bufs, out = [], []
    for j, n in enumerate(n_reads):
        if perms is None:
            buf, perm = encode._device_stage_a_hd(
                pre["seq"][j], pre["len"][j], n, pre["exc"][j], k, seed,
                rank_lut)
        else:
            perm = perms[j]
            buf = encode._device_stage_a2_hd(
                pre["seq"][j], pre["len"][j], pre["exc"][j], perm, k, seed,
                rank_lut)
        bufs.append(buf)
        out.append(perm)
    return bufs, out


class ShardedEncoder:
    """Data-parallel block encoder over the devices of one host.

    ``device`` names them (see :func:`local_mesh`) unless ``mesh`` lists
    them; ``group`` blocks go to each device per step (default 1);
    ``qual_map`` is the lossy quality map (None: lossless), kept on each
    device.  With host-placed qualities (``cfg.qual_on_device`` False)
    the devices run stages A and B of the sequences only and the host
    codec encodes each block's qualities at assembly.  Payloads are
    byte-identical to :class:`BlockEncoder`'s."""

    def __init__(self, cfg: Config, device, mesh=None,
                 group: Optional[int] = None, qual_map=None):
        cfg = resolve_read_len(cfg)
        self.mesh = list(mesh) if mesh is not None \
            else local_mesh(device=device)
        self.group = group or 1
        self.D = len(self.mesh) * self.group
        self._fallback = encode.BlockEncoder(cfg, self.mesh[0], qual_map)
        self._maps = {dev: encode.device_qual_map(qual_map, dev)
                      for dev in set(self.mesh)}
        self._links = {dev: Link(dev) for dev in set(self.mesh)}
        # the fallback encoder's LUT, built once, on every device
        self._luts = {dev: self._fallback.rank_lut
                      if dev == self._fallback.device
                      else encode.upload_rank_lut(self._fallback.rank_lut_np,
                                                  self._links[dev])
                      for dev in set(self.mesh)}
        self._host_delta = self._fallback.host_delta
        self.cfg = cfg

    def _shares(self, blocks: Sequence) -> List[Sequence]:
        g = self.group
        return [blocks[i * g:(i + 1) * g] for i in range(len(self.mesh))]

    def upload_group(self, blocks: Sequence[ReadBlock]
                     ) -> Optional[List[Staged]]:
        """Per-device stacked uploads of a full group; None for a tail
        group (it takes the per-block path)."""
        if len(blocks) != self.D:
            return None
        with stage("upload"):
            return [upload_blocks(share, dev, self.cfg.qual_on_device,
                                  self._links[dev])
                    for share, dev in zip(self._shares(blocks), self.mesh)]

    def _stage1(self, blocks: Sequence[ReadBlock], pre=None, perms=None):
        """Every device's :func:`stage1` of a full group (``perms``: per
        device, mate 1's permutations), queued before any pass B, so
        the devices run side by side."""
        if len(blocks) != self.D:
            raise ValueError(f"a device group takes {self.D} blocks, got "
                             f"{len(blocks)}")
        cfg = self.cfg
        pre = pre if pre is not None else self.upload_group(blocks)
        shares = list(enumerate(zip(pre, self._shares(blocks), self.mesh)))
        if self._host_delta:
            with stage("stage A"):
                return [stage1_hd(p, [b.n_reads for b in share], cfg.core_k,
                                  cfg.dict_seed, self._luts[dev],
                                  None if perms is None else perms[i])
                        for i, (p, share, dev) in shares]
        with stage("stage A+B"):
            return [stage1(p, [b.n_reads for b in share], cfg.core_k,
                           cfg.dict_seed, cfg.qual_context_order,
                           self._maps[dev],
                           None if perms is None else perms[i],
                           self._luts[dev])
                    for i, (p, share, dev) in shares]

    def _pass_b(self, blocks: Sequence[ReadBlock], s1):
        """Every device's group pass B: ``(perm, delta, len_s, freq,
        states, packed, wcounts)`` per device (the last four None for
        host-placed qualities, which the host encodes at assembly)."""
        cfg = self.cfg
        if not cfg.qual_on_device:
            return [(perm, delta, len_s, None, None, None, None)
                    for perm, delta, len_s, *_ in s1]
        B, L = blocks[0].seq.shape
        T = qualities.pick_T(B, L, cfg.qual_T_target)
        with stage("pass B"):
            return [(perm, delta, len_s) + qualities.group_encode(
                        sym, ctx, counts, T, cfg.qual_context_order)
                    for perm, delta, len_s, sym, ctx, counts in s1]

    def encode_device(self, blocks: Sequence[ReadBlock], pre=None):
        """Device work of a full group: every device's stage 1, then
        every device's pass B."""
        return self._pass_b(blocks, self._stage1(blocks, pre))

    def _download_hd(self, per_device, key: str) -> List[Fetched]:
        """Host delta: each device's packed buffers, one queued copy per
        device, marked ``key`` (``"hd"`` mate 1, ``"hd2"`` mate 2) -> one
        :class:`Fetched` per block, in input order."""
        out = []
        for dev, (bufs, _) in zip(self.mesh, per_device):
            with stage("download"):
                out += self._links[dev].download(*({key: b} for b in bufs))
        return out

    def _download(self, per_device) -> List[Fetched]:
        """Each device's downloads (one queued copy of its blocks'
        outputs) -> one :class:`Fetched` per block, in input order."""
        out = []
        for dev, (perm, delta, len_s, *pb) in zip(self.mesh, per_device):
            groups = []
            for j in range(len(perm)):
                g = {"perm": perm[j], "len_s": len_s[j],
                     **encode._delta_for_download(delta[j])}
                if pb[0] is not None:
                    g.update(qualities.for_download(*(t[j] for t in pb)))
                groups.append(g)
            with stage("download"):
                out += self._links[dev].download(*groups)
        return out

    def dispatch(self, blocks: Sequence[ReadBlock], pre=None
                 ) -> List[Fetched]:
        """Every kernel of a group and its downloads, queued (``pre``:
        its :meth:`upload_group`); a tail group block by block through
        the single-device encoder."""
        if len(blocks) < self.D:
            count("tail_blocks", len(blocks))
            return [self._fallback.dispatch(b) for b in blocks]
        count("grouped_blocks", len(blocks))
        if self._host_delta:
            return self._download_hd(self._stage1(blocks, pre), "hd")
        return self._download(self.encode_device(blocks, pre))

    def assemble(self, blocks: Sequence[ReadBlock],
                 fetched: Sequence[Fetched]) -> List[encode.EncodedBlock]:
        """Per-block host halves (payload bytes), in input order."""
        return [self._fallback.assemble(b, f)
                for b, f in zip(blocks, fetched)]

    def encode_blocks(self, blocks: Sequence[ReadBlock]
                      ) -> List[encode.EncodedBlock]:
        """Encode up to D blocks; a tail group goes block by block
        through the single-device encoder (identical bytes)."""
        return self.assemble(blocks, self.dispatch(blocks))

    # paired-end: mate 1 defines each block's permutation; mate 2's
    # stage 1 follows it, then each mate's group pass B (one K6 and one
    # K5 launch per device and mate)

    def encode_device_pair(self, pairs: Sequence[Tuple[ReadBlock,
                                                       ReadBlock]],
                           pre1=None, pre2=None):
        """Device work of a full group of D pairs (``pre1``/``pre2``:
        each mate's :meth:`upload_group`) -> ``(mate 1's, mate 2's)``
        per-device outputs in :meth:`encode_device`'s form."""
        b1s, b2s = [p[0] for p in pairs], [p[1] for p in pairs]
        s1 = self._stage1(b1s, pre1)
        s2 = self._stage1(b2s, pre2, perms=[s[0] for s in s1])
        return self._pass_b(b1s, s1), self._pass_b(b2s, s2)

    def dispatch_pair(self, pairs, pre1=None, pre2=None
                      ) -> List[List[Fetched]]:
        """:meth:`dispatch` of a group of pairs: per pair, both mates'
        downloads; a tail group pair by pair."""
        if len(pairs) < self.D:
            count("tail_blocks", len(pairs))
            return [self._fallback.dispatch_pair(*p) for p in pairs]
        count("grouped_blocks", len(pairs))
        if self._host_delta:
            b1s, b2s = [p[0] for p in pairs], [p[1] for p in pairs]
            s1 = self._stage1(b1s, pre1)
            s2 = self._stage1(b2s, pre2, perms=[perms for _, perms in s1])
            return [list(f) for f in zip(self._download_hd(s1, "hd"),
                                         self._download_hd(s2, "hd2"))]
        out1, out2 = self.encode_device_pair(pairs, pre1, pre2)
        return [list(f) for f in zip(self._download(out1),
                                     self._download(out2))]

    def assemble_pair(self, pairs, fetched
                      ) -> List[Tuple[encode.EncodedBlock,
                                      encode.EncodedBlock]]:
        return [self._fallback.assemble_pair(*p, f)
                for p, f in zip(pairs, fetched)]

    def encode_block_pairs(self, pairs: Sequence[Tuple[ReadBlock, ReadBlock]]
                           ) -> List[Tuple[encode.EncodedBlock,
                                           encode.EncodedBlock]]:
        """Encode up to D pairs; a tail group goes pair by pair through
        the single-device encoder (identical bytes)."""
        return self.assemble_pair(pairs, self.dispatch_pair(pairs))


def lossy_hist_allreduce(quals, lengths, mesh: Sequence[torch.device]
                         ) -> torch.Tensor:
    """Quality histogram of a group of blocks, summed over the devices
    (the reference's ``make_lossy_hist_allreduce``: every device, and
    later every host, derives the same lossy map from it).

    ``quals`` uint8 ``[D, B, L]`` and ``lengths`` ``[D, B]`` (host
    arrays; D a multiple of ``len(mesh)``) are split over ``mesh`` in
    consecutive shares.  On each device the symbols of valid cells and
    an overflow bin 94 for padding go through ONE K6 launch over 95
    cells; the per-device counts are summed on ``mesh[0]``.  Returns i32
    ``[94]`` on ``mesh[0]``."""
    D, _, L = quals.shape
    if D % len(mesh):
        raise ValueError(f"{D} blocks do not split over {len(mesh)} devices")
    g = D // len(mesh)
    total = None
    for i, dev in enumerate(mesh):
        q = torch.from_numpy(np.ascontiguousarray(quals[i * g:(i + 1) * g])
                             ).to(dev)
        ln = torch.from_numpy(np.asarray(lengths[i * g:(i + 1) * g],
                                         np.int64)).to(dev)
        valid = torch.arange(L, device=dev)[None, None, :] < ln[:, :, None]
        sym = torch.clamp(q.to(torch.int64) - qualities.QUAL_OFFSET, 0,
                          qualities.N_SYMS - 1)
        h = histogram(torch.where(valid, sym, qualities.N_SYMS),
                      qualities.N_SYMS + 1).to(mesh[0])
        total = h if total is None else total + h
    return total[:qualities.N_SYMS]
