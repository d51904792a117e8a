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
(``Config`` refuses it with ``--data-parallel``).  The encoder sends
nothing between devices; the one collective is
:func:`lossy_hist_allreduce` (the lossy map's histogram summed over
devices), which the single-host driver does not need.  A tail group
(fewer than D items) takes the single-device :class:`BlockEncoder`, as
the reference's does.  Every payload byte equals the single-device
path's: bytes are a pure function of (block, Config).  Under
``--profile`` the dispatch counts the items of full groups,
``grouped_blocks``, and of tail groups, ``tail_blocks``.

As :class:`BlockEncoder`'s, a group of items (tuples of mates) goes
through :meth:`ShardedEncoder.upload` (any thread),
:meth:`ShardedEncoder.dispatch` (the thread that owns the devices: every
kernel and each device's downloads, queued, mate by mate) and
:meth:`ShardedEncoder.assemble` (any thread: each item's host half).
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
    (mate 1's permutations) the blocks are a later mate's, each following
    its mate-1 block's permutation (``make_sharded_stage_mate2``).
    Returns per-block lists ``perm``, ``delta``, ``len_s``, then ``sym``
    and ``ctx`` ``[g, B, L]`` and ``counts`` ``[g, C*94]``; without
    qualities in ``pre`` (host placement: ``make_sharded_stage1_nq``)
    the last three are None.  ``rank_lut``: the explicit dictionary's
    ranks on this device (None: the hash)."""
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
        outs.append(encode.encode_core(
            pre["seq"][j], q, pre["len"][j], n, pre["exc"][j], k, seed,
            order, qual_map, grids, rank_lut,
            None if perms is None else perms[j]))
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
    and its packed buffer (``encode.stage_a_hd``).  Returns per-block
    lists ``perms`` and ``bufs``."""
    pre = pre.wait()
    out = [encode.stage_a_hd(pre["seq"][j], pre["len"][j], n, pre["exc"][j],
                             k, seed, rank_lut,
                             None if perms is None else perms[j])
           for j, n in enumerate(n_reads)]
    return [perm for _, perm in out], [buf for buf, _ in out]


class ShardedEncoder:
    """Data-parallel block encoder over the devices of one host.

    ``device`` names them (see :func:`local_mesh`) unless ``mesh`` lists
    them; ``group`` blocks go to each device per step (default 1);
    ``qual_map`` is the lossy quality map (None: lossless), kept on each
    device.  With host-placed qualities (``cfg.qual_on_device`` False)
    the devices run stages A and B of the sequences only and the host
    codec encodes each block's qualities at assembly.  Payloads are
    byte-identical to :class:`BlockEncoder`'s."""

    #: the cores' placement (``Config`` refuses host core here)
    placement = "device"
    on_host = False

    def __init__(self, cfg: Config, device, mesh=None,
                 group: Optional[int] = None, qual_map=None):
        cfg = resolve_read_len(cfg)
        self.mesh = list(mesh) if mesh is not None \
            else local_mesh(device=device)
        self.devices = self.mesh
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

    def _upload(self, blocks: Sequence[ReadBlock]) -> List[Staged]:
        """Per-device stacked uploads of one mate's blocks of a full
        group."""
        with stage("upload"):
            return [upload_blocks(share, dev, self.cfg.qual_on_device,
                                  self._links[dev])
                    for share, dev in zip(self._shares(blocks), self.mesh)]

    def upload(self, group: Sequence[Tuple[ReadBlock, ...]]
               ) -> Optional[List[List[Staged]]]:
        """A full group's uploads, mate by mate (per mate, per device);
        None for a tail group (it takes the per-item path)."""
        if len(group) != self.D:
            return None
        return [self._upload(blocks) for blocks in zip(*group)]

    def _stage1(self, blocks: Sequence[ReadBlock], pre, perms=None):
        """Every device's :func:`stage1` of one mate's blocks of a full
        group (``perms``: per device, mate 1's permutations), queued
        before any pass B, so the devices run side by side."""
        if len(blocks) != self.D:
            raise ValueError(f"a device group takes {self.D} blocks, got "
                             f"{len(blocks)}")
        cfg = self.cfg
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

    def _download_hd(self, per_device) -> List[Fetched]:
        """Host delta: each device's packed buffers, one queued copy per
        device, marked ``"hd"`` -> one :class:`Fetched` per block, in
        input order."""
        out = []
        for dev, (_, bufs) in zip(self.mesh, per_device):
            with stage("download"):
                out += self._links[dev].download(*({"hd": b} for b in bufs))
        return out

    def _download(self, per_device) -> List[Fetched]:
        """Each device's downloads (one queued copy of its blocks'
        outputs) -> one :class:`Fetched` per block, in input order."""
        out = []
        for dev, (perm, delta, len_s, *pb) in zip(self.mesh, per_device):
            groups = []
            for j in range(len(perm)):
                g = {"perm": perm[j], "len_s": len_s[j],
                     **encode.delta_for_download(delta[j])}
                if pb[0] is not None:
                    g.update(qualities.for_download(*(t[j] for t in pb)))
                groups.append(g)
            with stage("download"):
                out += self._links[dev].download(*groups)
        return out

    def dispatch(self, group: Sequence[Tuple[ReadBlock, ...]], pre=None
                 ) -> List[List[Fetched]]:
        """Every kernel of a group and its downloads, queued (``pre``:
        its :meth:`upload`, else made now): each mate's stage 1 in turn,
        a later mate's following mate 1's permutations, then each mate's
        group pass B (one K6 and one K5 launch per device and mate) and
        downloads.
        Returns per item one :class:`Fetched` per mate; a tail group
        goes item by item through the single-device encoder."""
        if len(group) < self.D:
            count("tail_blocks", len(group))
            return self._fallback.dispatch(group)
        count("grouped_blocks", len(group))
        mates = list(zip(*group))
        s1, perms = [], None
        for blocks, p in zip(mates, pre or self.upload(group)):
            s1.append(self._stage1(blocks, p, perms))
            perms = perms or [s[0] for s in s1[0]]
        if self._host_delta:
            fetched = [self._download_hd(s) for s in s1]
        else:
            outs = [self._pass_b(blocks, s) for blocks, s in zip(mates, s1)]
            fetched = [self._download(o) for o in outs]
        return [list(f) for f in zip(*fetched)]

    def assemble(self, group: Sequence[Tuple[ReadBlock, ...]],
                 fetched: Sequence[Sequence[Fetched]]
                 ) -> List[Tuple[encode.EncodedBlock, ...]]:
        """Per-item host halves (payload bytes), in input order."""
        return self._fallback.assemble(group, fetched)

    def encode(self, group: Sequence[Tuple[ReadBlock, ...]]
               ) -> List[Tuple[encode.EncodedBlock, ...]]:
        """Encode up to D items; a tail group goes item by item through
        the single-device encoder (identical bytes)."""
        return self.assemble(group, self.dispatch(group))


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
