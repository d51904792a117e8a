"""Block encode pipeline (port of ``scalce_tpu/pipeline/encode.py``:
every placement and dictionary, and long reads).

Placements, as the reference's ``BlockEncoder`` picks them:

- device (``core_on_device`` True, or AUTO on a fast link): stages A
  and B on the device, as below;
- host delta (``delta_on_device`` False with host-placed qualities):
  stage A on the device, whose sorted cores, positions, strands and
  lengths cross packed into one buffer (:func:`_hd_pack`), then the
  native delta match on the host (:meth:`BlockEncoder._assemble_hd`);
- host core (``core_on_device`` False, or AUTO on a link slower than
  200 MB/s, with host delta and the hash dictionary): the native core
  matcher, sort and delta match on the host, nothing on the device
  (:meth:`BlockEncoder._assemble_hc`);
- long reads (``max_read_len`` above :data:`SHORT_READ_MAX`, whatever
  the core placement: ``Config`` refuses device placements there):
  minimizer order and the anchored predecessor delta in numpy on the
  assembly workers (:meth:`BlockEncoder._assemble_long`, container
  v6/v7), nothing on the device.

The explicit dictionaries (``dict_mode`` lut / lcp) rank cores by a
4^k table (``models/core_dict.py``) that each encoder builds once and
uploads once per device.

Per block on the device placement: stage A (unpack the 2-bit upload,
canonical cores, sort keys, one stable multi-key sort, permute), stage B
(aligned-predecessor delta of the sorted sequences, K7; with device-placed
qualities, the quality grids and histogram, through the lossy map if
any, in one K2 launch), pass B of device-placed qualities (K3, then K8's
compaction) and the downloads, all queued on the device; then the host
assembly of the ``n``/``r``/``q`` payloads, which waits for the
downloads and where host-placed qualities (the CLI's default) are
encoded by ``streams/qualities_host.py``.

The mates of a pair are channels of one path, whatever the placement:
mate 1 sorts, and each later mate computes its own cores but follows
mate 1's permutation (stage A's ``perm``, the host halves' ``follow``),
so the pairs stay line-synchronized.  Every payload byte is the
reference's for the same block and Config.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from scalce_tpu_torch import container, native, timing
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.io.fastq import ReadBlock
from scalce_tpu_torch.models import core_dict
from scalce_tpu_torch.streams import names as names_stream
from scalce_tpu_torch.streams.seqs import _pack2bit_np
from scalce_tpu_torch.timing import stage
from scalce_tpu_torch.device import resolve_device
from scalce_tpu_torch.ops import core_match, delta_seq, reorder
from scalce_tpu_torch.ops.minimizer import (NO_KEY, minimizer_keys,
                                            segment_minimizer_keys)
from scalce_tpu_torch.ops.bitops import (MASK32, to_u32_bits,
                                         unpack_bases_u32)
from scalce_tpu_torch.streams import qualities, qualities_host, seqs
from scalce_tpu_torch.transfer import Fetched, Link, Staged

_DELTA_K = delta_seq.DELTA_K   # candidate predecessors of the host match
#: the widest short read (Config's rule): wider blocks are long reads
SHORT_READ_MAX = 32752
#: long reads: the target segment length of the v7 multi-anchor delta
#: (each block's nseg is a power of two of its median read length / 512,
#: in [4, 256], stored in the container)
_LONG_SEG_LEN = 512


def build_rank_lut(cfg: Config) -> Optional[np.ndarray]:
    """The explicit dictionary's u32 rank of every k-mer (host; the
    reference's ``rank_lut`` property), or None for the implicit hash
    dictionary."""
    if cfg.dict_mode == "lut":
        return core_dict.build_rank_lut(cfg.core_k, cfg.dict_seed)
    if cfg.dict_mode == "lcp":
        return core_dict.build_rank_lut_lcp(cfg.core_k, cfg.dict_seed)
    return None


def upload_rank_lut(lut: Optional[np.ndarray], link: Link
                    ) -> Optional[torch.Tensor]:
    """The rank LUT on ``link``'s device as int32 words holding the u32
    bits (one page-locked copy, ordered before the current stream's later
    work), or None."""
    if lut is None:
        return None
    return link.upload({"lut": lut.view(np.int32)}).wait()["lut"]


def device_qual_map(qual_map, device) -> Optional[torch.Tensor]:
    """The lossy quality map (uint8 ``[256]``) on ``device``, or None
    for no map or the identity (lossless: no gather at all)."""
    if qual_map is None:
        return None
    qual_map = np.asarray(qual_map, np.uint8)
    if np.array_equal(qual_map, np.arange(256, dtype=np.uint8)):
        return None
    return torch.from_numpy(qual_map.copy()).to(device)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool ``[B]`` -> uint8 ``[B/8]``, LSB-first."""
    w = 1 << torch.arange(8, dtype=torch.int64, device=bits.device)
    return (bits.reshape(-1, 8).to(torch.int64) * w).sum(dim=1).to(
        torch.uint8)


def _delta_seq(codes_s: torch.Tensor, len_s: torch.Tensor,
               ck_s: torch.Tensor, cp_s: torch.Tensor,
               n_reads: int) -> Dict[str, torch.Tensor]:
    """Aligned-predecessor delta over the sorted block: kernel K7
    (``ops/delta_seq.py::delta_seq``)."""
    return delta_seq.delta_seq(codes_s, len_s, ck_s, cp_s, n_reads)


def _stage_a_prologue(seq_packed: torch.Tensor, lengths: torch.Tensor,
                      exc_pos: torch.Tensor, k: int, seed: int,
                      rank_lut: Optional[torch.Tensor] = None):
    """Unpack the 2-bit upload, build the exception mask from the flat
    exception positions, run the canonical core matcher (``rank_lut``:
    the explicit dictionary's ranks, None for the hash)."""
    lengths = lengths.to(torch.int64)
    codes = unpack_bases_u32(seq_packed)
    B, L = codes.shape
    exc = torch.zeros(B * L, dtype=torch.bool, device=codes.device)
    # a scalar fill, where ``exc[exc_pos] = True`` copies the value from
    # pageable memory and so waits for the card
    exc.index_fill_(0, exc_pos, True)
    ck, cp, is_rc, codes_o, _ = core_match.find_cores_canonical(
        codes, lengths, exc.reshape(B, L), k, seed, rank_lut)
    return lengths, codes_o, ck, cp, is_rc


def _device_stage_a(seq_packed, qual, lengths, n_reads: int, exc_pos,
                    k: int, seed: int,
                    rank_lut: Optional[torch.Tensor] = None,
                    perm: Optional[torch.Tensor] = None):
    """Stage A: unpack -> canonical cores -> sort -> orient + permute.
    A later mate (``perm``: mate 1's permutation) computes its own cores
    (they align its delta: adjacent pairs usually overlap on mate 2 too)
    and follows mate 1's permutation in place of a sort, so pairs stay
    line-synchronized.  Qualities stay in their original orientation;
    with host-placed qualities (``qual`` None) ``qual_s`` is None."""
    lengths, codes_o, ck, cp, is_rc = _stage_a_prologue(
        seq_packed, lengths, exc_pos, k, seed, rank_lut)
    if perm is None:
        keys = core_match.build_sort_keys(codes_o, lengths, ck, cp, n_reads)
        perm = reorder.sort_permutation(keys)
    codes_s, len_s, ck_s, cp_s, rc_s = reorder.apply_permutation(
        perm, codes_o, lengths, ck, cp, is_rc)
    qual_s = None if qual is None else qual[perm]
    return perm, codes_s, qual_s, len_s, ck_s, cp_s, rc_s


def _device_stage_b(codes_s, qual_s, len_s, ck_s, cp_s, rc_s, n_reads: int,
                    order: int, qual_map: Optional[torch.Tensor] = None,
                    histogram: bool = True, grids=None):
    """Stage B: predecessor delta, then quality pass A (one K2 launch:
    the lossy map, the symbol/context grids, written into ``grids`` when
    given, and, with ``histogram``, their counts; a data-parallel group
    counts its blocks with one K6 launch instead).  Returns ``(delta,
    sym, ctx, counts)``; the last three are None for host-placed
    qualities (``qual_s`` None)."""
    delta = _delta_seq(codes_s, len_s, ck_s, cp_s, n_reads)
    delta["rc_bits"] = _pack_bits(rc_s)
    if qual_s is None:
        return delta, None, None, None
    sym, ctx, counts = qualities.sym_ctx_hist(qual_s, len_s, order,
                                              qual_map, histogram, grids)
    return delta, sym, ctx, counts


def encode_core(seq_packed, qual, lengths, n_reads: int, exc_pos, k: int,
                seed: int, order: int,
                qual_map: Optional[torch.Tensor] = None, grids=None,
                rank_lut: Optional[torch.Tensor] = None,
                perm: Optional[torch.Tensor] = None):
    """Stages A and B of one block -> ``(perm, delta, len_s)``: the
    reference's ``_encode_core`` (``_encode_core_nq`` when ``qual`` is
    None, ``_encode_core_mate2`` when ``perm``, mate 1's, is given)
    without its histogram, which a data-parallel group takes over all
    its blocks at once; K2 writes the quality grids into ``grids``, the
    block's slices of the group's ``(sym, ctx)``."""
    perm, *sorted_ = _device_stage_a(seq_packed, qual, lengths, n_reads,
                                     exc_pos, k, seed, rank_lut, perm)
    delta = _device_stage_b(*sorted_, n_reads, order, qual_map,
                            histogram=False, grids=grids)[0]
    return perm, delta, sorted_[2]


def delta_for_download(delta: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """The delta products as they cross to the host: the u32 literal
    words as their 32 bits (int32), every word (the count in use is
    known on the host only once ``n_lits`` lands)."""
    return {**delta, "lit_packed": to_u32_bits(delta["lit_packed"])}


def _delta_host(a: Dict[str, np.ndarray]) -> Dict:
    """The delta products on the host as the reference's numpy dtypes,
    from :func:`delta_for_download`'s arrays: the literal words in
    use."""
    n_lits = int(a["n_lits"])
    return {"mask_bits": a["mask_bits"], "shifts": a["shifts"],
            "lit_packed": a["lit_packed"][:(n_lits + 15) // 16].view(
                np.uint32),
            "n_lits": n_lits, "pred_k": a["pred_k"], "rc_bits": a["rc_bits"]}


def download_delta(delta: Dict[str, torch.Tensor]) -> Dict:
    """Blocking D2H of the delta products as the reference's numpy
    dtypes."""
    return _delta_host({k: t.cpu().numpy()
                        for k, t in delta_for_download(delta).items()})


def _hd_pack(len_s: torch.Tensor, ck_s: torch.Tensor, cp_s: torch.Tensor,
             rc_s: torch.Tensor, perm: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """The host-delta stage's outputs packed into one buffer of 2B u32
    words for one download (the reference's ``_hd_pack``), as int32
    holding the u32 bits.  The sorted codes do not cross: the host
    rebuilds the sorted oriented rows from its own block
    (``native.gather_orient``).

    Mate 1 (``perm`` given, the sorted frame, where equal cores are
    contiguous runs): ``[perm, cp<<17 | bnd<<16 | rc<<15 | len]``, bnd =
    first row of its core run or a NO_CORE row (row 0 always).  Mate 2
    (no ``perm``: mate-1 order, cores not contiguous): ``[ck, cp<<16 |
    rc<<15 | len]``.  cp < L <= 32752 and len <= 32752 fit 15 bits by
    Config."""
    len_s = len_s.to(torch.int64)
    cp = cp_s.to(torch.int64)
    rc = rc_s.to(torch.int64)
    if perm is None:
        parts = [ck_s, (cp << 16) | (rc << 15) | len_s]
    else:
        B = ck_s.shape[0]
        bnd = (ck_s != torch.roll(ck_s, 1)) | (ck_s == core_match.NO_CORE)
        bnd = bnd | (torch.arange(B, device=ck_s.device) == 0)
        parts = [perm.to(torch.int64),
                 (cp << 17) | (bnd.to(torch.int64) << 16) | (rc << 15)
                 | len_s]
    return to_u32_bits(torch.cat(parts) & MASK32)


def _hd_unpack(buf: np.ndarray, B: int,
               follow: Optional[np.ndarray] = None):
    """Host mirror of :func:`_hd_pack` (copy of the reference's; ``buf``
    the downloaded words viewed as uint32).  Returns ``(perm, key, cp,
    rc, len_s)`` where ``key`` is the boundary-bit vector (mate 1) or,
    for a later mate (``follow``: mate 1's permutation, returned as
    ``perm``), the core-id vector."""
    w = buf[B:2 * B]
    if follow is None:
        perm = buf[:B].astype(np.int64)
        key = ((w >> 16) & 1).astype(np.uint8)       # run-boundary bits
        cp = (w >> 17).astype(np.int32)
    else:
        perm = follow
        key = buf[:B]                                # core ids
        cp = (w >> 16).astype(np.int32)
    rc = ((w >> 15) & 1).astype(np.uint8)
    len_s = (w & 0x7FFF).astype(np.int32)
    return perm, key, cp, rc, len_s


def stage_a_hd(seq_packed, lengths, n_reads: int, exc_pos, k: int,
               seed: int, rank_lut: Optional[torch.Tensor] = None,
               perm: Optional[torch.Tensor] = None):
    """Stage A for the host-delta placement (the per-block body of the
    reference's ``_encode_core_hd``, or with ``perm``, mate 1's, of its
    ``_encode_core_mate2_hd``): cores -> sort (or mate 1's ``perm``) ->
    permute the per-read fields, packed by :func:`_hd_pack`; the delta
    match runs on the host.  Returns ``(buf, perm)``."""
    lengths, codes_o, ck, cp, is_rc = _stage_a_prologue(
        seq_packed, lengths, exc_pos, k, seed, rank_lut)
    follows = perm is not None
    if not follows:
        keys = core_match.build_sort_keys(codes_o, lengths, ck, cp, n_reads)
        perm = reorder.sort_permutation(keys)
    len_s, ck_s, cp_s, rc_s = reorder.apply_permutation(
        perm, lengths, ck, cp, is_rc)
    return _hd_pack(len_s, ck_s, cp_s, rc_s, None if follows else perm), perm


#: below this, the device link is slower than the host's own native
#: matcher and sort (the reference's AUTO rule)
_LINK_AUTO_THRESHOLD_MBPS = 200.0
_PROBE_BYTES = 4 << 20
_LINK_MBPS: Dict[torch.device, float] = {}
_LINK_LOCK = threading.Lock()


def device_link_mbps(device) -> float:
    """The link to ``device`` in MB/s, measured once per device and
    cached: a 4 MB round trip (upload, then download) through
    :class:`~scalce_tpu_torch.transfer.Link`'s page-locked staging,
    timed after one untimed round trip, under the span ``link probe``.
    Drives the AUTO core placement.  A probe that fails raises; the
    bytes must come back unchanged."""
    device = resolve_device(device)
    with _LINK_LOCK:
        if device not in _LINK_MBPS:
            with stage("link probe"):
                link = Link(device)
                payload = np.arange(_PROBE_BYTES, dtype=np.uint8)

                def round_trip():
                    staged = link.upload({"x": payload}).wait()
                    return link.download({"x": staged["x"]})[0].wait()["x"]
                round_trip()
                t0 = time.perf_counter()
                back = round_trip()
                dt = time.perf_counter() - t0
            if not np.array_equal(back, payload):
                raise RuntimeError(f"link probe on {device}: the round "
                                   "trip changed the bytes")
            _LINK_MBPS[device] = 2 * payload.nbytes / max(dt, 1e-6) / 1e6
        return _LINK_MBPS[device]


def host_core_available() -> bool:
    return native.AVAILABLE and hasattr(native, "core_match_block")


def host_delta_available() -> bool:
    return native.AVAILABLE and hasattr(native, "delta_match")


#: what :meth:`BlockEncoder.dispatch` gives each mate of a host-core
#: item: nothing was queued on any device
HOST_CORE = "hc"
#: what it gives each mate of a long-read item: nothing was queued either
LONG = "long"


@dataclasses.dataclass
class EncodedBlock:
    block_id: int
    n_reads: int
    payloads: Dict[str, bytes]      # 'n' / 'r' / 'q'

    @property
    def total_bytes(self) -> int:
        return sum(len(p) for p in self.payloads.values())


class BlockEncoder:
    """Per-block encoder on one device (``"cuda"``, ``"cuda:N"``, or
    ``"cpu"`` for the plain torch versions), with the lossy quality map
    ``qual_map`` (uint8 ``[256]``; None or the identity: lossless).  With
    ``cfg.qual_on_device`` False the qualities never reach the device:
    the host codec encodes them at assembly.

    The placement is the reference's (``host_delta``, ``host_core``,
    ``placement``; see the module docstring): AUTO (``core_on_device``
    None) measures the link once per device (:func:`device_link_mbps`)
    and keeps the cores on the host below 200 MB/s.  A host-core or
    long-read encoder (``long_mode``: no probe) makes no :class:`Link`
    and queues nothing on the device.

    An item is a tuple of mates: ``(block,)`` single-end, ``(mate 1,
    mate 2)`` for ``-r``.  Mate 1 sorts; each later mate computes its own
    cores and follows mate 1's permutation.  A group of items goes
    through :meth:`upload` (any thread: the driver runs it one group of
    ``D = 1`` item ahead), :meth:`dispatch` (the thread that owns the
    device: every kernel of each item and its downloads, queued without
    waiting) and :meth:`assemble` (any thread: waits for the downloads,
    then the payload bytes on the host), as
    :class:`~scalce_tpu_torch.parallel.mesh.ShardedEncoder`'s groups
    do."""

    #: items per group
    D = 1

    def __init__(self, cfg: Config, device, qual_map=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.qual_map_np = None if qual_map is None else np.asarray(
            qual_map, np.uint8)
        # host delta only with host-placed qualities (the device quality
        # path already holds the sorted block) and the native library
        self.host_delta = (not cfg.delta_on_device
                           and not cfg.qual_on_device
                           and host_delta_available())
        eligible = (self.host_delta and cfg.dict_mode == "hash"
                    and not cfg.data_parallel and host_core_available())
        #: long reads: the host numpy path (Config refuses device
        #: placements there), and no link probe
        self.long_mode = cfg.max_read_len > SHORT_READ_MAX
        if self.long_mode:
            want_host = False
        elif cfg.core_on_device is None:
            want_host = (eligible and device_link_mbps(self.device)
                         < _LINK_AUTO_THRESHOLD_MBPS)
        else:
            want_host = not cfg.core_on_device
        self.host_core = want_host and eligible
        #: nothing of the encoder touches the device
        self.on_host = self.host_core or self.long_mode
        self.placement = "host" if self.on_host else "device"
        #: the devices it queues work on (none on the host)
        self.devices = [] if self.on_host else [self.device]
        self.link = self.qual_map = self.rank_lut = None
        #: the explicit dictionary's ranks on the host (None: hash, or
        #: long reads, which rank no cores)
        self.rank_lut_np = None if self.long_mode else build_rank_lut(cfg)
        if not self.on_host:
            self.link = Link(self.device)
            self.qual_map = device_qual_map(qual_map, self.device)
            self.rank_lut = upload_rank_lut(self.rank_lut_np, self.link)

    def _upload(self, block: ReadBlock) -> Staged:
        """One block's H2D through page-locked staging: host-packed
        2-bit sequences, lengths, exception positions and, when they
        are device-placed, qualities.  The block's arrays are free
        again on return."""
        with stage("upload"):
            packed = _pack2bit_np(block.seq).reshape(block.seq.shape[0], -1)
            host = {"seq": packed, "len": block.lengths,
                    "exc": block.exc_pos}
            if self.cfg.qual_on_device:
                host["qual"] = block.qual
            return self.link.upload(host)

    def upload(self, group: Sequence[Tuple[ReadBlock, ...]]
               ) -> Optional[List[List[Staged]]]:
        """Each item's mates, uploaded in order (:meth:`_upload`): per
        item, one :class:`Staged` per mate; None for host core or long
        reads, which send nothing."""
        if self.on_host:
            return None
        return [[self._upload(b) for b in item] for item in group]

    def _wait(self, block: ReadBlock, pre: Optional[Staged]) -> Staged:
        """``pre`` (else the block's upload, made now), ordered before
        the work queued next."""
        return (pre if pre is not None else self._upload(block)).wait()

    def encode_device(self, item: Tuple[ReadBlock, ...],
                      pre: Optional[Sequence[Staged]] = None) -> List:
        """Stages A and B of each mate of ``item`` (``pre``: the mates'
        uploads, else made now), mate 1 first; each later mate follows
        mate 1's permutation.  Returns per mate ``(perm, delta, len_s,
        sym, ctx, counts)`` (the last three None for host-placed
        qualities; a later mate's ``perm`` is mate 1's, which its
        payload stores)."""
        outs, perm = [], None
        for c, (block, p) in enumerate(zip(item, pre or [None] * len(item))):
            outs.append(self._encode_mate(block, p, perm, c))
            perm = outs[0][0]
        return outs

    def _encode_mate(self, block: ReadBlock, pre: Optional[Staged],
                     perm: Optional[torch.Tensor], c: int):
        """Stages A and B of mate ``c`` (0: mate 1, which sorts; a later
        mate follows mate 1's ``perm``); its sorted codes and qualities
        are free again on return."""
        cfg = self.cfg
        x = self._wait(block, pre)
        mate = "" if c == 0 else f" (mate {c + 1})"
        with stage("stage A" + mate):
            perm, *sorted_ = _device_stage_a(
                x["seq"], x.get("qual"), x["len"], block.n_reads, x["exc"],
                cfg.core_k, cfg.dict_seed, self.rank_lut, perm)
        with stage("stage B" + mate):
            delta, sym, ctx, counts = _device_stage_b(
                *sorted_, block.n_reads, cfg.qual_context_order,
                self.qual_map)
        return perm, delta, sorted_[2], sym, ctx, counts

    def _dispatch(self, item: Tuple[ReadBlock, ...],
                  pre: Optional[Sequence[Staged]]) -> List:
        """Every kernel of one item and its downloads, queued: per mate
        one :class:`Fetched` from ONE :meth:`Link.download`."""
        if self.long_mode or self.host_core:
            return [LONG if self.long_mode else HOST_CORE] * len(item)
        if not self.host_delta:
            return self.download(item[0].seq.shape,
                                 *self.encode_device(item, pre))
        cfg = self.cfg
        bufs, perm = [], None
        for block, p in zip(item, pre or [None] * len(item)):
            x = self._wait(block, p)
            with stage("stage A"):
                buf, perm = stage_a_hd(x["seq"], x["len"], block.n_reads,
                                       x["exc"], cfg.core_k, cfg.dict_seed,
                                       self.rank_lut, perm)
            bufs.append({"hd": buf})
        with stage("download"):
            return self.link.download(*bufs)

    def dispatch(self, group: Sequence[Tuple[ReadBlock, ...]],
                 pre: Optional[List[List[Staged]]] = None) -> List[List]:
        """Every kernel of each item and its downloads, queued, item by
        item (``pre``: the group's :meth:`upload`, else each mate's made
        when its stage A needs it): :meth:`encode_device`, then
        :meth:`download`; under host delta, stage A and the packed
        buffers' download (marked ``"hd"``).  Returns per item one
        entry per mate: a :class:`Fetched`, or under host core
        :data:`HOST_CORE` and for long reads :data:`LONG` (nothing
        queued)."""
        return [self._dispatch(item, None if pre is None else pre[i])
                for i, item in enumerate(group)]

    def download(self, shape, *devouts) -> List[Fetched]:
        """The device half of assembly, for blocks of ``shape`` (B, L):
        pass B of each device output's quality grids (K3 and the
        compaction; none for host-placed qualities), then ONE queued
        download of everything :meth:`assemble` reads, per output."""
        cfg = self.cfg
        B, L = shape
        groups = []
        for perm, delta, len_s, sym, ctx, counts in devouts:
            g = {"perm": perm, "len_s": len_s, **delta_for_download(delta)}
            if sym is not None:
                with stage("pass B"):
                    g.update(qualities.pass_b(
                        sym, ctx, counts, B, L, cfg.qual_context_order,
                        T_target=cfg.qual_T_target))
            groups.append(g)
        with stage("download"):
            return self.link.download(*groups)

    def assemble(self, group: Sequence[Tuple[ReadBlock, ...]],
                 fetched: Sequence[Sequence]
                 ) -> List[Tuple[EncodedBlock, ...]]:
        """The host half of each item (:meth:`dispatch`'s ``fetched``):
        its mates' payload bytes, mate 1 first; each later mate follows
        mate 1's permutation.  Reads nothing of the device."""
        out = []
        for item, fs in zip(group, fetched):
            ebs, follow = [], None
            for block, f in zip(item, fs):
                eb, perm = self._assemble_mate(block, f, follow)
                follow = perm if follow is None else follow
                ebs.append(eb)
            out.append(tuple(ebs))
        return out

    def encode(self, group: Sequence[Tuple[ReadBlock, ...]]
               ) -> List[Tuple[EncodedBlock, ...]]:
        """Each item of ``group`` whole: :meth:`dispatch`, then
        :meth:`assemble`."""
        return self.assemble(group, self.dispatch(group))

    def _assemble_mate(self, block: ReadBlock, fetched,
                       follow: Optional[np.ndarray]
                       ) -> Tuple[EncodedBlock, np.ndarray]:
        """One mate's host half -> ``(payloads, permutation)``: wait for
        its downloads, then its payload bytes; the quality stream's
        lanes are gathered from the downloaded word matrix, or, for
        host-placed qualities, the host codec encodes the block's
        qualities through the sort permutation and the lossy map (the
        reference's ``_assemble``).  Host delta: the native match off
        the downloaded buffer; host core: the whole block on the host;
        long reads: the minimizer order and anchored delta on the host.
        ``follow``: mate 1's permutation, for a later mate (None for
        mate 1; the device path's download carries it)."""
        if fetched is LONG:
            return self._assemble_long(block, follow)
        if fetched is HOST_CORE:
            return self._assemble_hc(block, follow)
        cfg = self.cfg
        B, L = block.seq.shape
        a = fetched.wait()
        if "hd" in a:
            return self._assemble_hd(block, a["hd"].view(np.uint32), follow)
        enc_q = None
        if "packed" in a:
            with stage("pass B"):
                enc_q = qualities.encoded_from_host(
                    a, B, L, qualities.pick_T(B, L, cfg.qual_T_target),
                    cfg.qual_context_order)
        return self._assemble(block, a["perm"], a["len_s"], _delta_host(a),
                              enc_q)

    def _assemble_hd(self, block: ReadBlock, buf: np.ndarray,
                     follow: Optional[np.ndarray] = None):
        """Host-delta assembly (the reference's): the downloaded packed
        buffer, then the native byte-compare match (bit-identical to
        ``_delta_seq``) on the rows ``gather_orient`` rebuilds: over
        mate 1's sorted core runs, or a later mate's core ids.  Traced:
        the span ``host delta`` holds ``gather orient`` and ``delta
        match``, and the counter ``host_delta_blocks`` takes the block
        (also under host core)."""
        B, L = block.seq.shape
        perm_np, key, cp, rc, len_s = _hd_unpack(buf, B, follow)
        n = block.n_reads
        match = native.delta_match_runs if follow is None \
            else native.delta_match
        with stage("host delta"):
            with stage("gather orient"):
                codes_s = native.gather_orient(block.seq, perm_np[:n],
                                               rc[:n], len_s[:n])
            with stage("delta match"):
                mask_bits, shifts, pred_k, lits = match(
                    codes_s, key[:n], cp[:n], len_s[:n], _DELTA_K)
        timing.count("host_delta_blocks", 1)
        delta_np = {
            "mask_bits": mask_bits, "shifts": shifts, "pred_k": pred_k,
            "rc_bits": np.packbits(rc, bitorder="little"),
            "lits": lits, "n_lits": len(lits),
        }
        return self._assemble(block, perm_np, len_s, delta_np)

    def _assemble_hc(self, block: ReadBlock,
                     follow: Optional[np.ndarray] = None):
        """Host-core assembly (the reference's): the native canonical
        matcher and stable bucket sort (``core_match_block``,
        bit-identical to stage A; a later mate follows mate 1's
        permutation), then the host-delta path's match and payloads."""
        cfg = self.cfg
        B, L = block.seq.shape
        n = block.n_reads
        with stage("host core"):
            ck, cp, rc, perm_n = native.core_match_block(
                block.seq, block.lengths, block.exc_pos, n, cfg.core_k,
                cfg.dict_seed)
            perm_np = follow if follow is not None else np.concatenate(
                [perm_n, np.arange(n, B, dtype=np.int64)])
            order_n = perm_np[:n]
            ck_s = ck[order_n]
            cp_s = cp[order_n]
            rc_s = rc[order_n]
            len_n = block.lengths[order_n].astype(np.int64)
            len_s = np.zeros(B, np.int32)
            len_s[:n] = len_n
        with stage("host delta"):
            with stage("gather orient"):
                codes_s = native.gather_orient(block.seq, order_n, rc_s,
                                               len_n)
            with stage("delta match"):
                if follow is not None:     # cores NOT contiguous runs
                    mask_bits, shifts, pred_k, lits = native.delta_match(
                        codes_s, ck_s, cp_s, len_n, _DELTA_K)
                else:
                    bnd = np.ones(n, np.uint8)
                    if n > 1:
                        bnd[1:] = ((ck_s[1:] != ck_s[:-1])
                                   | (ck_s[1:]
                                      == np.uint32(core_match.NO_CORE))
                                   ).astype(np.uint8)
                    mask_bits, shifts, pred_k, lits = \
                        native.delta_match_runs(codes_s, bnd, cp_s, len_n,
                                                _DELTA_K)
        timing.count("host_delta_blocks", 1)
        rc_full = np.zeros(B, np.uint8)
        rc_full[:n] = rc_s
        delta_np = {
            "mask_bits": mask_bits, "shifts": shifts, "pred_k": pred_k,
            "rc_bits": np.packbits(rc_full, bitorder="little"),
            "lits": lits, "n_lits": len(lits),
        }
        return self._assemble(block, perm_np, len_s, delta_np)

    def _long_order(self, block: ReadBlock, h=None, mp=None) -> np.ndarray:
        """Long reads' order (the reference's): by (minimizer hash,
        -position), ties stable; the identity when fewer than two reads
        carry a key."""
        n = block.n_reads
        if h is None:
            h, mp = minimizer_keys(block.seq[:n],
                                   block.lengths[:n].astype(np.int64))
        if n >= 2 and int((h != NO_KEY).sum()) >= 2:
            return np.lexsort((-mp, h)).astype(np.int64)
        return np.arange(n, dtype=np.int64)

    def _assemble_long(self, block: ReadBlock,
                       follow: Optional[np.ndarray] = None):
        """Long-read assembly (the reference's, container v7): reads
        sorted by their global minimizer, so that overlapping reads are
        neighbours; each read's ``nseg`` equal segments copy from the
        predecessor at the shift of a segment minimizer the two share
        (else the global minimizers' shift), and a segment matching
        under 50% of its cells falls back to literals with shift 0.
        ``follow``: mate 1's order (a pair's mate 2 follows it).  The
        ``[n, L]`` int64 temporaries keep the reference's formulation:
        the bytes depend on it."""
        B, L = block.seq.shape
        n = block.n_reads
        with stage("long order"):
            len_n0 = block.lengths[:n].astype(np.int64)
            med = int(np.median(len_n0)) if n else 0
            nseg = 1 << max(2, min(8, (med // _LONG_SEG_LEN).bit_length()))
            h, mp = minimizer_keys(block.seq[:n], len_n0)
            order_n = self._long_order(block, h, mp) if follow is None \
                else follow[:n]
        with stage("long delta"):
            codes_s = block.seq[:n][order_n]
            len_n = len_n0[order_n]
            h_s = h[order_n]
            mp_s = mp[order_n]
            match = np.zeros((n, L), bool)
            col = np.arange(L, dtype=np.int64)[None, :]
            seg_shift = np.zeros((n, nseg), np.int64)
            if n >= 2:
                same = np.zeros(n, bool)
                same[1:] = (h_s[1:] == h_s[:-1]) & (h_s[1:] != NO_KEY)
                prev_mp = np.zeros(n, np.int64)
                prev_mp[1:] = mp_s[:-1]
                prev_len = np.zeros(n, np.int64)
                prev_len[1:] = len_n[:-1]
                gshift = np.where(same, prev_mp - mp_s, 0)
                sh_cur, sp_cur = segment_minimizer_keys(codes_s, len_n, nseg)
                sh_prev = np.roll(sh_cur, 1, axis=0)
                sp_prev = np.roll(sp_cur, 1, axis=0)
                seg_shift[:] = gshift[:, None]
                # first match wins, over rows at once, one segment of the
                # read at a time
                rows_i = np.arange(n)
                for a in range(nseg):
                    eq_a = (sh_cur[:, a:a + 1] == sh_prev) \
                        & (sh_cur[:, a:a + 1] != NO_KEY)   # [n, nseg]
                    hit = eq_a.any(axis=1) & same
                    b_idx = eq_a.argmax(axis=1)            # first True
                    matched = sp_prev[rows_i, b_idx] - sp_cur[:, a]
                    seg_shift[:, a] = np.where(hit, matched,
                                               seg_shift[:, a])
                seg_shift = np.where(same[:, None], seg_shift, 0)
                # the decoder's column -> segment map
                # (seqs._cell_shifts)
                seg_of = np.minimum((col * nseg)
                                    // np.maximum(len_n[:, None], 1),
                                    nseg - 1)
                cell_shift = np.take_along_axis(seg_shift, seg_of, axis=1)
                pidx = col + cell_shift
                inb = (pidx >= 0) & (pidx < prev_len[:, None])
                prev_rows = np.roll(codes_s, 1, axis=0)
                aligned = np.take_along_axis(prev_rows,
                                             np.clip(pidx, 0, L - 1), axis=1)
                valid = col < len_n[:, None]
                match = (same[:, None] & inb & (aligned == codes_s) & valid)
                # per segment: under a 50% match rate (random 2-bit codes
                # match 25%) the mask costs more than the literals saved
                for s in range(nseg):
                    in_seg = seg_of == s
                    seg_cells = (in_seg & valid).sum(axis=1)
                    seg_match = (match & in_seg).sum(axis=1)
                    kill = seg_match * 2 < seg_cells
                    match &= ~(kill[:, None] & in_seg)
                    seg_shift[kill, s] = 0
            valid = col < len_n[:, None]
            lits = codes_s[(~match) & valid]
        perm_np = np.concatenate([order_n, np.arange(n, B, dtype=np.int64)])
        len_s = np.zeros(B, np.int32)
        len_s[:n] = len_n
        delta_np = {
            "mask_bits": np.packbits(match, axis=1, bitorder="little"),
            "shifts": seg_shift.astype(np.int32),     # v7: [n, nseg]
            "pred_k": np.zeros(n, np.uint8),
            "rc_bits": np.zeros((B + 7) // 8, np.uint8),
            "lits": lits, "n_lits": len(lits),
        }
        return self._assemble(block, perm_np, len_s, delta_np)

    def _assemble(self, block: ReadBlock, perm_np: np.ndarray,
                  len_np: np.ndarray, delta_np: Dict,
                  enc_q=None) -> Tuple[EncodedBlock, np.ndarray]:
        """Payload bytes of one block from its permutation, sorted
        lengths and delta products (``"lits"`` bytes from the host
        match, or the device's literal words), and its encoded qualities
        (None: the host codec encodes them here) -> ``(payloads,
        perm_np)``, the permutation a later mate follows."""
        cfg = self.cfg
        B, L = block.seq.shape
        timing.count("literals", delta_np["n_lits"])
        if enc_q is None:
            with stage("quality encode (host)"):
                enc_q = qualities_host.encode_host(
                    block.qual, len_np, cfg.qual_context_order,
                    T_target=cfg.qual_T_target, qual_map=self.qual_map_np,
                    perm=perm_np)
        with stage("quality payload"):
            q_payload = qualities.payload(enc_q, backend=cfg.backend)
        with stage("seqs.payload"):
            # exceptions into the reordered frame (host; exceptions are
            # rare)
            inv = np.empty(B, np.int64)
            inv[perm_np] = np.arange(B)
            if block.exc_pos.size:
                rows, cols = block.exc_pos // L, block.exc_pos % L
                new_pos = inv[rows] * L + cols
                order_idx = np.argsort(new_pos, kind="stable")
                exc_pos_s = new_pos[order_idx]
                exc_byte_s = block.exc_byte[order_idx]
            else:
                exc_pos_s = block.exc_pos
                exc_byte_s = block.exc_byte
            r_payload = seqs.payload(delta_np, len_np, block.n_reads,
                                     exc_pos_s, exc_byte_s, perm_np,
                                     backend=cfg.backend)
        with stage("names payload"):
            n_payload = self._encode_names(block)
        return EncodedBlock(block.block_id, block.n_reads, {
            "n": n_payload, "r": r_payload, "q": q_payload}), perm_np

    def _encode_names(self, block: ReadBlock) -> bytes:
        """Names stay in original order (copy of the reference's)."""
        n = block.n_reads
        arrays = {"n": np.asarray([n], np.int64)}
        deflate = []
        if self.cfg.name_lib is not None:
            arrays["template"] = np.asarray([1], np.uint8)
        else:
            blob = names_stream.encode(block.names, n,
                                       backend=self.cfg.backend)
            arrays["names_blob"] = np.frombuffer(blob, np.uint8)
        if block.plus is not None:
            arrays["plus_cat"] = block.plus.cat
            arrays["plus_lens"] = block.plus.lens.astype(np.uint32)
            deflate += ["plus_cat", "plus_lens"]
        return container.pack_arrays(arrays, deflate=deflate,
                                     backend=self.cfg.backend)


def file_meta(cfg: Config) -> Dict:
    """Per-file metadata shared by every block (copy of the reference's:
    the container header holds it)."""
    return {
        "block_reads": cfg.block_reads,
        "max_read_len": cfg.max_read_len,
        "core_k": cfg.core_k,
        "dict_seed": cfg.dict_seed,
        "qual_order": cfg.qual_context_order,
        "lossy_pct": cfg.lossy_pct,
        "name_lib": cfg.name_lib,
        "paired": cfg.paired,
    }
