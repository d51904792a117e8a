"""Block decode pipeline (port of ``scalce_tpu/pipeline/decode.py``).

Per group of up to ``DECODE_GROUP`` blocks: :meth:`BlockDecoder.parse_block`
parses each block's payloads on the host (the sequences by a serial
delta walk in the native library; with ``delta_on_device`` only their
fields, deep-validated); with ``qual_on_device``,
:meth:`BlockDecoder.dispatch_quals` decodes the group's qualities in one
K4 launch and queues the grids' download, and with ``delta_on_device``
:meth:`BlockDecoder.dispatch_seqs` uploads each block's delta fields,
queues its pointer-doubling reconstruction (``ops/delta_decode.py``) and
the codes' download (both on the thread that owns the device);
:meth:`BlockDecoder.finish_block` waits, for one block, for its codes and
its row of the group's grids, or decodes its qualities on the host
(``qualities_host.decode_host``, the default), then ``_finish`` restores
strand orientation, names and, under keep-order, arrival order.  Parse
and each block's finish run on any thread.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from scalce_tpu_torch import container, native
from scalce_tpu_torch.io.fastq import Ragged, lens_to_offsets, reorder_ragged
from scalce_tpu_torch.streams import names as names_stream
from scalce_tpu_torch.device import resolve_device
from scalce_tpu_torch.ops import delta_decode
from scalce_tpu_torch.timing import stage
from scalce_tpu_torch.streams import qualities, qualities_host, seqs
from scalce_tpu_torch.transfer import Link


@dataclasses.dataclass
class DecodedBlock:
    seq: np.ndarray          # uint8 [B, L] 2-bit codes
    qual: np.ndarray         # uint8 [B, L]
    lengths: np.ndarray      # int32 [B]
    n_reads: int
    exc_pos: np.ndarray
    exc_byte: np.ndarray
    names: Ragged
    plus: Optional[Ragged]


#: blocks whose quality streams share one K4 launch
DECODE_GROUP = 4


class BlockDecoder:
    def __init__(self, meta: Dict, device, keep_order: bool = False,
                 qual_on_device: bool = False,
                 delta_on_device: bool = False):
        self.meta = meta
        self.device = resolve_device(device)
        self.link = Link(self.device)
        self.keep_order = keep_order
        #: quality-decode placement, a per-run choice (the payload does
        #: not depend on where it was encoded)
        self.qual_on_device = qual_on_device
        #: sequence-delta decode placement: pointer doubling on the
        #: device or the serial host walk
        self.delta_on_device = delta_on_device
        if delta_on_device and int(meta["max_read_len"]) > 32752:
            raise ValueError("--delta-device does not decode long-read "
                             "files (max_read_len > 32752): the host walk "
                             "only")

    def parse_block(self, payloads: Dict[str, bytes]):
        """Host payload parse: the sequences (reconstructed, or under
        ``delta_on_device`` their validated fields, padded for the
        upload, in the codes' place) and the quality stream's fields."""
        B = int(self.meta["block_reads"])
        L = int(self.meta["max_read_len"])
        with stage("seqs.parse"):
            if self.delta_on_device:
                fields, lengths, n, *rest = seqs.parse_fields(
                    payloads["r"], B, L, delta_device=True)
                parsed = (delta_decode.host_inputs(
                    fields["mask_bits"], fields["shifts"],
                    fields["pred_k"], fields["lits"], lengths[:n], B, L),
                    lengths, n, *rest)
            else:
                parsed = seqs.parse(payloads["r"], B, L)
        with stage("qualities.parse"):
            return parsed, qualities.parse(payloads["q"])

    def dispatch_seqs(self, parsed_list):
        """Under ``delta_on_device``, per block of the group, queued: the
        upload of its delta fields, the reconstruction and the codes'
        download (one :class:`~scalce_tpu_torch.transfer.Fetched` each);
        else None (the codes are in ``parsed_list`` already)."""
        if not self.delta_on_device:
            return None
        L = int(self.meta["max_read_len"])
        out = []
        with stage("delta decode (device)"):
            for pr in parsed_list:
                x = self.link.upload(pr[0]).wait()
                codes = delta_decode.reconstruct(
                    x["mask_bits"], x["shifts"], x["pred_k"], x["lits"],
                    x["lengths"], L)
                out += self.link.download({"codes": codes})
        return out

    def dispatch_quals(self, parsed_list, encs):
        """The group's quality decode on the device, queued: one K4
        launch (the blocks must share (B, L, T, order), as per-block
        order selection may not make them) and the grids' download.  For
        host placement the streams pass through to :meth:`finish_block`."""
        if not self.qual_on_device:
            return encs
        with stage("quality decode"):
            return qualities.decode_batch_dispatch(
                list(encs), [pr[1] for pr in parsed_list], self.link)

    def decode_qual_single(self, enc, lengths) -> np.ndarray:
        """One block's qualities decoded on the host."""
        return qualities_host.decode_host(enc, lengths)

    def finish_block(self, payloads: Dict[str, bytes], parsed, dev, d: int,
                     name_start: int, seq_dev=None) -> DecodedBlock:
        """The host half of one block: its codes (its
        :meth:`dispatch_seqs` download, when ``seq_dev`` holds it), its
        qualities (row ``d`` of the group's :meth:`dispatch_quals`
        download, which the group's blocks share, or its stream
        ``dev[d]`` decoded here on the host), then :meth:`_finish`;
        ``name_start``: its first template-name index."""
        if seq_dev is not None:
            with stage("delta decode (device)"):
                parsed = (seq_dev.wait()["codes"], *parsed[1:])
        if self.qual_on_device:
            with stage("quality decode"):
                qual = qualities.decode_batch_fetch(dev)[d]
        else:
            with stage("quality decode (host)"):
                qual = self.decode_qual_single(dev[d], parsed[1])
        with stage("_finish"):
            return self._finish(payloads, parsed, qual, name_start)

    def _finish(self, payloads: Dict[str, bytes], parsed,
                qual: np.ndarray, name_start: int) -> DecodedBlock:
        """Copy of the reference's: rc flip, names, keep-order."""
        seq, lengths, n_reads, exc_pos, exc_byte, perm, rc = parsed
        L = seq.shape[1]

        if rc.any():
            # flip strand-canonicalized sequences back to input
            # orientation (qualities were never flipped)
            if native.AVAILABLE:
                seq = np.ascontiguousarray(seq)
                native.rc_flip_rows(seq, lengths, rc)
            else:
                col = np.arange(L)[None, :]
                src = lengths[:, None] - 1 - col
                safe = np.maximum(src, 0)
                fseq = np.take_along_axis(seq, safe, axis=1)
                fseq = np.where(src >= 0, 3 - fseq, 0).astype(np.uint8)
                seq = np.where(rc[:, None], fseq, seq)

        na = container.unpack_arrays(payloads["n"])
        n = int(na["n"][0])
        if n != n_reads:
            raise ValueError("stream record-count mismatch")
        if "template" in na:
            lib = self.meta.get("name_lib") or "lib"
            names = names_stream.template_names(lib, name_start, n)
            names_orig_order = self.keep_order   # template: emit as-is
        else:
            names = names_stream.decode(na["names_blob"].tobytes())
            names_orig_order = True              # stored in original order
        plus: Optional[Ragged] = None
        if "plus_cat" in na:
            plus = Ragged(na["plus_cat"].copy(),
                          lens_to_offsets(na["plus_lens"].astype(np.int64)))

        if self.keep_order:
            # restore arrival order: reordered row i came from perm[i]
            inv = np.zeros(n_reads, np.int64)
            inv[perm] = np.arange(n_reads)
            seq2, qual2 = np.zeros_like(seq), np.zeros_like(qual)
            seq2[:n_reads] = seq[inv]
            qual2[:n_reads] = qual[inv]
            seq, qual = seq2, qual2
            lengths2 = np.zeros_like(lengths)
            lengths2[:n_reads] = lengths[inv]
            lengths = lengths2
            if exc_pos.size:
                rows, cols = exc_pos // L, exc_pos % L
                new_pos = perm[rows] * L + cols
                o = np.argsort(new_pos, kind="stable")
                exc_pos, exc_byte = new_pos[o], exc_byte[o]
        else:
            # align original-order names/plus with the reordered reads
            if names_orig_order and "template" not in na:
                names = reorder_ragged(names, perm[:n_reads])
            if plus is not None:
                plus = reorder_ragged(plus, perm[:n_reads])
        return DecodedBlock(seq=seq, qual=qual, lengths=lengths,
                            n_reads=n_reads, exc_pos=exc_pos,
                            exc_byte=exc_byte, names=names, plus=plus)
