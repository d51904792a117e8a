"""Block decode pipeline (port of ``scalce_tpu/pipeline/decode.py``).

Per group of up to ``DECODE_GROUP`` blocks: the host parses each
block's sequence payload (serial delta walk in the native library), the
qualities decode on the host (``qualities_host.decode_host``, the
default) or in one K4 launch for every block (``qual_on_device``), then
``_finish`` restores strand orientation, names and — under keep-order —
arrival order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from scalce_tpu_torch import container, native
from scalce_tpu_torch.io.fastq import Ragged, lens_to_offsets, reorder_ragged
from scalce_tpu_torch.streams import names as names_stream
from scalce_tpu_torch.device import resolve_device
from scalce_tpu_torch.timing import stage
from scalce_tpu_torch.streams import qualities, qualities_host, seqs


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
                 qual_on_device: bool = False):
        self.meta = meta
        self.device = resolve_device(device)
        self.keep_order = keep_order
        #: quality-decode placement, a per-run choice (the payload does
        #: not depend on where it was encoded)
        self.qual_on_device = qual_on_device
        self._name_counter = 1          # template-mode running index

    def parse_block(self, payloads: Dict[str, bytes]):
        """Host payload parse: seq reconstruct + quality stream fields."""
        B = int(self.meta["block_reads"])
        L = int(self.meta["max_read_len"])
        with stage("seqs.parse"):
            parsed = seqs.parse(payloads["r"], B, L)
        with stage("qualities.parse"):
            return parsed, qualities.parse(payloads["q"])

    def decode_blocks(self, payload_list) -> List["DecodedBlock"]:
        """Decode up to DECODE_GROUP blocks.  On the device their
        qualities decode in one launch (D = the group's size) unless
        their (B, L, T, order) differ, as per-block order selection can
        make them; on the host, block by block."""
        parsed, encs = zip(*(self.parse_block(p) for p in payload_list))
        lengths = [pr[1] for pr in parsed]
        with stage("quality decode"):
            if not self.qual_on_device:
                quals = [qualities_host.decode_host(e, ln)
                         for e, ln in zip(encs, lengths)]
            elif len({(e.B, e.L, e.T, e.order) for e in encs}) == 1:
                quals = qualities.decode_batch(list(encs), lengths,
                                               self.device)
            else:
                quals = [qualities.decode_batch([e], [ln], self.device)[0]
                         for e, ln in zip(encs, lengths)]
        with stage("_finish"):
            return [self._finish(p, pr, q)
                    for p, pr, q in zip(payload_list, parsed, quals)]

    def _finish(self, payloads: Dict[str, bytes], parsed,
                qual: np.ndarray) -> DecodedBlock:
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
            names = names_stream.template_names(lib, self._name_counter, n)
            self._name_counter += n
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
