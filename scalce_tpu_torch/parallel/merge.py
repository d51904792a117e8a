# Copy of scalce_tpu/parallel/merge.py (only the imports differ).
"""Deterministic multi-host output merge (the "ordered gather").

Multi-host encode (SURVEY.md §3 "Multi-host DP"): every host parses the
input, encodes only the blocks it owns (``block_id % n_hosts ==
host_id``), and writes a private triplet ``<prefix>.hostH.*``.  The
merge step re-frames all hosts' blocks into the final triplet in
block_id order with the same part-splitting policy — so the N-host
output is BYTE-IDENTICAL to the 1-host output (SURVEY.md §5:
"determinism test = N-host output must be byte-identical to 1-host"),
because every block payload is a pure function of (input block, config)
and the merge order is a pure function of block ids.

This is host-level data movement over DCN/filesystem, not a tensor
collective — the reference analogue is nothing at all (it has no
multi-node story); the TPU-native design gets it by block construction.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from scalce_tpu_torch import container


def host_prefix(prefix: str, host_id: int) -> str:
    return f"{prefix}.host{host_id}"


def owns_block(block_id: int, host_id: int, n_hosts: int) -> bool:
    return block_id % n_hosts == host_id


def merge_host_outputs(prefix: str, n_hosts: int, part_size: int = 0,
                       mate: Optional[int] = None,
                       cleanup: bool = True) -> int:
    """Merge per-host triplets into the final triplet; returns n_blocks.

    Blocks are interleaved back into ascending block_id order; framing,
    metadata, and part roll-over match what a single host would have
    produced.
    """
    readers = [container.TripletReader(
        container.part_paths(host_prefix(prefix, h), 0, mate)["r"])
        for h in range(n_hosts)]
    meta = readers[0].meta
    iters = [r.iter_blocks() for r in readers]
    heads = []
    for it in iters:
        heads.append(next(it, None))

    writer = container.TripletWriter(prefix, meta, part_size=part_size,
                                     mate=mate)
    n_blocks = 0
    expected = 0
    while True:
        h = expected % n_hosts
        item = heads[h]
        if item is None:
            # this host is drained; every other head must be too
            if any(x is not None for x in heads):
                live = [i for i, x in enumerate(heads) if x is not None]
                raise ValueError(
                    f"merge: missing block {expected} from host {h} but "
                    f"hosts {live} still have blocks — incomplete encode?")
            break
        bid, payloads = item
        if bid != expected:
            raise ValueError(f"merge: host {h} produced block {bid}, "
                             f"expected {expected}")
        n_records = _block_records(payloads)
        writer.add_block(bid, payloads, n_records)
        heads[h] = next(iters[h], None)
        expected += 1
        n_blocks += 1
    writer.close()
    if cleanup:
        for h in range(n_hosts):
            _remove_host_files(host_prefix(prefix, h), mate)
    return n_blocks


def _block_records(payloads: Dict[str, bytes]) -> int:
    a = container.unpack_arrays(payloads["n"])
    return int(a["n"][0])


def _remove_host_files(hprefix: str, mate: Optional[int]) -> None:
    p = 0
    while True:
        paths = container.part_paths(hprefix, p, mate)
        if not os.path.exists(paths["r"]):
            return
        for f in paths.values():
            os.remove(f)
        p += 1
