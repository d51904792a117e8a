# Copy of scalce_tpu/container.py (only the imports differ).
"""On-disk container: the triplet stream files and block framing.

The reference emits three output files per input — ``.scalcen`` (names),
``.scalcer`` (sequences), ``.scalceq`` (qualities) — optionally split
into fixed-size parts ``name.00``, ``name.01`` … [REF: scalce output
layout — UNVERIFIED; SURVEY.md §1 items 3, 7].  scalce_tpu keeps the
same user-visible surface (same extensions, same part numbering) but the
inside is block-granular: every block is independently decodable, which
is what makes part splitting, retry/resume, and multi-host ordered
merge trivial by construction (SURVEY.md §6 "Failure detection",
"Checkpoint / resume").

File layout (little-endian):

  header  MAGIC(8) ver(u16) kind(1 byte: n/r/q) reserved(u8)
          meta_len(u32) meta_json
  block   BLK0(4) block_id(u32) n_records(u64) payload_len(u64) payload
  footer  FTR0(4) n_blocks(u32) total_records(u64) end_magic(8)

The footer is written last — a torn write leaves it missing, which the
reader reports (SURVEY.md §6: torn-write detection).

Block payloads are dictionaries of named numpy arrays serialized by
``pack_arrays`` (per-array optional deflate), so stream modules never
hand-roll offsets.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"SCLCTPU1"
END_MAGIC = b"1UPTCLCS"
#: bumped on any change to payload SEMANTICS, not just framing (v2:
#: qualities stored in original orientation for rc reads; v3: zstd
#: array codec added; v4: order-1 quality contexts use full prev1;
#: v5: order-3 quality contexts may appear (auto-trial), and long-read
#: mode (max_read_len > 32752) stores wide u32 length/count fields —
#: a strictly-v4 reader must reject these instead of misreporting a
#: valid file as corrupt; v6: long-read blocks may carry
#: minimizer-reordered reads with anchored predecessor delta — wide
#: i32 shifts as four zig-zag planes (``shv4_*``) and a non-identity
#: permutation)
#: v7: long-read blocks carry MULTI-ANCHOR delta — ``nseg`` segment
#: shifts per read (flat read-major through the ``shv4`` planes) with
#: per-segment copy masks; columns map to segments by
#: ``min(col*nseg//len, nseg-1)``.  v4-v6 files remain readable.
VERSION = 7
_READABLE_VERSIONS = (4, 5, 6, 7)  # v<=3: different quality context
                                # map — decoding them with this code
                                # would silently corrupt, so reject them
_BLK = b"BLK0"
_FTR = b"FTR0"

STREAM_EXT = {"n": ".scalcen", "r": ".scalcer", "q": ".scalceq"}


# ---------------------------------------------------------------------------
# array (de)serialization

_DTYPES = {
    "u1": np.uint8, "u2": np.uint16, "u4": np.uint32, "u8": np.uint64,
    "i1": np.int8, "i2": np.int16, "i4": np.int32, "i8": np.int64,
}

#: generic byte-backend codecs (the reference's gz/bz/no output modes,
#: selected per run by ``--backend`` [REF: scalce buffio.c mode select —
#: UNVERIFIED; SURVEY.md §2 L0]); codec id is stored per array so the
#: reader never consults run config.
_CODEC_NONE, _CODEC_ZLIB, _CODEC_BZ2, _CODEC_ZSTD = 0, 1, 2, 3
_CODEC_OF_BACKEND = {"no": _CODEC_NONE, "gz": _CODEC_ZLIB, "bz": _CODEC_BZ2,
                     "zstd": _CODEC_ZSTD}


_BACKEND_OF_CODEC = {v: k for k, v in _CODEC_OF_BACKEND.items()}


def _codec_compress(codec: int, raw: bytes, level: int) -> bytes:
    from scalce_tpu_torch.io.backend import compress_bytes
    return compress_bytes(raw, _BACKEND_OF_CODEC[codec], level)


def _codec_decompress(codec: int, data: bytes) -> bytes:
    from scalce_tpu_torch.io.backend import decompress_bytes
    if codec not in _BACKEND_OF_CODEC:
        raise ValueError(f"corrupt array: unknown codec {codec}")
    return decompress_bytes(data, _BACKEND_OF_CODEC[codec])


def pack_arrays(arrays: Dict[str, np.ndarray],
                deflate: Sequence[str] = (), level: int = 6,
                backend: str = "gz") -> bytes:
    """Serialize named arrays; names in ``deflate`` go through the
    selected generic byte backend (zstd/gz/bz/no).

    ``deflate`` may be a sequence of names (all at ``level``) or a
    mapping name -> level — entropy-coded arrays cost real CPU to
    compress for zero gain, so hot callers tune per array.
    """
    codec = _CODEC_OF_BACKEND[backend]
    levels = deflate if isinstance(deflate, dict) else \
        {k: level for k in deflate}
    out = io.BytesIO()
    out.write(struct.pack("<H", len(arrays)))
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        code = arr.dtype.str[1:]          # e.g. 'u4'
        if code not in _DTYPES:
            raise ValueError(f"unsupported dtype {arr.dtype} for {name!r}")
        raw = arr.tobytes()
        c = codec if name in levels else _CODEC_NONE
        data = _codec_compress(c, raw, levels.get(name, level))
        if len(data) >= len(raw):         # store incompressible raw
            c, data = _CODEC_NONE, raw
        nb = name.encode()
        out.write(struct.pack("<B", len(nb)))
        out.write(nb)
        out.write(struct.pack("<2sBB", code.encode(), c, arr.ndim))
        out.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
        out.write(struct.pack("<QQ", len(data), len(raw)))
        out.write(data)
    return out.getvalue()


def unpack_arrays(data: bytes) -> Dict[str, np.ndarray]:
    view = memoryview(data)
    pos = 0
    (n,) = struct.unpack_from("<H", view, pos); pos += 2
    out: Dict[str, np.ndarray] = {}
    for _ in range(n):
        (ln,) = struct.unpack_from("<B", view, pos); pos += 1
        name = bytes(view[pos:pos + ln]).decode(); pos += ln
        code, codec, ndim = struct.unpack_from("<2sBB", view, pos); pos += 4
        shape = struct.unpack_from(f"<{ndim}q", view, pos); pos += 8 * ndim
        dlen, rlen = struct.unpack_from("<QQ", view, pos); pos += 16
        payload = bytes(view[pos:pos + dlen]); pos += dlen
        raw = _codec_decompress(codec, payload)
        if len(raw) != rlen:
            raise ValueError(f"corrupt array {name!r}")
        out[name] = np.frombuffer(raw, dtype=_DTYPES[code.decode()]
                                  ).reshape(shape)
    return out


# ---------------------------------------------------------------------------
# single stream file

class StreamWriter:
    """Appends framed blocks to one stream file."""

    def __init__(self, path: str, kind: str, meta: Dict):
        self.path = path
        self._f = open(path, "wb")
        meta_json = json.dumps(meta, sort_keys=True).encode()
        self._f.write(MAGIC)
        self._f.write(struct.pack("<H", VERSION))
        self._f.write(kind.encode())
        self._f.write(b"\0")
        self._f.write(struct.pack("<I", len(meta_json)))
        self._f.write(meta_json)
        self.n_blocks = 0
        self.n_records = 0

    def add_block(self, block_id: int, payload: bytes, n_records: int) -> None:
        self._f.write(_BLK)
        self._f.write(struct.pack("<IQQ", block_id, n_records, len(payload)))
        self._f.write(payload)
        self.n_blocks += 1
        self.n_records += n_records

    @property
    def bytes_written(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        self._f.write(_FTR)
        self._f.write(struct.pack("<IQ", self.n_blocks, self.n_records))
        self._f.write(END_MAGIC)
        self._f.close()


@dataclasses.dataclass
class StreamBlockRef:
    block_id: int
    offset: int
    length: int
    n_records: int = 0


class StreamReader:
    """Scans one stream file; validates framing and footer."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        hdr = self._f.read(8)
        if hdr != MAGIC:
            raise ValueError(f"{path}: not a scalce_tpu stream")
        (ver,) = struct.unpack("<H", self._f.read(2))
        if ver not in _READABLE_VERSIONS:
            raise ValueError(f"{path}: unsupported version {ver}")
        self.kind = self._f.read(1).decode()
        self._f.read(1)
        (mlen,) = struct.unpack("<I", self._f.read(4))
        self.meta = json.loads(self._f.read(mlen))
        self.blocks: List[StreamBlockRef] = []
        self._scan()

    def _scan(self) -> None:
        size = os.fstat(self._f.fileno()).st_size
        while True:
            tag = self._f.read(4)
            if tag == _BLK:
                hdr = self._f.read(20)
                if len(hdr) < 20:
                    raise ValueError(f"{self.path}: truncated stream "
                                     "(torn write?)")
                bid, nrec, plen = struct.unpack("<IQQ", hdr)
                off = self._f.tell()
                if off + plen > size:
                    raise ValueError(f"{self.path}: truncated block "
                                     "(torn write?)")
                self.blocks.append(StreamBlockRef(bid, off, plen, nrec))
                self._f.seek(plen, os.SEEK_CUR)
            elif tag == _FTR:
                ftr = self._f.read(20)
                if len(ftr) < 20 or ftr[12:20] != END_MAGIC:
                    raise ValueError(f"{self.path}: corrupt footer "
                                     "(torn write?)")
                nb, nr = struct.unpack("<IQ", ftr[:12])
                if nb != len(self.blocks):
                    raise ValueError(f"{self.path}: footer block count "
                                     f"mismatch ({nb} != {len(self.blocks)})")
                self.n_records = nr
                return
            elif tag == b"":
                raise ValueError(
                    f"{self.path}: truncated stream (no footer — torn write?)")
            else:
                raise ValueError(f"{self.path}: corrupt block framing")

    def read_block(self, ref: StreamBlockRef) -> bytes:
        self._f.seek(ref.offset)
        return self._f.read(ref.length)

    def close(self) -> None:
        self._f.close()


# ---------------------------------------------------------------------------
# triplet management (the user-facing unit) + part splitting

def part_paths(prefix: str, part: int, mate: Optional[int]) -> Dict[str, str]:
    """scalce-compatible naming: ``prefix.00_1.scalcen`` etc.

    mate=None (single-end) omits the ``_1``/``_2`` suffix."""
    m = f"_{mate}" if mate is not None else ""
    base = f"{prefix}.{part:02d}{m}"
    return {k: base + ext for k, ext in STREAM_EXT.items()}


def _header_end(path: str) -> int:
    """Offset just past the file header (start of block data)."""
    with open(path, "rb") as f:
        f.seek(12)
        (mlen,) = struct.unpack("<I", f.read(4))
        return 16 + mlen


def scan_resumable(path: str):
    """Tolerant scan of a possibly-crashed stream file.

    Returns ``(meta, blocks, end_offset, has_footer)`` where ``blocks``
    are the COMPLETE blocks found and ``end_offset`` is where a resumed
    writer may continue appending (truncating any torn tail).
    """
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if f.read(8) != MAGIC:
            raise ValueError(f"{path}: not a scalce_tpu stream")
        (ver,) = struct.unpack("<H", f.read(2))
        if ver not in _READABLE_VERSIONS:
            raise ValueError(f"{path}: unsupported version {ver}")
        f.read(2)
        (mlen,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(mlen))
        blocks: List[StreamBlockRef] = []
        end = f.tell()
        while True:
            tag = f.read(4)
            if tag == _FTR:
                ftr = f.read(20)
                if len(ftr) == 20 and ftr[12:20] == END_MAGIC:
                    return meta, blocks, end, True
                return meta, blocks, end, False
            if tag != _BLK:
                return meta, blocks, end, False
            hdr = f.read(20)
            if len(hdr) < 20:
                return meta, blocks, end, False
            bid, nrec, plen = struct.unpack("<IQQ", hdr)
            off = f.tell()
            if off + plen > size:
                return meta, blocks, end, False
            blocks.append(StreamBlockRef(bid, off, plen, nrec))
            f.seek(plen, os.SEEK_CUR)
            end = f.tell()


class TripletWriter:
    """Writes the n/r/q triplet, rolling all three to a new part together
    when the combined size passes ``part_size`` (the reference's ``-B``).

    ``resume=True`` implements restart (SURVEY.md §6 "Checkpoint /
    resume"): existing parts are scanned, any torn tail is truncated to
    the last block COMPLETE IN ALL THREE streams, and
    ``existing_blocks`` reports the block ids already durable so the
    encoder can skip them.
    """

    def __init__(self, prefix: str, meta: Dict, part_size: int = 0,
                 mate: Optional[int] = None, resume: bool = False,
                 keep_only: Optional[set] = None):
        self.prefix = prefix
        self.meta = meta
        self.part_size = part_size
        self.mate = mate
        self.part = 0
        self.parts_written: List[int] = []
        self.existing_blocks: set = set()
        if resume and os.path.exists(part_paths(prefix, 0, mate)["r"]):
            self._resume(keep_only)
        else:
            self._open_part()

    def _resume(self, keep_only: Optional[set] = None) -> None:
        """Scan existing parts, truncate any torn tail, reopen for append.

        ``keep_only`` (asymmetric paired resume): treat any block id NOT
        in the set as torn — the durable prefix stops at the first such
        block, files are truncated there, and later part files are
        deleted.  Used when a crash split the two mates mid-pair: both
        writers re-truncate to the intersection of their durable blocks.
        """
        # completed parts (footer present in all three) stand as-is
        part = 0
        while True:
            paths = part_paths(self.prefix, part, self.mate)
            if not os.path.exists(paths["r"]):
                part = max(part - 1, 0)
                break
            scans = {k: scan_resumable(p) for k, p in paths.items()}
            ids = [tuple(b.block_id for b in s[1]) for s in scans.values()]
            common = min(len(i) for i in ids)
            # the common complete prefix must agree on ids
            while common and not all(i[:common] == ids[0][:common]
                                     for i in ids):
                common -= 1
            if keep_only is not None:
                cut = 0
                while cut < common and ids[0][cut] in keep_only:
                    cut += 1
                common = cut
            for bid in ids[0][:common]:
                self.existing_blocks.add(bid)
            intact = all(s[3] for s in scans.values()) and \
                all(len(i) == common for i in ids)
            if intact:                               # footers + nothing cut
                self.parts_written.append(part)
                part += 1
                continue
            # partial part: truncate to the common prefix and append
            self.part = part
            self.writers = {}
            for k, p in paths.items():
                blocks = scans[k][1][:common]
                end = (blocks[-1].offset + blocks[-1].length) if blocks \
                    else _header_end(p)
                with open(p, "r+b") as f:
                    f.truncate(end)
                w = StreamWriter.__new__(StreamWriter)
                w.path = p
                w._f = open(p, "r+b")
                w._f.seek(0, os.SEEK_END)
                w.n_blocks = common
                w.n_records = sum(b.n_records for b in blocks)
                self.writers[k] = w
            self.parts_written.append(part)
            self._unlink_parts_after(part)
            return
        # every part completed — open a fresh next part
        self.part = part + 1 if self.parts_written else 0
        self._open_part()

    def _unlink_parts_after(self, part: int) -> None:
        """Delete orphan part files past the active part (asymmetric
        truncation can cut into an earlier part than the crash did)."""
        nxt = part + 1
        while True:
            paths = part_paths(self.prefix, nxt, self.mate)
            if not os.path.exists(paths["r"]):
                return
            for p in paths.values():
                try:
                    os.unlink(p)
                except OSError:
                    pass
            nxt += 1

    def abort(self) -> None:
        """Close file handles WITHOUT writing footers (the caller is
        about to re-truncate and reopen via a fresh resume)."""
        for w in self.writers.values():
            w._f.close()

    def _open_part(self) -> None:
        paths = part_paths(self.prefix, self.part, self.mate)
        self.writers = {k: StreamWriter(p, k, self.meta)
                        for k, p in paths.items()}
        self.parts_written.append(self.part)

    def _combined_bytes(self) -> int:
        return sum(w.bytes_written for w in self.writers.values())

    def add_block(self, block_id: int, payloads: Dict[str, bytes],
                  n_records: int) -> None:
        if (self.part_size and self.writers["r"].n_blocks > 0
                and self._combined_bytes() >= self.part_size):
            self._roll()
        for k, w in self.writers.items():
            w.add_block(block_id, payloads[k], n_records)

    def _roll(self) -> None:
        for w in self.writers.values():
            w.close()
        self.part += 1
        self._open_part()

    def close(self) -> None:
        for w in self.writers.values():
            w.close()


class TripletReader:
    """Iterates blocks across all parts of a triplet in order.

    Accepts any one of the triplet's file names (like the reference's
    decompressor, which is pointed at a ``.scalcen`` file) and derives
    the rest, including all parts.
    """

    def __init__(self, any_path: str):
        prefix, part, mate = parse_stream_path(any_path)
        self.prefix = prefix
        self.mate = mate
        self.part_ids: List[int] = []
        p = 0
        while os.path.exists(part_paths(prefix, p, mate)["r"]):
            self.part_ids.append(p)
            p += 1
        if not self.part_ids:
            raise FileNotFoundError(f"no parts found for {prefix!r}")
        first = StreamReader(part_paths(prefix, 0, mate)["r"])
        self.meta = first.meta
        first.close()

    def iter_blocks(self) -> Iterator[Tuple[int, Dict[str, bytes]]]:
        for part in self.part_ids:
            paths = part_paths(self.prefix, part, self.mate)
            readers = {k: StreamReader(p) for k, p in paths.items()}
            ref_blocks = {k: r.blocks for k, r in readers.items()}
            nb = len(ref_blocks["r"])
            if any(len(v) != nb for v in ref_blocks.values()):
                raise ValueError("triplet files disagree on block count")
            for i in range(nb):
                bid = ref_blocks["r"][i].block_id
                if any(v[i].block_id != bid for v in ref_blocks.values()):
                    raise ValueError(
                        "triplet files disagree on block ids — mixed or "
                        "stale stream files?")
                payloads = {k: readers[k].read_block(ref_blocks[k][i])
                            for k in readers}
                yield bid, payloads
            for r in readers.values():
                r.close()


def parse_stream_path(path: str) -> Tuple[str, int, Optional[int]]:
    """'out.00_1.scalcen' -> ('out', 0, 1); 'out.03.scalceq' -> ('out', 3, None)."""
    for ext in STREAM_EXT.values():
        if path.endswith(ext):
            stem = path[: -len(ext)]
            break
    else:
        raise ValueError(f"{path}: not a scalce stream file "
                         f"(want one of {list(STREAM_EXT.values())})")
    mate: Optional[int] = None
    if stem.endswith(("_1", "_2")):
        mate = int(stem[-1])
        stem = stem[:-2]
    i = stem.rfind(".")
    if i < 0 or not stem[i + 1:].isdigit():
        raise ValueError(f"{path}: missing part number")
    return stem[:i], int(stem[i + 1:]), mate
