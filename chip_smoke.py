#!/usr/bin/env python3
"""Drive scalce_tpu_torch's main path once on an NVIDIA GPU.

    python3 chip_smoke.py               # from the root of a checkout

Phases (the first failure exits non-zero; no phase is caught):
  1. card: name and power limit; no CUDA device -> exit 1
  2. build: the CUDA kernels (csrc/*.cu, nvcc, sm_90a: K1-K8)
  3. kernels: K1-K4 against their plain torch versions on one real
     262144-read block (B = 262144, L = 128, T = 2048, N = 16384): K1
     from the block's codes, exception mask and lengths; K2 (pass A)
     from its sorted quality bytes at orders 1, 2 and 3, each lossless
     and through the -p 30 map that models/lossy.py builds from the
     block, with and without the histogram (timed at order 1: lossless,
     through the map, grids only); K3 and K4 decode_quals in the
     decompress path's groups of D = 4 and 1 at order 1 (K3 and K4, with
     decode_scan, also at orders 2 and 3); K1 also through a k = 12
     rank LUT (dict_mode lut, 64 MB: its bound counts the distinct
     32-byte table sectors the block's lookups touch); K5 and K6 from
     the grids
     that the data-parallel stage 1 leaves for the file's first 4 blocks
     ([4, 262144, 128] int64, 286,136 cells; K5: T = 2048, 65,536 lanes)
     and for its first block alone, and K6's flat entry at the lossy
     all-reduce's shapes (one block's symbols into 95 cells); K7 (the
     sequence delta) on that block's stage-A outputs and on phase 5's
     ragged block with N bases; K8 (the compaction) on K3's int16 words
     for that block at order 1 and on K5's for the group of 4, with the
     emitted share sum(counts) / (N T) of each; exact equality (K3's,
     K5's and K8's words and K7's literal words after the download's
     narrowing of the plain versions'); per kernel, timed with CUDA
     events: the wrapper, the launch alone (each kernel's ``prepare``),
     the plain version, and the one PyTorch call that computes the same
     function where there is one (the flat K6: ``torch.bincount``; K8:
     the reference's per-lane ``torch.sort`` of ``key << 16 | word``,
     the sort alone); and its bound from this run's bytes and
     operations, which the launch alone must not beat
  4. main path: compress a 1,148,576-read synthetic FASTQ on the card
     (single-end, lossless, every stage on the device, order 1, gz),
     decompress it in keep-order, require the input bytes back and K1-K4,
     K7 and K8 launched (K4: decode_quals; K7 once per block, K8 once per
     block on K3's path and once per group on K5's, in every phase that
     codes sequences or qualities on the card)
  5. card vs CPU: a ragged file with N bases compressed on the card and
     with the plain torch versions on the CPU must give identical
     triplets (tests pin the CPU path to scalce_tpu byte for byte)
  6. data-parallel path on the main file: ShardedEncoder over every card
     in groups of 4 blocks (4 per card on one card: one group and a
     tail) must give the single-device encoder's payloads, and the
     --data-parallel driver (one block per card) phase 4's triplet; K1,
     K2 (grids only), K5, K6, K7 and K8 must have run in each, counted
     apart; then the driver's run once more under torch.profiler: the
     device busy time, split into K1-K8, the eager torch ops and copies
  7. paired-end: a 2 x 1,148,576-read pair compressed on the card (-r)
     and decompressed in keep-order must give both files back, with K1-K4,
     K7 and K8 launched; the --data-parallel pair (K1, K2, K5-K8 launched)
     must write the same _1/_2 triplets
  8. lossy (-p 30) on the main file: keep-order decompress keeps names
     and sequences and gives every quality through the map that
     models/lossy.py builds from the sampled reads (within the 30%
     budget); the --data-parallel lossy triplet equals the single-device
     one (K1, K2, K5 and K6 launched); the lossy histogram all-reduce
     over every card equals the host's (one flat K6 launch per card); a
     ragged lossy pair with N bases gives the same triplets on the card
     and on the CPU
  9. the bare command (``scalce_tpu_torch.cli.main`` with the reference
     CLI's defaults but ``-T 1``: qualities coded on the host, each block
     at the order its trial picks) on the main file: K1 and none of
     K2-K6 run, the card's triplet equals the CPU's, and the bare ``-d``
     (host quality decode, no K4) gives the input back
 10. pipelined: phases 4 and 6-9 (which run at ``-T 1``) once more at
     ``-T 4``, the CLI's default: the full-device compress and its
     keep-order ``--qual-device`` decompress, the bare command and its
     host decompress, ``--data-parallel``, the pair and ``-p 30``; every
     triplet equals its ``-T 1`` triplet, each decompress gives the input
     back, every kernel launches as often as at ``-T 1``; walls and the
     peak device memory beside ``-T 1``'s and the parent's (PERF.md §5),
     the main file at Config()'s
     default threads (cores + 2), and the ``-T 4`` compress's device busy
     time with its copies split into pageable and page-locked
 11. placements and dictionaries: the bare command's Config under host
     core (``--core-placement host``: no kernel, no device memory),
     AUTO (``--core-placement auto``: prints the link probe's MB/s),
     host delta (K1 once per block, no device delta) and
     ``--data-parallel`` host delta must each write phase 9's triplet;
     the pair under host delta (host qualities at order 1) phase 7's;
     ``dict_mode`` lut and lcp at core k 12 on phase 5's ragged file the
     same triplets on the card and the CPU (host table builds timed),
     and the main file under lut round-trips; ``-d --delta-device`` on
     phase 4's triplet gives the input back, equal to the host walk's
     output, with the reconstruction's device ms per block and both
     decompress walls
 12. the rest of the feature surface: a HiFi-like long-read file (2,048
     reads of 10-20 kbp from a 1 Mbp genome, 0.5% substitutions, 0.2%
     indels; ``--max-read-len 32768 --block-reads 512``, ``-T 4``)
     through the bare command in a child process must round-trip in
     keep-order with no device memory allocated, its sequence stream
     under the 2-bit floor / 1.08 (the reference's own gate for
     indel-bearing long reads); two ranks of
     ``scalce_tpu_torch.parallel.multihost`` on localhost sharing the
     card, at phase 4's Config and at phase 8's ``-p 30``, must merge
     to phase 4's and phase 8's triplets with K1-K3, K7 and K8 launched
     as often across the ranks; phase 4's compress and keep-order
     decompress through the CLI under ``--profile`` must give phase 4's
     triplet and the input back, with traces naming the stages and K1-K4,
     K7 and K8

The line before the last is the card's name and power limit; the one
before that is a JSON object with one entry per kernel (``launches``:
phase 4's count for K1-K4, K7 and K8, the phase-6 --data-parallel
driver's for K5 and K6, and their ``sharded_launches`` the
ShardedEncoder's (K7's and K8's ``dp_launches`` the driver's); K1's
``lut`` case phase 11's main-file lut compress's; phases 7 to 9 check
their own counts; ``launches_T4`` phase 10's counts of the
same runs at ``-T 4``; ``ms`` the wrapper, ``kernel_ms`` the
launch alone; K1's ``lut``, K2's ``lut`` and ``grids_only``, K4's
``d1``, K5's and
K6's ``one_block``, K6's ``flat``, K7's ``ragged`` and K8's ``group`` the
other cases above); the last
line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX and nothing
of scalce_tpu.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

#: the slice's configuration (bench corpus reads, Config defaults)
SLICE = dict(block_reads=1 << 18, max_read_len=128, qual_T_target=2048,
             core_on_device=True, delta_on_device=True, qual_on_device=True,
             qual_context_order=1, dict_mode="hash", backend="gz", threads=1)
MAIN_READS = 1_148_576
RAGGED_READS = 393_216
LOSSY_PCT = 30
#: the main file's blocks
MAIN_BLOCKS = -(-MAIN_READS // SLICE["block_reads"])
#: phase 10's peak device memory, GiB at -T 1 and -T 4, before stage B's
#: delta and pass B's compaction were kernels (commit bdc8925; PERF.md §5)
PARENT_PEAK_GIB = {"main": (1.592, 1.688), "bare": (1.011, 1.028),
                   "dp": (1.619, 1.668), "pair": (2.329, 2.425),
                   "lossy": (1.640, 1.640)}


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is false)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return smi[0]


def time_ms(fn, iters: int) -> float:
    """ms per call over ``iters`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> int:
    """Largest |kernel - plain| over paired outputs; raise unless equal."""
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype {x.shape} {x.dtype} vs "
                                 f"{y.shape} {y.dtype}")
        err = max(err, int((x.to(torch.int64) - y.to(torch.int64))
                           .abs().max()) if x.numel() else 0)
        if not torch.equal(x, y):
            raise AssertionError(f"kernel != plain (max abs err {err})")
    return err


def reset(kernels: dict) -> None:
    """Set every kernel's launch count to 0."""
    for _, fn in kernels.values():
        fn.launches = 0


def counts(kernels: dict, names) -> dict:
    """The launch counts of the kernels ``names``."""
    return {name: kernels[name][1].launches for name in names}


def check_sequence_kernels(run: str, launches: dict, blocks: int) -> None:
    """K7 must have run once per block (and mate) of ``run`` and K8 once
    per K3 launch (a block) and per K5 launch (a group)."""
    if launches["K7"] != blocks or \
            launches["K8"] != launches["K3"] + launches["K5"]:
        raise AssertionError(f"{run}: K7 must run once per block ({blocks}) "
                             f"and K8 once per K3 or K5 launch: {launches}")


def write_fastq(path: str, n_reads: int, **kw) -> bytes:
    from scalce_tpu_torch.utils.synth import synth_fastq
    data = synth_fastq(n_reads, 100, **kw)
    with open(path, "wb") as f:
        f.write(data)
    return data


#: the card's peaks (H100 SXM datasheet, 700 W): HBM
#: bytes per second, and 32-bit integer operations per second of the
#: CUDA cores (the datasheet's 67 TFLOP/s float32 rate counts a fused
#: multiply-add as two operations: one operation per lane and clock is
#: half of it)
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2
#: integer operations each kernel must do per element, counted from its
#: source (K1: per k-mer window inside a read, both strands' mix32 ranks
#: and the reverse complement, or with a rank LUT the two lookups' address
#: arithmetic and compares; K2: per cell of a read, the LUT, clamp,
#: context and count; K3 and K4: per cell of a read, the context, table
#: entry and state update; K5: per (lane, step); K6: per index; K7: per
#: 16-column word of a row, its packing, four candidates' funnel shift,
#: compare and popcount, the winner's mask and literal compaction; K8: per
#: (step, lane), the emit test, slot and store).  Padding cells and
#: windows past a read's end are not counted: the bound stays a bound.
OPS_PER_ELEMENT = {"K1": 40, "K2": 10, "K3": 20, "K4": 25, "K5": 15, "K6": 4,
                   "K1 lut": 20, "K7": 40, "K8": 4}


def narrow_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t`` at the narrowest of 1, 2, 4 and 8 bytes per element
    that holds this run's values; a tensor with a negative value keeps
    its own width (it carries bit patterns)."""
    if t.numel() == 0:
        return 0
    width = t.element_size()
    if t.dtype != torch.bool and int(t.min()) >= 0:
        top = int(t.max())
        width = min(width, next(b for b in (1, 2, 4, 8) if top < 1 << 8 * b))
    return t.numel() * width


def bound(name: str, tensors_in, tensors_out, elements: int,
          extra_bytes: int = 0) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once,
    each at the narrowest type that holds its values, so never more than
    a launch moves; plus ``extra_bytes``, the table sectors a lookup
    kernel must read) over the HBM rate and its integer operations over
    the CUDA cores' rate."""
    nbytes = sum(narrow_bytes(t) for t in (*tensors_in, *tensors_out)) \
        + extra_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEMENT[name] * elements / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_ops": OPS_PER_ELEMENT[name]
            * elements}


class Case:
    """One kernel at one shape: the wrapper and its plain version on the
    same arguments, the kernel's ``prepare`` (a launch alone, for the
    kernel-only time), the single PyTorch call that computes the same
    function, where there is one, and the bound from ``bound_in``, the
    outputs and ``elements``."""

    def __init__(self, name, wrapper, plain, args, prepare, iters,
                 plain_iters, bound_in, elements, library=None,
                 ops_key=None, extra_bytes=0):
        self.name, self.wrapper, self.plain, self.args = (name, wrapper,
                                                          plain, args)
        self.prepare, self.iters, self.plain_iters = (prepare, iters,
                                                      plain_iters)
        self.bound_in, self.elements = bound_in, elements
        self.library = library
        self.ops_key = ops_key or name.split()[0]
        self.extra_bytes = extra_bytes

    def run(self) -> dict:
        got = as_tuple(self.wrapper(*self.args))
        ref = as_tuple(self.plain(*self.args))
        torch.cuda.synchronize()
        out = {"max_abs_err": max_abs_err(got, ref)}
        out["ms"] = time_ms(lambda: self.wrapper(*self.args), self.iters)
        launch = self.prepare(*self.args)[0]
        out["kernel_ms"] = time_ms(launch, self.iters)
        out["plain_ms"] = time_ms(lambda: self.plain(*self.args),
                                  self.plain_iters)
        out["library_ms"] = None
        if self.library is not None:
            out["library_ms"] = time_ms(self.library, self.iters)
        out.update(bound(self.ops_key, self.bound_in, got, self.elements,
                         self.extra_bytes))
        if out["kernel_ms"] < out["bound_ms"]:
            raise AssertionError(f"{self.name}: the launch ({out['kernel_ms']}"
                                 f" ms) beats its bound ({out['bound_ms']} "
                                 f"ms)")
        return out


def as_tuple(x):
    """A kernel's outputs as a tuple, without the absent ones (None)."""
    return tuple(t for t in (x if isinstance(x, tuple) else (x,))
                 if t is not None)


def delta_outputs(fn):
    """K7's function ``fn`` with its products as a tuple, the literal
    words narrowed as the download narrows them (the kernel writes them
    so)."""
    from scalce_tpu_torch.ops.bitops import to_u32_bits

    def run(*args):
        d = fn(*args)
        return (d["mask_bits"], d["shifts"], d["pred_k"],
                to_u32_bits(d["lit_packed"]), d["n_lits"])
    return run


def compact_plain_narrowed(words, emits):
    """K8's plain version with its words narrowed to int16 as the
    download narrows them (the kernel writes them so)."""
    from scalce_tpu_torch.ops import compact
    packed, counts = compact.compact_emissions_plain(words, emits)
    return packed.to(torch.int16), counts


def encode_plain_narrowed(fn):
    """An encoder's plain version ``fn`` with its int32 words narrowed to
    the int16 holding their u16 bits (K3 and K5 write them so)."""

    def run(*args):
        states, words, emits = fn(*args)
        return states, words.to(torch.int16), emits
    return run


def sort_library(words, emits):
    """The one PyTorch call under the reference's compaction
    (``scalce_tpu/ops/rans.py:157-186``): ``torch.sort`` along each lane
    of ``key << 16 | word`` (int32 ``[N, T]``; key the word's compacted
    slot, T where it is not emitted).  The key is built here, once; the
    call timed is the sort alone (values and indices), without the
    transpose, cumsum and tail mask that make it the whole function."""
    et = emits.T
    key = torch.where(et, torch.cumsum(et, dim=1, dtype=torch.int32) - 1,
                      emits.shape[0])
    packed_key = (key << 16) | (words.T.to(torch.int32) & 0xFFFF)
    return lambda: torch.sort(packed_key, dim=1)


def emitted_share(counts, T: int) -> float:
    """The share of the [N, T] word matrix that holds emitted words."""
    return int(counts.sum()) / (counts.numel() * T)


def check_kernels(blocks, ragged, dev, kernels) -> dict:
    """Phase 3: each kernel against its plain version at the slice's
    shapes, timed: K1-K4 and K7 from one real block (K4 in the main
    path's groups of 4 blocks and of 1), K7 also from the block
    ``ragged``, K8 from K3's outputs, K5, K6 and K8 from a data-parallel
    group of ``blocks`` and from one block; K2-K4 also at orders 2 and
    3."""
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.models import entropy, lossy
    from scalce_tpu_torch.ops import (compact, core_rank, delta_seq,
                                      histogram, rans, rans_decode,
                                      rans_encode, rans_encode_flat)
    from scalce_tpu_torch.ops.bitops import unpack_bases_u32
    from scalce_tpu_torch.parallel import mesh
    from scalce_tpu_torch.pipeline import encode
    from scalce_tpu_torch.streams import qualities
    cfg = Config(inputs=("-",), **SLICE)
    enc = encode.BlockEncoder(cfg, dev)
    block = blocks[0]
    pre = enc.upload([(block,)])[0][0].wait()
    k, seed = cfg.core_k, cfg.dict_seed
    B, L = block.seq.shape
    cases = []

    codes = unpack_bases_u32(pre["seq"])
    exc = torch.zeros(B * L, dtype=torch.bool, device=dev)
    exc[pre["exc"]] = True
    exc = exc.reshape(B, L)
    lengths = pre["len"].to(torch.int64)
    windows = int((lengths - k + 1).clamp(min=0).sum())
    cases.append(Case("K1", core_rank.core_rank_codes,
                      core_rank.core_rank_codes_plain,
                      (codes, exc, lengths, k, seed), core_rank.prepare, 20, 5,
                      (codes, exc, lengths), windows))
    # the explicit dictionary at k = 12: a 64 MB table, more than L2; its
    # bound counts each distinct 32-byte sector the lookups of this
    # block's valid windows touch (every sector read once)
    from scalce_tpu_torch.models import core_dict
    t0 = time.monotonic()
    lut = torch.from_numpy(core_dict.build_rank_lut(k, seed).view(
        "int32")).to(dev)
    say(f"K1 lut: rank_lut built in {time.monotonic() - t0:.2f} s "
        f"(k = {k}, {lut.numel() * 4} B)")
    valid = ~core_rank.window_invalid(exc, lengths, k)
    kmers = core_rank.rolling_kmers(codes, k)
    looked = torch.cat([kmers[valid], core_rank.revcomp_kmer(kmers,
                                                             k)[valid]])
    sectors = int(torch.unique(looked >> 3).numel())
    say(f"K1 lut: {looked.numel()} lookups ({looked.numel() * 32} B as "
        f"32-byte sectors if every one missed L2), {sectors} distinct "
        f"sectors ({sectors * 32} B, the bound's)")
    lut_reads = {"lookups": looked.numel(), "sectors": sectors}
    del kmers, looked
    cases.append(Case("K1 lut", core_rank.core_rank_codes,
                      core_rank.core_rank_codes_plain,
                      (codes, exc, lengths, k, seed, lut), core_rank.prepare,
                      20, 2, (codes, exc, lengths), int(valid.sum()),
                      ops_key="K1 lut", extra_bytes=sectors * 32))
    del valid

    _, codes_s, qual_s, len_s, ck_s, cp_s, _ = encode._device_stage_a(
        pre["seq"], pre["qual"], pre["len"], block.n_reads, pre["exc"], k,
        seed)
    n_valid = int(len_s.sum())
    # K7 on this block's stage-A outputs and on the ragged block's (reads
    # of 50-100 bases, N bases); its bound counts these inputs and the
    # products it writes
    rag = enc.upload([(ragged,)])[0][0].wait()
    _, rcodes, _, rlen, rck, rcp, _ = encode._device_stage_a(
        rag["seq"], rag["qual"], rag["len"], ragged.n_reads, rag["exc"], k,
        seed)
    for tag, a in (("", (codes_s, len_s, ck_s, cp_s, block.n_reads)),
                   (" ragged", (rcodes, rlen, rck, rcp, ragged.n_reads))):
        cases.append(Case("K7" + tag, delta_outputs(delta_seq.delta_seq),
                          delta_outputs(delta_seq.delta_seq_plain), a,
                          delta_seq.prepare, 20, 3, a[:4],
                          a[0].numel() // 16))
    del rag, rcodes, rlen, rck, rcp
    T = qualities.pick_T(B, L, cfg.qual_T_target)
    # the -p 30 map that models/lossy.py builds from this block's reads
    qmap = encode.device_qual_map(lossy.build_quant_map(
        lossy.sample_histogram(block.qual, block.lengths, block.n_reads),
        LOSSY_PCT), dev)
    grids, tables = {}, {}
    for order in (1, 2, 3):
        for m in (None, qmap):
            for h in (True, False):
                a = (qual_s, len_s, order, m, h)
                max_abs_err(as_tuple(qualities.sym_ctx_hist(*a)),
                            as_tuple(qualities.sym_ctx_hist_plain(*a)))
        sym, ctx, counts = qualities.sym_ctx_hist(qual_s, len_s, order)
        grids[order] = (sym, ctx, counts)
        tables[order] = entropy.device_normalize(
            counts, qualities.n_contexts(order), qualities.N_SYMS)
    sym, ctx, counts = grids[1]
    for tag, m, h in (("", None, True), (" lut", qmap, True),
                      (" grids", None, False)):
        bound_in = (qual_s, len_s) + (() if m is None else (m,))
        cases.append(Case(
            "K2" + tag, qualities.sym_ctx_hist, qualities.sym_ctx_hist_plain,
            (qual_s, len_s, 1, m, h), qualities.prepare_pass_a, 20, 5,
            bound_in, n_valid))

    freq, cum = tables[1]
    cases.append(Case(
        "K3", rans_encode.encode_scan,
        encode_plain_narrowed(rans_encode.encode_scan_plain),
        (sym, ctx, freq, cum, T, 1), rans_encode.prepare, 20, 2,
        (sym, ctx, freq, cum), n_valid))
    # K8 on K3's int16 words; the library call is the reference's sort
    _, words, emits = rans_encode.encode_scan(sym, ctx, freq, cum, T, 1)
    cases.append(Case("K8", compact.compact_emissions, compact_plain_narrowed,
                      (words, emits), compact.prepare, 20, 3, (words, emits),
                      words.numel(), library=sort_library(words, emits)))
    share = {"K8": emitted_share(compact.compact_emissions(words, emits)[1],
                                 T)}

    encoded = {}

    def decode_args(order, D):
        if order not in encoded:
            s, c, _ = grids[order]
            f, cm = tables[order]
            st, w, e = rans_encode.encode_scan(s, c, f, cm, T, order)
            if order != 1:
                max_abs_err((st, w, e), encode_plain_narrowed(
                    rans_encode.encode_scan_plain)(s, c, f, cm, T, order))
            packed, wc = rans.compact_emissions(w, e)
            encoded[order] = qualities.finish_encoded(f, st, packed, wc, B,
                                                      L, T, order)
        x = qualities.decode_inputs([encoded[order]] * D,
                                    [len_s.cpu().numpy()] * D, dev)
        return (x["states"], x["words"], x["freq"], x["lengths"], order, T,
                L)

    for D in (4, 1):
        a = decode_args(1, D)
        cases.append(Case(
            "K4" if D == 4 else "K4 D=1", rans_decode.decode_quals,
            rans_decode.decode_quals_plain, a, rans_decode.prepare, 20, 1,
            a[:4], D * n_valid))

    # the data-parallel group: stage 1 of every block (K2 writes each
    # block's grids into its slices of the group's), then K6 and K5 on
    # those grids, each block against its own table; and the same for the
    # group's first block alone (the one-card --data-parallel driver's
    # group)
    C = qualities.n_contexts(1)
    for tag, group in (("", blocks), (" 1 block", blocks[:1])):
        _, _, _, gsym, gctx, gcounts = mesh.stage1(
            mesh.upload_blocks(group, dev), [b.n_reads for b in group],
            k, seed, 1)
        cases.append(Case(
            "K6" + tag, histogram.grid_histogram,
            histogram.grid_histogram_plain,
            (gsym, gctx, C, qualities.N_SYMS), histogram.prepare_grids, 20, 5,
            (gsym, gctx), gsym.numel()))
        gfreq, gcum = entropy.device_normalize(gcounts, C, qualities.N_SYMS)
        cases.append(Case(
            "K5" + tag, rans_encode_flat.encode_grids,
            encode_plain_narrowed(rans_encode_flat.encode_grids_plain),
            (gsym, gctx, gfreq, gcum, T), rans_encode_flat.prepare, 10, 1,
            (gsym, gctx, gfreq, gcum), gsym.numel()))
        if not tag:
            _, gwords, gemits = rans_encode_flat.encode_grids(
                gsym, gctx, gfreq, gcum, T)
            cases.append(Case(
                "K8 group", compact.compact_emissions, compact_plain_narrowed,
                (gwords, gemits), compact.prepare, 10, 1, (gwords, gemits),
                gwords.numel(), library=sort_library(gwords, gemits)))
            share["K8 group"] = emitted_share(
                compact.compact_emissions(gwords, gemits)[1], T)
        say(f"group of {len(group)} block(s): K5 and K6 on grids "
            f"{list(gsym.shape)}, {len(group) * C * qualities.N_SYMS} "
            f"cells; K5 T = {T}, {gsym.numel() // T} lanes")
    # the flat entry at the lossy all-reduce's shapes on one card: one
    # block's symbols, padding in an overflow bin
    q = torch.from_numpy(block.qual).to(dev)
    valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    idx = torch.where(valid, torch.clamp(q.to(torch.int64) - 33, 0, 93), 94)
    cases.append(Case(
        "K6 flat", histogram.histogram, histogram.histogram_plain,
        (idx, 95), histogram.prepare, 20, 5, (idx,), idx.numel(),
        library=lambda: torch.bincount(idx.reshape(-1), minlength=95)))

    out = {}
    for case in cases:
        out[case.name] = m = case.run()
        if case.name == "K1 lut":
            m.update(lut_reads)
        if case.name in share:
            m["emitted_share"] = share[case.name]
            say(f"{case.name}: emitted share sum(counts) / (N T) = "
                f"{share[case.name]} (the share of pass B's whole-matrix "
                f"download in use)")
        lib = "none" if m["library_ms"] is None else \
            f"{m['library_ms']:.3f}"
        say(f"{case.name}: equal to plain; wrapper {m['ms']:.3f} ms, kernel "
            f"{m['kernel_ms']:.3f} ms, plain {m['plain_ms']:.3f} ms, library "
            f"{lib} ms, bound {m['bound_ms']:.4f} ms ({m['bound_by']}, "
            f"{m['bound_bytes']} B)")

    # the decoded grid must be the block's qualities
    a = decode_args(1, 1)
    want = torch.where(torch.arange(L, device=dev)[None, :] < len_s[:, None],
                       qual_s, 0)
    if not torch.equal(rans_decode.decode_quals(*a).reshape(B, L), want):
        raise AssertionError("K4 decode does not give the block's qualities")
    for order in (1, 2, 3):
        a = decode_args(order, 4 if order == 1 else 1)
        err = max_abs_err((rans_decode.decode_quals(*a),),
                          (rans_decode.decode_quals_plain(*a),))
        err = max(err, max_abs_err((rans_decode.decode_scan(*a),),
                                   (rans_decode.decode_scan_plain(*a),)))
        say(f"order {order}: K2, K3, K4 (decode_quals and decode_scan) equal "
            f"to plain (max abs err {err})")
    return out


def compress_file(src: str, out: str, device: str, **change) -> float:
    """Wall seconds of one compress (on the card: from a reset of the
    peak device memory to the card's idle)."""
    import scalce_tpu_torch
    from scalce_tpu_torch.config import Config
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    scalce_tpu_torch.compress(Config(inputs=(src,), output=out,
                                     **{**SLICE, **change}), device)
    if device != "cpu":
        torch.cuda.synchronize()
    return time.monotonic() - t0


def record(runs: dict, name: str, kernels: dict, wall: float,
           prefix: str) -> None:
    """Keep a -T 1 run for phase 10: its wall, every kernel's launches
    since the last reset, the peak device memory since the last reset,
    its triplet's prefix."""
    runs[name] = {"wall_s": wall, "launches": counts(kernels, kernels),
                  "peak_bytes": torch.cuda.max_memory_allocated(),
                  "prefix": prefix}


def triplet(prefix: str) -> list:
    """[(suffix, bytes)] of every part file of the triplet ``prefix``."""
    out = []
    for path in sorted(glob.glob(prefix + ".*.scalce[nrq]")):
        with open(path, "rb") as fh:
            out.append((path[len(prefix):], fh.read()))
    return out


def check_data_parallel(src: str, tmp: str, kernels: dict, smi: str,
                        t_single: float, t1: dict) -> dict:
    """Phase 6: the data-parallel path on the main file; returns the launch
    counts of the ShardedEncoder run and of the --data-parallel driver's."""
    import scalce_tpu_torch
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.io import fastq
    from scalce_tpu_torch.parallel import mesh
    from scalce_tpu_torch.pipeline.encode import BlockEncoder
    cfg = Config(inputs=(src,), **SLICE)
    blocks = list(fastq.iter_blocks(src, cfg.block_reads, cfg.max_read_len))
    t0 = time.monotonic()
    items = [(b,) for b in blocks]
    want = [eb.payloads for item in items
            for eb, in BlockEncoder(cfg, "cuda").encode([item])]
    torch.cuda.synchronize()
    t_one = time.monotonic() - t0

    reset(kernels)
    t0 = time.monotonic()
    senc = mesh.ShardedEncoder(
        cfg, "cuda", group=max(1, 4 // torch.cuda.device_count()))
    got = []
    for i in range(0, len(items), senc.D):
        got += [eb.payloads for eb, in senc.encode(items[i:i + senc.D])]
    torch.cuda.synchronize()
    t_group = time.monotonic() - t0
    sharded = counts(kernels, kernels)
    if got != want:
        raise AssertionError("data-parallel payloads != single-device "
                             "payloads")
    n_blocks = len(blocks)
    del blocks, items, got, want
    reset(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    scalce_tpu_torch.compress(Config(inputs=(src,), output=os.path.join(
        tmp, "dp"), data_parallel=True, **SLICE), "cuda")
    torch.cuda.synchronize()
    t_dp = time.monotonic() - t0
    driver = counts(kernels, kernels)
    record(t1, "dp", kernels, t_dp, os.path.join(tmp, "dp"))
    if triplet(os.path.join(tmp, "dp")) != triplet(os.path.join(tmp,
                                                                 "main")):
        raise AssertionError("--data-parallel triplet != phase 4's")
    for run, launches in (("ShardedEncoder", sharded), ("driver", driver)):
        if not all(launches[n] for n in ("K1", "K2", "K5", "K6")):
            raise AssertionError(f"K1, K2, K5 or K6 never ran in the "
                                 f"data-parallel {run} run: {launches}")
        check_sequence_kernels(f"data-parallel {run}", launches, n_blocks)
    mb = os.path.getsize(src) / 1e6
    say(f"data-parallel on {[str(d) for d in senc.mesh]}: the payloads of "
        f"{n_blocks} blocks (groups of {senc.D}) equal the single-device "
        f"encoder's (launches {sharded}); the --data-parallel triplet "
        f"equals phase 4's (launches {driver})")
    say(f"encode of the parsed file: single-device {t_one:.3f} s, "
        f"{senc.group} blocks per card {t_group:.3f} s | {smi}")
    say(f"compress: single-device {t_single:.3f} s = {mb / t_single:.2f} "
        f"MB/s, --data-parallel (1 block per card) {t_dp:.3f} s = "
        f"{mb / t_dp:.2f} MB/s | {smi}")
    from scalce_tpu_torch.timing import device_busy
    prof = device_busy(lambda: scalce_tpu_torch.compress(Config(
        inputs=(src,), output=os.path.join(tmp, "dp_prof"),
        data_parallel=True, **SLICE), "cuda"))
    if prof is None:
        say("--data-parallel compress under torch.profiler: no device "
            "events recorded (device busy not measured)")
    else:
        say(f"--data-parallel compress under torch.profiler: wall "
            f"{prof['wall_s']:.3f} s, device busy {prof['busy_s']:.4f} s "
            f"({busy_split(prof)}) | {smi}")
    return sharded, driver


def busy_split(prof: dict) -> str:
    """``timing.device_busy``'s device seconds: the port's kernels
    K1-K8 together, the eager torch ops and the copies, then each kind."""
    kinds = prof["by_kind_s"]
    ours = sum(sec for name, sec in kinds.items() if name[:1] == "K")
    copies = sum(sec for name, sec in kinds.items() if "copies" in name)
    each = ", ".join(f"{name} {sec:.4f} s" for name, sec in sorted(
        kinds.items()))
    return (f"K1-K8 {ours:.4f} s, eager torch ops "
            f"{kinds.get('torch kernels', 0.0):.4f} s, copies {copies:.4f} s;"
            f" {each}")


def check_cli_defaults(src: str, data: bytes, tmp: str, kernels: dict,
                       smi: str, t1: dict) -> None:
    """Phase 9: the bare command (the reference CLI's defaults: qualities
    coded on the host, each block at the order its trial picks) on the
    main file, on the card and on the CPU; the card's triplet decompressed
    by the bare ``-d`` (host quality decode)."""
    from scalce_tpu_torch import cli, container
    from scalce_tpu_torch.streams import qualities
    reset(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    cli.main([src, "-o", os.path.join(tmp, "bare"), "-T", "1"])
    torch.cuda.synchronize()
    t_c = time.monotonic() - t0
    launches = counts(kernels, kernels)
    record(t1, "bare", kernels, t_c, os.path.join(tmp, "bare"))
    t0 = time.monotonic()
    cli.main(["-d", os.path.join(tmp, "bare.00.scalcen"), "-o",
              os.path.join(tmp, "bare_out"), "--keep-order", "-T", "1"])
    t_d = time.monotonic() - t0
    decode = counts(kernels, kernels)
    t1["bare decompress"] = {"wall_s": t_d, "launches": decode}
    with open(os.path.join(tmp, "bare_out.fastq"), "rb") as f:
        if f.read() != data:
            raise AssertionError("bare decompress != input")
    if not launches["K1"] or any(launches[n] for n in ("K2", "K3", "K5",
                                                        "K6")) \
            or decode["K4"]:
        raise AssertionError(f"the bare command must run K1 and code the "
                             f"qualities on the host: compress {launches}, "
                             f"decompress {decode}")
    check_sequence_kernels("bare command", launches, MAIN_BLOCKS)
    t0 = time.monotonic()
    cli.main([src, "-o", os.path.join(tmp, "bare_cpu"), "--device", "cpu",
              "-T", "1"])
    t_cpu = time.monotonic() - t0
    gpu = triplet(os.path.join(tmp, "bare"))
    if gpu != triplet(os.path.join(tmp, "bare_cpu")):
        raise AssertionError("bare command: card and CPU triplets differ")
    reader = container.TripletReader(os.path.join(tmp, "bare.00.scalcen"))
    orders = [qualities.parse(p["q"]).order for _, p in reader.iter_blocks()]
    comp = sum(len(b) for _, b in gpu)
    mb = len(data) / 1e6
    say(f"bare command: {len(data)} B -> {comp} B (ratio "
        f"{len(data) / comp:.4f}; quality orders {orders}), card == CPU "
        f"triplet, host decompress gives the input back; launches "
        f"{launches}")
    say(f"bare compress {t_c:.3f} s = {mb / t_c:.2f} MB/s (CPU "
        f"{t_cpu:.2f} s), decompress {t_d:.3f} s = {mb / t_d:.2f} MB/s | "
        f"{smi}")


def check_paired(tmp: str, kernels: dict, smi: str, t1: dict) -> None:
    """Phase 7: paired-end compress, keep-order decompress and the
    --data-parallel pair on the card."""
    import scalce_tpu_torch
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.utils.synth import synth_pair
    mates = synth_pair(MAIN_READS, 100, seed=42, genome_len=1_000_000,
                       n_rate=0.001)
    paths = tuple(os.path.join(tmp, f"mate{m}.fastq") for m in (1, 2))
    for path, data in zip(paths, mates):
        with open(path, "wb") as f:
            f.write(data)
    cfg = dict(inputs=paths, paired=True, **SLICE)

    reset(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    scalce_tpu_torch.compress(Config(output=os.path.join(tmp, "pair"),
                                     **cfg), "cuda")
    torch.cuda.synchronize()
    t_c = time.monotonic() - t0
    record(t1, "pair", kernels, t_c, os.path.join(tmp, "pair"))
    t0 = time.monotonic()
    scalce_tpu_torch.decompress(Config(
        mode="decompress", inputs=(os.path.join(tmp, "pair.00_1.scalcen"),),
        output=os.path.join(tmp, "pair_out"), keep_order=True,
        qual_on_device=True, threads=1), "cuda")
    t_d = time.monotonic() - t0
    launches = counts(kernels, kernels)
    for m, data in zip((1, 2), mates):
        with open(os.path.join(tmp, f"pair_out_{m}.fastq"), "rb") as f:
            if f.read() != data:
                raise AssertionError(f"paired keep-order decompress != "
                                     f"mate {m}'s input")
    if not all(launches[n] for n in ("K1", "K2", "K3", "K4")):
        raise AssertionError(f"a kernel never ran on the paired path: "
                             f"{launches}")
    check_sequence_kernels("paired", launches, 2 * MAIN_BLOCKS)
    trip = triplet(os.path.join(tmp, "pair"))
    comp = sum(len(b) for _, b in trip)
    mb = sum(len(d) for d in mates) / 1e6
    say(f"paired: 2 x {MAIN_READS} reads, {int(mb * 1e6)} B -> {comp} B "
        f"(ratio {mb * 1e6 / comp:.4f}, {len(trip)} files); launches "
        f"{launches}")
    del mates

    reset(kernels)
    t0 = time.monotonic()
    scalce_tpu_torch.compress(Config(output=os.path.join(tmp, "pair_dp"),
                                     data_parallel=True, **cfg), "cuda")
    torch.cuda.synchronize()
    t_dp = time.monotonic() - t0
    dp = counts(kernels, kernels)
    if triplet(os.path.join(tmp, "pair_dp")) != trip:
        raise AssertionError("paired --data-parallel triplets != "
                             "single-device ones")
    if not all(dp[n] for n in ("K1", "K2", "K5", "K6")):
        raise AssertionError(f"K1, K2, K5 or K6 never ran on the paired "
                             f"data-parallel path: {dp}")
    check_sequence_kernels("paired --data-parallel", dp, 2 * MAIN_BLOCKS)
    say(f"paired --data-parallel: _1/_2 triplets equal the single-device "
        f"ones; launches {dp}")
    say(f"paired compress {t_c:.3f} s = {mb / t_c:.2f} MB/s, decompress "
        f"{t_d:.3f} s = {mb / t_d:.2f} MB/s, --data-parallel compress "
        f"{t_dp:.3f} s = {mb / t_dp:.2f} MB/s | {smi}")


def check_lossy(src: str, data: bytes, lossless_bytes: int, tmp: str,
                kernels: dict, smi: str, t1: dict) -> None:
    """Phase 8: lossy compress of the main file on the card, its keep-order
    round trip, the --data-parallel lossy triplet, the all-reduce, and a
    ragged lossy pair on the card and the CPU."""
    import numpy as np
    import scalce_tpu_torch
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.io import fastq
    from scalce_tpu_torch.utils.synth import synth_pair
    from scalce_tpu_torch.models import lossy
    from scalce_tpu_torch.parallel import mesh
    cfg = dict(lossy_pct=LOSSY_PCT, **SLICE)

    reset(kernels)
    t_c = compress_file(src, os.path.join(tmp, "lossy"), "cuda",
                        lossy_pct=LOSSY_PCT)
    record(t1, "lossy", kernels, t_c, os.path.join(tmp, "lossy"))
    t0 = time.monotonic()
    scalce_tpu_torch.decompress(Config(
        mode="decompress", inputs=(os.path.join(tmp, "lossy.00.scalcen"),),
        output=os.path.join(tmp, "lossy_out"), keep_order=True,
        qual_on_device=True, threads=1), "cuda")
    t_d = time.monotonic() - t0
    launches = counts(kernels, kernels)
    if not all(launches[n] for n in ("K1", "K2", "K3", "K4")):
        raise AssertionError(f"a kernel never ran on the lossy path: "
                             f"{launches}")
    check_sequence_kernels("lossy", launches, MAIN_BLOCKS)

    # the map the driver must have used: the reads of the first blocks
    # up to the sample size (Config.sample_size)
    sample = Config(inputs=(src,), **cfg).sample_size
    hist, n, blocks = np.zeros(lossy.N_SYMS, np.int64), 0, []
    for block in fastq.iter_blocks(src, SLICE["block_reads"],
                                   SLICE["max_read_len"]):
        blocks.append(block)
        if n < sample:
            hist += lossy.sample_histogram(block.qual, block.lengths,
                                           block.n_reads)
            n += block.n_reads
        if n >= sample and len(blocks) >= torch.cuda.device_count():
            break
    lut = lossy.build_quant_map(hist, LOSSY_PCT)
    v = np.arange(lossy.N_SYMS)
    err = np.abs(lut[v + lossy.QUAL_OFFSET].astype(np.int64)
                 - lossy.QUAL_OFFSET - v)
    if (err > LOSSY_PCT / 100 * v).any() or lossy.max_abs_error(lut) == 0:
        raise AssertionError("lossy map outside its budget, or identity")
    lines = data.split(b"\n")
    lines[3::4] = [q.translate(lut.tobytes()) for q in lines[3::4]]
    with open(os.path.join(tmp, "lossy_out.fastq"), "rb") as f:
        if f.read() != b"\n".join(lines):
            raise AssertionError("lossy decompress: names or sequences "
                                 "changed, or a quality not through the map")
    del lines
    comp = sum(len(b) for _, b in triplet(os.path.join(tmp, "lossy")))
    mb = len(data) / 1e6
    say(f"lossy -p {LOSSY_PCT}: {len(data)} B -> {comp} B (ratio "
        f"{len(data) / comp:.4f}; lossless {len(data) / lossless_bytes:.4f})"
        f", max abs quality error {lossy.max_abs_error(lut)}; names and "
        f"sequences exact, qualities through the sampled map; launches "
        f"{launches}")

    # the histogram all-reduce over every card (one flat K6 launch each)
    from scalce_tpu_torch.ops import histogram
    cards = mesh.local_mesh(device="cuda")
    group = blocks[:len(cards)]
    histogram.histogram.launches = 0
    got = mesh.lossy_hist_allreduce(np.stack([b.qual for b in group]),
                                    np.stack([b.lengths for b in group]),
                                    cards).cpu().numpy()
    want = sum(lossy.sample_histogram(b.qual, b.lengths, b.n_reads)
               for b in group)
    if not np.array_equal(got, want):
        raise AssertionError("lossy histogram all-reduce != host histogram")
    if histogram.histogram.launches != len(cards):
        raise AssertionError("the all-reduce did not launch the flat K6 "
                             "entry once per card")
    del blocks, group

    reset(kernels)
    t_dp = compress_file(src, os.path.join(tmp, "lossy_dp"), "cuda",
                         lossy_pct=LOSSY_PCT, data_parallel=True)
    dp = counts(kernels, kernels)
    if triplet(os.path.join(tmp, "lossy_dp")) != triplet(
            os.path.join(tmp, "lossy")):
        raise AssertionError("lossy --data-parallel triplet != "
                             "single-device one")
    if not all(dp[n] for n in ("K1", "K2", "K5", "K6")):
        raise AssertionError(f"K1, K2, K5 or K6 never ran on the lossy "
                             f"data-parallel path: {dp}")
    check_sequence_kernels("lossy --data-parallel", dp, MAIN_BLOCKS)
    say(f"lossy --data-parallel triplet equals the single-device one; "
        f"all-reduce over {len(cards)} card(s) equals the host histogram; "
        f"launches {dp}")

    mates = synth_pair(RAGGED_READS // 2, 100, seed=7, var_len=True,
                       n_rate=0.01)
    paths = tuple(os.path.join(tmp, f"lr{m}.fastq") for m in (1, 2))
    for path, mate in zip(paths, mates):
        with open(path, "wb") as f:
            f.write(mate)
    walls = {}
    for dev in ("cuda", "cpu"):
        t0 = time.monotonic()
        scalce_tpu_torch.compress(Config(
            inputs=paths, paired=True, output=os.path.join(tmp, "lp" + dev),
            **cfg), dev)
        if dev != "cpu":
            torch.cuda.synchronize()
        walls[dev] = time.monotonic() - t0
    gpu, cpu = (triplet(os.path.join(tmp, "lp" + dev))
                for dev in ("cuda", "cpu"))
    if gpu != cpu or len(gpu) != 6:
        raise AssertionError("card and CPU lossy paired triplets differ")
    say(f"card == CPU lossy paired triplets on the ragged pair (2 x "
        f"{RAGGED_READS // 2} reads; card {walls['cuda']:.2f} s, CPU "
        f"{walls['cpu']:.2f} s)")
    say(f"lossy compress {t_c:.3f} s = {mb / t_c:.2f} MB/s, decompress "
        f"{t_d:.3f} s = {mb / t_d:.2f} MB/s, --data-parallel compress "
        f"{t_dp:.3f} s = {mb / t_dp:.2f} MB/s | {smi}")


def check_pipelined(src: str, data: bytes, tmp: str, kernels: dict,
                    smi: str, t1: dict) -> dict:
    """Phase 10: the -T 1 runs of phases 4 and 6-9 once more at -T 4 (the
    CLI's default): the full-device compress of the main file and its
    keep-order --qual-device decompress, the bare command and its host
    decompress, --data-parallel, the pair and -p 30.  Each triplet must
    equal its -T 1 triplet, each decompress must give the input back,
    and every kernel must launch as often as at -T 1.  Then the main file
    at Config()'s default threads (cores + 2), and the -T 4 compress once
    more under torch.profiler.  Prints walls and peak device memory
    beside -T 1's; returns the -T 4 runs."""
    import scalce_tpu_torch
    from scalce_tpu_torch import cli
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.timing import device_busy
    mates = tuple(os.path.join(tmp, f"mate{m}.fastq") for m in (1, 2))
    at4 = {**SLICE, "threads": 4}

    def compress(out, **change):
        scalce_tpu_torch.compress(Config(inputs=(src,), output=out,
                                         **{**at4, **change}), "cuda")

    def keep_order_decompress(name, argv):
        cli.main(["-d", os.path.join(tmp, name + ".00.scalcen"), "-o",
                  os.path.join(tmp, name + "_out"), "--keep-order", "-T",
                  "4", *argv])
        with open(os.path.join(tmp, name + "_out.fastq"), "rb") as f:
            if f.read() != data:
                raise AssertionError(f"-T 4 decompress of {name} != input")

    runs = {"main": (compress, ["--qual-device"]),
            "bare": (lambda out: cli.main([src, "-o", out, "-T", "4"]), []),
            "dp": (lambda out: compress(out, data_parallel=True), None),
            "pair": (lambda out: scalce_tpu_torch.compress(Config(
                inputs=mates, paired=True, output=out, **at4), "cuda"), None),
            "lossy": (lambda out: compress(out, lossy_pct=LOSSY_PCT), None)}
    t4 = {}
    for name, (run, decompress_argv) in runs.items():
        out = os.path.join(tmp, name + "_T4")
        reset(kernels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        run(out)
        torch.cuda.synchronize()
        record(t4, name, kernels, time.monotonic() - t0, out)
        if triplet(out) != triplet(t1[name]["prefix"]):
            raise AssertionError(f"-T 4 {name} triplet != -T 1's")
        if t4[name]["launches"] != t1[name]["launches"]:
            raise AssertionError(f"-T 4 {name} launches {t4[name]['launches']}"
                                 f" != -T 1's {t1[name]['launches']}")
        if decompress_argv is not None:
            t0 = time.monotonic()
            keep_order_decompress(name + "_T4", decompress_argv)
            t4[name + " decompress"] = {"wall_s": time.monotonic() - t0,
                                        "launches": counts(kernels, kernels)}
            if t4[name + " decompress"]["launches"] != \
                    t1[name + " decompress"]["launches"]:
                raise AssertionError(f"-T 4 {name} decompress launches != "
                                     f"-T 1's")
    for name in runs:
        peaks = " -> ".join(f"{r[name]['peak_bytes'] / 2**30:.3f}"
                            for r in (t1, t4))
        before = " -> ".join(f"{g:.3f}" for g in PARENT_PEAK_GIB[name])
        say(f"{name} compress: -T 1 {t1[name]['wall_s']:.3f} s, -T 4 "
            f"{t4[name]['wall_s']:.3f} s; peak device memory {peaks} GiB "
            f"(bdc8925, PERF.md §5: {before} GiB); equal triplets and "
            f"launches {t4[name]['launches']} | {smi}")
        if name + " decompress" in t4:
            say(f"{name} keep-order decompress: -T 1 "
                f"{t1[name + ' decompress']['wall_s']:.3f} s, -T 4 "
                f"{t4[name + ' decompress']['wall_s']:.3f} s, the input back "
                f"| {smi}")

    default = {k: v for k, v in SLICE.items() if k != "threads"}
    threads = Config(inputs=(src,), **default).threads
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    scalce_tpu_torch.compress(Config(inputs=(src,), output=os.path.join(
        tmp, "main_Tdef"), **default), "cuda")
    torch.cuda.synchronize()
    t_def = time.monotonic() - t0
    if triplet(os.path.join(tmp, "main_Tdef")) != triplet(t1["main"]
                                                           ["prefix"]):
        raise AssertionError("default-threads triplet != -T 1's")
    say(f"main compress at Config()'s default -T {threads} (os.cpu_count() "
        f"{os.cpu_count()}): {t_def:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {smi}")

    prof = device_busy(lambda: compress(os.path.join(tmp, "main_T4_prof")))
    if prof is None:
        say("-T 4 compress under torch.profiler: no device events recorded "
            "(device busy not measured)")
    else:
        say(f"timing.device_busy of the -T 4 compress: wall "
            f"{prof['wall_s']:.3f} s, device busy {prof['busy_s']:.4f} s "
            f"({100 * prof['busy_s'] / prof['wall_s']:.1f}%; "
            f"{busy_split(prof)}) | {smi}")
    return t4


def cli_config(argv, **change):
    """The Config that ``scalce_tpu_torch.cli.main(argv)`` compresses
    with, with ``change`` on top (placements the CLI has no flag for)."""
    from scalce_tpu_torch import cli
    args = cli.build_parser().parse_args(argv)
    return dataclasses.replace(cli.config_from_args(args), **change)


def check_placements(src: str, data: bytes, rag: str, tmp: str,
                     kernels: dict, smi: str, t1: dict) -> int:
    """Phase 11: the placements and dictionaries on the main file.  The
    bare command's Config under host core, AUTO, host delta and
    --data-parallel host delta must write phase 9's triplet (host core:
    no kernel, no device memory; host delta: K1 per block and no device
    delta); the pair under host delta phase 7's triplet; lut and lcp at
    core k 12 the same triplets on the card and the CPU (phase 5's ragged
    file), the main file round-tripping under lut; and -d --delta-device
    the input back, equal to the host walk's output.  Returns K1's
    launches in the main file's lut compress."""
    import scalce_tpu_torch
    from scalce_tpu_torch import container
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.models import core_dict
    from scalce_tpu_torch.ops import delta_decode
    from scalce_tpu_torch.pipeline import encode
    from scalce_tpu_torch.streams import seqs
    bare = triplet(t1["bare"]["prefix"])
    delta_ops = [0]
    real_delta = encode._delta_seq

    def counted_delta(*a):
        delta_ops[0] += 1
        return real_delta(*a)
    encode._delta_seq = counted_delta
    base = [src, "-T", "1"]
    runs = {"host core": (cli_config(base + ["--core-placement", "host"]),
                          "host"),
            "auto": (cli_config(base + ["--core-placement", "auto"]), None),
            "host delta": (cli_config(base, delta_on_device=False),
                           "device"),
            "host delta --data-parallel": (cli_config(
                base, delta_on_device=False, data_parallel=True), "device")}
    try:
        for name, (cfg, placement) in runs.items():
            out = os.path.join(tmp, name.replace(" ", "_"))
            reset(kernels)
            delta_ops[0] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.monotonic()
            stats = scalce_tpu_torch.compress(
                dataclasses.replace(cfg, output=out), "cuda")
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            peak = torch.cuda.max_memory_allocated() - before
            launches = counts(kernels, kernels)
            if triplet(out) != bare:
                raise AssertionError(f"{name}: triplet != the bare "
                                     "command's (phase 9)")
            if placement is not None and stats.placement != placement:
                raise AssertionError(f"{name}: placement "
                                     f"{stats.placement}")
            if name == "host core" and (any(launches.values()) or peak
                                        or delta_ops[0]):
                raise AssertionError(f"host core touched the card: "
                                     f"launches {launches}, {peak} B")
            if name != "host core" and (launches["K1"] != 5 or delta_ops[0]
                                        or any(launches[n] for n in launches
                                               if n != "K1")):
                raise AssertionError(f"{name}: launches {launches}, device "
                                     f"delta ops {delta_ops[0]}")
            if name == "auto":
                mbps = encode._LINK_MBPS[torch.device("cuda", 0)]
                say(f"AUTO: link probe {mbps:.1f} MB/s (4 MB page-locked "
                    f"round trip) -> {stats.placement} cores | {smi}")
            say(f"{name}: triplet equals the bare command's, placement "
                f"{stats.placement}, launches {launches}, peak device "
                f"memory {peak} B, wall {wall:.3f} s (bare "
                f"{t1['bare']['wall_s']:.3f} s) | {smi}")

        mates = tuple(os.path.join(tmp, f"mate{m}.fastq") for m in (1, 2))
        reset(kernels)
        delta_ops[0] = 0
        t0 = time.monotonic()
        scalce_tpu_torch.compress(Config(
            inputs=mates, paired=True, output=os.path.join(tmp, "pair_hd"),
            **{**SLICE, "qual_on_device": False, "delta_on_device": False}),
            "cuda")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = counts(kernels, kernels)
        if triplet(os.path.join(tmp, "pair_hd")) != triplet(
                t1["pair"]["prefix"]):
            raise AssertionError("host-delta pair != phase 7's triplets")
        if launches["K1"] != 10 or delta_ops[0]:
            raise AssertionError(f"host-delta pair: launches {launches}, "
                                 f"device delta ops {delta_ops[0]}")
        say(f"pair under host delta (host qualities, order 1): phase 7's "
            f"triplets; launches {launches}; wall {wall:.3f} s (phase 7 "
            f"{t1['pair']['wall_s']:.3f} s) | {smi}")
    finally:
        encode._delta_seq = real_delta

    for mode in ("lut", "lcp"):
        t0 = time.monotonic()
        getattr(core_dict, {"lut": "build_rank_lut",
                            "lcp": "build_rank_lut_lcp"}[mode])(12, 0)
        t_build = time.monotonic() - t0
        walls = {}
        for dev in ("cuda", "cpu"):
            reset(kernels)
            walls[dev] = compress_file(rag, os.path.join(tmp, mode + dev),
                                       dev, dict_mode=mode)
            if dev == "cuda" and not kernels["K1"][1].launches:
                raise AssertionError(f"{mode}: K1 never ran")
        if triplet(os.path.join(tmp, mode + "cuda")) != triplet(
                os.path.join(tmp, mode + "cpu")):
            raise AssertionError(f"{mode}: card and CPU triplets differ")
        say(f"dict_mode {mode} (k 12): card == CPU triplets on the ragged "
            f"file (card {walls['cuda']:.2f} s, CPU {walls['cpu']:.2f} s); "
            f"host build of the table {t_build:.2f} s")
    reset(kernels)
    t_c = compress_file(src, os.path.join(tmp, "main_lut"), "cuda",
                        dict_mode="lut")
    lut_launches = counts(kernels, kernels)
    check_sequence_kernels("main file under lut", lut_launches, MAIN_BLOCKS)
    scalce_tpu_torch.decompress(Config(
        mode="decompress", inputs=(os.path.join(tmp, "main_lut.00.scalcen"),),
        output=os.path.join(tmp, "main_lut_out"), keep_order=True,
        threads=1), "cuda")
    with open(os.path.join(tmp, "main_lut_out.fastq"), "rb") as f:
        if f.read() != data:
            raise AssertionError("main file under lut: decompress != input")
    comp = sum(len(b) for _, b in triplet(os.path.join(tmp, "main_lut")))
    say(f"main file under lut: round trip exact, ratio "
        f"{len(data) / comp:.4f}, compress {t_c:.3f} s, launches "
        f"{lut_launches} | {smi}")

    # -d --delta-device against the host walk on phase 4's triplet
    main = os.path.join(tmp, "main.00.scalcen")
    walls, outs = {}, {}
    for tag, dev in (("host walk", False), ("delta device", True)):
        out = os.path.join(tmp, "dd_" + tag.replace(" ", "_"))
        t0 = time.monotonic()
        scalce_tpu_torch.decompress(Config(
            mode="decompress", inputs=(main,), output=out, keep_order=True,
            delta_on_device=dev, threads=1), "cuda")
        walls[tag] = time.monotonic() - t0
        with open(out + ".fastq", "rb") as f:
            outs[tag] = f.read()
    if not outs["delta device"] == outs["host walk"] == data:
        raise AssertionError("--delta-device decompress != input or != the "
                             "host walk's")
    reader = container.TripletReader(main)
    B, L = reader.meta["block_reads"], reader.meta["max_read_len"]
    ms = []
    for _, payloads in reader.iter_blocks():
        fields, lengths, n, *_ = seqs.parse_fields(payloads["r"], B, L,
                                                   delta_device=True)
        x = {k: torch.from_numpy(a).to("cuda") for k, a in
             delta_decode.host_inputs(fields["mask_bits"], fields["shifts"],
                                      fields["pred_k"], fields["lits"],
                                      lengths[:n], B, L).items()}
        ms.append(time_ms(lambda: delta_decode.reconstruct(
            x["mask_bits"], x["shifts"], x["pred_k"], x["lits"],
            x["lengths"], L), 10))
    say(f"-d --delta-device: the input back, equal to the host walk's; "
        f"reconstruction {', '.join(f'{m:.3f}' for m in ms)} ms per block "
        f"({delta_decode.ceil_log2(B)} doubling rounds over {B * L} cells);"
        f" keep-order decompress -T 1 {walls['delta device']:.3f} s (host "
        f"walk {walls['host walk']:.3f} s) | {smi}")
    return lut_launches["K1"]


#: phase 4's Config (``SLICE``) as flags of the port's command line
SLICE_FLAGS = ["--block-reads", str(SLICE["block_reads"]), "--max-read-len",
               str(SLICE["max_read_len"]), "--core-placement", "device",
               "--delta-device", "--qual-device", "--qual-order", "1",
               "-c", "gz", "-T", "1"]
#: phase 12's long-read file: HiFi-like reads from a 1 Mbp genome (~30x)
LONG = dict(n_reads=2048, min_len=10_000, max_len=20_000,
            genome_len=1_000_000, sub=0.005, ins=0.001, dele=0.001, seed=12)
LONG_FLAGS = ["--max-read-len", "32768", "--block-reads", "512", "-T", "4"]
#: the device of phase 12's child processes
DEVICE = "cuda"

#: child of phase 12: the bare command on the long-read file and its
#: keep-order decompress, on the card; prints walls, peak device memory
#: and the host RSS (at the start, and the peak sampled every 20 ms
#: during each run; null where /proc gives no resident size) as JSON.
#: getrusage's ru_maxrss would keep the parent's peak across fork and
#: exec, and the card's machine has no VmHWM
LONG_CHILD = """
import json, os, sys, threading, time
import torch
from scalce_tpu_torch import cli

def rss_mb():
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, ValueError, IndexError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 20 if pages else None

def sampled(fn):
    peak, stop = [rss_mb()], threading.Event()

    def sample():
        while peak[0] is not None and not stop.wait(0.02):
            now = rss_mb()
            peak[0] = None if now is None else max(peak[0], now)
    t = threading.Thread(target=sample)
    t.start()
    try:
        fn()
    finally:
        stop.set()
        t.join()
    return peak[0]

src, out, device, flags = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:]
res = {"start_rss_mb": rss_mb()}
for name, argv in (("compress", [src, *flags, "-o", out]),
                   ("decompress", ["-d", "--keep-order", "-T", "4", "-o",
                                   out + "_d", out + ".00.scalcen"])):
    argv += ["--device", device]
    t0 = time.monotonic()
    res[name + "_rss_mb"] = sampled(lambda: cli.main(argv))
    res[name + "_s"] = time.monotonic() - t0
    res[name + "_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                 if torch.cuda.is_initialized() else 0)
print(json.dumps(res))
"""

#: child of phase 12: one rank of ``parallel.multihost``, then its launch
#: counts of K1-K4, K7 and K8 as JSON
RANK_CHILD = """
import json, sys
from scalce_tpu_torch.ops import (compact, core_rank, delta_seq, rans_decode,
                                  rans_encode)
from scalce_tpu_torch.parallel import multihost
from scalce_tpu_torch.streams import qualities
multihost.main(sys.argv[1:])
print(json.dumps({"K1": core_rank.core_rank_codes.launches,
                  "K2": qualities.sym_ctx_hist.launches,
                  "K3": rans_encode.encode_scan.launches,
                  "K4": rans_decode.decode_quals.launches,
                  "K7": delta_seq.delta_seq.launches,
                  "K8": compact.compact_emissions.launches}))
"""


def run_children(argvs, timeout: int = 600) -> list:
    """Run the command lines side by side from this script's directory;
    the lines of each one's standard output; raise with a child's
    standard error if one fails (every child is stopped on the way out)."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=here)
             for a in argvs]
    outs = []
    try:
        for a, p in zip(argvs, procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode:
                raise AssertionError(f"{a[:4]} exited {p.returncode}:\n"
                                     f"{err[-3000:]}")
            outs.append(out.strip().splitlines())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def mb_or_not(x) -> str:
    return "not measured" if x is None else f"{x:.0f}"


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_two_ranks(src: str, tmp: str, name: str, flags, want_prefix: str,
                    want_launches: dict, smi: str) -> None:
    """Two ranks of ``parallel.multihost`` on localhost, sharing the card
    (``cuda:R % cards``): rank 0's merged triplet must be ``want_prefix``'s,
    and K1-K3, K7 and K8 must launch as often across the ranks as in that
    run (K4 decodes: none)."""
    out = os.path.join(tmp, name)
    port = free_port()
    t0 = time.monotonic()
    outs = run_children([
        [sys.executable, "-c", RANK_CHILD, src, "-o", out, "--coordinator",
         f"localhost:{port}", "--num-processes", "2", "--process-id",
         str(rank), "--stats-json", *flags] for rank in range(2)])
    wall = time.monotonic() - t0
    ranks = [json.loads(lines[-1]) for lines in outs]
    rank_s = [json.loads(lines[-2])["wall_s"] for lines in outs]
    total = {k: sum(r[k] for r in ranks) for k in ranks[0]}
    want = {k: want_launches[k] for k in ("K1", "K2", "K3", "K7", "K8")}
    if triplet(out) != triplet(want_prefix):
        raise AssertionError(f"{name}: the two ranks' merged triplet != "
                             f"{os.path.basename(want_prefix)}'s")
    if {k: total[k] for k in want} != want or total["K4"]:
        raise AssertionError(f"{name}: launches over the ranks {total}, "
                             f"want {want} and no K4")
    say(f"two ranks ({name}): merged triplet equals "
        f"{os.path.basename(want_prefix)}'s (phase {'8' if '-p' in flags else '4'}); "
        f"launches over the ranks {total}, per rank {ranks}; each rank's "
        f"compress {', '.join(f'{x:.3f}' for x in rank_s)} s, "
        f"{wall:.3f} s from launch to both exits (starts, barrier and "
        f"merge included) | {smi}")


def spans_and_kernels(trace: str):
    """(user span names, {kernel kind: events}) of one Chrome trace."""
    import collections
    from scalce_tpu_torch import timing
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    kinds = collections.Counter(timing.device_event_kind(e["name"])
                                for e in events if e.get("cat") == "kernel")
    return spans, dict(kinds)


def check_feature_surface(src: str, data: bytes, tmp: str, smi: str,
                          t1: dict) -> None:
    """Phase 12: long reads through the bare command (on the host, no
    device memory), two ranks of ``parallel.multihost`` at phase 4's and
    phase 8's Configs, and phase 4's compress and decompress through the
    CLI under ``--profile``."""
    from scalce_tpu_torch.utils.longread import synth_long_fastq
    lsrc = os.path.join(tmp, "hifi.fastq")
    ldata = synth_long_fastq(**LONG)
    with open(lsrc, "wb") as f:
        f.write(ldata)
    bases = sum(len(s) for s in ldata.split(b"\n")[1::4])
    lout = os.path.join(tmp, "hifi")
    (lines,) = run_children([[sys.executable, "-c", LONG_CHILD, lsrc, lout,
                              DEVICE, *LONG_FLAGS]], timeout=900)
    res = json.loads(lines[-1])
    with open(lout + "_d.fastq", "rb") as f:
        if f.read() != ldata:
            raise AssertionError("long reads: keep-order decompress != "
                                 "input")
    seq_bytes = os.path.getsize(lout + ".00.scalcer")
    comp = sum(len(b) for _, b in triplet(lout))
    floor = bases / 4
    if res["compress_peak_bytes"] or res["decompress_peak_bytes"]:
        raise AssertionError(f"long reads touched the card: {res}")
    # the reference's own v7 gate for indel-bearing long reads
    # (tests/test_edge_cases.py: 1.08x under the 2-bit floor)
    if seq_bytes * 1.08 >= floor:
        raise AssertionError(f"long reads: seq stream {seq_bytes} B not "
                             f"under the 2-bit floor {floor:.0f} B / 1.08")
    mb = len(ldata) / 1e6
    say(f"long reads ({LONG['n_reads']} reads, {bases} bases, "
        f"{' '.join(LONG_FLAGS)}): keep-order round trip exact; ratio "
        f"{len(ldata) / comp:.4f}; seq stream {seq_bytes} B = 2-bit floor "
        f"/ {floor / seq_bytes:.4f}; compress {res['compress_s']:.3f} s = "
        f"{mb / res['compress_s']:.2f} MB/s, decompress "
        f"{res['decompress_s']:.3f} s = {mb / res['decompress_s']:.2f} "
        f"MB/s; peak device memory {res['compress_peak_bytes']} / "
        f"{res['decompress_peak_bytes']} B; host RSS (MB) "
        f"{mb_or_not(res['start_rss_mb'])} at the start, peak "
        f"{mb_or_not(res['compress_rss_mb'])} in the compress, "
        f"{mb_or_not(res['decompress_rss_mb'])} in the decompress | {smi}")

    check_two_ranks(src, tmp, "mh", SLICE_FLAGS, t1["main"]["prefix"],
                    t1["main"]["launches"], smi)
    check_two_ranks(src, tmp, "mh_lossy", SLICE_FLAGS + ["-p", str(LOSSY_PCT)],
                    t1["lossy"]["prefix"], t1["lossy"]["launches"], smi)

    # --profile as a user runs it: one command line per run, each in its
    # own process
    prof = os.path.join(tmp, "prof")
    out = os.path.join(tmp, "prof_main")
    walls, found = {}, {}
    for mode, argv in (("compress", [src, *SLICE_FLAGS, "-o", out]),
                       ("decompress", ["-d", "--keep-order", "--qual-device",
                                       "-T", "1", "-o", out + "_d",
                                       out + ".00.scalcen"])):
        (lines,) = run_children([[sys.executable, "-m", "scalce_tpu_torch",
                                  *argv, "--device", DEVICE, "--stats-json",
                                  "--profile", os.path.join(prof, mode)]])
        walls[mode] = json.loads(lines[-1])["wall_s"]
    if triplet(out) != triplet(t1["main"]["prefix"]):
        raise AssertionError("--profile: triplet != phase 4's")
    with open(out + "_d.fastq", "rb") as f:
        if f.read() != data:
            raise AssertionError("--profile: decompress != input")
    want_spans = {"compress": {"parse FASTQ", "upload", "stage A",
                               "stage B", "pass B", "download",
                               "seqs.payload", "write"},
                  "decompress": {"seqs.parse", "quality decode", "_finish",
                                 "render FASTQ", "write"}}
    # K7 is two kernels per launch (match, literal placement)
    want_kinds = {"compress": {k: t1["main"]["launches"][k]
                               * (2 if k == "K7" else 1)
                               for k in ("K1", "K2", "K3", "K7", "K8")},
                  "decompress": {"K4": t1["main decompress"]["launches"]
                                 ["K4"]}}
    for mode in walls:
        (trace,) = glob.glob(os.path.join(prof, mode, "*.trace.json"))
        spans, kinds = spans_and_kernels(trace)
        launched = {k: kinds.get(k, 0) for k in want_kinds[mode]}
        if not want_spans[mode] <= spans or launched != want_kinds[mode]:
            raise AssertionError(
                f"--profile {mode}: spans missing "
                f"{want_spans[mode] - spans}, kernel events {kinds}, want "
                f"{want_kinds[mode]}")
        found[mode] = (len(spans), launched, os.path.getsize(trace))
    say(f"--profile (the CLI, one process per run): phase 4's triplet and "
        f"the input back; the traces name the stages and kernels (spans, "
        f"kernel events, trace bytes: {found}); the CLI's walls under the "
        f"profiler compress {walls['compress']:.3f} s (phase 4 unprofiled "
        f"{t1['main']['wall_s']:.3f} s), decompress "
        f"{walls['decompress']:.3f} s (unprofiled "
        f"{t1['main decompress']['wall_s']:.3f} s) | {smi}")


def main() -> int:
    smi = card()                                              # phase 1
    from scalce_tpu_torch.ops import (_cuda, compact, core_rank, delta_seq,
                                      hist, histogram, rans_decode,
                                      rans_encode, rans_encode_flat)
    from scalce_tpu_torch.streams import qualities
    kind = torch.cuda.get_device_name(0)
    say(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    #: name -> (module with SOURCE / REPLACES, wrapper with .launches)
    kernels = {"K1": (core_rank, core_rank.core_rank_codes),
               "K2": (hist, qualities.sym_ctx_hist),
               "K3": (rans_encode, rans_encode.encode_scan),
               "K4": (rans_decode, rans_decode.decode_quals),
               "K5": (rans_encode_flat, rans_encode_flat.encode_grids),
               "K6": (histogram, histogram.grid_histogram),
               "K7": (delta_seq, delta_seq.delta_seq),
               "K8": (compact, compact.compact_emissions)}
    main_path = ("K1", "K2", "K3", "K4", "K7", "K8")

    t0 = time.monotonic()                                       # phase 2
    _cuda.library()
    say(f"build: {time.monotonic() - t0:.1f} s ({_cuda.library_path()})")

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "main.fastq")
        data = write_fastq(src, MAIN_READS, seed=42, genome_len=1_000_000,
                           n_rate=0.001)
        rag = os.path.join(tmp, "ragged.fastq")
        write_fastq(rag, RAGGED_READS, seed=7, var_len=True, n_rate=0.01)
        from scalce_tpu_torch.io import fastq
        blocks = fastq.iter_blocks(src, SLICE["block_reads"],
                                   SLICE["max_read_len"])
        group = [next(blocks) for _ in range(4)]
        blocks.close()
        blocks = fastq.iter_blocks(rag, SLICE["block_reads"],
                                   SLICE["max_read_len"])
        ragged = next(blocks)
        blocks.close()
        measured = check_kernels(group, ragged, dev, kernels)   # phase 3
        del group, ragged

        reset(kernels)                                          # phase 4
        t1 = {}        # the -T 1 runs that phase 10 repeats at -T 4
        t_c = compress_file(src, os.path.join(tmp, "main"), "cuda")
        record(t1, "main", kernels, t_c, os.path.join(tmp, "main"))
        import scalce_tpu_torch
        from scalce_tpu_torch.config import Config
        t0 = time.monotonic()
        scalce_tpu_torch.decompress(Config(
            mode="decompress", inputs=(os.path.join(tmp, "main.00.scalcen"),),
            output=os.path.join(tmp, "main_out"), keep_order=True,
            qual_on_device=True, threads=1), "cuda")
        t_d = time.monotonic() - t0
        t1["main decompress"] = {"wall_s": t_d,
                                 "launches": counts(kernels, kernels)}
        launches = counts(kernels, main_path)
        with open(os.path.join(tmp, "main_out.fastq"), "rb") as f:
            if f.read() != data:
                raise AssertionError("keep-order decompress != input")
        if not all(launches.values()):
            raise AssertionError(f"a kernel never ran on the main path: "
                                 f"{launches}")
        check_sequence_kernels("main path", t1["main decompress"]["launches"],
                               MAIN_BLOCKS)
        comp = sum(len(b) for _, b in triplet(os.path.join(tmp, "main")))
        mb = len(data) / 1e6
        say(f"main path: {MAIN_READS} reads, {len(data)} B -> {comp} B "
            f"(ratio {len(data) / comp:.4f}); launches {launches}")
        say(f"compress {t_c:.3f} s = {mb / t_c:.2f} MB/s | {smi}")
        say(f"decompress {t_d:.3f} s = {mb / t_d:.2f} MB/s | {smi}")

        t_gpu = compress_file(rag, os.path.join(tmp, "rg"),
                              "cuda")                           # phase 5
        t_cpu = compress_file(rag, os.path.join(tmp, "rc"), "cpu")
        gpu, cpu = triplet(os.path.join(tmp, "rg")), \
            triplet(os.path.join(tmp, "rc"))
        if gpu != cpu:
            raise AssertionError("card and CPU triplets differ: "
                                 f"{[(n, len(b)) for n, b in gpu]} vs "
                                 f"{[(n, len(b)) for n, b in cpu]}")
        say(f"card == CPU triplets on the ragged file ({len(gpu)} files; "
            f"card {t_gpu:.2f} s, CPU {t_cpu:.2f} s)")

        sharded, driver = check_data_parallel(src, tmp, kernels, smi,
                                              t_c, t1)          # phase 6
        launches.update(K5=driver["K5"], K6=driver["K6"])
        dp_launches = {"K7": driver["K7"], "K8": driver["K8"]}
        check_paired(tmp, kernels, smi, t1)                     # phase 7
        check_lossy(src, data, comp, tmp, kernels, smi, t1)     # phase 8
        check_cli_defaults(src, data, tmp, kernels, smi, t1)    # phase 9
        t4 = check_pipelined(src, data, tmp, kernels, smi, t1)  # phase 10
        measured["K1 lut"]["launches"] = check_placements(
            src, data, rag, tmp, kernels, smi, t1)              # phase 11
        check_feature_surface(src, data, tmp, smi, t1)          # phase 12
        launches_t4 = {n: t4["main decompress"]["launches"][n]
                       for n in main_path}
        launches_t4.update(K5=t4["dp"]["launches"]["K5"],
                           K6=t4["dp"]["launches"]["K6"])

    # K2 also through the lossy LUT and grids-only (the data-parallel
    # path's); K4 also at the main path's remainder group (D = 1); K5 and
    # K6 also at one block's shapes (the one-card --data-parallel
    # driver's); K6 also through its flat entry (the all-reduce's); K7
    # also on the ragged block; K8 also on K5's group of 4
    other = {"K1": (("K1 lut", "lut"),),
             "K2": (("K2 lut", "lut"), ("K2 grids", "grids_only")),
             "K4": (("K4 D=1", "d1"),), "K5": (("K5 1 block", "one_block"),),
             "K6": (("K6 1 block", "one_block"), ("K6 flat", "flat")),
             "K7": (("K7 ragged", "ragged"),), "K8": (("K8 group", "group"),)}
    print(json.dumps({"kernels": [
        {"name": f"{name} {fn.__name__}", "route": "cuda",
         "source": mod.SOURCE, "replaces": mod.REPLACES,
         "launches": launches[name], "launches_T4": launches_t4[name],
         **({"sharded_launches": sharded[name]}
            if name in ("K5", "K6") else {}),
         **({"dp_launches": dp_launches[name]} if name in dp_launches
            else {}),
         **measured[name],
         **{key: measured[case] for case, key in other.get(name, ())}}
        for name, (mod, fn) in kernels.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
