"""scalce_tpu_torch stands alone: it imports nothing of scalce_tpu, and
its copies of the reference's host modules (Config and the CLI parser,
the container, FASTQ I/O, the names codec, synthetic data, the native C
library) give the reference's bytes and values on the same inputs."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import scalce_tpu.cli as ref_cli
from scalce_tpu import container as ref_container
from scalce_tpu import native as ref_native
from scalce_tpu.io import backend as ref_backend
from scalce_tpu.io import fastq as ref_fastq
from scalce_tpu.streams import names as ref_names
from scalce_tpu.utils import synth as ref_synth
from scalce_tpu_torch import cli, cli_args, container, native
from scalce_tpu_torch.io import backend, fastq
from scalce_tpu_torch.models import entropy
from scalce_tpu_torch.streams import names
from scalce_tpu_torch.utils import synth
from scalce_tpu_torch.utils.longread import synth_long_fastq

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "scalce_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py"]


def _imports_of_reference(path):
    """The lines of ``path`` that import scalce_tpu, jax or a module of
    either."""
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names_ = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names_ = [node.module or ""]
        else:
            continue
        if any(n == top or n.startswith(top + ".")
               for n in names_ for top in ("scalce_tpu", "jax")):
            bad.append(node.lineno)
    return bad


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_nothing_of_the_reference(path):
    assert _imports_of_reference(path) == []


def test_import_walk_sees_a_reference_import(tmp_path):
    """The walk above finds each form of import it must refuse."""
    src = tmp_path / "m.py"
    src.write_text("import scalce_tpu\nfrom scalce_tpu.io import fastq\n"
                   "def f():\n    from scalce_tpu import native\n"
                   "import scalce_tpu_torch\nimport jax.numpy as jnp\n"
                   "from jax import lax\nimport jaxlib\n")
    assert sorted(_imports_of_reference(str(src))) == [1, 2, 4, 6, 7]


@pytest.mark.parametrize("entry", ["cli"])
def test_entry_points_default_to_the_card(entry):
    """The port's entry point runs on the card unless the caller asks
    for the CPU: the CLI's ``--device``."""
    device = cli.build_parser().parse_args(["in.fastq"]).device
    assert device == "cuda"


def test_cli_round_trip_loads_no_reference_module(tmp_path):
    """A compress, a keep-order decompress, a -r pair, a -p file, host
    cores, AUTO with the lcp dictionary, a --delta-device decompress, a
    long-read file and a two-host compress with --merge-hosts through
    the port's CLI in a fresh process: no module named scalce_tpu or
    scalce_tpu.* is ever loaded."""
    src = os.path.join(tmp_path, "in.fastq")
    with open(src, "wb") as f:
        f.write(synth.synth_fastq(500, 100, seed=8, var_len=True,
                                  n_rate=0.01))
    long_src = os.path.join(tmp_path, "long.fastq")
    with open(long_src, "wb") as f:
        f.write(synth_long_fastq(8, 30_000, 36_000, genome_len=60_000,
                                 ins=0.001, dele=0.001, seed=8))
    mates = [os.path.join(tmp_path, f"m{m}.fastq") for m in (1, 2)]
    for path, data in zip(mates, synth.synth_pair(400, 100, seed=9)):
        with open(path, "wb") as f:
            f.write(data)
    script = textwrap.dedent(f"""
        import sys
        from scalce_tpu_torch.cli import main
        out = {str(tmp_path)!r}
        base = ["--device", "cpu", "--block-reads", "256", "-c", "gz"]
        main(base + ["-o", out + "/o", {src!r}])
        main(["--device", "cpu", "-d", "--keep-order", "-o", out + "/d",
              out + "/o.00.scalcen"])
        main(base + ["-r", "-o", out + "/r", *{mates!r}])
        main(["--device", "cpu", "-d", "--keep-order", "-o", out + "/rd",
              out + "/r.00_1.scalcen"])
        main(base + ["-p", "30", "-S", "300", "-o", out + "/l", {src!r}])
        main(["--device", "cpu", "-d", "-o", out + "/ld",
              out + "/l.00.scalcen"])
        main(base + ["--core-placement", "host", "-o", out + "/h", {src!r}])
        main(base + ["--core-placement", "auto", "--dict-mode", "lcp",
                     "--core-k", "8", "-o", out + "/a", {src!r}])
        main(["--device", "cpu", "-d", "--delta-device", "--keep-order",
              "-o", out + "/hd", out + "/h.00.scalcen"])
        assert open(out + "/d.fastq", "rb").read() == \\
            open({src!r}, "rb").read() == \\
            open(out + "/hd.fastq", "rb").read()
        main(base + ["-o", out + "/lr", {long_src!r}])
        main(["--device", "cpu", "-d", "--keep-order", "-o", out + "/lrd",
              out + "/lr.00.scalcen"])
        assert open(out + "/lrd.fastq", "rb").read() == \\
            open({long_src!r}, "rb").read()
        for h in ("0", "1"):
            main(base + ["-o", out + "/mh", "--n-hosts", "2", "--host-id",
                         h, {src!r}])
        main(base + ["-o", out + "/mh", "--n-hosts", "2", "--merge-hosts",
                     {src!r}])
        for s in "nrq":
            assert open(out + "/mh.00.scalce" + s, "rb").read() == \\
                open(out + "/o.00.scalce" + s, "rb").read()
        loaded = sorted(m for m in sys.modules
                        if m == "scalce_tpu" or m.startswith("scalce_tpu."))
        assert not loaded, loaded
        print("no reference module")
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no reference module" in proc.stdout


@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=5, var_len=True, n_rate=0.01),
    dict(seed=7, qual_model="hiseq", name_style="illumina", rc_rate=0.3),
    dict(seed=11, genome_len=5_000, mate=2)])
def test_synth_fastq_bytes_match_reference(kw):
    assert synth.synth_fastq(300, 120, **kw) == \
        ref_synth.synth_fastq(300, 120, **kw)


@pytest.mark.parametrize("seed", [1, 42])
def test_synth_pair_bytes_match_reference(seed):
    assert synth.synth_pair(250, 100, seed=seed, var_len=True) == \
        ref_synth.synth_pair(250, 100, seed=seed, var_len=True)


@pytest.mark.parametrize("argv", [
    ["in.fastq"],
    ["-d", "out.00.scalcen", "-o", "res", "--keep-order"],
    ["a.fq", "b.fq", "-r", "-p", "30", "-S", "5000", "-B", "500M",
     "-c", "gz", "--block-reads", "1024", "--max-read-len", "160"],
    ["in.fq", "-n", "lib", "-T", "2", "--qual-order", "3", "--qual-device",
     "--delta-device", "--core-placement", "device", "--dict-mode", "lut",
     "--data-parallel", "--resume", "--stats-json", "-v"],
    ["in.fq", "--n-hosts", "4", "--host-id", "3", "--core-k", "10",
     "--profile", "trace"]])
def test_config_from_both_parsers(argv):
    """The parser copy builds the reference's Config, field for field;
    the port's own parser adds --device and its slice's defaults."""
    got = cli_args.config_from_args(cli_args.build_parser().parse_args(argv))
    want = ref_cli.config_from_args(ref_cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    args = cli.build_parser().parse_args(argv)
    assert args.device == "cuda"
    assert type(cli_args.config_from_args(args)).__module__ == \
        "scalce_tpu_torch.config"


def _arrays(rng):
    return {"u8": rng.integers(0, 256, 1000).astype(np.uint8),
            "u16": rng.integers(0, 1 << 16, 77).astype(np.uint16),
            "u32": rng.integers(0, 1 << 32, 33, dtype=np.uint64).astype(
                np.uint32),
            "i64": rng.integers(-(1 << 40), 1 << 40, (5, 7)),
            "zeros": np.zeros(4096, np.uint8), "empty": np.zeros(0, np.int32)}


@pytest.mark.parametrize("backend_name", ["gz", "bz", "no"])
def test_container_arrays_cross(backend_name):
    rng = np.random.default_rng(3)
    arrays = _arrays(rng)
    for pack, unpack in ((container.pack_arrays, ref_container.unpack_arrays),
                         (ref_container.pack_arrays, container.unpack_arrays)):
        blob = pack(arrays, deflate=("u8", "zeros"), level=6,
                    backend=backend_name)
        back = unpack(blob)
        assert sorted(back) == sorted(arrays)
        for k, a in arrays.items():
            assert back[k].dtype == a.dtype
            np.testing.assert_array_equal(back[k], a)
    assert container.pack_arrays(arrays, backend=backend_name) == \
        ref_container.pack_arrays(arrays, backend=backend_name)
    raw = arrays["u8"].tobytes() * 3
    assert backend.compress_bytes(raw, backend_name) == \
        ref_backend.compress_bytes(raw, backend_name)


@pytest.mark.parametrize("writer,reader", [
    (container.TripletWriter, ref_container.TripletReader),
    (ref_container.TripletWriter, container.TripletReader)])
def test_triplet_written_by_one_read_by_the_other(tmp_path, writer, reader):
    """Parts rolled by a small part size, a paired mate's file names."""
    rng = np.random.default_rng(4)
    meta = {"block_reads": 256, "max_read_len": 128, "paired": True}
    blocks = [(i, {s: rng.integers(0, 256, 3000 + 100 * i).astype(
        np.uint8).tobytes() for s in "nrq"}) for i in range(5)]
    prefix = os.path.join(tmp_path, "t")
    w = writer(prefix, meta, part_size=9000, mate=2)
    for bid, payloads in blocks:
        w.add_block(bid, payloads, 256)
    w.close()
    r = reader(prefix + ".00_2.scalcen")
    assert r.meta["paired"] and len(r.part_ids) > 1
    assert list(r.iter_blocks()) == blocks


def _fastq_file(tmp_path, seed, crlf=False):
    data = synth.synth_fastq(700, 150, seed=seed, var_len=True,
                             n_rate=0.02, name_style="illumina")
    if crlf:
        data = data.replace(b"\n", b"\r\n")
    path = os.path.join(tmp_path, f"r{seed}.fastq")
    with open(path, "wb") as f:
        f.write(data)
    return path, data


@pytest.mark.parametrize("crlf", [False, True])
def test_fastq_parse_render_names_match_reference(tmp_path, crlf):
    """Blocks (the native parse: line_starts, parse_into_block,
    fill_block), names payloads (analyze_names, render_ints_i64) and
    their decode (join_fields), and the rendered records (render_fastq2)
    of the copies equal the reference's."""
    path, data = _fastq_file(tmp_path, 12 + crlf, crlf)
    got = list(fastq.iter_blocks(path, 256, 160))
    want = list(ref_fastq.iter_blocks(path, 256, 160))
    assert len(got) == len(want) == 3
    out = []
    for g, w in zip(got, want):
        for field in ("seq", "qual", "lengths", "exc_pos", "exc_byte"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field))
        assert g.n_reads == w.n_reads and g.block_id == w.block_id
        blob = names.encode(g.names, g.n_reads, backend="gz")
        assert blob == ref_names.encode(w.names, w.n_reads, backend="gz")
        back = names.decode(blob)
        ref_back = ref_names.decode(blob)
        np.testing.assert_array_equal(back.cat, ref_back.cat)
        np.testing.assert_array_equal(back.offsets, ref_back.offsets)
        buf = fastq.render_fastq_records(g.seq, g.qual, g.lengths, g.n_reads,
                                         g.exc_pos, g.exc_byte, back, g.plus)
        np.testing.assert_array_equal(buf, ref_fastq.render_fastq_records(
            w.seq, w.qual, w.lengths, w.n_reads, w.exc_pos, w.exc_byte,
            ref_back, w.plus))
        out.append(bytes(buf))
    assert b"".join(out) == data.replace(b"\r\n", b"\n")
    assert fastq.probe_max_read_len([path]) == \
        ref_fastq.probe_max_read_len([path])


#: the port's copies of reference modules -> the file each names
COPIES = {"config.py": "config.py", "container.py": "container.py",
          "version.py": "version.py", "cli_args.py": "cli.py",
          "io/__init__.py": "io/__init__.py", "io/fastq.py": "io/fastq.py",
          "io/backend.py": "io/backend.py",
          "models/core_dict.py": "models/core_dict.py",
          "native/__init__.py": "native/__init__.py",
          "ops/minimizer.py": "ops/minimizer.py",
          "parallel/merge.py": "parallel/merge.py",
          "pipeline/threads.py": "pipeline/driver.py",
          "streams/names.py": "streams/names.py",
          "streams/qualities_host.py": "streams/qualities.py",
          "utils/__init__.py": "utils/__init__.py",
          "utils/synth.py": "utils/synth.py"}


@pytest.mark.parametrize("copy", sorted(COPIES))
def test_copy_names_its_original_in_its_header(copy):
    """The first line of each copied module names the reference file it
    copies, and that file exists."""
    with open(os.path.join(REPO, "scalce_tpu_torch", copy)) as f:
        head = f.readline()
    original = "scalce_tpu/" + COPIES[copy]
    assert head.startswith("# Copy of ") and original in head, head
    assert os.path.exists(os.path.join(REPO, original))


def test_async_writer_is_the_references_verbatim():
    """The decompress driver's ordered writer is the reference's code,
    statement for statement."""
    def definition(path):
        tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
        (node,) = [n for n in tree.body
                   if getattr(n, "name", None) == "_AsyncWriter"]
        return ast.dump(node)
    assert definition("scalce_tpu_torch/pipeline/threads.py") == \
        definition("scalce_tpu/pipeline/driver.py")


def _body(path):
    """The module's statements but its imports and docstring, as AST."""
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    return [ast.dump(n) for n in tree.body
            if not isinstance(n, (ast.Import, ast.ImportFrom))
            and not (isinstance(n, ast.Expr)
                     and isinstance(n.value, ast.Constant))]


@pytest.mark.parametrize("copy", ["ops/minimizer.py", "parallel/merge.py"])
def test_verbatim_copy_matches_reference_statement_for_statement(copy):
    """The long-read minimizer keys and the multi-host merge are the
    reference's code: every statement but the imports."""
    assert _body("scalce_tpu_torch/" + copy) == _body("scalce_tpu/" + copy)


def test_native_library_is_the_ports_own():
    assert native.AVAILABLE
    assert os.path.dirname(native._SO) == os.path.join(
        REPO, "scalce_tpu_torch", "_build")
    assert native._lib is not ref_native._lib


def _rans_inputs(rng, n, n_ctx, n_syms):
    counts = rng.integers(0, 50, (n_ctx, n_syms)) * (
        rng.random((n_ctx, n_syms)) < 0.4)
    counts[0] = 0
    return counts.reshape(-1)


def _native_cases():
    """name -> f(lib, rng) giving a tuple of outputs (in-place outputs
    included), for each native function the port calls directly."""
    def ragged_gather(lib, rng):
        buf = rng.integers(0, 256, 5000).astype(np.uint8)
        lens = rng.integers(0, 40, 60)
        starts = rng.integers(0, 5000 - 40, 60)
        return (lib.ragged_gather_u8(buf, starts, lens),)

    def ragged_scatter(lib, rng):
        lens = rng.integers(0, 30, 50)
        dst_starts = np.arange(50, dtype=np.int64) * 30
        src = rng.integers(0, 256, int(lens.sum())).astype(np.uint8)
        dst = np.zeros(1500, np.uint8)
        lib.ragged_scatter_u8(dst, dst_starts, src, lens)
        return (dst,)

    def bitpack(lib, rng):
        vals = rng.integers(0, 1 << 17, 999).astype(np.uint32)
        packed = lib.bitpack_u32(vals, 17)
        return packed, lib.bitunpack_u32(packed, 999, 17)

    def pack2bit(lib, rng):
        codes = rng.integers(0, 4, (30, 128)).astype(np.uint8)
        words = lib.pack2bit(codes)
        return words, lib.unpack2bit(words)

    def reconstruct(lib, rng):
        n, L = 200, 64
        lens = rng.integers(0, L + 1, n).astype(np.int64)
        bits = (rng.random((n, L)) < 0.7) & (np.arange(L) < lens[:, None])
        bits[0] = False
        mask = np.packbits(bits, axis=1, bitorder="little")
        shifts = rng.integers(-3, 4, n).astype(np.int16)
        pred_k = rng.integers(0, 2, n).astype(np.uint8)
        lits = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
        out = np.zeros((n, L), np.uint8)
        got = lib.reconstruct_delta_checked(mask, shifts, pred_k, lits,
                                            lens, L, out)
        return np.asarray(got), out

    def normalize(lib, rng):
        counts = _rans_inputs(rng, 0, 257, 256)
        freq, cum = lib.host_normalize_tbl(counts, 257, 256)
        return freq, cum, lib.build_flat_lut(freq, cum, 257, 256)

    def lits(lib, rng):
        n = 10_000
        x = rng.choice(4, n, p=[0.6, 0.2, 0.1, 0.1]).astype(np.uint8)
        N = (n + 4095) // 4096
        counts = lib.lit_hist(x, n, N, 4096)
        freq, cum = entropy.host_normalize_np(counts, 17, 4)
        states, wc, words = lib.rans_encode_lits(x, n, N, 4096, freq, cum)
        lut = entropy.build_decode_lut(freq, cum)
        back = lib.rans_decode_lits(states, words, wc, lut, n, N, 4096)
        return counts, states, wc, words, back

    def mask(lib, rng):
        nb = 9000
        b = np.where(rng.random(nb) < 0.8, 255,
                     rng.integers(0, 256, nb)).astype(np.uint8)
        N = (nb + 4095) // 4096
        counts = lib.mask_hist(b, nb, N, 4096)
        freq, cum = entropy.host_normalize_np(counts, 257, 256)
        states, wc, words = lib.rans_encode_mask(b, nb, N, 4096, freq, cum)
        lut = lib.build_flat_lut(freq, cum, 257, 256)
        back = lib.rans_decode_mask(states, words, wc, lut, nb, N, 4096)
        return counts, states, wc, words, back

    def lanes(lib, rng):
        N, T = 12, 256
        sym = rng.integers(0, 94, N * T).astype(np.uint8)
        ctx = rng.integers(1, 20, N * T).astype(np.uint16)
        counts = np.bincount(ctx.astype(np.int64) * 94 + sym,
                             minlength=20 * 94)
        freq, cum = entropy.host_normalize_np(counts, 20, 94)
        return lib.rans_encode_lanes(sym, ctx, freq, cum, N, T, 94)

    def tail_check(lib, rng):
        mb = rng.integers(0, 256, (40, 16)).astype(np.uint8)
        lens = rng.integers(0, 129, 40)
        ok = mb & 0
        return (np.asarray(lib.mask_tail_check(mb, lens)),
                np.asarray(lib.mask_tail_check(ok, lens)))

    def rc_flip(lib, rng):
        seq = rng.integers(0, 4, (50, 96)).astype(np.uint8)
        lens = rng.integers(0, 97, 50)
        lib.rc_flip_rows(seq, lens, rng.random(50) < 0.5)
        return (seq,)

    def ints(lib, rng):
        return lib.render_ints_i64(rng.integers(0, 1 << 40, 300))

    def line_starts(lib, rng):
        buf = np.where(rng.random(4000) < 0.05, 10,
                       rng.integers(32, 127, 4000)).astype(np.uint8)
        return (lib.line_starts(buf),)

    def _quals(rng, B=64, L=96):
        walk = np.clip(np.cumsum(rng.integers(-2, 3, (B, L)), axis=1) + 38,
                       2, 80) + 33
        lengths = rng.integers(0, L + 1, B)
        perm = rng.permutation(B).astype(np.int64)
        qmap = np.minimum(np.arange(256) // 3 * 3, 255).astype(np.uint8)
        return walk.astype(np.uint8), lengths, perm, qmap

    def qual_grids(lib, rng):
        qual, lengths, perm, qmap = _quals(rng)
        out = []
        for order in (1, 2, 3):
            out += lib.qual_sym_ctx_hist(qual, lengths, 96, order,
                                         [761, 1401, 3041][order - 1])
            out.append(lib.qual_hist_one(qual, lengths, 96, order,
                                         [761, 1401, 3041][order - 1],
                                         perm, qmap))
        return (*out, *lib.qual_hist3(qual, lengths, 96, perm, qmap),
                lib.permute_rows_u8(qual, perm))

    def qual_codec(lib, rng):
        """The grid-free encode and both decodes, through the tables of
        the block's own histogram (order 2)."""
        qual, lengths, perm, qmap = _quals(rng)
        counts = lib.qual_hist_one(qual, lengths, 96, 2, 1401, perm, qmap)
        freq, cum = entropy.host_normalize_np(counts, 1401, 94)
        states, wc, words = lib.rans_encode_qual(qual, lengths[perm], freq,
                                                 cum, 384, 2, perm, qmap)
        back2 = lib.rans_decode_lanes2(states, words, wc, freq, cum,
                                       lengths[perm], 64, 96, 384, 2)
        back = lib.rans_decode_lanes(states, words, wc,
                                     entropy.build_decode_lut(freq, cum),
                                     lengths[perm], 64, 96, 384, 2)
        return states, wc, words, back2, back

    def host_core(lib, rng):
        """The host placements' chain: the core matcher and sort, the
        oriented rows, both delta matches."""
        B, L = 200, 96
        codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
        codes[:60] = codes[60:120]                   # shared cores
        lengths = rng.integers(20, L + 1, B).astype(np.int32)
        exc_pos = np.sort(rng.choice(B * L, 50, replace=False))
        ck, cp, rc, perm = lib.core_match_block(codes, lengths, exc_pos,
                                                190, 12, 0x5CA1CE)
        len_s = lengths[perm]
        rows = lib.gather_orient(codes, perm, rc[perm], len_s)
        bnd = np.ones(190, np.uint8)
        bnd[1:] = ck[perm][1:] != ck[perm][:-1]
        return (ck, cp, rc, perm, rows,
                *lib.delta_match_runs(rows, bnd, cp[perm], len_s, 4),
                *lib.delta_match(rows, ck[perm], cp[perm], len_s, 4))

    return {"ragged_gather_u8": ragged_gather,
            "core_match_block/gather_orient/delta_match_runs/delta_match":
            host_core,
            "ragged_scatter_u8": ragged_scatter,
            "bitpack_u32/bitunpack_u32": bitpack,
            "pack2bit/unpack2bit": pack2bit,
            "reconstruct_delta_checked": reconstruct,
            "host_normalize_tbl/build_flat_lut": normalize,
            "lit_hist/rans_encode_lits/rans_decode_lits": lits,
            "mask_hist/rans_encode_mask/rans_decode_mask": mask,
            "rans_encode_lanes": lanes, "mask_tail_check": tail_check,
            "rc_flip_rows": rc_flip, "render_ints_i64": ints,
            "line_starts": line_starts,
            "qual_sym_ctx_hist/qual_hist_one/qual_hist3/permute_rows_u8":
            qual_grids,
            "rans_encode_qual/rans_decode_lanes2/rans_decode_lanes":
            qual_codec}


@pytest.mark.parametrize("name", sorted(_native_cases()))
def test_native_function_matches_reference(name):
    case = _native_cases()[name]
    got = case(native, np.random.default_rng(21))
    want = case(ref_native, np.random.default_rng(21))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
