"""ops/lookup (the code-table gather), ops/walk (the decode walk: the Pallas
kernel in interpret mode and its XLA twin), the backend policy that picks
between them, and ops/histogram."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from phyngsc_tpu import backend
from phyngsc_tpu.ops import lookup, walk


def _reference(sym: np.ndarray, tab: np.ndarray) -> np.ndarray:
    return tab[np.arange(sym.shape[1])[None, :], sym]


@pytest.mark.parametrize("R,L", [(100, 4), (256, 36), (300, 40),
                                 (128, 80), (64, 128)])
def test_fused_lookup_matches_take(R, L):
    rng = np.random.default_rng(R * 1000 + L)
    # full 16-bit fused-entry range: (len << 12) | code with len <= 12
    tab = ((rng.integers(0, 13, size=(L, 256)) << lookup.CODE_BITS)
           | rng.integers(0, 1 << lookup.CODE_BITS, size=(L, 256))
           ).astype(np.int32)
    sym = rng.integers(0, 256, size=(R, L)).astype(np.uint8)
    got = np.asarray(lookup.fused_lookup(jnp.asarray(sym), jnp.asarray(tab)))
    want = np.stack([np.take(tab[p], sym[:, p]) for p in range(L)], axis=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("A", [64, 128])
def test_fused_lookup_narrow_tables(A):
    # alphabet-window slicing (lookup.window_np): tables with A < 256
    # columns, symbols pre-clipped to [0, A) by the caller
    rng = np.random.default_rng(A)
    R, L = 300, 36
    tab = rng.integers(0, 1 << 16, size=(L, A)).astype(np.int32)
    sym = rng.integers(0, A, size=(R, L)).astype(np.uint8)
    got = np.asarray(lookup.fused_lookup(jnp.asarray(sym), jnp.asarray(tab)))
    np.testing.assert_array_equal(got, _reference(sym, tab))


def test_window_np():
    counts = np.zeros((3, 256), np.int64)
    counts[0, 33] = 5
    counts[2, 96] = 1
    off, A = lookup.window_np(counts)
    assert (off, A) == (33, 64)
    counts[1, 200] = 2
    off, A = lookup.window_np(counts)
    assert (off, A) == (0, 256)  # width 168 → full-table bucket, off pinned 0
    assert lookup.window_np(np.zeros((1, 256), np.int64)) == (0, 64)
    # window near the top of the byte range shifts off down to fit
    hi = np.zeros((1, 256), np.int64)
    hi[0, 250] = 1
    off, A = lookup.window_np(hi)
    assert off + A <= 256 and off <= 250 < off + A


def test_encode_device_windowed_matches_full():
    # quality encode with sliced tables + off == full-width encode
    from phyngsc_tpu.models import quality
    from phyngsc_tpu.config import CodecConfig

    rng = np.random.default_rng(11)
    R, L = 256, 36
    qual = (rng.integers(33, 74, size=(R, L))).astype(np.uint8)
    lens = np.full(R, L, np.int32)
    counts = quality.analyze(jnp.asarray(qual), jnp.asarray(lens))
    tabs, group = quality.build_tables_adaptive(np.asarray(counts),
                                                CodecConfig())
    off, A = lookup.window_np(np.asarray(counts))
    assert A < 256
    full = quality.encode_device(
        jnp.asarray(qual), jnp.asarray(lens), jnp.asarray(tabs.codes),
        jnp.asarray(tabs.lens), 64, 4096, group)
    win = quality.encode_device(
        jnp.asarray(qual), jnp.asarray(lens),
        jnp.asarray(np.ascontiguousarray(tabs.codes[:, off:off + A])),
        jnp.asarray(np.ascontiguousarray(tabs.lens[:, off:off + A])),
        64, 4096, group, off=np.int32(off))
    for a, b in zip(full, win):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fused_lookup_long_reads():
    # 1000 bp rows: one table row per position
    rng = np.random.default_rng(7)
    L = 1000
    tab = rng.integers(0, 1 << 16, size=(L, 256)).astype(np.int32)
    sym = rng.integers(0, 256, size=(33, L)).astype(np.uint8)
    got = np.asarray(lookup.fused_lookup(jnp.asarray(sym), jnp.asarray(tab)))
    np.testing.assert_array_equal(got, _reference(sym, tab))


# ---------------------------------------------------------------------------
# the slot walk (ops/walk.py): Pallas kernel in interpret mode + XLA twin
# ---------------------------------------------------------------------------

from phyngsc_tpu.ops import bitpack, huffman
from phyngsc_tpu.utils.bitio import BitWriter

IMPLS = [backend.INTERPRET, backend.XLA]


def _random_tables(rng, n_trees, alphabet, max_len):
    counts = rng.integers(1, 1000, size=(n_trees, alphabet))
    lens = huffman.build_code_lengths_batch(counts, max_len)
    codes = np.asarray(huffman.canonical_codes(lens))
    luts = []
    for t in range(n_trees):
        sym, ln = huffman.decode_lut(lens[t], max_len, -1)
        luts.append((ln.astype(np.int32) << 9) | sym.astype(np.int32))
    return lens, codes, np.stack(luts)


def _pack_slots(codes, lens, tree, mask, syms):
    """Host-pack each lane's consumed slots (word-aligned substreams) →
    (linear words, sub_word_start)."""
    parts, sub = [], []
    for s in range(mask.shape[1]):
        bw = BitWriter()
        for t in np.flatnonzero(mask[:, s]):
            bw.put_bits(int(codes[tree[t], syms[t, s]]),
                        int(lens[tree[t], syms[t, s]]))
        bw.flush()
        w = bitpack.bytes_to_words(bw.getvalue())
        parts.append(w)
        sub.append(w.shape[0])
    words = np.concatenate(parts) if parts else np.zeros(0, np.uint32)
    start = np.concatenate([[0], np.cumsum(sub)[:-1]]).astype(np.int32)
    return (words if words.size else np.zeros(1, np.uint32)), start


def _walk_all(words, start, luts, tree, mask, lut_bits):
    """Every implementation's output (they must agree)."""
    return [np.asarray(walk.walk_slots(
        jnp.asarray(words), jnp.asarray(start), jnp.asarray(luts),
        jnp.asarray(tree), jnp.asarray(mask), lut_bits, impl))
        for impl in IMPLS]


@pytest.mark.parametrize("S,T,n_trees,max_len", [
    (130, 70, 3, 8),      # lane padding + multi-tree + 8-bit windows
    (256, 130, 5, 12),    # many steps, 12-bit windows
    (32, 128, 1, 6),      # one kernel program, shared single tree
])
def test_pallas_walk_matches_py_walk(S, T, n_trees, max_len):
    rng = np.random.default_rng(S + T)
    alphabet = 50
    lens, codes, luts = _random_tables(rng, n_trees, alphabet, max_len)
    tree = rng.integers(0, n_trees, size=T).astype(np.int32)
    totals = rng.integers(0, T + 1, size=S)
    mask = np.arange(T)[:, None] < totals[None, :]     # contiguous validity
    syms = rng.integers(0, alphabet, size=(T, S))
    words, start = _pack_slots(codes, lens, tree, mask, syms)

    # reference: the host walk over the same streams
    ref = bitpack._unpack_substreams_py(
        words, start, luts, np.broadcast_to(tree, (S, T)), mask.T, T,
        max_len).T
    for got in _walk_all(words, start, luts, tree, mask, max_len):
        np.testing.assert_array_equal(got, np.where(mask, ref, 0))
        np.testing.assert_array_equal(got, np.where(mask, syms, 0))


def test_pallas_walk_shared_luts():
    """One table for every slot (the DNA stream) under a scattered slot
    mask: unset slots emit 0 and do not advance the lane."""
    rng = np.random.default_rng(99)
    lens, codes, luts = _random_tables(rng, 1, 30, 8)
    S, T = 140, 64
    tree = np.zeros(T, np.int32)
    mask = rng.random((T, S)) < 0.6
    syms = rng.integers(0, 30, size=(T, S))
    words, start = _pack_slots(codes, lens, tree, mask, syms)
    for got in _walk_all(words, start, luts, tree, mask, 8):
        np.testing.assert_array_equal(got, np.where(mask, syms, 0))


@pytest.mark.parametrize("impl", IMPLS)
def test_walk_dead_lanes(impl):
    """Lanes with no slot set (bucket padding) own no words: they never
    advance and emit zeros, and live neighbours still decode exactly —
    also when the dead lanes' start points past the last word."""
    rng = np.random.default_rng(7)
    lens, codes, luts = _random_tables(rng, 2, 20, 10)
    S, T = 70, 40
    tree = (np.arange(T) % 2).astype(np.int32)
    mask = np.ones((T, S), bool)
    dead = np.array([0, 5, 6, 31, 32, 69])
    mask[:, dead] = False
    syms = rng.integers(0, 20, size=(T, S))
    words, start = _pack_slots(codes, lens, tree, mask, syms)
    start[dead] = words.shape[0] + 7
    got = np.asarray(walk.walk_slots(
        jnp.asarray(words), jnp.asarray(start), jnp.asarray(luts),
        jnp.asarray(tree), jnp.asarray(mask), 10, impl))
    np.testing.assert_array_equal(got, np.where(mask, syms, 0))
    assert not got[:, dead].any()


@pytest.mark.parametrize("impl", IMPLS)
def test_walk_window_shift_edges(impl):
    """1-bit codes put the cursor at every bit offset 0..31 of a word,
    including offset 0, where the second window word must not leak in (a
    32-bit shift is undefined on the GPU, so the kernel clamps it); words
    of all ones make any leak visible."""
    lens = np.zeros((1, 2), np.uint8)
    lens[0] = [1, 1]
    codes = np.asarray(huffman.canonical_codes(lens))
    sym, ln = huffman.decode_lut(lens[0], 12, -1)
    luts = ((ln.astype(np.int32) << 9) | sym.astype(np.int32))[None]
    T, S = 130, 33
    tree = np.zeros(T, np.int32)
    mask = np.ones((T, S), bool)
    syms = np.ones((T, S), np.int64)
    syms[::7] = 0
    words, start = _pack_slots(codes, lens, tree, mask, syms)
    got = np.asarray(walk.walk_slots(
        jnp.asarray(words), jnp.asarray(start), jnp.asarray(luts),
        jnp.asarray(tree), jnp.asarray(mask), 12, impl))
    np.testing.assert_array_equal(got, syms)


def _roundtrip(data, cfg):
    from phyngsc_tpu.pipeline.compress import compress_bytes
    from phyngsc_tpu.pipeline.decompress import decompress_bytes

    blob = compress_bytes(data, cfg)
    assert decompress_bytes(blob, cfg) == data


def test_pallas_walk_full_roundtrip(monkeypatch):
    """Full container round trip with the walk kernel forced on (interpret
    mode on the CPU) — exercises the parse gating, the fused blob layout,
    and the quality and plain-DNA decodes of the walk graph."""
    monkeypatch.setenv("PHYNGSC_WALK", "kernel")
    from phyngsc_tpu.config import CodecConfig
    from phyngsc_tpu.utils.fastq import synthesize_fastq

    _roundtrip(synthesize_fastq(600, read_len=36, seed=11,
                                ambiguity_rate=0.01),
               CodecConfig(records_per_substream=4))


def test_pallas_walk_huffman_dna_roundtrip(monkeypatch):
    """DNA stays Huffman-coded when IUPAC symbols can't transfer (quality
    outside [33,40]) — exercises dna.decode_huffman under the kernel."""
    monkeypatch.setenv("PHYNGSC_WALK", "kernel")
    from phyngsc_tpu.config import CodecConfig

    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(600):
        seq = acgt[rng.integers(0, 4, size=36)].copy()
        seq[rng.integers(0, 36)] = ord("N")  # high quality → no transfer
        qual = np.full(36, ord("I"), np.uint8)
        recs.append(b"@r%d\n" % i + seq.tobytes() + b"\n+\n"
                    + qual.tobytes() + b"\n")
    _roundtrip(b"".join(recs), CodecConfig(records_per_substream=4))


def test_pallas_walk_variable_length_roundtrip(monkeypatch):
    """Variable-length records under the kernel: the slot mask from the
    per-record lengths + packed lens in the fused blob."""
    monkeypatch.setenv("PHYNGSC_WALK", "kernel")
    from phyngsc_tpu.config import CodecConfig

    rng = np.random.default_rng(17)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(500):
        n = int(rng.integers(20, 48))
        seq = acgt[rng.integers(0, 4, size=n)]
        qual = (rng.integers(33, 73, size=n)).astype(np.uint8)
        recs.append(b"@v%d\n" % i + seq.tobytes() + b"\n+\n"
                    + qual.tobytes() + b"\n")
    _roundtrip(b"".join(recs), CodecConfig(records_per_substream=4))


def test_pallas_walk_delta_roundtrip(monkeypatch):
    """SOLiD color-space reads under the kernel (is_delta path: raw planes
    fetch, no packed-alphabet output)."""
    monkeypatch.setenv("PHYNGSC_WALK", "kernel")
    from phyngsc_tpu.config import CodecConfig

    rng = np.random.default_rng(23)
    digits = np.frombuffer(b"0123", np.uint8)
    recs = []
    for i in range(400):
        colors = digits[rng.integers(0, 4, size=35)]
        seq = b"T" + colors.tobytes()
        qual = (rng.integers(33, 70, size=36)).astype(np.uint8)
        recs.append(b"@s%d\n" % i + seq + b"\n+\n" + qual.tobytes() + b"\n")
    _roundtrip(b"".join(recs), CodecConfig(records_per_substream=4))


def test_pallas_walk_long_reads_any_substream_width(monkeypatch):
    """1002 bp reads at G=3: the step count G*L has no relation to any tile
    size (a tiled walk would need the tile to divide G*L)."""
    monkeypatch.setenv("PHYNGSC_WALK", "kernel")
    from phyngsc_tpu.config import CodecConfig

    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(20):
        seq = acgt[rng.integers(0, 4, size=1002)]
        qual = rng.integers(35, 71, size=1002).astype(np.uint8)
        recs.append(b"@k%d\n" % i + seq.tobytes() + b"\n+\n"
                    + qual.tobytes() + b"\n")
    _roundtrip(b"".join(recs),
               CodecConfig(records_per_substream=3, auto_substream=False,
                           subblock_input_bytes=1 << 30))


def test_shard_words_np_splits_streams_per_shard():
    """Mesh decode rows: shard k's quality words, then its DNA words."""
    from phyngsc_tpu.config import CodecConfig
    from phyngsc_tpu.parallel.mesh import ShardedSubblockCodec, make_mesh

    codec = ShardedSubblockCodec(make_mesh(4, 1), CodecConfig(data_shards=4))
    q_sub = np.array([2, 1, 0, 3, 1, 1, 2, 2], np.int32)
    d_sub = np.array([1, 0, 1, 1, 0, 0, 2, 1], np.int32)
    q = np.arange(100, 100 + q_sub.sum(), dtype=np.uint32)
    d = np.arange(200, 200 + d_sub.sum(), dtype=np.uint32)
    rows = codec.shard_words_np(q, q_sub, d, d_sub)
    assert rows.shape == (4, 7)
    np.testing.assert_array_equal(rows[0, :4], [100, 101, 102, 200])
    np.testing.assert_array_equal(rows[1, :5], [103, 104, 105, 201, 202])
    np.testing.assert_array_equal(rows[2, :2], [106, 107])
    np.testing.assert_array_equal(rows[3], [108, 109, 110, 111, 203, 204, 205])
    assert not rows[2, 2:].any()
    assert codec.can_decode(8, 8 * 16, 16)
    assert not codec.can_decode(6, 6 * 16, 16)


# ---------------------------------------------------------------------------
# backend policy (backend.walk_impl)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,env,want", [
    ("gpu", None, backend.KERNEL),
    ("gpu", "kernel", backend.KERNEL),
    ("gpu", "xla", backend.XLA),
    ("cpu", None, backend.XLA),
    ("cpu", "kernel", backend.INTERPRET),
    ("cpu", "xla", backend.XLA),
])
def test_walk_policy(monkeypatch, name, env, want):
    """The GPU runs the compiled kernel (never interpret mode); the CPU runs
    the XLA walk unless a test forces the kernel, which then interprets."""
    if env is None:
        monkeypatch.delenv("PHYNGSC_WALK", raising=False)
    else:
        monkeypatch.setenv("PHYNGSC_WALK", env)
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    assert backend.walk_impl() == want


def test_walk_policy_rejects_unknown_backend(monkeypatch):
    monkeypatch.delenv("PHYNGSC_WALK", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        backend.walk_impl()


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """$JAX_COMPILATION_CACHE_DIR wins; otherwise <checkout>/.jax_cache."""
    import os

    before = jax.config.jax_compilation_cache_dir
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache")
    try:
        assert backend.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("pid,per_host,want", [
    (0, 1, None), (5, 1, None), (5, 4, [1]), (3, 4, [3])])
def test_distributed_local_device_ids(pid, per_host, want):
    """Several processes on one host each open only their own GPU."""
    from phyngsc_tpu.parallel.distributed import local_device_ids

    assert local_device_ids(pid, per_host) == want


def test_walk_policy_rejects_unknown_setting(monkeypatch):
    monkeypatch.setenv("PHYNGSC_WALK", "pallas")
    with pytest.raises(ValueError, match="PHYNGSC_WALK"):
        backend.walk_impl("gpu")


def test_luts_from_lens_device_matches_batch():
    """luts_from_lens_device (the 4-bit wire form's device rebuild) is
    bit-identical to huffman.decode_lut_batch for normal, singleton, and
    empty trees, at both 8- and 12-bit LUT widths."""
    rng = np.random.default_rng(53)
    for bits in (8, 12):
        lens_rows, sing_rows = [], []
        for k in range(12):
            f = np.zeros(256, np.int64)
            n = int(rng.integers(0, 80))
            if k == 0:
                pass                      # empty tree
            elif k == 1:
                f[int(rng.integers(0, 256))] = 5   # singleton
            else:
                idx = rng.choice(256, size=max(n, 2), replace=False)
                f[idx] = np.maximum(rng.zipf(1.5, size=max(n, 2)), 1)
            lens_rows.append(huffman.build_code_lengths(f, bits))
            sing_rows.append(huffman.singleton_of(f))
        lens = np.stack(lens_rows)
        sing = np.array(sing_rows, np.int32)
        sym, ln = huffman.decode_lut_batch(lens, bits, sing)
        planes = ((ln.astype(np.int32) << 9) | sym.astype(np.int32))
        wire = bitpack.pack_lens4_np(lens, sing)
        T = lens.shape[0]
        got = np.asarray(bitpack.luts_from_lens_device(
            jnp.asarray(wire[: T * 32]), jnp.asarray(wire[T * 32 :]),
            T, 1 << bits))
        np.testing.assert_array_equal(got, planes)


def test_canonical_codes_batch_matches_prefix_property():
    """Vectorized canonical_codes: prefix-free, ordered by (len, sym), and
    identical across 1-D and batched calls."""
    rng = np.random.default_rng(59)
    rows = []
    for _ in range(8):
        f = np.zeros(256, np.int64)
        idx = rng.choice(256, size=40, replace=False)
        f[idx] = np.maximum(rng.zipf(1.4, size=40), 1)
        rows.append(huffman.build_code_lengths(f, 12))
    lens = np.stack(rows)
    codes = huffman.canonical_codes(lens)
    for t in range(lens.shape[0]):
        np.testing.assert_array_equal(codes[t],
                                      huffman.canonical_codes(lens[t]))
        present = np.flatnonzero(lens[t])
        # left-aligned codes strictly increase in (len, sym) order and
        # consecutive codes of one length differ by 1
        order = sorted(present, key=lambda s: (lens[t][s], s))
        la = [int(codes[t][s]) << (16 - int(lens[t][s])) for s in order]
        assert all(a < b for a, b in zip(la, la[1:]))
        kraft = sum(1 << (12 - int(lens[t][s])) for s in present)
        assert kraft == 1 << 12


@pytest.mark.parametrize("R,L,A", [(100, 7, 256), (1030, 36, 256),
                                   (64, 5, 128), (40, 1000, 256)])
def test_position_histogram_matches_add_at(R, L, A):
    from phyngsc_tpu.ops import histogram
    rng = np.random.default_rng(R + L)
    sym = rng.integers(0, A, size=(R, L)).astype(np.uint8)
    valid = rng.random((R, L)) < 0.8
    got = np.asarray(histogram.position_histogram(
        jnp.asarray(sym), jnp.asarray(valid), A))
    ref = np.zeros((L, A), np.int32)
    for p in range(L):
        np.add.at(ref[p], sym[valid[:, p], p], 1)
    np.testing.assert_array_equal(got, ref)
