import jax.numpy as jnp
import numpy as np
import pytest

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.models import quality
from phyngsc_tpu.utils.bitio import BitReader, BitWriter

CFG = CodecConfig()
LUT_BITS = CFG.max_code_len


def roundtrip(qual, lens, G):
    R, L = qual.shape
    counts = quality.analyze(jnp.array(qual), jnp.array(lens))
    tables = quality.build_tables(np.asarray(counts), CFG)
    cap = R * L  # generous cap
    words, sub_n_words, total_words = quality.encode_device(
        jnp.array(qual), jnp.array(lens),
        jnp.array(tables.codes), jnp.array(tables.lens), G, cap,
    )
    # serialize header + words through the container path
    bw = BitWriter()
    quality.write_header(bw, tables, np.asarray(sub_n_words), int(total_words))
    bw.flush()
    tables2, sub_n_words2, total_words2 = quality.read_header(BitReader(bw.getvalue()))
    np.testing.assert_array_equal(tables2.lens, tables.lens)
    np.testing.assert_array_equal(sub_n_words2, np.asarray(sub_n_words))
    assert total_words2 == int(total_words)

    luts = tables2.luts(LUT_BITS)
    got = quality.decode_device(
        words[: int(total_words)], jnp.array(sub_n_words2), jnp.array(lens),
        jnp.array(luts), L, G, LUT_BITS,
    )
    return np.asarray(got)


def test_fixed_length_roundtrip():
    rng = np.random.default_rng(0)
    R, L, G = 64, 36, 8
    qual = rng.integers(33, 74, size=(R, L)).astype(np.uint8)
    lens = np.full(R, L, dtype=np.int32)
    got = roundtrip(qual, lens, G)
    np.testing.assert_array_equal(got, qual)


def test_variable_length_roundtrip():
    rng = np.random.default_rng(1)
    R, L, G = 48, 20, 8
    lens = rng.integers(1, L + 1, size=R).astype(np.int32)
    qual = rng.integers(33, 74, size=(R, L)).astype(np.uint8)
    qual[~np.asarray(quality.valid_mask(jnp.array(lens), L))] = 0
    got = roundtrip(qual, lens, G)
    np.testing.assert_array_equal(got, qual)


def test_ambiguity_extended_alphabet_roundtrip():
    # symbols >= 128 (transferred IUPAC codes) must survive
    rng = np.random.default_rng(2)
    R, L, G = 32, 12, 8
    qual = rng.integers(33, 74, size=(R, L)).astype(np.uint8)
    amb = rng.random((R, L)) < 0.1
    qual[amb] = rng.integers(128, 248, size=int(amb.sum())).astype(np.uint8)
    lens = np.full(R, L, dtype=np.int32)
    got = roundtrip(qual, lens, G)
    np.testing.assert_array_equal(got, qual)


def test_constant_quality_roundtrip():
    # single-symbol alphabet per position → 1-bit codes
    R, L, G = 16, 8, 8
    qual = np.full((R, L), ord("I"), dtype=np.uint8)
    lens = np.full(R, L, dtype=np.int32)
    got = roundtrip(qual, lens, G)
    np.testing.assert_array_equal(got, qual)


def test_long_read_tree_cap():
    # positions beyond MAX_TREES share the last tree
    rng = np.random.default_rng(3)
    R, G = 8, 8
    L = quality.MAX_TREES + 40
    qual = rng.integers(33, 43, size=(R, L)).astype(np.uint8)
    lens = np.full(R, L, dtype=np.int32)
    counts = quality.analyze(jnp.array(qual), jnp.array(lens))
    assert counts.shape[0] == quality.MAX_TREES
    got = roundtrip(qual, lens, G)
    np.testing.assert_array_equal(got, qual)


def test_compression_beats_raw():
    rng = np.random.default_rng(4)
    R, L, G = 256, 36, 8
    # skewed like real phred: mostly 'I'
    pool = np.array([ord("I")] * 30 + list(range(33, 55)), dtype=np.uint8)
    qual = pool[rng.integers(0, pool.shape[0], size=(R, L))]
    lens = np.full(R, L, dtype=np.int32)
    counts = quality.analyze(jnp.array(qual), jnp.array(lens))
    tables = quality.build_tables(np.asarray(counts), CFG)
    _, _, total_words = quality.encode_device(
        jnp.array(qual), jnp.array(lens),
        jnp.array(tables.codes), jnp.array(tables.lens), G, R * L,
    )
    assert int(total_words) * 4 < R * L * 0.6  # < 4.8 bits/symbol here


@pytest.mark.parametrize("Lt,R_real,G", [(7, 37, 8), (36, 120, 16),
                                          (12, 33, 4)])
def test_decode_device_impls_agree(Lt, R_real, G):
    """The XLA walk and the walk kernel (Pallas interpret mode) decode the
    same stream identically, including odd read lengths that leave slack
    in the length bucket and zero-length padding records."""
    from phyngsc_tpu import backend
    from phyngsc_tpu.utils.shapes import bucket_length

    rng = np.random.default_rng(11)
    L = bucket_length(Lt)
    Rp = ((R_real + G - 1) // G) * G
    qual = np.zeros((Rp, L), np.uint8)
    qual[:R_real, :Lt] = rng.integers(33, 60, size=(R_real, Lt))
    lens = np.concatenate([np.full(R_real, Lt, np.int32),
                           np.zeros(Rp - R_real, np.int32)])
    counts = np.asarray(quality.analyze(jnp.array(qual), jnp.array(lens)))
    tables = quality.build_tables(counts, CFG)
    cap = Rp * L // 2 + Rp // G + 8
    words, sub, _ = quality.encode_device(
        jnp.array(qual), jnp.array(lens),
        jnp.array(tables.codes), jnp.array(tables.lens), G, cap)
    for impl in (backend.XLA, backend.INTERPRET):
        got = quality.decode_device(
            jnp.asarray(words), jnp.asarray(sub), jnp.array(lens),
            jnp.array(tables.luts(LUT_BITS)), L, G, LUT_BITS, impl=impl)
        np.testing.assert_array_equal(np.asarray(got), qual, err_msg=impl)


def test_decode_device_base_offset():
    """A stream that starts `base` words into a larger buffer (the fused
    decode blob's layout) decodes like the bare stream."""
    rng = np.random.default_rng(12)
    R, L, G = 32, 20, 8
    lens = rng.integers(1, L + 1, size=R).astype(np.int32)
    qual = rng.integers(33, 74, size=(R, L)).astype(np.uint8)
    qual[~np.asarray(quality.valid_mask(jnp.array(lens), L))] = 0
    counts = quality.analyze(jnp.array(qual), jnp.array(lens))
    tables = quality.build_tables(np.asarray(counts), CFG)
    words, sub, total = quality.encode_device(
        jnp.array(qual), jnp.array(lens),
        jnp.array(tables.codes), jnp.array(tables.lens), G, R * L)
    prefix = rng.integers(0, 1 << 32, size=13, dtype=np.uint64)
    buf = np.concatenate([prefix.astype(np.uint32),
                          np.asarray(words)[: int(total)]])
    got = quality.decode_device(
        jnp.asarray(buf), sub, jnp.array(lens),
        jnp.array(tables.luts(LUT_BITS)), L, G, LUT_BITS,
        base=jnp.int32(13))
    np.testing.assert_array_equal(np.asarray(got), qual)


def test_tree_grouping_merges_identical_distributions():
    """Cost-gated tree grouping: positions with
    near-identical histograms collapse onto few stored tables (the v4
    proportional mapping needs no new container fields), and the stream
    round-trips."""
    rng = np.random.default_rng(3)
    L, R = 36, 4096
    # same skewed distribution at every position -> tables merge
    probs = np.linspace(0.2, 4.0, 41) ** 4
    probs /= probs.sum()
    counts = np.zeros((L, 256), np.int64)
    sym = rng.choice(np.arange(33, 74), size=(R, L), p=probs)
    for p in range(L):
        counts[p] = np.bincount(sym[:, p], minlength=256)
    tables, _ = quality.build_tables_adaptive(counts, CFG)
    assert tables.n_trees < L, "identical distributions did not merge"

    # strongly position-dependent distributions must NOT merge to 1
    counts2 = np.zeros((L, 256), np.int64)
    for p in range(L):
        lo = 33 + (p * 3) % 60
        counts2[p, lo : lo + 8] = 1000
    tables2, _ = quality.build_tables_adaptive(counts2, CFG)
    assert tables2.n_trees > 1, "distinct distributions over-merged"


def test_tree_grouping_roundtrip_end_to_end():
    """A transfer-free corpus (uniform per-position stats) engages grouping
    in the real pipeline and still round-trips byte-exactly."""
    from phyngsc_tpu.pipeline.compress import compress_bytes
    from phyngsc_tpu.pipeline.decompress import decompress_bytes
    from phyngsc_tpu.utils.fastq import synthesize_fastq

    seen = {}
    orig = quality.build_tables_adaptive

    def spy(c, cfg):
        t, k = orig(c, cfg)
        seen["n"] = t.n_trees
        return t, k

    quality.build_tables_adaptive = spy
    try:
        cfg = CodecConfig(subblock_input_bytes=1 << 30,
                          records_per_substream=16)
        data = synthesize_fastq(3000, read_len=36, seed=5,
                                ambiguity_rate=0.0)
        comp = compress_bytes(data, cfg, 1)
        assert decompress_bytes(comp, cfg) == data
    finally:
        quality.build_tables_adaptive = orig
    assert seen["n"] < 36, "grouping did not engage on uniform stats"
