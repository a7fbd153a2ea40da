import jax.numpy as jnp
import numpy as np
import pytest

from phyngsc_tpu.ops import huffman
from phyngsc_tpu.ops.bitpack import (
    bytes_to_words,
    extract_fixed_width,
    pack_bits_scatter,
    pack_lut,
    substream_layout,
    words_to_bytes,
)
from phyngsc_tpu.ops.walk import walk_slots_xla
from phyngsc_tpu.utils.bitio import BitWriter


def reference_pack(codes, lens, n_words):
    """Host BitWriter ground truth for the same code sequence."""
    w = BitWriter()
    for c, l in zip(codes, lens):
        w.put_bits(int(c), int(l))
    w.flush()
    words = bytes_to_words(w.getvalue())
    out = np.zeros(n_words, dtype=np.uint32)
    out[: len(words)] = words
    return out


def test_pack_matches_bitwriter():
    rng = np.random.default_rng(0)
    n = 1000
    lens = rng.integers(1, 17, size=n).astype(np.int32)
    codes = np.array([rng.integers(0, 1 << l) for l in lens], dtype=np.uint32)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    total_bits = int(lens.sum())
    n_words = (total_bits + 31) // 32
    got = pack_bits_scatter(jnp.array(codes), jnp.array(lens), jnp.array(offsets), n_words)
    want = reference_pack(codes, lens, n_words)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_pack_scatter_handles_zero_len_runs():
    # long runs of zero-length symbols (e.g. all-ambiguous DNA records)
    rng = np.random.default_rng(1)
    n = 500
    lens = rng.integers(1, 5, size=n).astype(np.int32)
    lens[100:200] = 0
    lens[490:] = 0
    codes = np.array([rng.integers(0, 1 << max(l, 1)) for l in lens], dtype=np.uint32)
    codes[lens == 0] = 0
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    n_words = (int(lens.sum()) + 31) // 32
    got = pack_bits_scatter(jnp.array(codes), jnp.array(lens), jnp.array(offsets), n_words)
    want = reference_pack(codes[lens > 0], lens[lens > 0], n_words)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_substream_layout_word_aligned():
    rng = np.random.default_rng(2)
    R, L, G = 32, 7, 8
    lens = rng.integers(0, 6, size=(R, L)).astype(np.int32)
    lay = substream_layout(jnp.array(lens), records_per_substream=G)
    offs = np.asarray(lay["bit_offsets"])
    sub_start = np.asarray(lay["sub_word_start"])
    sub_words = np.asarray(lay["sub_n_words"])
    S = R // G
    for s in range(S):
        # first symbol of each substream starts at a word boundary
        assert offs[s * G, 0] == sub_start[s] * 32
        bits = int(lens[s * G : (s + 1) * G].sum())
        assert sub_words[s] == (bits + 31) // 32
    # offsets advance exactly by lens in flat order within a substream
    flat_off = offs.reshape(S, -1)
    flat_len = lens.reshape(S, -1)
    for s in range(S):
        np.testing.assert_array_equal(
            flat_off[s, 1:], flat_off[s, :-1] + flat_len[s, :-1]
        )
    assert int(lay["total_words"]) == int(sub_words.sum())


def _make_codec(rng, L, alpha, max_len=12):
    """Per-position histograms → canonical tables (codes/lens/luts)."""
    freqs = rng.integers(1, 200, size=(L, alpha)).astype(np.int64)
    lens_tab = huffman.build_code_lengths_batch(freqs, max_len)
    codes_tab = huffman.canonical_codes(lens_tab)
    sym_t, len_t = huffman.decode_lut_batch(lens_tab, max_len)
    luts = np.asarray(pack_lut(jnp.array(sym_t), jnp.array(len_t)))
    return codes_tab, lens_tab, luts


def test_huffman_roundtrip_fixed_length():
    rng = np.random.default_rng(3)
    R, L, G, alpha = 64, 9, 8, 17
    codes_tab, lens_tab, luts = _make_codec(rng, L, alpha)
    data = rng.integers(0, alpha, size=(R, L))
    codes = codes_tab[np.arange(L)[None, :], data]
    lens = lens_tab[np.arange(L)[None, :], data].astype(np.int32)
    lay = substream_layout(jnp.array(lens), records_per_substream=G)
    n_words = int(lay["total_words"])
    words = pack_bits_scatter(jnp.array(codes), jnp.array(lens), lay["bit_offsets"], n_words)

    S = R // G
    n_steps = G * L
    step_tree = np.tile(np.arange(L, dtype=np.int32), G)
    mask = np.ones((n_steps, S), dtype=bool)
    out = walk_slots_xla(
        words, lay["sub_word_start"], jnp.array(luts),
        jnp.array(step_tree), jnp.array(mask), 12,
    )
    got = np.asarray(out).T.reshape(R, L)
    np.testing.assert_array_equal(got, data)


def test_huffman_roundtrip_variable_length():
    rng = np.random.default_rng(4)
    R, L, G, alpha = 48, 11, 8, 9
    rec_len = rng.integers(1, L + 1, size=R)
    pos_valid = np.arange(L)[None, :] < rec_len[:, None]
    codes_tab, lens_tab, luts = _make_codec(rng, L, alpha)
    data = rng.integers(0, alpha, size=(R, L))
    data[~pos_valid] = 0
    codes = np.where(pos_valid, codes_tab[np.arange(L)[None, :], data], 0)
    lens = np.where(pos_valid, lens_tab[np.arange(L)[None, :], data], 0).astype(np.int32)
    lay = substream_layout(jnp.array(lens), records_per_substream=G)
    n_words = int(lay["total_words"])
    words = pack_bits_scatter(jnp.array(codes), jnp.array(lens), lay["bit_offsets"], n_words)

    # slot t = g*L + p of substream s is record s*G+g at position p; it
    # consumes a code iff p < that record's length
    S = R // G
    n_steps = G * L
    step_tree = np.tile(np.arange(L, dtype=np.int32), G)
    mask = pos_valid.reshape(S, n_steps).T
    out = np.asarray(
        walk_slots_xla(
            words, lay["sub_word_start"], jnp.array(luts),
            jnp.array(step_tree), jnp.array(mask), 12,
        )
    )
    got = out.T.reshape(R, L)
    np.testing.assert_array_equal(got, data)


def test_extract_fixed_width_roundtrip():
    rng = np.random.default_rng(5)
    n = 300
    widths = rng.integers(0, 17, size=n).astype(np.int32)
    vals = np.array([rng.integers(0, 1 << w) if w else 0 for w in widths], dtype=np.uint32)
    offsets = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int32)
    n_words = (int(widths.sum()) + 31) // 32
    words = pack_bits_scatter(jnp.array(vals), jnp.array(widths), jnp.array(offsets), n_words)
    got = extract_fixed_width(words, jnp.array(offsets), jnp.array(widths), n)
    np.testing.assert_array_equal(np.asarray(got), vals)


def test_words_bytes_roundtrip():
    rng = np.random.default_rng(6)
    words = rng.integers(0, 1 << 32, size=17, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(bytes_to_words(words_to_bytes(words)), words)


# --- rows (sort-compaction) pack --------------------------------------------

def _rows_vs_scatter(lens2d, G, seed=0):
    """Build codes for the given per-element lens, pack both ways, compare."""
    from phyngsc_tpu.ops.bitpack import (pack_bits_rows, substream_layout_np,
                                         pack_bits_scatter_np, trim_rows_np)

    rng = np.random.default_rng(seed)
    lens2d = np.asarray(lens2d, np.int32)
    codes = (rng.integers(0, 1 << 31, size=lens2d.shape).astype(np.uint64)
             & ((1 << lens2d.astype(np.uint64)) - 1)).astype(np.uint32)
    codes[lens2d == 0] = 0
    plane, subw, total = pack_bits_rows(jnp.array(codes), jnp.array(lens2d), G)
    lay = substream_layout_np(lens2d, G)
    want = pack_bits_scatter_np(codes, lens2d, lay["bit_offsets"],
                                max(int(lay["total_words"]), 1))
    np.testing.assert_array_equal(np.asarray(subw), lay["sub_n_words"])
    assert int(total) == int(lay["total_words"])
    got = trim_rows_np(np.asarray(plane), np.asarray(subw))
    np.testing.assert_array_equal(got, want[: int(lay["total_words"])])


def test_pack_rows_random_mixed():
    rng = np.random.default_rng(3)
    lens = rng.integers(0, 33, size=(64, 9))
    _rows_vs_scatter(lens, G=8)


def test_pack_rows_exact_word_boundary():
    # substream bits end exactly on a word boundary (phantom-flag path)
    lens = np.full((8, 4), 8, np.int32)  # 32 bits/record, G=2 -> 64 bits/sub
    _rows_vs_scatter(lens, G=2)


def test_pack_rows_final_spill_word():
    # last element straddles into a final word no element starts in
    lens = np.array([[30, 30, 0, 0]], np.int32)  # 60 bits -> word 1 spill-only
    _rows_vs_scatter(lens, G=1)


def test_pack_rows_zero_runs_and_empty_substream():
    lens = np.zeros((16, 6), np.int32)
    lens[0:4] = [[5, 0, 0, 7, 1, 0]] * 4
    lens[8] = [32, 32, 32, 0, 32, 9]
    # substreams 3 (records 12..15) entirely empty
    _rows_vs_scatter(lens, G=4)


def test_pack_rows_32bit_elements():
    # every element exactly 32 bits: word index increments exactly 1
    lens = np.full((12, 3), 32, np.int32)
    _rows_vs_scatter(lens, G=4)


def test_pack_rows_single_element_substreams():
    lens = np.array([[1], [31], [32], [0], [17]], np.int32)
    _rows_vs_scatter(lens, G=1)


def test_compact_rows_dus_matches_sort():
    """The ascending-overwrite compaction equals the sort compaction on
    every valid word (slack past each total is unspecified in both)."""
    import jax.numpy as jnp

    from phyngsc_tpu.ops import bitpack

    rng = np.random.default_rng(77)
    for S, T in ((4, 16), (33, 64), (128, 40)):
        sub = rng.integers(0, T + 1, size=S).astype(np.int32)
        plane = rng.integers(0, 1 << 32, size=(S, T), dtype=np.uint64
                             ).astype(np.uint32)
        # valid prefix only: columns past sub[s] are garbage by contract
        total = int(sub.sum())
        cap = -(-max(total, 1) // 64) * 64
        a = np.asarray(bitpack.compact_rows_sort(
            jnp.asarray(plane), jnp.asarray(sub), cap))
        b = np.asarray(bitpack.compact_rows_dus(
            jnp.asarray(plane), jnp.asarray(sub), cap))
        np.testing.assert_array_equal(a[:total], b[:total])
