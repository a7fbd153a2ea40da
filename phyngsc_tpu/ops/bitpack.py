"""Device bit packing and unpacking: the replacement for BitStream.

The reference emits variable-length codes one at a time through a 32-bit word
buffer (`BitStream::PutBits`, bit_stream.h:149-169) — inherently serial, and
its decode bit-walks a tree per symbol (huffman.h:189-213). Here both
directions are data-parallel:

Encode (`pack_bits_*`): every symbol i owns the bit span
[offset_i, offset_i + len_i) of the output, with offsets computed by exclusive
prefix sum. A symbol's bits land in at most two consecutive uint32 words
(len <= 16 < 32), so packing is either
  - 'scatter': two scatter-adds with sorted indices (disjoint spans make
    add == or), or
  - 'rows'   : a per-substream cumsum/sort compaction into a row plane.
Both are pure jnp, fully vectorized, jit-compatible, identical streams.

Decode: entropy decode is sequential *per stream*, so the format cuts each
stream into many independent substreams (contiguous record ranges,
word-aligned starts; offsets stored in the stream header). Decode then
vectorizes across substreams — each lane walks one substream via a packed
LUT (sym|len in one int32 → one gather per step). The device walk is
ops/walk.py; `unpack_substreams_np` is its host twin and reference.

Bit order is MSB-first within words and words are in-order, so the byte image
equals the host BitWriter's layout for the same bit sequence (words serialized
big-endian).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

WORD_BITS = 32

def pack_lut(sym: jnp.ndarray, length: jnp.ndarray) -> jnp.ndarray:
    """Pack decode-LUT (sym, len) pairs into one int32: (len << 9) | sym."""
    return (length.astype(jnp.int32) << 9) | sym.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Layout: symbol bit offsets with word-aligned substream starts
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("records_per_substream",))
def substream_layout(lens2d: jnp.ndarray, records_per_substream: int):
    """Compute bit offsets for (R, L) per-symbol code lengths.

    Records are grouped into substreams of `records_per_substream` consecutive
    records (R must be a multiple; pad with zero-length records). Each
    substream's bits start at a fresh word boundary so substreams decode
    independently.

    Returns dict with:
      bit_offsets (R, L) int32 — absolute bit position of each symbol
      sub_n_words (S,) int32  — words used by each substream
      sub_word_start (S,) int32 — exclusive prefix sum of sub_n_words
      total_words () int32
    """
    R, L = lens2d.shape
    G = records_per_substream
    assert R % G == 0, "pad R to a multiple of records_per_substream"
    S = R // G
    lens = lens2d.astype(jnp.int32)
    rec_bits = jnp.sum(lens, axis=1)                      # (R,)
    sub_bits = jnp.sum(rec_bits.reshape(S, G), axis=1)    # (S,)
    sub_n_words = (sub_bits + WORD_BITS - 1) // WORD_BITS
    sub_word_start = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(sub_n_words)[:-1].astype(jnp.int32)]
    )
    # within-substream exclusive cumsum over the (G*L,) flattened lens
    flat = lens.reshape(S, G * L)
    within = jnp.cumsum(flat, axis=1) - flat              # exclusive
    bit_offsets = (within + (sub_word_start * WORD_BITS)[:, None]).reshape(R, L)
    total_words = sub_word_start[-1] + sub_n_words[-1] if S > 0 else jnp.int32(0)
    return {
        "bit_offsets": bit_offsets.astype(jnp.int32),
        "sub_n_words": sub_n_words.astype(jnp.int32),
        "sub_word_start": sub_word_start.astype(jnp.int32),
        "total_words": total_words.astype(jnp.int32),
    }


def word_starts(sub_n_words: jnp.ndarray, base=None) -> jnp.ndarray:
    """First word of each substream: the exclusive prefix sum of the stored
    per-substream word counts, plus an optional (traced) offset `base` of
    the stream inside a larger buffer."""
    n = sub_n_words.astype(jnp.int32)
    start = jnp.cumsum(n) - n
    return start if base is None else start + base


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _split_two_words(codes, lens, bit_in_word):
    """Split each code into (hi, lo) contributions for words (w, w+1).

    bit_in_word = offset & 31 (0 == MSB). Shift amounts stay in [0, 31];
    len == 0 contributes nothing.
    """
    codes = codes.astype(jnp.uint32)
    lens = lens.astype(jnp.int32)
    r = WORD_BITS - bit_in_word  # bits available in the first word, in [1, 32]
    fits = lens <= r
    sh_hi_l = jnp.clip(r - lens, 0, 31)       # left shift when it fits
    sh_hi_r = jnp.clip(lens - r, 0, 31)       # right shift when it spills
    hi = jnp.where(fits, codes << sh_hi_l.astype(jnp.uint32),
                   codes >> sh_hi_r.astype(jnp.uint32))
    sh_lo = jnp.clip(WORD_BITS - (lens - r), 1, 31).astype(jnp.uint32)
    lo = jnp.where(fits, jnp.uint32(0), codes << sh_lo)
    zero = lens == 0
    return jnp.where(zero, 0, hi), jnp.where(zero, 0, lo)


@functools.partial(jax.jit, static_argnames=("n_words",))
def pack_bits_scatter(codes: jnp.ndarray, lens: jnp.ndarray,
                      bit_offsets: jnp.ndarray, n_words: int) -> jnp.ndarray:
    """Scatter-mode bitpack: (N,) codes/lens/offsets -> (n_words,) uint32."""
    codes = codes.reshape(-1)
    lens = lens.reshape(-1)
    bit_offsets = bit_offsets.reshape(-1)
    w = (bit_offsets // WORD_BITS).astype(jnp.int32)
    b = (bit_offsets % WORD_BITS).astype(jnp.int32)
    hi, lo = _split_two_words(codes, lens, b)
    # zero-length elements (padding) can sit exactly at the buffer end
    # (w == n_words when the cap is an exact fit); clamping — rather than
    # redirecting to 0 — keeps the index sequence monotone, which
    # indices_are_sorted promises. For len>0, offset+len <= 32*n_words by
    # construction, so w < n_words and w+1 <= n_words — both scatters are
    # provably in bounds and the per-element bounds check can be skipped.
    w = jnp.minimum(w, n_words - 1)
    words = jnp.zeros((n_words + 1,), jnp.uint32)
    # disjoint bit spans → add == or; indices are monotonically non-decreasing
    words = words.at[w].add(hi, mode="promise_in_bounds", indices_are_sorted=True)
    words = words.at[w + 1].add(lo, mode="promise_in_bounds", indices_are_sorted=True)
    return words[:n_words]


def pack_mode() -> str:
    """The bitpack kernel, by PHYNGSC_PACK (default "scatter"):

    - "scatter": two sorted scatter-adds into the exact-cap linear buffer.
    - "rows": sort-compaction pack. Output is a padded (S, T) row plane the
      host trims.
    - "rows_compact": rows + one on-device global sort compacting the plane
      into the exact-cap linear buffer (fewest device->host bytes).

    All three produce identical streams.
    """
    mode = os.environ.get("PHYNGSC_PACK", "scatter")
    if mode not in ("rows", "rows_compact", "scatter"):
        raise ValueError(f"PHYNGSC_PACK={mode!r}: expected rows, "
                         "rows_compact or scatter")
    return mode


@functools.partial(jax.jit, static_argnames=("records_per_substream",))
def pack_bits_rows(codes: jnp.ndarray, lens: jnp.ndarray,
                   records_per_substream: int):
    """Scatter-free bitpack into a per-substream row plane.

    (R, Lg) grouped codes/lens (every element <= 32 bits) → (S, T) uint32
    plane where row s holds substream s's packed words (columns past
    sub_n_words[s] are garbage; the host trims and concatenates rows into
    the dense stream — byte-identical to pack_bits_scatter's output for the
    same substream_layout).

    Within a substream, word indices (bit_offset >> 5) are non-decreasing
    with increments in {0, 1}, so each output word is a *contiguous run* of
    per-element word contributions, and a contiguous-run sum equals a
    difference of wrapping uint32 cumsums at the run ends (disjoint bit
    spans make add == or, and mod-2^32 differences are exact). Run-end
    cumsum values are compacted to dense word rows by one sort per lane on
    unique keys — no scatter and no gather.

    Returns (plane (S, T) uint32, sub_n_words (S,) int32, total_words).
    """
    R, Lg = codes.shape
    G = records_per_substream
    assert R % G == 0, "pad R to a multiple of records_per_substream"
    S = R // G
    T = G * Lg
    c = codes.reshape(S, T).astype(jnp.uint32)
    l = lens.reshape(S, T).astype(jnp.int32)
    csum = jnp.cumsum(l, axis=1)
    off = csum - l                                   # exclusive, within-lane
    wmat = off >> 5
    hi, lo = _split_two_words(c, l, off & 31)
    chi = jnp.cumsum(hi, axis=1)                     # wrapping uint32
    clo = jnp.cumsum(lo, axis=1)
    t_iota = jnp.arange(T, dtype=jnp.int32)[None, :]
    wnext = jnp.concatenate(
        [wmat[:, 1:], jnp.full((S, 1), T + 1, jnp.int32)], axis=1)
    # run-end steps, keyed by step index (unique per lane) so the sort is
    # deterministic without stability; non-ends pushed past column T-1
    key = jnp.where(wnext != wmat, t_iota, T + t_iota)
    _, A, B = jax.lax.sort((key, chi, clo), dimension=1, num_keys=1)
    A_p = jnp.pad(A, ((0, 0), (1, 0)))[:, :-1]
    B_p = jnp.pad(B, ((0, 0), (1, 0)))[:, :-1]
    B_p2 = jnp.pad(B, ((0, 0), (2, 0)))[:, :-2]
    # word w = hi-run (A[w] - A[w-1]) + spill-run (B[w-1] - B[w-2]). Rows of
    # A/B past the last *starter* word hold non-end garbage; the one word
    # that can lack a starter is a final spill-only word, where the value is
    # the spill part alone (its B rows are still valid).
    last_w = wmat[:, -1][:, None]
    words = jnp.where(t_iota <= last_w, (A - A_p) + (B_p - B_p2), B_p - B_p2)
    sub_n_words = ((csum[:, -1] + 31) // 32).astype(jnp.int32)
    total = jnp.sum(sub_n_words)
    return words.astype(jnp.uint32), sub_n_words, total


#: rows-plane compaction strategy, resolved once at import (it is traced
#: inside the fused encode graph): "sort" (default) — one global sort;
#: "dus" — ascending per-lane dynamic-update-slice overwrite. Both produce
#: identical valid words; [total, cap) is unspecified slack either way.
COMPACT = os.environ.get("PHYNGSC_COMPACT", "sort")


def compact_rows(plane: jnp.ndarray, sub_n_words: jnp.ndarray,
                 n_words_cap: int) -> jnp.ndarray:
    """Device compaction of a pack_bits_rows plane to the dense linear
    stream (strategy-selected, see COMPACT). Words in [total_words,
    n_words_cap) are cap slack, as in pack_bits_scatter; callers trim with
    the returned totals."""
    if COMPACT == "sort":
        return compact_rows_sort(plane, sub_n_words, n_words_cap)
    return compact_rows_dus(plane, sub_n_words, n_words_cap)


@functools.partial(jax.jit, static_argnames=("n_words_cap",))
def compact_rows_sort(plane: jnp.ndarray, sub_n_words: jnp.ndarray,
                      n_words_cap: int) -> jnp.ndarray:
    """Sort-based compaction: one global sort on unique word-index keys
    (invalid slots pushed past the end)."""
    S, T = plane.shape
    sub = sub_n_words.astype(jnp.int32)
    start = (jnp.cumsum(sub) - sub)[:, None]
    col = jnp.arange(T, dtype=jnp.int32)[None, :]
    key = jnp.where(col < sub[:, None], start + col, jnp.int32(0x7FFFFFFF))
    _, v = jax.lax.sort((key.reshape(-1), plane.reshape(-1)),
                        dimension=0, num_keys=1)
    if v.shape[0] < n_words_cap:
        # a bucketed cap can exceed the plane on small sub-blocks; the slack
        # is trimmed by the caller either way
        return jnp.pad(v, (0, n_words_cap - v.shape[0]))
    return v[:n_words_cap]


@functools.partial(jax.jit, static_argnames=("n_words_cap",))
def compact_rows_dus(plane: jnp.ndarray, sub_n_words: jnp.ndarray,
                     n_words_cap: int) -> jnp.ndarray:
    """Sort-free compaction: write each lane's T-word row at its exclusive
    prefix start in ASCENDING lane order — lane s's garbage tail (columns
    past sub[s]) lands exactly where lanes s+1.. write next, so the final
    buffer's valid region equals the sorted compaction's. The last lane's tail spills into dedicated scratch past the cap."""
    S, T = plane.shape
    sub = sub_n_words.astype(jnp.int32)
    start = jnp.cumsum(sub) - sub

    def body(s, b):
        row = jax.lax.dynamic_slice(plane, (s, 0), (1, T)).reshape(T)
        return jax.lax.dynamic_update_slice(b, row, (start[s],))

    buf = jax.lax.fori_loop(
        0, S, body, jnp.zeros((n_words_cap + T,), jnp.uint32))
    return buf[:n_words_cap]


def trim_rows_np(plane: np.ndarray, sub_n_words: np.ndarray) -> np.ndarray:
    """Host compaction of a pack_bits_rows plane: concat row s's first
    sub_n_words[s] words (the dense stream, = pack_bits_scatter output).
    One boolean-mask flatten — row-major selection preserves (row, column)
    order, so no per-substream Python iteration (S can be 1024+)."""
    plane = np.asarray(plane)
    if not plane.shape[0]:
        return np.zeros(0, np.uint32)
    n = np.asarray(sub_n_words).astype(np.int64)
    mask = np.arange(plane.shape[1], dtype=np.int64)[None, :] < n[:, None]
    return plane[mask]


def substream_layout_np(lens2d: np.ndarray, records_per_substream: int):
    R, L = lens2d.shape
    G = records_per_substream
    assert R % G == 0
    S = R // G
    lens = lens2d.astype(np.int64)
    sub_bits = lens.reshape(S, G * L).sum(axis=1)
    sub_n_words = (sub_bits + WORD_BITS - 1) // WORD_BITS
    sub_word_start = np.concatenate([[0], np.cumsum(sub_n_words)[:-1]])
    flat = lens.reshape(S, G * L)
    within = np.cumsum(flat, axis=1) - flat
    bit_offsets = (within + (sub_word_start * WORD_BITS)[:, None]).reshape(R, L)
    total = int(sub_word_start[-1] + sub_n_words[-1]) if S else 0
    return {
        "bit_offsets": bit_offsets.astype(np.int64),
        "sub_n_words": sub_n_words.astype(np.int32),
        "sub_word_start": sub_word_start.astype(np.int64),
        "total_words": total,
    }

def pack_bits_scatter_np(codes: np.ndarray, lens: np.ndarray,
                         bit_offsets: np.ndarray, n_words: int) -> np.ndarray:
    codes = codes.reshape(-1).astype(np.uint64)
    lens = lens.reshape(-1).astype(np.int64)
    off = bit_offsets.reshape(-1).astype(np.int64)
    w = off >> 5
    b = off & 31
    r = 32 - b
    fits = lens <= r
    sh_l = np.maximum(r - lens, 0).astype(np.uint64)
    sh_r = np.maximum(lens - r, 0).astype(np.uint64)
    sh_lo = np.clip(32 - (lens - r), 0, 63).astype(np.uint64)
    hi = np.where(fits, codes << sh_l, codes >> sh_r) & np.uint64(0xFFFFFFFF)
    lo = np.where(fits, np.uint64(0), (codes << sh_lo) & np.uint64(0xFFFFFFFF))
    nz = lens > 0
    words = np.zeros(n_words + 1, np.uint64)
    np.add.at(words, w[nz], hi[nz])
    np.add.at(words, np.minimum(w[nz] + 1, n_words), lo[nz])
    return words[:n_words].astype(np.uint32)


def extract_fixed_width_np(words: np.ndarray, bit_offsets: np.ndarray,
                           widths: np.ndarray) -> np.ndarray:
    words = np.concatenate([words.astype(np.uint64), np.zeros(2, np.uint64)])
    o = bit_offsets.astype(np.int64)
    w = o >> 5
    b = (o & 31).astype(np.uint64)
    n = words.shape[0]
    w1 = words[np.clip(w, 0, n - 1)]
    w2 = words[np.clip(w + 1, 0, n - 1)]
    win = ((w1 << b) | (w2 >> (np.uint64(32) - b))) & np.uint64(0xFFFFFFFF)
    win = np.where(b == 0, w1, win)
    width = widths.astype(np.uint64)
    shifted = win >> (np.uint64(32) - np.maximum(width, 1))
    return np.where(width == 0, 0,
                    shifted & ((np.uint64(1) << width) - np.uint64(1))).astype(np.uint32)


def unpack_substreams_np(words: np.ndarray, sub_word_start: np.ndarray,
                         luts: np.ndarray, tree_ids: np.ndarray,
                         valid: np.ndarray, n_steps: int, lut_bits: int):
    """Host decode walk: native OpenMP twin when available (no per-step
    Python iteration — n_steps is O(title chars/substream) on real variable
    titles), numpy fallback otherwise. Steps are compact per lane: tree_ids
    and valid are (S, n_steps); returns (S, n_steps) int32 symbols."""
    from phyngsc_tpu.utils import native

    out = native.unpack_substreams(
        np.concatenate([np.asarray(words, np.uint32),
                        np.zeros(2, np.uint32)]),
        np.asarray(sub_word_start, np.int64), np.asarray(luts),
        np.asarray(tree_ids), np.asarray(valid), n_steps, lut_bits)
    if out is not None:
        return out
    return _unpack_substreams_py(words, sub_word_start, luts, tree_ids,
                                 valid, n_steps, lut_bits)


def _unpack_substreams_py(words: np.ndarray, sub_word_start: np.ndarray,
                          luts: np.ndarray, tree_ids: np.ndarray,
                          valid: np.ndarray, n_steps: int, lut_bits: int):
    """Vectorized-over-substreams numpy fallback (per-step Python loop)."""
    S = sub_word_start.shape[0]
    words = np.concatenate([words.astype(np.uint64), np.zeros(2, np.uint64)])
    n = words.shape[0]
    word_idx = np.zeros(S, np.int64)
    bit_idx = np.zeros(S, np.int64)
    out = np.zeros((S, n_steps), np.int32)
    base0 = sub_word_start.astype(np.int64)
    for t in range(n_steps):
        base = base0 + word_idx
        w1 = words[np.clip(base, 0, n - 1)]
        w2 = words[np.clip(base + 1, 0, n - 1)]
        b = bit_idx.astype(np.uint64)
        win = ((w1 << b) | (w2 >> (np.uint64(32) - b))) & np.uint64(0xFFFFFFFF)
        win = np.where(bit_idx == 0, w1, win)
        idx = (win >> np.uint64(32 - lut_bits)).astype(np.int64)
        entry = luts[tree_ids[:, t], idx]
        out[:, t] = entry & 0x1FF
        l = np.where(valid[:, t], entry >> 9, 0)
        bit_idx = bit_idx + l
        word_idx = word_idx + (bit_idx >> 5)
        bit_idx = bit_idx & 31
    return out


def words_to_bytes(words: np.ndarray) -> bytes:
    """Serialize packed words big-endian (matches BitWriter's MSB-first bytes)."""
    return np.asarray(words, dtype=">u4").tobytes()


def bytes_to_words(data: bytes) -> np.ndarray:
    pad = (-len(data)) % 4
    if pad:
        data = data + b"\x00" * pad
    return np.frombuffer(data, dtype=">u4").astype(np.uint32)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def pack_lens4_np(lens2d: np.ndarray, singletons: np.ndarray) -> np.ndarray:
    """Decode-table wire form: (T, 256) code lengths as packed 4-bit
    nibbles (MSB-first) + per-tree singleton symbols — T*33 uint32 words,
    ~120x smaller than int16 LUT planes.
    luts_from_lens_device is the exact device inverse (the planes are a
    pure function of canonical lengths)."""
    lens = np.asarray(lens2d, np.uint32)
    T = lens.shape[0]
    assert lens.shape[1] == 256, \
        "lens4 wire form requires 256-symbol alphabets"
    if not (lens < 16).all():
        # guards untrusted container data (load_table admits nibble+1 = 16),
        # so this must survive python -O and raise per the ValueError contract
        raise ValueError("corrupt table: code length >= 16")
    nib = lens.reshape(T, 32, 8)
    shifts = (28 - 4 * np.arange(8, dtype=np.uint32))
    words = (nib << shifts[None, None, :]).sum(axis=2, dtype=np.uint32)
    singles = np.asarray(singletons, np.int32).view(np.uint32)
    return np.concatenate([words.reshape(-1), singles])


@functools.partial(jax.jit, static_argnames=("T", "V"))
def lut_runs_device(lens_words: jnp.ndarray, singles: jnp.ndarray,
                    T: int, V: int):
    """Nibble-packed canonical code lengths → per-tree LUT RUNS:
    (starts (T, 256) int32, deltas (T, 256) int32) in canonical order.

    Canonical codes left-align at the running Kraft sum of their (len, sym)
    predecessors, so symbol i's full-width LUT run starts exactly at that
    prefix and the plane value at window w is Σ deltas over runs with
    start <= w (the cumulative-delta identity, which luts_from_lens_device
    expands into planes). Absent symbols share start = the Kraft end (= V for complete codes, so
    they never match a window; an incomplete corrupt table zero-fills its
    tail via the first absent slot's negative delta, exactly like
    decode_lut's unused windows). Zero-bit singleton trees become one
    all-covering run carrying the symbol."""
    B = (V - 1).bit_length()
    w = lens_words.reshape(T, 32)
    sh = (28 - 4 * jnp.arange(8, dtype=jnp.uint32))
    lens = ((w[:, :, None] >> sh[None, None, :]) & 0xF).reshape(
        T, 256).astype(jnp.int32)
    sym = jnp.broadcast_to(jnp.arange(256, dtype=jnp.int32)[None, :],
                           (T, 256))
    present = lens > 0
    key = jnp.where(present, lens * 512 + sym, jnp.int32(1) << 20)
    _, ssym, slens = jax.lax.sort((key, sym, lens), dimension=1, num_keys=1)
    wk = jnp.where(slens > 0,
                   jnp.int32(1) << (B - jnp.minimum(slens, B)), 0)
    start = jnp.cumsum(wk, axis=1) - wk            # = code << (B - len)
    entry = jnp.where(slens > 0, (slens << 9) | ssym, 0)
    prev = jnp.concatenate([jnp.zeros((T, 1), jnp.int32), entry[:, :-1]],
                           axis=1)
    deltas = entry - prev
    singles = singles.astype(jnp.int32)
    single_row = singles[:, None] >= 0
    col0 = jnp.arange(256, dtype=jnp.int32)[None, :] == 0
    start = jnp.where(single_row, jnp.where(col0, 0, V), start)
    deltas = jnp.where(single_row,
                       jnp.where(col0, singles[:, None], 0), deltas)
    return start, deltas


@functools.partial(jax.jit, static_argnames=("T", "V"))
def luts_from_lens_device(lens_words: jnp.ndarray, singles: jnp.ndarray,
                          T: int, V: int) -> jnp.ndarray:
    """Device inverse of pack_lens4_np: nibble-packed canonical code
    lengths → (T, V) int32 packed (len << 9 | sym) decode planes,
    bit-identical to huffman.decode_lut_batch (the expanded form of
    lut_runs_device; the decode walks' tables)."""
    start, deltas = lut_runs_device(lens_words, singles, T, V)
    rows = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[:, None],
                            (T, 256))
    grid = jnp.zeros((T, V), jnp.int32).at[
        rows, jnp.minimum(start, V)].add(deltas, mode="drop")
    return jnp.cumsum(grid, axis=1)


@functools.partial(jax.jit, static_argnames=("n_out",))
def extract_fixed_width(words: jnp.ndarray, bit_offsets: jnp.ndarray,
                        widths: jnp.ndarray, n_out: int):
    """Fully parallel extraction of fixed/known-width fields.

    When symbol widths are known up front (2-bit DNA, fixed-width numeric
    fields), decode needs no sequential walk at all: every symbol's bit offset
    comes from a prefix sum over the known widths and extraction is one
    two-word gather per symbol. widths must be <= 16.
    """
    del n_out
    o = bit_offsets.astype(jnp.int32)
    w = o // WORD_BITS
    b = (o % WORD_BITS).astype(jnp.uint32)
    words = jnp.concatenate([words, jnp.zeros(2, jnp.uint32)])
    n_words = words.shape[0]
    w1 = words[jnp.clip(w, 0, n_words - 1)]
    w2 = words[jnp.clip(w + 1, 0, n_words - 1)]
    win = jnp.where(b == 0, w1, (w1 << b) | (w2 >> (jnp.uint32(WORD_BITS) - b)))
    width = widths.astype(jnp.uint32)
    shifted = win >> (jnp.uint32(WORD_BITS) - jnp.maximum(width, 1))
    return jnp.where(width == 0, 0, shifted & ((jnp.uint32(1) << width) - 1)).astype(jnp.uint32)
