"""DNA stream codec: ambiguity transfer + 2-bit/Huffman coding + SOLiD delta.

Capability equivalent of the reference DNA codec (C6):

- **Ambiguity transfer** (phyNGSC.cpp:552-588): IUPAC codes
  Y R W S K M D V H B N X U . -  (codes 2..16) are removed from the DNA
  stream and re-encoded into the quality byte as
  ``128 + (code << 3) - 16 + (q - 33)`` when the covering quality is in
  [33, 40]; records containing any unknown symbol, or an ambiguous base with
  out-of-range quality, keep their full symbol set in the DNA stream
  (per-record decision, mirroring make_transfer/possible_transfer).
- **Mode choice** (tasks.cpp:239-256): the reference picks 2-bit plain coding
  for <= 4 balanced symbols, else Huffman. Here both costs are computed from
  the histogram and the cheaper one wins — strictly dominating the reference
  heuristic.
- **SOLiD color-space delta** (phyNGSC.cpp:478-547): reads like 'T0123...'
  are translated color→nucleotide through the four delta matrices
  (a `lax.scan` over positions, carry = last nucleotide matrix, vectorized
  over records). Deliberate deviations from the reference, both required for
  an exact round-trip: (a) delta mode only engages when every color char is
  in '0'..'3' — the reference maps '.'/'/' both to 'N', which is not
  invertible (and its decompressor never existed to notice); (b) the
  reference overwrites the quality line with raw color digits during
  translation (phyNGSC.cpp:533, destroying quality data) — here quality is
  left untouched.

Decode ordering contract: quality decodes first; transferred positions are
exactly the quality symbols >= 128 (tasks.cpp:986,1084-1087 mirror), which
yields each record's DNA-stream symbol count and the parallel-extract offsets.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from phyngsc_tpu import backend
from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.ops import bitpack, histogram, huffman, lookup, walk
from phyngsc_tpu.utils.bitio import (BitReader, BitWriter, bit_length,
                                     get_uint_array, put_uint_array)

ALPHABET = 256

# trans_amb_codes equivalent (phyNGSC.cpp:184-206): ACGT → 1, IUPAC → 2..16.
AMB_CODE = np.zeros(256, dtype=np.uint8)
for _c in b"ACGT":
    AMB_CODE[_c] = 1
for _i, _c in enumerate(b"YRWSKMDVHBNXU.-"):
    AMB_CODE[_c] = 2 + _i
# inverse: code → IUPAC character
AMB_CHAR = np.zeros(17, dtype=np.uint8)
for _s in range(256):
    if AMB_CODE[_s] >= 2:
        AMB_CHAR[AMB_CODE[_s]] = _s

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
NUC_INDEX = np.full(256, -1, dtype=np.int32)
for _i, _c in enumerate(b"ACGT"):
    NUC_INDEX[_c] = _i

# Color-space delta matrices (phyNGSC.cpp:497-502 semantics), indexed by
# (current nucleotide 0-3, color digit 0-3) → next nucleotide index.
DELTA_NEXT = np.array(
    [[0, 1, 2, 3],   # from A: 0→A 1→C 2→G 3→T
     [1, 0, 3, 2],   # from C
     [2, 3, 0, 1],   # from G
     [3, 2, 1, 0]],  # from T
    dtype=np.int32,
)
# inverse: (current nucleotide, next nucleotide) → color digit
DELTA_COLOR = np.zeros((4, 4), dtype=np.int32)
for _a in range(4):
    for _d in range(4):
        DELTA_COLOR[_a, DELTA_NEXT[_a, _d]] = _d

MODE_PLAIN = 0
MODE_HUFFMAN = 1


def valid_mask(lens: jnp.ndarray, L: int) -> jnp.ndarray:
    return jnp.arange(L, dtype=jnp.int32)[None, :] < lens[:, None]


# ---------------------------------------------------------------------------
# Ambiguity transfer
# ---------------------------------------------------------------------------

#: the (char, code) pairs of trans_amb_codes — 19 nonzero entries of a
#: 256-slot table, so the per-base code is 19 fused elementwise compares
#: instead of a table lookup pass
_AMB_PAIRS = tuple((int(c), int(AMB_CODE[c]))
                   for c in np.flatnonzero(AMB_CODE))


@jax.jit
def transfer_ambiguity(seq: jnp.ndarray, qual: jnp.ndarray, lens: jnp.ndarray):
    """Apply the DNA→quality ambiguity transfer.

    Returns (qual_out, keep, transferred):
      qual_out (R, L) uint8 — quality with codes >= 128 at transferred spots
      keep     (R, L) bool  — True where the symbol stays in the DNA stream
      transferred (R,) bool — records whose ambiguity moved to quality
    """
    R, L = seq.shape
    v = valid_mask(lens, L)
    s32 = seq.astype(jnp.int32)
    code = jnp.zeros_like(s32)
    for ch, c in _AMB_PAIRS:
        code = code + c * (s32 == ch)
    acgt = (code == 1) & v
    amb = (code >= 2) & v
    unknown = (code == 0) & v
    qual_ok = (qual >= 33) & (qual <= 40)
    possible = ~jnp.any(unknown | (amb & ~qual_ok), axis=1)
    do = possible & jnp.any(amb, axis=1)          # make_transfer && possible
    moved = do[:, None] & amb
    q32 = qual.astype(jnp.int32)
    qual_out = jnp.where(
        moved, 128 + (code.astype(jnp.int32) << 3) - 16 + (q32 - 33), q32
    ).astype(jnp.uint8)
    keep = v & ~moved
    return qual_out, keep, do


@jax.jit
def restore_ambiguity(dna: jnp.ndarray, qual: jnp.ndarray, lens: jnp.ndarray):
    """Inverse transfer (decode side): quality symbols >= 128 expand back to
    (IUPAC char, original quality). dna holds the kept symbols already placed
    at their original positions (see scatter_kept)."""
    q = qual.astype(jnp.int32)
    moved = q >= 128
    code = jnp.clip((q - 128 + 16) >> 3, 0, 16)
    orig_q = (q - 128 + 16) - (code << 3) + 33
    # code -> IUPAC char by 15 compares (a (R, L) gather from the 17-entry
    # table is the serialized-gather trap; see transfer_ambiguity)
    amb_ch = jnp.zeros_like(code)
    for _c in range(2, 17):
        amb_ch = amb_ch + int(AMB_CHAR[_c]) * (code == _c)
    seq = jnp.where(moved, amb_ch, dna.astype(jnp.int32))
    qual_out = jnp.where(moved, orig_q, q)
    v = valid_mask(lens, qual.shape[1])
    return (
        jnp.where(v, seq, 0).astype(jnp.uint8),
        jnp.where(v, qual_out, 0).astype(jnp.uint8),
    )


# ---------------------------------------------------------------------------
# SOLiD color-space delta translation
# ---------------------------------------------------------------------------

def detect_delta(seq_np: np.ndarray, lens_np: np.ndarray) -> bool:
    """Sub-block-level delta detection, derived from phyNGSC.cpp:474-478 but
    safe: engage only when every record is nucleotide + pure '0'-'3' colors
    (see module docstring deviation (a))."""
    if seq_np.shape[0] == 0 or seq_np.shape[1] < 2:
        return False
    first = seq_np[0]
    if lens_np[0] < 2 or not (ord("0") <= first[1] <= ord("3")):
        return False
    v = np.arange(seq_np.shape[1])[None, :] < lens_np[:, None]
    heads_ok = np.isin(seq_np[:, 0], ACGT) | ~v[:, 0]
    tail = v & (np.arange(seq_np.shape[1])[None, :] >= 1)
    colors_ok = ~tail | ((seq_np >= ord("0")) & (seq_np <= ord("3")))
    return bool(np.all(heads_ok) and np.all(colors_ok))


@jax.jit
def delta_translate(seq: jnp.ndarray, lens: jnp.ndarray) -> jnp.ndarray:
    """Color digits → nucleotides: out[:,0]=seq[:,0]; out[:,n]=M[out[:,n-1]][d_n]."""
    R, L = seq.shape
    start = jnp.asarray(NUC_INDEX)[seq[:, 0].astype(jnp.int32)]
    digits = jnp.clip(seq.astype(jnp.int32) - ord("0"), 0, 3)

    def step(carry, d):
        nxt = jnp.asarray(DELTA_NEXT)[carry, d]
        return nxt, nxt

    _, nucs = jax.lax.scan(step, start, digits[:, 1:].T)
    nucs = nucs.T  # (R, L-1) nucleotide indices
    out = jnp.concatenate([seq[:, :1].astype(jnp.int32),
                           jnp.asarray(ACGT)[nucs].astype(jnp.int32)], axis=1)
    v = valid_mask(lens, L)
    return jnp.where(v, out, 0).astype(jnp.uint8)


@jax.jit
def delta_untranslate(seq: jnp.ndarray, lens: jnp.ndarray) -> jnp.ndarray:
    """Nucleotides → color digits (exact inverse of delta_translate)."""
    R, L = seq.shape
    idx = jnp.asarray(NUC_INDEX)[seq.astype(jnp.int32)]
    cur = idx[:, :-1]
    nxt = idx[:, 1:]
    colors = jnp.asarray(DELTA_COLOR)[jnp.clip(cur, 0, 3), jnp.clip(nxt, 0, 3)] + ord("0")
    out = jnp.concatenate([seq[:, :1].astype(jnp.int32), colors], axis=1)
    v = valid_mask(lens, L)
    return jnp.where(v, out, 0).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Stream coding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DnaPlan:
    mode: int                   # MODE_PLAIN | MODE_HUFFMAN
    lens_tab: np.ndarray        # (256,) uint8 (huffman) — zeros for plain
    codes_tab: np.ndarray       # (256,) uint32
    singleton: int = -1         # zero-bit tree symbol (constant base stream)

    def luts(self, lut_bits: int) -> np.ndarray:
        sym, ln = huffman.decode_lut(self.lens_tab, lut_bits, self.singleton)
        return np.asarray((ln.astype(np.int32) << 9) | sym.astype(np.int32))[None, :]


def analyze(seq: jnp.ndarray, keep: jnp.ndarray,
            small_alpha: bool = False) -> jnp.ndarray:
    """Histogram of DNA-stream symbols (the reference's dna_occ).

    small_alpha (static; transfer.seq_alpha_small): every byte < 128, so the
    one-hot histogram runs 128 alphabet lanes instead of 256 — half the
    compare work of the analyze graph's DNA pass (VERDICT r4 next #8)."""
    if small_alpha:
        h = histogram.global_histogram(seq, keep, 128)
        return jnp.pad(h, (0, ALPHABET - 128))
    return histogram.global_histogram(seq, keep, ALPHABET)


def plan(counts: np.ndarray, cfg: CodecConfig) -> DnaPlan:
    counts = np.asarray(counts, dtype=np.int64)
    present = np.flatnonzero(counts)
    total = int(counts.sum())
    lens_tab = huffman.build_code_lengths(counts, cfg.max_code_len)
    cost_huf = int(np.sum(counts * lens_tab))
    only_acgt = bool(np.all(AMB_CODE[present] == 1)) if present.size else True
    if only_acgt and 2 * total <= cost_huf and present.size > 1:
        return DnaPlan(MODE_PLAIN, np.zeros(ALPHABET, np.uint8), np.zeros(ALPHABET, np.uint32))
    codes_tab = np.asarray(huffman.canonical_codes(lens_tab))
    return DnaPlan(MODE_HUFFMAN, lens_tab, codes_tab, huffman.singleton_of(counts))


def _acgt_chars(vals: jnp.ndarray) -> jnp.ndarray:
    """2-bit code -> 'ACGT' byte by compares (A=65 C=67 G=71 T=84)."""
    v = vals.astype(jnp.int32)
    return (jnp.int32(65) + (v == 1) * 2 + (v == 2) * 6 + (v == 3) * 19)


# 2-bit symbol mapping for plain mode (A=0 C=1 G=2 T=3)
SYM2BIT = np.zeros(256, dtype=np.uint32)
for _i, _c in enumerate(b"ACGT"):
    SYM2BIT[_c] = _i


@functools.partial(jax.jit, static_argnames=("mode", "records_per_substream", "n_words_cap", "group", "pack"))
def encode_device(seq: jnp.ndarray, keep: jnp.ndarray,
                  codes_tab: jnp.ndarray, lens_tab: jnp.ndarray,
                  mode: int, records_per_substream: int, n_words_cap: int,
                  group: int = 2, pack: str = "scatter", off=None):
    """Pack kept DNA symbols. Returns (words, sub_n_words, total_words).

    Plain mode packs 16 bases per element (group_fixed2); Huffman mode uses
    the fused table lookup + symbol grouping. pack selects the bitpack kernel
    ("scatter" | "rows" | "rows_compact", see quality.encode_device); bit
    layouts are unchanged vs symbol-at-a-time packing in every mode."""
    s32 = seq.astype(jnp.int32)
    if mode == MODE_PLAIN:
        # A=0 C=1 G=2 T=3 via compares
        vals = ((s32 == ord("C")) * 1 + (s32 == ord("G")) * 2
                + (s32 == ord("T")) * 3).astype(jnp.uint32)
        pc, pl = lookup.group_fixed2(vals, keep, 16)
    else:
        A = codes_tab.shape[-1]
        sym = s32 if off is None else jnp.clip(s32 - off, 0, A - 1)
        fused_tab = jnp.broadcast_to(
            lookup.fuse_tables(codes_tab, lens_tab)[None, :], (seq.shape[1], A))
        fused = lookup.fused_lookup(sym, fused_tab)
        codes, lens = lookup.split_fused(fused)
        lens = jnp.where(keep, lens, 0)
        codes = jnp.where(keep, codes, 0)
        pc, pl = lookup.group_codes(codes, lens, group)
    if pack != "scatter":
        plane, sub, total = bitpack.pack_bits_rows(pc, pl, records_per_substream)
        if pack == "rows":
            return plane, sub, total
        return bitpack.compact_rows(plane, sub, n_words_cap), sub, total
    lay = bitpack.substream_layout(pl, records_per_substream)
    words = bitpack.pack_bits_scatter(pc, pl, lay["bit_offsets"], n_words_cap)
    return words, lay["sub_n_words"], lay["total_words"]


@functools.partial(jax.jit, static_argnames=("L", "records_per_substream"))
def decode_plain(words: jnp.ndarray, sub_n_words: jnp.ndarray,
                 keep: jnp.ndarray, L: int, records_per_substream: int,
                 base=None):
    """Fully parallel 2-bit decode: offsets are a prefix sum over the keep
    mask — no sequential walk (SURVEY §7 step 3b realized). base: optional
    (traced) word offset of the first substream in `words`."""
    G = records_per_substream
    R = keep.shape[0]
    S = R // G
    widths = jnp.where(keep, 2, 0).astype(jnp.int32)
    lay = bitpack.substream_layout(widths, G)
    # layout must match encode: same widths → same offsets, but word starts
    # come from the *stored* sub_n_words (identical by construction)
    sub_word_start = bitpack.word_starts(sub_n_words, base)
    within = lay["bit_offsets"] - (lay["sub_word_start"] * 32).repeat(G, axis=0).reshape(R, 1)
    offsets = within + (sub_word_start * 32).repeat(G, axis=0).reshape(R, 1)
    vals = bitpack.extract_fixed_width(words, offsets, widths, R * L).reshape(R, L)
    nucs = _acgt_chars(vals)
    return jnp.where(keep, nucs, 0).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("L", "records_per_substream",
                                             "lut_bits", "impl"))
def decode_huffman(words: jnp.ndarray, sub_n_words: jnp.ndarray,
                   keep: jnp.ndarray, luts: jnp.ndarray, L: int,
                   records_per_substream: int, lut_bits: int,
                   impl: str = backend.XLA, base=None):
    """Huffman DNA decode via the slot walk (ops/walk.py, implementation
    `impl`): slots are (record, position) pairs and kept slots consume the
    lane's next code, so symbols land directly in (R, L) layout. The stream
    starts at word `base` (traced, default 0) of `words`."""
    G = records_per_substream
    R = keep.shape[0]
    S = R // G
    T = G * L
    syms = walk.walk_slots(words, bitpack.word_starts(sub_n_words, base),
                           luts, jnp.zeros((T,), jnp.int32),
                           keep.reshape(S, T).T, lut_bits, impl)
    return syms.T.reshape(R, L).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Stream header
# ---------------------------------------------------------------------------

def write_header(bw: BitWriter, plan_: DnaPlan, sub_n_words: np.ndarray,
                 total_words: int, is_delta: bool) -> None:
    sub_n_words = np.asarray(sub_n_words)
    bw.put_bits(plan_.mode, 2)
    bw.put_bit(int(is_delta))
    bw.put_uint(int(total_words), 4)
    bw.put_bits(sub_n_words.shape[0], 24)
    w = bit_length(int(sub_n_words.max())) if sub_n_words.size else 1
    bw.put_bits(w, 6)
    put_uint_array(bw, sub_n_words, w)
    if plan_.mode == MODE_HUFFMAN:
        huffman.store_table(bw, plan_.lens_tab, plan_.singleton)


def read_header(br: BitReader):
    mode = br.get_bits(2)
    if mode > MODE_HUFFMAN:
        raise ValueError(f"corrupt DNA stream mode {mode}")
    is_delta = bool(br.get_bit())
    total_words = br.get_uint(4)
    n_sub = br.get_bits(24)
    w = br.get_bits(6)
    if w > 31:
        raise ValueError(f"corrupt substream-table width {w}")
    sub_n_words = get_uint_array(br, n_sub, w).astype(np.int32)
    if int(sub_n_words.sum()) > total_words:
        raise ValueError("corrupt DNA substream table (sum > total)")
    if mode == MODE_HUFFMAN:
        lens_tab, singleton = huffman.load_table(br, ALPHABET)
        codes_tab = np.asarray(huffman.canonical_codes(lens_tab))
    else:
        lens_tab = np.zeros(ALPHABET, np.uint8)
        codes_tab = np.zeros(ALPHABET, np.uint32)
        singleton = -1
    return DnaPlan(mode, lens_tab, codes_tab, singleton), sub_n_words, total_words, is_delta
