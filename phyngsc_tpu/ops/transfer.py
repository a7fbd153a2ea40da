"""Host→device transfer packing for the (seq, qual) input planes.

The pipeline's H2D traffic is 2 bytes per base (sequence byte + quality
byte), so the host packs both planes before upload — DNA to 2 bits when the plane is pure
ACGT (the common case; the reference reaches the same 4-symbol insight in
its plain coder, tasks.cpp:239-256) and quality to 6 bits when all symbols
are in [33, 96] — a 4x/1.33x reduction, 2x combined. The device unpacks
inside the fused analyze graph with pure shift/mask vector ops (no gather).

Word layout is lane-aligned: `per` values per uint32, value j in bits
[32-w*(j+1), 32-w*j) — symbols never straddle words, so unpacking is one
broadcast shift. Padding bytes (batch rows past R, columns past each
record's length) are canonicalized ('A' / chr(33)) — every consumer masks
by record length, so their value is never observed.

Modes: SEQ_2BIT uses the (c >> 1) & 3 nucleotide code (A→0 C→1 T→2 G→3, a
bijection on ACGT); SEQ_3BIT adds N (code 4) for the very common ACGTN
planes — real Illumina data almost always carries a few no-calls, and raw
bytes would cost 2.67x the upload; QUAL_6BIT stores q − 33. *_RAW falls
back to 4 bytes per word (IUPAC-rich DNA, SOLiD color space, exotic
quality ranges).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

SEQ_RAW = 0
SEQ_2BIT = 1
SEQ_3BIT = 2
#: 2-bit base plane + sparse exception words `(flat_idx << 8) | raw_byte`
#: appended after it — IUPAC-rich reads (reference ambiguity set,
#: phyNGSC.cpp:184-206) are typically >99% ACGT, so raw bytes (4x upload)
#: for the whole plane just to carry a few ambiguity codes is waste. The
#: device reconstructs with ONE tiny scatter (mode="drop"; padding words
#: carry idx 0xFFFFFF, out of bounds by the f.size <= 0xFFFFFF guard).
SEQ_2BIT_EXC = 3
QUAL_RAW = 0
QUAL_6BIT = 1

_PER = {2: 16, 3: 10, 6: 5, 8: 4}  # width -> values per uint32 word

#: exception-word counts are padded to these buckets so sub-blocks with
#: different ambiguity counts share one compiled _analyze_all executable
_EXC_MIN_BUCKET = 1024


def _exc_bucket(k: int) -> int:
    b = _EXC_MIN_BUCKET
    while b < k:
        b <<= 1
    return b


def _width(kind: str, mode: int) -> int:
    if kind == "seq":
        return {SEQ_2BIT: 2, SEQ_3BIT: 3, SEQ_2BIT_EXC: 2}.get(mode, 8)
    return 6 if mode == QUAL_6BIT else 8


def n_words(n_values: int, kind: str, mode: int) -> int:
    """Word count of the fixed-width plane. For SEQ_2BIT_EXC this is the
    BASE (2-bit) plane only — the data-dependent exception words follow it;
    consumers derive their count from the buffer length."""
    per = _PER[_width(kind, mode)]
    return (n_values + per - 1) // per


def _pack_fixed_np(vals: np.ndarray, w: int) -> np.ndarray:
    per = _PER[w]
    pad = (-vals.size) % per
    v = np.concatenate([vals.reshape(-1).astype(np.uint32),
                        np.zeros(pad, np.uint32)])
    shifts = (32 - w * (np.arange(per) + 1)).astype(np.uint32)
    return np.bitwise_or.reduce(v.reshape(-1, per) << shifts[None, :], axis=1)


def pack_seq_np(seq: np.ndarray):
    """(R, L) uint8 sequence plane (padding 0) → (mode, uint32 words).

    Native fast path: one phyngsc_byte_scan census picks the mode and one
    phyngsc_pack_fixed pass packs with the mode's value map fused in —
    byte-identical to the numpy fallback below (tests/test_transfer.py)."""
    from phyngsc_tpu.utils import native

    f = seq.reshape(-1)
    sc = native.byte_scan(f)
    acgt = None
    if sc is not None:
        n_bad = sc["n_non_acgt"]
        if n_bad == 0:
            return SEQ_2BIT, native.pack_fixed(f, 2, native.PACK_ACGT2)
        all_acgtn = n_bad == sc["n_N"]
    else:
        acgt = (f == 0) | (f == 65) | (f == 67) | (f == 71) | (f == 84)
        n_bad = int(f.size - np.count_nonzero(acgt))
        if n_bad == 0:
            return SEQ_2BIT, _pack_fixed_np((f >> 1) & 3, 2)
        all_acgtn = bool((acgt | (f == 78)).all())
    # sparse non-ACGT (N's, IUPAC ambiguity): 2-bit plane + exception list.
    # The 1/32 cap bounds the device scatter (~3% of cells worst case) and
    # guarantees the word count beats both 3-bit and raw even after the
    # bucket round-up: RL/16 + 2*RL/32 = RL/8 < RL/4 always, and exc mode
    # is preferred over 3-bit only when actually smaller (checked below).
    if f.size <= 0xFFFFFF and n_bad <= f.size // 32:
        n_exc = n_words(f.size, "seq", SEQ_2BIT) + _exc_bucket(n_bad)
        better_3bit = all_acgtn and n_words(f.size, "seq", SEQ_3BIT) <= n_exc
        # tiny planes: the minimum exception bucket can exceed the raw plane
        if n_exc < n_words(f.size, "seq", SEQ_RAW) and not better_3bit:
            exc = native.find_non_acgt(f, n_bad) if sc is not None else None
            if exc is None:
                if acgt is None:
                    acgt = ((f == 0) | (f == 65) | (f == 67) | (f == 71)
                            | (f == 84))
                exc = np.flatnonzero(~acgt)
            base = (native.pack_fixed(f, 2, native.PACK_ACGT2)
                    if sc is not None else _pack_fixed_np((f >> 1) & 3, 2))
            ew = np.full(n_exc - base.shape[0], 0xFFFFFFFF, np.uint32)
            ew[: exc.size] = (exc.astype(np.uint32) << np.uint32(8)) \
                | f[exc].astype(np.uint32)
            return SEQ_2BIT_EXC, np.concatenate([base, ew])
    if all_acgtn:  # ACGTN: N -> code 4
        if sc is not None:
            return SEQ_3BIT, native.pack_fixed(f, 3, native.PACK_ACGTN3)
        v = np.where(f == 78, 4, (f >> 1) & 3).astype(np.uint32)
        return SEQ_3BIT, _pack_fixed_np(v, 3)
    if sc is not None:
        return SEQ_RAW, native.pack_fixed(f, 8, native.PACK_RAW)
    return SEQ_RAW, _pack_fixed_np(f, 8)


def seq_alpha_small(mode: int, seq: np.ndarray) -> bool:
    """True when every sequence byte is < 128, enabling the 128-lane DNA
    histogram (half the one-hot compares of the 256-wide kernel). The 2/3-
    bit planes guarantee it by construction; EXC/RAW scan the plane (one
    SIMD max over ~2 MB)."""
    if mode in (SEQ_2BIT, SEQ_3BIT):
        return True
    return int(seq.max(initial=0)) < 128


def pack_qual_np(qual: np.ndarray):
    """(R, L) uint8 quality plane (padding 0) → (mode, uint32 words)."""
    from phyngsc_tpu.utils import native

    f = qual.reshape(-1)
    sc = native.byte_scan(f)
    if sc is not None:
        if sc["n_non_q6"] == 0:
            return QUAL_6BIT, native.pack_fixed(f, 6, native.PACK_QUAL6)
        return QUAL_RAW, native.pack_fixed(f, 8, native.PACK_RAW)
    ok = (f == 0) | ((f >= 33) & (f <= 96))
    if ok.all():
        v = np.where(f == 0, 0, f.astype(np.int32) - 33).astype(np.uint32)
        return QUAL_6BIT, _pack_fixed_np(v, 6)
    return QUAL_RAW, _pack_fixed_np(f, 8)


def _unpack_words(words: jnp.ndarray, w: int, R: int, L: int) -> jnp.ndarray:
    per = _PER[w]
    shifts = jnp.array(32 - w * (np.arange(per) + 1), jnp.uint32)
    lanes = (words[:, None] >> shifts[None, :]) & jnp.uint32((1 << w) - 1)
    return lanes.reshape(-1)[: R * L].reshape(R, L)


def unpack_seq(words: jnp.ndarray, mode: int, R: int, L: int) -> jnp.ndarray:
    """Inverse of pack_seq_np on device → (R, L) uint8 symbol plane
    (2-bit padding decodes to 'A'; consumers mask by record length).
    For SEQ_2BIT_EXC, words = [base plane | exception words] and the
    exception count is taken from the buffer length (static under jit)."""
    if mode == SEQ_RAW:
        return _unpack_words(words, 8, R, L).astype(jnp.uint8)
    if mode == SEQ_2BIT_EXC:
        nb = n_words(R * L, "seq", SEQ_2BIT)
        base = unpack_seq(words[:nb], SEQ_2BIT, R, L)
        ew = words[nb:]
        # exception-region padding must never scatter: the producers pad with
        # 0xFFFFFFFF (idx 0xFFFFFF, out of bounds by the f.size <= 0xFFFFFF
        # guard in pack_seq_np), but a zero-padded blob would decode to
        # idx=0/sym=0 and silently clobber cell 0 — mask any word whose
        # symbol byte is 0 (real exceptions are printable non-ACGT bytes)
        idx = jnp.where((ew & jnp.uint32(0xFF)) == 0, jnp.uint32(R * L),
                        ew >> jnp.uint32(8)).astype(jnp.int32)
        sym = (ew & jnp.uint32(0xFF)).astype(jnp.uint8)
        return base.reshape(-1).at[idx].set(sym, mode="drop").reshape(R, L)
    v = _unpack_words(words, 2 if mode == SEQ_2BIT else 3, R, L)
    # inverse of the nucleotide code: 0→'A' 1→'C' 2→'T' 3→'G' (4→'N')
    chars = (jnp.uint32(65) + jnp.where(v == 1, 2, 0)
             + jnp.where(v == 2, 19, 0) + jnp.where(v == 3, 6, 0)
             + jnp.where(v == 4, 13, 0))
    return chars.astype(jnp.uint8)


def unpack_qual(words: jnp.ndarray, mode: int, R: int, L: int) -> jnp.ndarray:
    """Inverse of pack_qual_np on device (6-bit padding decodes to chr(33))."""
    if mode == QUAL_RAW:
        return _unpack_words(words, 8, R, L).astype(jnp.uint8)
    return (_unpack_words(words, 6, R, L) + 33).astype(jnp.uint8)
