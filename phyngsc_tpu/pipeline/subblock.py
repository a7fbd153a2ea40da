"""Sub-block encode/decode: one device batch of records → self-contained bytes.

This is the per-sub-block orchestration the reference spreads across its
OpenMP regions (analyze :439-687, store sections :690-727, meta :717-742,
concat :804-840 in phyNGSC.cpp). Section layout (each u32-length-prefixed):

    [meta][title][quality][dna]

meta    := R:u32, L:u16, flags:u8 (bit0 variable_length, bit1 is_delta),
           [len_width:u8 + bit-packed per-record lengths]  (if variable)
title   := title.write_header || fixed words || char words
quality := quality.write_header || words
dna     := dna.write_header || words

Decode order is meta → title → quality → dna: the quality stream carries the
ambiguity transfer (symbols >= 128), which determines each record's DNA
symbol count (tasks.cpp:986 mirror).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from phyngsc_tpu import backend
from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.models import dna, quality, title
from phyngsc_tpu.ops import bitpack, transfer
from phyngsc_tpu.utils import logging as log
from phyngsc_tpu.utils.bitio import BitReader, BitWriter
from phyngsc_tpu.utils.fastq import RecordIndex
from phyngsc_tpu.utils.shapes import bucket_length, bucket_records

FLAG_VARIABLE_LENGTH = 1
FLAG_DELTA = 2
#: meta carries a crc32 of the original record bytes; decode verifies it
#: (the reference reserved CRC hooks but compiled them out, defs.h:35-46)
FLAG_CRC = 4


def _gather_matrix(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                   width: int) -> np.ndarray:
    """(R, width) uint8 padded gather of byte spans."""
    R = starts.shape[0]
    if R == 0 or width == 0:
        return np.zeros((R, max(width, 1)), np.uint8)
    from phyngsc_tpu.utils import native

    out = native.gather(buf, starts, lens, width)
    if out is not None:
        return out
    cols = starts[:, None] + np.arange(width, dtype=np.int64)[None, :]
    mask = np.arange(width)[None, :] < lens[:, None]
    out = buf[np.clip(cols, 0, buf.shape[0] - 1)]
    out[~mask] = 0
    return out


def _pack_fixed_np(values: np.ndarray, width: int) -> bytes:
    """Host fixed-width bit pack via np.packbits (MSB-first)."""
    if width == 0 or values.shape[0] == 0:
        return b""
    v = values.astype(np.uint64)
    bits = (v[:, None] >> np.arange(width - 1, -1, -1, dtype=np.uint64)[None, :]) & 1
    return np.packbits(bits.astype(np.uint8).reshape(-1)).tobytes()


def _unpack_fixed_np(data: bytes, width: int, n: int) -> np.ndarray:
    if width == 0 or n == 0:
        return np.zeros(n, np.int64)
    bits = np.unpackbits(np.frombuffer(data, np.uint8))[: n * width]
    bits = bits.reshape(n, width).astype(np.int64)
    return (bits << np.arange(width - 1, -1, -1, dtype=np.int64)[None, :]).sum(axis=1)


def _word_cap(R: int, L: int, G: int) -> int:
    """Static worst-case packed size: <= 16 bits/symbol + one alignment word
    per substream."""
    return (R * L) // 2 + (R // G) + 8


def _exact_cap(counts: np.ndarray, lens_tab: np.ndarray, S: int,
               worst: int) -> int:
    """Huffman output size is deterministic from the histogram × code
    lengths: exact bits + <= S-1 words of substream alignment. Bucketed to
    16K words so shapes (and compiled executables) are shared; fetching the
    cap-sized buffer then costs barely more than the real payload."""
    bits = int(np.sum(counts.astype(np.int64) * lens_tab.astype(np.int64)))
    words = bits // 32 + S + 8
    bucket = 1 << 14
    return min((words + bucket - 1) // bucket * bucket, worst)


class _StageA:
    """Host gather + device analyze dispatched (nothing fetched yet).

    Device outputs are fused into one `counts_blob` so the stage pays a
    single device→host round trip."""

    __slots__ = ("R", "Lt", "L", "Rp", "lens_np", "tlens_np", "titles_np",
                 "is_delta", "seq_j", "lens_j", "qual_t", "keep",
                 "counts_blob", "n_q_counts", "t_future", "crc", "buckets")


class _StageB:
    """Tables built, stream packing dispatched; all packed outputs fused into
    one `blob` for a single device→host fetch."""

    __slots__ = ("a", "q_tables", "d_plan", "t_enc", "blob", "blob_layout",
                 "n_shards", "rows_shapes")


def _trim_shard_words(words: np.ndarray, totals: np.ndarray, n_shards: int
                      ) -> np.ndarray:
    """Concatenate per-shard word buffers, dropping each shard's cap slack
    (the substream table already accounts for only the real words). One
    boolean-mask flatten — no per-shard Python iteration."""
    t = np.asarray(totals).reshape(-1).astype(np.int64)
    if n_shards <= 1:
        return words[: int(t[0])]
    per = words.reshape(n_shards, -1)
    mask = np.arange(per.shape[1], dtype=np.int64)[None, :] < t[:, None]
    return per[mask]


#: optional sub-step timing sink (set by the compress driver under
#: PHYNGSC_TIMING; maps label → accumulated seconds)
TIMING = None


def _tick(label, t0):
    import time as _t

    if TIMING is not None:
        TIMING[label] = TIMING.get(label, 0.0) + _t.perf_counter() - t0
    return _t.perf_counter()


def _acct(key: str, nbytes: int) -> None:
    """Transfer-byte accounting (under PHYNGSC_TIMING): host↔device bytes by
    direction."""
    if TIMING is not None:
        TIMING[key] = TIMING.get(key, 0.0) + float(nbytes)


def _host_async(*arrays) -> None:
    for a in arrays:
        try:
            a.copy_to_host_async()
        except AttributeError:  # numpy input (tests) or older jax
            pass


def stage_a(buf: np.ndarray, idx: RecordIndex, cfg: CodecConfig,
            codec=None, executor=None, buckets=None, rp=None) -> _StageA:
    """codec: optional parallel.mesh.ShardedSubblockCodec for multi-chip.
    executor: optional ThreadPoolExecutor — the host-heavy title encode runs
    on a worker thread, overlapping device dispatch of later stages (numpy
    and the native runtime release the GIL).
    buckets: optional shapes.BucketCtx — per-run record-bucket registry that
    promotes tail sub-blocks into an already-compiled bucket. When the driver
    runs stage A on worker threads it picks `rp` itself on the main thread in
    task order (BucketCtx decisions are history-dependent, so concurrent
    picks would make output bytes timing-dependent)."""
    st = _StageA()
    st.t_future = None
    st.crc = None
    st.buckets = buckets
    R = st.R = idx.n_records
    G = cfg.records_per_substream
    lens_np = st.lens_np = idx.seq_len.astype(np.int32)
    Lt = st.Lt = int(lens_np.max()) if R else 1
    L = st.L = bucket_length(Lt)
    n_shards = codec.n_data if codec is not None else 1
    Rp = st.Rp = (rp if rp is not None
                  else buckets.pick(R, G, n_shards) if buckets is not None
                  else bucket_records(R, G, n_shards))

    if Lt > 0xFFFF:
        from phyngsc_tpu.utils.fastq import FastqFormatError

        raise FastqFormatError(
            f"read length {Lt} exceeds the container's 65535 limit")
    tlens_np = st.tlens_np = (idx.title_end - idx.title_start).astype(np.int32)
    TL = int(tlens_np.max()) if R else 1
    from phyngsc_tpu.utils import native as _native

    # one fused pass over records gathers all three planes (each record's
    # title/seq/qual bytes are adjacent in the input) and tracks the max
    # quality byte for the >= 128 validation below
    g3 = (_native.gather3(buf, idx.title_start, tlens_np, TL,
                          idx.seq_start, idx.qual_start, lens_np, L)
          if R else None)
    if g3 is not None:
        st.titles_np, seq_np, qual_np, qmax = g3
    else:
        seq_np = _gather_matrix(buf, idx.seq_start,
                                lens_np.astype(np.int64), L)
        qual_np = _gather_matrix(buf, idx.qual_start,
                                 lens_np.astype(np.int64), L)
        st.titles_np = _gather_matrix(buf, idx.title_start,
                                      tlens_np.astype(np.int64), TL)
        qmax = int(qual_np.max()) if R else 0
    if R and qmax >= 128:
        from phyngsc_tpu.utils.fastq import FastqFormatError

        raise FastqFormatError(
            "quality byte >= 128 in input: outside printable phred+33 and "
            "reserved for the ambiguity transfer (phyNGSC.cpp:579 encoding)")

    if Rp != R:
        pad = Rp - R
        seq_np = np.vstack([seq_np, np.zeros((pad, L), np.uint8)])
        qual_np = np.vstack([qual_np, np.zeros((pad, L), np.uint8)])
        lens_pad = np.concatenate([lens_np, np.zeros(pad, np.int32)])
    else:
        lens_pad = lens_np

    if cfg.checksum and R:
        import zlib

        span = buf[int(idx.title_start[0]) : int(idx.qual_end[-1]) + 1]
        st.crc = zlib.crc32(np.ascontiguousarray(span))
    st.is_delta = dna.detect_delta(seq_np[:R], lens_np)
    if R and bool(np.all(lens_np == lens_np[0])):
        # uniform lengths regenerate on device from the scalar record count
        # — elides the (Rp,) int32 lens upload (262 KB per 64K-record
        # sub-block)
        _acct("h2d_bytes", 8)
        lens_j = st.lens_j = _uniform_lens(
            jax.device_put(np.array([R], np.int32)), Rp, int(lens_np[0]))
    else:
        _acct("h2d_bytes", lens_pad.nbytes)
        lens_j = st.lens_j = jax.device_put(lens_pad)

    if codec is not None:
        seq_j = jax.device_put(seq_np)
        if st.is_delta:
            seq_j = dna.delta_translate(seq_j, lens_j)
        st.seq_j = seq_j
        qual_j = jax.device_put(qual_np)
        q_counts, d_counts, st.qual_t, st.keep = codec.analyze(
            seq_j, qual_j, lens_j)
        st.n_q_counts = int(q_counts.shape[0]) * int(q_counts.shape[1])
        st.counts_blob = _fuse_counts(q_counts, d_counts)
    else:
        s_mode, s_words = transfer.pack_seq_np(seq_np)
        q_mode, q_words = transfer.pack_qual_np(qual_np)
        _acct("h2d_bytes", s_words.nbytes + q_words.nbytes)
        blob_in = jax.device_put(np.concatenate([s_words, q_words]))  # one H2D
        st.seq_j, st.qual_t, st.keep, st.counts_blob = _analyze_all(
            blob_in, lens_j, is_delta=st.is_delta,
            seq_mode=s_mode, qual_mode=q_mode, L=L,
            d_small=transfer.seq_alpha_small(s_mode, seq_np))
        st.n_q_counts = min(L, quality.MAX_TREES) * quality.ALPHABET
    _host_async(st.counts_blob)
    if executor is not None:
        st.t_future = executor.submit(title.encode, st.titles_np, tlens_np, cfg)
    return st


@functools.partial(jax.jit, static_argnames=("Rp", "Lt"))
def _uniform_lens(r: jnp.ndarray, Rp: int, Lt: int) -> jnp.ndarray:
    """(Rp,) lens for uniform-length sub-blocks from the scalar real record
    count (padding rows get 0) — replaces a 4*Rp-byte upload with 4 bytes."""
    return jnp.where(jnp.arange(Rp, dtype=jnp.int32) < r[0], Lt, 0)


@jax.jit
def _keep_from_quality(qual_t, lens):
    L = qual_t.shape[1]
    v = jnp.arange(L, dtype=jnp.int32)[None, :] < lens[:, None]
    return (qual_t < 128) & v


@jax.jit
def _fuse_seq_qual(seq, qual):
    return jnp.stack([seq, qual])


#: lane widths -> values per uint32 word (same layout as ops/transfer)
_OUT_PER = {2: 16, 3: 10, 4: 8, 5: 6, 6: 5, 8: 4}


def _out_fetch_words(n: int, w: int, q6: bool) -> tuple:
    per_s = _OUT_PER[w]
    per_q = 5 if q6 else 4
    return (n + per_s - 1) // per_s, (n + per_q - 1) // per_q


def _lane_pack_j(vals: jnp.ndarray, w: int) -> jnp.ndarray:
    per = _OUT_PER[w]
    pad = (-vals.shape[0]) % per
    if pad:
        vals = jnp.concatenate([vals, jnp.zeros(pad, vals.dtype)])
    shifts = jnp.asarray(32 - w * (np.arange(per) + 1), jnp.uint32)
    return jnp.sum(vals.reshape(-1, per).astype(jnp.uint32)
                   << shifts[None, :], axis=1, dtype=jnp.uint32)


def _lane_unpack_np(words: np.ndarray, w: int, n: int) -> np.ndarray:
    per = _OUT_PER[w]
    shifts = (32 - w * (np.arange(per) + 1)).astype(np.uint32)
    lanes = (words[:, None] >> shifts[None, :]) & np.uint32((1 << w) - 1)
    return lanes.reshape(-1)[:n]


@functools.partial(jax.jit, static_argnames=("w", "q6"))
def _pack_out(seq, qual, alpha32, lens, w, q6):
    """Packed decode-output fetch: the (2, Rp, L) uint8 planes are the
    decompressor's dominant device→host transfer — the restored alphabet is
    host-known, so seq ships as a w-bit alphabet index and quality as
    q-33 in 6 bits when the range allows. Inverse of ops/transfer's H2D
    packing, same lane layout.

    Byte -> alphabet index runs as <= 32 unrolled compares over the tiny
    alphabet (sentinel -1 slots never match a byte)."""
    q = qual.astype(jnp.int32).reshape(-1)
    if q6:
        qv = jnp.where(q < 33, 0, q - 33)
        qw = _lane_pack_j(qv, 6)
    else:
        qw = _lane_pack_j(q, 8)
    s32 = seq.astype(jnp.int32).reshape(-1)
    idx = jnp.zeros_like(s32)
    for k in range(1, 32):
        idx = idx + k * (s32 == alpha32[k])
    sw = _lane_pack_j(idx.astype(jnp.uint32), w)
    return jnp.concatenate([sw, qw])


@jax.jit
def _fuse_counts(q_counts, d_counts):
    return jnp.concatenate(
        [q_counts.reshape(-1).astype(jnp.int32),
         d_counts.reshape(-1).astype(jnp.int32)]
    )


@functools.partial(jax.jit, static_argnames=("is_delta", "seq_mode",
                                              "qual_mode", "L", "d_small"))
def _analyze_all(blob, lens, is_delta=False, seq_mode=0, qual_mode=0, L=1,
                 d_small=False):
    """Whole stage-A device graph as ONE executable over ONE H2D transfer.

    blob is the host-packed [seq_words | qual_words] uint32 buffer
    (ops/transfer: 2-bit DNA + 6-bit quality in the common case — halves
    H2D bytes); unpacking is fused shift/mask vector ops. Call and transfer
    counts both stay at one.
    """
    R = lens.shape[0]
    if seq_mode == transfer.SEQ_2BIT_EXC:
        # base plane + data-dependent exception words: everything before
        # the (statically sized) quality plane belongs to the sequence
        ns = blob.shape[0] - transfer.n_words(R * L, "qual", qual_mode)
    else:
        ns = transfer.n_words(R * L, "seq", seq_mode)
    seq = transfer.unpack_seq(blob[:ns], seq_mode, R, L)
    qual = transfer.unpack_qual(blob[ns:], qual_mode, R, L)
    if is_delta:
        seq = dna.delta_translate(seq, lens)
    qual_t, keep, _ = dna.transfer_ambiguity(seq, qual, lens)
    q_counts = quality.analyze(qual_t, lens)
    d_counts = dna.analyze(seq, keep, small_alpha=d_small)
    blob = jnp.concatenate(
        [q_counts.reshape(-1).astype(jnp.int32),
         d_counts.reshape(-1).astype(jnp.int32)]
    )
    return seq, qual_t, keep, blob


@functools.partial(jax.jit, static_argnames=("mode", "G", "q_cap", "d_cap",
                                              "q_group", "d_group", "pack"))
def _encode_all(qual_t, keep, seq, lens, q_codes, q_lens, d_codes, d_lens,
                mode, G, q_cap, d_cap, q_group=2, d_group=2, pack="scatter",
                q_off=None, d_off=None):
    """Whole stage-B device graph (both stream encoders + output fusion) as
    one executable; returns the fused fetch blob + layout sizes.

    q_off/d_off: alphabet-window origins when the code tables are sliced to
    64/128 columns (lookup.window_np) — smaller table uploads for the
    common ~70-symbol quality alphabet."""
    q_words, q_sub, q_total = quality.encode_device(
        qual_t, lens, q_codes, q_lens, G, q_cap, q_group, pack, q_off)
    d_words, d_sub, d_total = dna.encode_device(
        seq, keep, d_codes, d_lens, mode, G, d_cap, d_group, pack, d_off)
    blob = jnp.concatenate([
        q_words.reshape(-1),
        d_words.reshape(-1),
        q_sub.reshape(-1).astype(jnp.uint32),
        d_sub.reshape(-1).astype(jnp.uint32),
        q_total.reshape(-1).astype(jnp.uint32),
        d_total.reshape(-1).astype(jnp.uint32),
    ])
    return blob


@functools.partial(jax.jit, static_argnames=())
def _fuse_blob(q_words, q_sub, q_total, d_words, d_sub, d_total):
    return jnp.concatenate([
        q_words.reshape(-1),
        d_words.reshape(-1),
        q_sub.reshape(-1).astype(jnp.uint32),
        d_sub.reshape(-1).astype(jnp.uint32),
        q_total.reshape(-1).astype(jnp.uint32),
        d_total.reshape(-1).astype(jnp.uint32),
    ])


def stage_b(a: _StageA, cfg: CodecConfig, codec=None) -> _StageB:
    import time as _t

    t0 = _t.perf_counter()
    st = _StageB()
    st.a = a
    G = cfg.records_per_substream
    st.n_shards = codec.n_data if codec is not None else 1
    counts = np.asarray(a.counts_blob)  # the one stage-A fetch
    _acct("d2h_bytes", counts.nbytes)
    t0 = _tick("b.counts_fetch", t0)
    q_counts = counts[: a.n_q_counts].reshape(-1, quality.ALPHABET)
    d_counts = counts[a.n_q_counts :]
    st.q_tables, q_group = quality.build_tables_adaptive(q_counts, cfg)
    st.d_plan = dna.plan(d_counts, cfg)
    from phyngsc_tpu.ops import lookup as _lookup

    d_group = _lookup.group_for(int(st.d_plan.lens_tab.max()) or 1) \
        if st.d_plan.mode == dna.MODE_HUFFMAN else 2
    # alphabet windows: slice the device copies of the code tables to the
    # occupied symbol range (counts-derived, so every symbol that can occur
    # at a valid position is inside) — the table upload shrinks with the
    # column count. Header serialization keeps
    # the full-width tables; decode is unaffected.
    q_off, q_A = _lookup.window_np(q_counts)
    q_codes_dev = np.ascontiguousarray(st.q_tables.codes[:, q_off:q_off + q_A])
    q_lens_dev = np.ascontiguousarray(st.q_tables.lens[:, q_off:q_off + q_A])
    if st.d_plan.mode == dna.MODE_HUFFMAN:
        d_off, d_A = _lookup.window_np(d_counts.reshape(1, -1))
        d_codes_dev = np.ascontiguousarray(
            st.d_plan.codes_tab[d_off:d_off + d_A])
        d_lens_dev = np.ascontiguousarray(st.d_plan.lens_tab[d_off:d_off + d_A])
    else:
        d_off, d_codes_dev, d_lens_dev = 0, st.d_plan.codes_tab, st.d_plan.lens_tab
    t0 = _tick("b.tables", t0)

    _acct("h2d_bytes", q_codes_dev.nbytes + q_lens_dev.nbytes
          + d_codes_dev.nbytes + d_lens_dev.nbytes)
    S = a.Rp // G
    pack = bitpack.pack_mode()
    plane = pack == "rows"
    if codec is not None:
        cap = 0 if plane else _word_cap(a.Rp // st.n_shards, a.L, G)
        q_words, q_sub, q_total, d_words, d_sub, d_total = codec.encode(
            a.qual_t, a.keep, a.seq_j, a.lens_j,
            jax.device_put(q_codes_dev), jax.device_put(q_lens_dev),
            jax.device_put(d_codes_dev), jax.device_put(d_lens_dev),
            G, cap, st.d_plan.mode, pack,
            np.int32(q_off), np.int32(d_off),
        )
        st.blob_layout = [int(np.prod(x.shape)) for x in
                          (q_words, d_words, q_sub, d_sub)]
        st.rows_shapes = (q_words.shape, d_words.shape) if plane else None
        st.blob = _fuse_blob(q_words, q_sub, jnp.asarray(q_total),
                             d_words, d_sub, jnp.asarray(d_total))
    else:
        if plane:
            q_cap = d_cap = 0
        else:
            worst = _word_cap(a.Rp, a.L, G)
            q_cap = _exact_cap(
                q_counts,
                quality.lens_rows_for(st.q_tables, q_counts.shape[0]),
                S, worst)
            if st.d_plan.mode == dna.MODE_PLAIN:
                d_cap = _exact_cap(d_counts, np.full(256, 2, np.int64), S, worst)
            else:
                d_cap = _exact_cap(d_counts, st.d_plan.lens_tab, S, worst)
            if a.buckets is not None:
                # share one _encode_all executable across SAME-Rp sub-blocks:
                # caps promote to an in-use bucket (bounded extra fetch beats
                # a recompile); keyed by Rp — other record buckets compile
                # their own executables, so cross-bucket promotion only
                # inflates the fetch
                q_cap = a.buckets.pick_words(f"enc_q:{a.Rp}", q_cap, worst)
                d_cap = a.buckets.pick_words(f"enc_d:{a.Rp}", d_cap, worst)
        st.blob = _encode_all(
            a.qual_t, a.keep, a.seq_j, a.lens_j,
            jax.device_put(q_codes_dev), jax.device_put(q_lens_dev),
            jax.device_put(d_codes_dev), jax.device_put(d_lens_dev),
            st.d_plan.mode, G, q_cap, d_cap, q_group, d_group, pack,
            np.int32(q_off), np.int32(d_off),
        )
        if plane:
            Lgq = -(-a.L // q_group)
            d_elem = 16 if st.d_plan.mode == dna.MODE_PLAIN else d_group
            Lgd = -(-a.L // d_elem)
            st.rows_shapes = ((S, G * Lgq), (S, G * Lgd))
            st.blob_layout = [S * G * Lgq, S * G * Lgd, S, S]
        else:
            st.rows_shapes = None
            st.blob_layout = [q_cap, d_cap, S, S]
    t0 = _tick("b.encode_dispatch", t0)
    # title is host-heavy: runs on a worker thread started in stage A (or
    # inline here), while the device packs quality/dna
    st.t_enc = a.t_future.result() if a.t_future is not None \
        else title.encode(a.titles_np, a.tlens_np, cfg)
    t0 = _tick("b.title", t0)
    _host_async(st.blob)
    return st


def stage_c(b: _StageB, cfg: CodecConfig) -> bytes:
    import time as _t

    a = b.a
    t0 = _t.perf_counter()
    blob = np.asarray(b.blob)  # the one stage-B fetch
    _tick("c.fetch", t0)       # wire wait, not host work (bench models it)
    _acct("d2h_bytes", blob.nbytes)
    nqw, ndw, nqs, nds = b.blob_layout
    off = 0
    q_words = blob[off : off + nqw]; off += nqw
    d_words = blob[off : off + ndw]; off += ndw
    q_sub = blob[off : off + nqs].astype(np.int32); off += nqs
    d_sub = blob[off : off + nds].astype(np.int32); off += nds
    q_total = blob[off : off + max(b.n_shards, 1)].astype(np.int64); off += max(b.n_shards, 1)
    d_total = blob[off:].astype(np.int64)

    meta = BitWriter()
    meta.put_uint(a.R, 4)
    meta.put_bits(a.Lt, 16)
    variable = bool(a.R) and not bool(np.all(a.lens_np == a.lens_np[0]))
    flags = (FLAG_VARIABLE_LENGTH if variable else 0) | (
        FLAG_DELTA if a.is_delta else 0) | (FLAG_CRC if a.crc is not None else 0)
    meta.put_byte(flags)
    if a.crc is not None:
        meta.put_uint(a.crc, 4)
    if variable:
        w = max(1, int(a.lens_np.max()).bit_length())
        meta.put_byte(w)
        meta.flush()
        meta.put_bytes(_pack_fixed_np(a.lens_np, w))
    meta.flush()

    tbw = BitWriter()
    title.write_header(tbw, b.t_enc)
    tbw.flush()
    title_sec = (
        tbw.getvalue()
        + bitpack.words_to_bytes(b.t_enc.fixed_words)
        + bitpack.words_to_bytes(b.t_enc.char_words)
    )

    if b.rows_shapes is not None:
        q_stream = bitpack.trim_rows_np(
            q_words.reshape(b.rows_shapes[0]), q_sub)
    else:
        q_stream = _trim_shard_words(q_words, q_total, b.n_shards)
    qbw = BitWriter()
    quality.write_header(qbw, b.q_tables, q_sub, q_stream.shape[0])
    qbw.flush()
    quality_sec = qbw.getvalue() + bitpack.words_to_bytes(q_stream)

    if b.rows_shapes is not None:
        d_stream = bitpack.trim_rows_np(
            d_words.reshape(b.rows_shapes[1]), d_sub)
    else:
        d_stream = _trim_shard_words(d_words, d_total, b.n_shards)
    dbw = BitWriter()
    dna.write_header(dbw, b.d_plan, d_sub, d_stream.shape[0], a.is_delta)
    dbw.flush()
    dna_sec = dbw.getvalue() + bitpack.words_to_bytes(d_stream)

    out = bytearray()
    for sec in (meta.getvalue(), title_sec, quality_sec, dna_sec):
        out += len(sec).to_bytes(4, "big")
        out += sec
    return bytes(out)


def encode_subblock(buf: np.ndarray, idx: RecordIndex, cfg: CodecConfig) -> bytes:
    """Single-shot composition of the three pipeline stages (the compress
    driver runs them software-pipelined across sub-blocks to overlap host
    prep, device compute, and device→host fetches)."""
    return stage_c(stage_b(stage_a(buf, idx, cfg), cfg), cfg)


class _DStage:
    """Decode stage A result: everything parsed/dispatched, the fused
    (seq, qual) device blob pending fetch. out_meta is
    (alpha, q6, Rp, L, qual8) when the blob is lane-packed (see
    _pack_out / _decode_tail), else None."""

    __slots__ = ("R", "lens_np", "titles_np", "tlens_np", "blob", "crc",
                 "out_meta", "cfg")


def decode_stage_a(data: bytes, cfg: CodecConfig, buckets=None,
                   executor=None, codec=None) -> _DStage:
    st = _DStage()
    (st.R, st.lens_np, st.titles_np, st.tlens_np, st.blob,
     st.crc, st.out_meta) = _decode_dispatch(
        data, cfg, buckets, executor, codec)
    st.cfg = cfg
    _host_async(st.blob)
    return st


def decode_stage_b(st: _DStage) -> bytes:
    import time as _t

    t0 = _t.perf_counter()
    both = np.asarray(st.blob)
    _acct("d2h_bytes", both.nbytes)
    t0 = _tick("d.fetch", t0)
    if st.out_meta is not None:
        alpha, q6, Rp, L, qual8 = st.out_meta
        n = Rp * L
        w = _out_width(alpha.shape[0])
        n_sw, n_qw = _out_fetch_words(n, w, q6 and not qual8)
        qb = 6 if (q6 and not qual8) else 8
        from phyngsc_tpu.utils import native as _native

        a32 = np.zeros(32, np.uint8)
        a32[: alpha.shape[0]] = alpha
        nt = _native.decode_tail(
            both[:n_sw], both[n_sw : n_sw + n_qw], n, w, qb,
            plus33=bool(q6 and not qual8), qual8=bool(qual8),
            alpha=a32, amb=dna.AMB_CHAR)
        if nt is not None:
            seq = nt[0].reshape(Rp, L)[: st.R]
            qual = nt[1].reshape(Rp, L)[: st.R]
        else:
            # numpy fallback (native lib absent): identical math
            idx = _lane_unpack_np(both[:n_sw], w, n)
            q = _lane_unpack_np(both[n_sw : n_sw + n_qw], qb, n)
            if qual8:
                # host-side ambiguity restore (inverse of
                # phyNGSC.cpp:573-588): the fetched planes are PRE-restore —
                # kept-symbol alphabet indices and raw qual_t, whose symbols
                # >= 128 mark transferred positions (tasks.cpp:1084-1087).
                # int16 throughout: the values fit and the plane is
                # megabytes per sub-block
                qt = q.astype(np.int16)
                moved = qt >= 128
                code = np.clip((qt - 112) >> 3, 0, 16)
                seq = np.where(moved, dna.AMB_CHAR[code], alpha[idx])
                qual = np.where(moved, (qt - 112 - (code << 3) + 33
                                        ).astype(np.int16), qt)
            else:
                seq = alpha[idx]
                qual = q + 33 if q6 else q
            seq = seq.astype(np.uint8).reshape(Rp, L)[: st.R]
            qual = qual.astype(np.uint8).reshape(Rp, L)[: st.R]
    else:
        seq, qual = both[0, : st.R], both[1, : st.R]
    if st.tlens_np is None:        # title decode ran on a worker thread
        st.titles_np, st.tlens_np = st.titles_np.result()
    out = _reassemble(st.R, st.lens_np, st.titles_np, st.tlens_np, seq, qual)
    _tick("d.reassemble", t0)
    if st.crc is not None:
        import zlib

        if zlib.crc32(out) != st.crc:
            raise ValueError(
                "sub-block checksum mismatch: decoded bytes differ from the "
                "original input (corrupt container or codec defect)")
    return out


def decode_subblock(data: bytes, cfg: CodecConfig) -> bytes:
    """Inverse of encode_subblock → FASTQ text bytes. (The decompress driver
    runs decode_stage_a/b software-pipelined across sub-blocks.)"""
    return decode_stage_b(decode_stage_a(data, cfg))


class _DParsed:
    """Host-side parse result of one sub-block payload: everything the device
    decode needs, as numpy arrays + table plans. Splitting parse from device
    dispatch lets the decompress driver time them separately and lets bench.py
    hoist the H2D uploads to measure device-only decode throughput."""

    __slots__ = ("R", "Lt", "L", "Rp", "G", "variable", "is_delta", "crc",
                 "lens_np", "lens_pad", "titles_np", "tlens_np",
                 "q_tables", "q_sub", "q_words",
                 "d_plan", "d_sub", "d_words", "out_alpha", "d_alpha",
                 "q6", "walk", "buckets")


def _check_tables(lens2d: np.ndarray, singletons: np.ndarray,
                  what: str, cfg: CodecConfig) -> None:
    """Reject corrupt decode tables at parse time (ValueError, per the
    fuzz-hardening contract): wire code lengths can encode up to 16 but the
    codec never emits beyond cfg.max_code_len, and singleton symbols must
    fit the 256-symbol alphabet."""
    if lens2d.size and int(lens2d.max()) > cfg.max_code_len:
        raise ValueError(
            f"corrupt {what} table: code length exceeds max_code_len")
    s = np.asarray(singletons)
    if s.size and int(s.max()) >= 256:
        raise ValueError(
            f"corrupt {what} table: singleton symbol out of range")


def _decode_parse(data: bytes, cfg: CodecConfig, buckets=None,
                  executor=None) -> _DParsed:
    """executor: optional ThreadPoolExecutor — the host-heavy title decode
    (native walk + text reassembly) runs on a worker thread, overlapping
    the device decode dispatch of this and later sub-blocks; p.titles_np is
    then a Future that decode_stage_b resolves (mirrors the encode side's
    stage-A title offload)."""
    p = _DParsed()
    p.buckets = buckets
    sections = []
    off = 0
    for _ in range(4):
        n = int.from_bytes(data[off : off + 4], "big")
        sections.append(data[off + 4 : off + 4 + n])
        off += 4 + n
    meta_sec, title_sec, quality_sec, dna_sec = sections

    br = BitReader(meta_sec)
    R = p.R = br.get_uint(4)
    Lt = p.Lt = br.get_bits(16)
    p.L = bucket_length(Lt)
    flags = br.get_byte()
    variable = p.variable = bool(flags & FLAG_VARIABLE_LENGTH)
    p.is_delta = bool(flags & FLAG_DELTA)
    p.crc = br.get_uint(4) if flags & FLAG_CRC else None
    if variable:
        w = br.get_byte()
        br.align()
        p.lens_np = _unpack_fixed_np(
            br.get_bytes(((R * w) + 7) // 8), w, R).astype(np.int32)
    else:
        br.align()
        p.lens_np = np.full(R, Lt, np.int32) if R else np.zeros(0, np.int32)

    G = p.G = cfg.records_per_substream

    # title
    br = BitReader(title_sec)
    t_plan, n_fixed, n_char, t_sub = title.read_header(br, R)
    br.align()
    fixed_words = bitpack.bytes_to_words(br.get_bytes(4 * n_fixed))
    char_words = bitpack.bytes_to_words(br.get_bytes(4 * n_char))
    if executor is not None and R:
        p.titles_np = executor.submit(
            title.decode, t_plan, fixed_words, char_words, t_sub, R, cfg)
        p.tlens_np = None
    else:
        p.titles_np, p.tlens_np = title.decode(
            t_plan, fixed_words, char_words, t_sub, R, cfg)

    # quality (before DNA — carries the ambiguity transfer)
    br = BitReader(quality_sec)
    p.q_tables, p.q_sub, q_total = quality.read_header(br)
    br.align()
    # Validate untrusted tables HERE so both decode paths — the fused-blob
    # walk and the sharded mesh branch — see the same checks: load_table
    # yields lengths up to 16 (nibble+1) and 16-bit singleton symbols;
    # anything beyond the codec cap / alphabet is container corruption, not
    # a recoverable state.
    _check_tables(p.q_tables.lens, p.q_tables.singletons, "quality", cfg)

    # Rp comes from the stored substream-table length, making decode agnostic
    # to the encoder's shard count / bucketing.
    p.Rp = p.q_sub.shape[0] * G if p.q_sub.shape[0] else bucket_records(R, G)
    if p.Rp < R:
        raise ValueError(
            f"corrupt quality substream table: capacity {p.Rp} < {R} records")
    p.lens_pad = np.concatenate([p.lens_np, np.zeros(p.Rp - R, np.int32)])

    # the decode walk (backend.walk_impl): the compiled kernel on the GPU,
    # the XLA walk on the CPU (the kernel in interpret mode where
    # PHYNGSC_WALK=kernel forces it)
    p.walk = backend.walk_impl()

    dbr = BitReader(dna_sec)
    p.d_plan, p.d_sub, d_total, is_delta_hdr = dna.read_header(dbr)
    if p.d_plan.mode != dna.MODE_PLAIN:
        _check_tables(p.d_plan.lens_tab[None, :],
                      np.array([p.d_plan.singleton], np.int32), "DNA", cfg)
    if p.d_sub.shape[0] != p.q_sub.shape[0]:
        raise ValueError(
            "corrupt container: DNA substream table length "
            f"{p.d_sub.shape[0]} != quality's {p.q_sub.shape[0]}")
    p.is_delta = p.is_delta or is_delta_hdr
    dbr.align()

    # the words travel tight: _walk_blob_np buckets the whole blob once
    p.q_words = bitpack.bytes_to_words(br.get_bytes(4 * q_total))
    p.d_words = bitpack.bytes_to_words(dbr.get_bytes(4 * d_total))

    # restored-output alphabet for the packed D2H fetch: provably complete —
    # kept positions hold DNA-plan symbols (plain mode only fires on pure
    # ACGT, dna.plan:217), transferred positions restore to AMB_CHAR chars
    # derivable from the quality tables' >=128 symbols
    if p.d_plan.mode == dna.MODE_PLAIN:
        dsyms = {65, 67, 71, 84}
    else:
        dsyms = set(np.flatnonzero(p.d_plan.lens_tab).tolist())
        if p.d_plan.singleton >= 0:
            dsyms.add(int(p.d_plan.singleton))
    qpresent = set(np.flatnonzero(
        np.count_nonzero(p.q_tables.lens, axis=0)).tolist())
    qpresent |= {int(s) for s in p.q_tables.singletons if s >= 0}
    restored_q = [33]
    rest_chars = set()
    for s in qpresent:
        if s >= 128:
            code = min(max((s - 128 + 16) >> 3, 0), 16)
            rest_chars.add(int(dna.AMB_CHAR[code]))
            restored_q.append((s - 128 + 16) - (code << 3) + 33)
        else:
            restored_q.append(s)
    p.q6 = max(restored_q) <= 96
    # 32 covers ACGT + the full 15-char IUPAC ambiguity set with room to
    # spare; beyond that (exotic alphabets) the raw u8 plane is shipped
    alpha = sorted(dsyms | rest_chars)
    p.out_alpha = (np.array(alpha, np.uint8)
                   if 0 < len(alpha) <= 32 and R else None)
    # qual8 fetch ships KEPT symbols only, so its index plane uses the DNA
    # alphabet's width (2-3 bits typical) — not the restored alphabet's.
    # It only pays off when transfers exist (rest_chars nonempty): a rich
    # kept alphabet WITHOUT transfers costs the same wire either way, and
    # the small mode's device restore is then an identity
    da = sorted(dsyms)
    p.d_alpha = (np.array(da, np.uint8)
                 if (p.out_alpha is not None and rest_chars
                     and 0 < len(da) <= 32) else None)
    return p


def _qual8_mode(p: _DParsed) -> bool:
    """Rich restored alphabets (> 8 symbols = IUPAC-bearing sub-blocks)
    ship pre-restore planes and restore on host (_decode_tail qual8)."""
    return bool(p.out_alpha is not None and not p.is_delta
                and p.out_alpha.shape[0] > 8 and p.d_alpha is not None)


def _pack_u16_pairs(vals: np.ndarray) -> np.ndarray:
    v = np.asarray(vals, np.uint32)
    if v.size and int(v.max()) >= (1 << 16):
        # per-lane words are < 2^16 under the walk's step-count guard for
        # well-formed streams; only a corrupt substream table can get here
        raise ValueError("corrupt substream table: entry exceeds 16 bits")
    if v.shape[0] % 2:
        v = np.append(v, np.uint32(0))
    return (v[0::2] << np.uint32(16)) | v[1::2]


def _unpack_u16_pairs(words: jnp.ndarray, n: int) -> jnp.ndarray:
    hi = (words >> jnp.uint32(16)).astype(jnp.int32)
    lo = (words & jnp.uint32(0xFFFF)).astype(jnp.int32)
    return jnp.stack([hi, lo], axis=1).reshape(-1)[:n]


def _lens4(p: _DParsed):
    """Nibble-packed decode tables (bitpack.pack_lens4_np) of the quality
    trees (an empty tree when there are none) and of the DNA tree (None in
    plain mode)."""
    if p.q_tables.n_trees:
        q = bitpack.pack_lens4_np(p.q_tables.lens, p.q_tables.singletons)
    else:
        q = bitpack.pack_lens4_np(np.zeros((1, 256), np.uint8),
                                  np.array([-1], np.int32))
    d = None
    if p.d_plan.mode != dna.MODE_PLAIN:
        d = bitpack.pack_lens4_np(p.d_plan.lens_tab[None, :],
                                  np.array([p.d_plan.singleton], np.int32))
    return q, d


def _walk_blob_np(p: _DParsed, cfg: CodecConfig):
    """Fuse every decode-side upload of the walk graph into ONE uint32
    buffer: real record count, u16-packed substream tables, per-record
    lengths only when actually variable (uint16 pairs; uniform lengths
    regenerate from static Lt), decode tables as nibble-packed canonical
    code lengths (bitpack.luts_from_lens_device rebuilds the planes on
    device), the packed-output alphabet, then the quality and DNA words.
    Everything before the words has a static offset; the walks read the
    words in place from per-substream start offsets. The blob is bucketed
    once at geometric granularity. Returns (blob, n_q_trees)."""
    # table validity (code lengths <= max_code_len, singleton range) is
    # enforced for every path in _decode_parse via _check_tables
    q_lens4, d_lens4 = _lens4(p)
    pieces = [np.array([p.R], np.uint32),
              _pack_u16_pairs(p.q_sub), _pack_u16_pairs(p.d_sub)]
    if p.variable:
        pieces.append(_pack_u16_pairs(p.lens_pad))
    pieces.append(q_lens4)
    if d_lens4 is not None:
        pieces.append(d_lens4)
    if p.out_alpha is not None and not p.is_delta:
        src = p.d_alpha if _qual8_mode(p) else p.out_alpha
        a = np.full(32, 0xFFFFFFFF, np.uint32)
        a[: src.shape[0]] = src
        pieces.append(a)
    pieces += [p.q_words[: int(p.q_sub.sum())],
               p.d_words[: int(p.d_sub.sum())]]
    blob = np.concatenate(pieces)
    n0 = blob.shape[0]
    n = _bucket_words(n0, p.buckets, f"dwalk:{p.Rp}")
    if n > n0:
        blob = np.concatenate([blob, np.zeros(n - n0, np.uint32)])
    return blob, max(p.q_tables.n_trees, 1)


def _bucket_words(n0: int, buckets, key: str) -> int:
    """Word count of an upload that keys an executable: geometric
    granularity (<= ~6% avg slack), promoted (at most 25% over natural) to a
    size already in use under `key`, so sub-blocks land on a handful of
    shapes and compile once."""
    g = 1 << max(12, n0.bit_length() - 4)
    n = -(-n0 // g) * g
    if buckets is not None:
        n = buckets.pick_words(key, n, n0 + n0 // 4 + g)
    return n


def _decode_device_inputs(p: _DParsed, cfg: CodecConfig, codec=None) -> dict:
    """One-time H2D uploads for _decode_device (bench.py hoists this out of
    its device-only timing loop): ONE fused blob, or nothing for an empty
    sub-block. codec:
    optional parallel.mesh.ShardedSubblockCodec — the decode shards over
    the data mesh axis when the substreams split evenly across shards."""
    if codec is not None and p.R:
        S = p.q_sub.shape[0]
        if codec.can_decode(S, p.Rp, p.G):
            q_lens4, d_lens4 = _lens4(p)
            if d_lens4 is None:       # plain DNA: a placeholder table
                d_lens4 = bitpack.pack_lens4_np(
                    np.zeros((1, 256), np.uint8), np.array([-1], np.int32))
            dev = {
                "mesh": True,
                "words": jax.device_put(codec.shard_words_np(
                    p.q_words, p.q_sub, p.d_words, p.d_sub,
                    lambda w: _bucket_words(w, p.buckets,
                                            f"mesh:{p.Rp}"))),
                "q_sub": jax.device_put(p.q_sub),
                "d_sub": jax.device_put(p.d_sub),
                "lens": jax.device_put(p.lens_pad),
                "q_luts": jax.device_put(q_lens4),
                "d_luts": jax.device_put(d_lens4),
            }
            _acct("h2d_bytes", sum(
                int(np.prod(v.shape)) * v.dtype.itemsize
                for k, v in dev.items() if k != "mesh"))
            return dev
        log.warn("sharded decode fallback: S=%d substreams do not split "
                 "evenly across %d shards; decoding on one device",
                 S, codec.n_data)
    if not p.R:
        return {}
    blob_np, n_q_trees = _walk_blob_np(p, cfg)
    _acct("h2d_bytes", blob_np.nbytes)
    return {"blob": jax.device_put(blob_np), "walk_meta": n_q_trees}


def _out_width(n_alpha: int) -> int:
    if n_alpha <= 4:
        return 2
    if n_alpha <= 8:
        return 3
    return 4 if n_alpha <= 16 else 5


def _decode_tail(qual_t, lens, dna_syms, alpha32, *, is_delta, out_w, q6,
                 qual8=False):
    """Shared decode-graph tail.

    qual8 (IUPAC-bearing sub-blocks, DNA alphabet <= 32): ship the
    PRE-restore planes — kept-symbol alphabet indices + raw 8-bit qual_t —
    and let the host apply the ambiguity restore (a handful of numpy
    where's). This deletes the device restore and an exception compaction
    (one u32 sort over R*L) from the decode graph; transferred positions are recoverable host-side because they
    are exactly the qual_t symbols >= 128 (tasks.cpp:1084-1087).
    Otherwise: ambiguity restore → delta untranslate → packed (small
    alphabets, w-bit + 6-bit) or raw planes (delta)."""
    if qual8:
        return _pack_out(dna_syms, qual_t, alpha32, lens, out_w, False)
    seq_j, qual_j = dna.restore_ambiguity(dna_syms, qual_t, lens)
    if is_delta:
        seq_j = dna.delta_untranslate(seq_j, lens)
    if out_w and not is_delta:
        return _pack_out(seq_j, qual_j, alpha32, lens, out_w, q6)
    return _fuse_seq_qual(seq_j, qual_j)


def decode_streams(words, off, q_sub, d_sub, lens, q_luts, d_luts, *, L, G,
                   lut_bits, legacy, d_plain, impl):
    """Quality then DNA decode of one record range whose quality words start
    at words[off] and whose DNA words follow them (the walk blob's and a
    mesh shard's layout). Returns (qual_t, dna_syms), both (R, L) uint8."""
    qual_t = quality.decode_device(
        words, q_sub, lens, q_luts, L, G, lut_bits, legacy=legacy,
        impl=impl, base=off)
    keep = _keep_from_quality(qual_t, lens)
    d_off = off + jnp.sum(q_sub.astype(jnp.int32))
    if d_plain:
        dna_syms = dna.decode_plain(words, d_sub, keep, L, G, base=d_off)
    else:
        dna_syms = dna.decode_huffman(words, d_sub, keep, d_luts, L, G,
                                      lut_bits, impl=impl, base=d_off)
    return qual_t, dna_syms


@functools.partial(jax.jit, static_argnames=(
    "S", "Rp", "L", "Lt", "G", "variable", "n_q_trees", "lut_bits",
    "d_plain", "is_delta", "out_w", "q6", "qual8", "legacy", "impl"))
def _decode_walk_fused(blob, *, S, Rp, L, Lt, G, variable, n_q_trees,
                       lut_bits, d_plain, is_delta, out_w, q6, qual8=False,
                       legacy=False, impl):
    """Whole per-sub-block decode graph over ONE fused H2D blob
    (_walk_blob_np's exact layout; every static is bucketed so sub-blocks
    share this executable). `impl` picks the walk (backend.walk_impl): the
    rest of the graph is the same on every backend. Decode tables arrive as 4-bit canonical code
    lengths and become LUT planes on device; per-record lengths ship only
    when actually variable. Reference decode side this replaces:
    tasks.cpp:957-1101."""
    V = 1 << lut_bits
    off = 1
    q_sub = _unpack_u16_pairs(blob[off : off + (S + 1) // 2], S)
    off += (S + 1) // 2
    d_sub = _unpack_u16_pairs(blob[off : off + (S + 1) // 2], S)
    off += (S + 1) // 2
    if variable:
        lens = _unpack_u16_pairs(blob[off : off + (Rp + 1) // 2], Rp)
        off += (Rp + 1) // 2
    else:
        R = blob[0].astype(jnp.int32)
        lens = jnp.where(jnp.arange(Rp, dtype=jnp.int32) < R, Lt, 0)
    q_luts = bitpack.luts_from_lens_device(
        blob[off : off + n_q_trees * 32],
        blob[off + n_q_trees * 32 : off + n_q_trees * 33], n_q_trees, V)
    off += n_q_trees * 33
    d_luts = None
    if not d_plain:
        d_luts = bitpack.luts_from_lens_device(
            blob[off : off + 32], blob[off + 32 : off + 33], 1, V)
        off += 33
    out_tab = None
    if out_w and not is_delta:
        # 32-slot restored alphabet; sentinel words (0xFFFFFFFF -> -1 as
        # int32) never match a byte in the compare-indexing
        out_tab = blob[off : off + 32].astype(jnp.int32)
        off += 32
    qual_t, dna_syms = decode_streams(
        blob, jnp.int32(off), q_sub, d_sub, lens, q_luts, d_luts, L=L, G=G,
        lut_bits=lut_bits, legacy=legacy, d_plain=d_plain, impl=impl)
    return _decode_tail(qual_t, lens, dna_syms, out_tab,
                        is_delta=is_delta, out_w=out_w, q6=q6,
                        qual8=qual8)


def _decode_device(p: _DParsed, dev: dict, cfg: CodecConfig, codec=None):
    """Dispatch the fused decode executable; returns the blob pending one
    fetch."""
    if dev.get("mesh"):
        return codec.decode_walk(
            dev["words"], dev["q_sub"], dev["d_sub"], dev["lens"],
            dev["q_luts"], dev["d_luts"], L=p.L, G=p.G,
            lut_bits=cfg.max_code_len,
            d_plain=p.d_plan.mode == dna.MODE_PLAIN,
            is_delta=bool(p.is_delta), impl=p.walk)
    if not p.R:
        return np.zeros((2, 0, p.L), np.uint8)
    pack = p.out_alpha is not None and not p.is_delta
    qual8 = _qual8_mode(p)
    out_w = 0
    if pack:
        out_w = _out_width((p.d_alpha if qual8 else p.out_alpha).shape[0])
    return _decode_walk_fused(
        dev["blob"], S=p.q_sub.shape[0], Rp=p.Rp, L=p.L,
        # Lt only regenerates uniform lengths; pin it for variable
        # lengths so raw read lengths don't key extra executables
        Lt=0 if p.variable else p.Lt,
        G=p.G, variable=p.variable, n_q_trees=dev["walk_meta"],
        lut_bits=cfg.max_code_len,
        d_plain=p.d_plan.mode == dna.MODE_PLAIN,
        is_delta=bool(p.is_delta), out_w=out_w, q6=bool(p.q6),
        qual8=qual8, legacy=bool(cfg.legacy_tail_trees), impl=p.walk)


def _decode_dispatch(data: bytes, cfg: CodecConfig, buckets=None,
                     executor=None, codec=None):
    import time as _t

    t0 = _t.perf_counter()
    p = _decode_parse(data, cfg, buckets, executor)
    t0 = _tick("d.parse", t0)
    dev = _decode_device_inputs(p, cfg, codec)
    blob = _decode_device(p, dev, cfg, codec=codec)
    _tick("d.device_dispatch", t0)
    # the mesh decode returns raw (2, Rp, L) planes, never the packed fetch
    pack = (p.out_alpha is not None and not p.is_delta
            and not dev.get("mesh"))
    qual8 = _qual8_mode(p)
    out_meta = ((p.d_alpha if qual8 else p.out_alpha, p.q6, p.Rp, p.L,
                 qual8)
                if pack else None)
    return (p.R, p.lens_np, p.titles_np, p.tlens_np, blob, p.crc, out_meta)


def _reassemble(R, lens_np, titles_np, tlens_np, seq_np, qual_np) -> bytes:
    # reassemble FASTQ text: native per-record memcpy (OpenMP) when
    # available, else a vectorized numpy scatter
    rec_bytes = tlens_np.astype(np.int64) + 1 + lens_np.astype(np.int64) + 1 + 2 + lens_np.astype(np.int64) + 1
    offs = np.concatenate([[0], np.cumsum(rec_bytes)])
    if R:
        from phyngsc_tpu.utils import native

        res = native.fastq_assemble(titles_np[:R], tlens_np[:R], seq_np[:R],
                                    qual_np[:R], lens_np[:R], offs[:-1],
                                    int(offs[-1]))
        if res is not None:
            return res
    out = np.zeros(int(offs[-1]), np.uint8)

    def scatter(mat, mlens, base):
        Wm = mat.shape[1]
        if Wm == 0 or R == 0:
            return
        pos = np.arange(Wm, dtype=np.int64)
        m = pos[None, :] < mlens[:, None]
        flat = (base[:, None] + pos[None, :])[m]
        out[flat] = mat[:R][m]

    base_t = offs[:-1]
    scatter(titles_np, tlens_np.astype(np.int64), base_t)
    out[base_t + tlens_np] = 0x0A
    base_s = base_t + tlens_np + 1
    scatter(seq_np, lens_np.astype(np.int64), base_s)
    out[base_s + lens_np] = 0x0A
    base_p = base_s + lens_np + 1
    out[base_p] = ord("+")
    out[base_p + 1] = 0x0A
    base_q = base_p + 2
    scatter(qual_np, lens_np.astype(np.int64), base_q)
    out[base_q + lens_np] = 0x0A
    return out.tobytes()
