"""Device mesh + sharded encode steps.

The reference's process/thread hierarchy (MPI rank = file region, OpenMP
thread = buffer chunk, SURVEY §1) maps onto a 2-D `jax.sharding.Mesh`:

- `data` axis — records (data parallelism; the MPI-rank analogue). Each shard
  owns a contiguous record range whose substreams are self-contained, so
  per-shard packed words concatenate into one container stream.
- `seq` axis — read positions (sequence parallelism). Per-position histograms
  and code tables are independent across positions (tasks.cpp:590-605), so
  the statistics pass shards cleanly along the position axis; the cross-chip
  reduction is one `psum` over `data` (replacing the reference's
  omp-critical merge, phyNGSC.cpp:622-653).

`sharded_analyze` runs on the full (data × seq) mesh; `sharded_encode` runs
data-parallel (packing needs each record's whole row). Both are pure
`shard_map`s over jitted kernels from ops/ and models/.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.models import dna as dmod
from phyngsc_tpu.models import quality as qmod
from phyngsc_tpu.ops import bitpack, histogram


def make_mesh(n_data: int, n_seq: int = 1,
              devices: Optional[Sequence] = None,
              cfg: Optional[CodecConfig] = None) -> Mesh:
    cfg = cfg or CodecConfig()
    devices = np.asarray(devices if devices is not None else jax.devices())
    need = n_data * n_seq
    if devices.size < need:
        raise ValueError(f"need {need} devices, have {devices.size}")
    grid = devices[:need].reshape(n_data, n_seq)
    return Mesh(grid, (cfg.data_axis, cfg.seq_axis))


def sharded_analyze(mesh: Mesh, cfg: Optional[CodecConfig] = None):
    """(R, L) symbols + (R,) lens → (L, 256) global per-position histogram.

    R shards over `data`, L shards over `seq`; result is psum-reduced over
    `data` and re-assembled over `seq` (each seq shard computed its own
    position slice)."""
    cfg = cfg or CodecConfig()
    da, sa = cfg.data_axis, cfg.seq_axis

    def body(sym_shard, valid_shard):
        local = histogram.position_histogram(sym_shard, valid_shard, 256)
        return jax.lax.psum(local, da)

    fn = shard_map(
        body, mesh=mesh, check_vma=False,
        in_specs=(P(da, sa), P(da, sa)),
        out_specs=P(sa, None),
    )
    return jax.jit(fn)


def sharded_quality_encode(mesh: Mesh, records_per_substream: int,
                           n_words_cap_per_shard: int,
                           cfg: Optional[CodecConfig] = None):
    """Data-parallel quality encode: each shard packs its record range.

    Returns jitted fn: (qual (R, L), lens (R,), codes (T,256), lens_tab
    (T,256)) → (words (n_data * cap,), sub_n_words (S,), totals (n_data,)).
    Substreams are shard-local, so the global stream is the concatenation of
    shard word buffers; `totals` lets the host trim each shard's cap slack
    (the container stores per-substream word counts, so decode never sees the
    slack)."""
    cfg = cfg or CodecConfig()
    da, sa = cfg.data_axis, cfg.seq_axis

    def body(qual_shard, lens_shard, codes_tab, lens_tab):
        words, sub_n_words, total = qmod.encode_device(
            qual_shard, lens_shard, codes_tab, lens_tab,
            records_per_substream, n_words_cap_per_shard,
        )
        return words, sub_n_words, total.reshape(1)

    fn = shard_map(
        body, mesh=mesh, check_vma=False,
        in_specs=(P(da, None), P(da), P(), P()),
        out_specs=(P(da), P(da), P(da)),
    )
    return jax.jit(fn)


class ShardedSubblockCodec:
    """Data-parallel sub-block encode over a 1-D (or data×seq) mesh.

    Each data shard owns a contiguous record range; substreams never cross
    shards, so per-shard packed words concatenate into the exact container
    stream a single chip would produce with the same substream table — the
    format is shard-count independent. Histograms psum over `data` so the
    host builds one table set (the omp-critical merge, phyNGSC.cpp:622-653,
    as one collective).
    """

    def __init__(self, mesh: Mesh, cfg: CodecConfig):
        self.mesh = mesh
        self.cfg = cfg
        self.n_data = mesh.shape[cfg.data_axis]
        da = cfg.data_axis

        def analyze(seq, qual, lens):
            qual_t, keep, _ = dmod.transfer_ambiguity(seq, qual, lens)
            q_local = qmod.analyze(qual_t, lens)
            d_local = dmod.analyze(seq, keep)
            return (jax.lax.psum(q_local, da), jax.lax.psum(d_local, da),
                    qual_t, keep)

        self._analyze = jax.jit(shard_map(
            analyze, mesh=mesh, check_vma=False,
            in_specs=(P(da), P(da), P(da)),
            out_specs=(P(), P(), P(da), P(da)),
        ))

        self._encode_cache = {}
        self._decode_cache = {}

    def analyze(self, seq, qual, lens):
        return self._analyze(seq, qual, lens)

    def _encoder(self, G: int, cap: int, mode: int, pack: str):
        key = (G, cap, mode, pack)
        fn = self._encode_cache.get(key)
        if fn is not None:
            return fn
        da = self.cfg.data_axis

        def encode(qual_t, keep, seq, lens, q_codes, q_lens, d_codes, d_lens,
                   q_off, d_off):
            qw, qs, qt = qmod.encode_device(
                qual_t, lens, q_codes, q_lens, G, cap, pack=pack, off=q_off)
            dw, ds, dt = dmod.encode_device(
                seq, keep, d_codes, d_lens, mode, G, cap, pack=pack, off=d_off)
            return qw, qs, qt.reshape(1), dw, ds, dt.reshape(1)

        fn = jax.jit(shard_map(
            encode, mesh=self.mesh, check_vma=False,
            in_specs=(P(da), P(da), P(da), P(da), P(), P(), P(), P(),
                      P(), P()),
            out_specs=(P(da), P(da), P(da), P(da), P(da), P(da)),
        ))
        self._encode_cache[key] = fn
        return fn

    # -- decode ------------------------------------------------------------

    def can_decode(self, S: int, Rp: int, G: int) -> bool:
        """Sharded decode splits the S substreams evenly across shards, so
        every shard owns whole substreams of a contiguous record range."""
        return S % self.n_data == 0 and Rp == S * G

    def shard_words_np(self, q_words: np.ndarray, q_sub: np.ndarray,
                       d_words: np.ndarray, d_sub: np.ndarray,
                       bucket=None) -> np.ndarray:
        """(n_data, W) rows: row k holds shard k's quality words followed by
        its DNA words (substreams are contiguous in each stream), zero-padded
        to the widest shard — or to bucket(widest) when given, so that
        sub-blocks share one compiled decoder."""
        n = self.n_data
        rows = []
        for words, sub in ((q_words, q_sub), (d_words, d_sub)):
            per = np.asarray(sub, np.int64).reshape(n, -1).sum(axis=1)
            bounds = np.concatenate([[0], np.cumsum(per)])
            rows.append([words[bounds[k]:bounds[k + 1]] for k in range(n)])
        parts = [np.concatenate([q, d]) for q, d in zip(*rows)]
        width = max(1, max(x.shape[0] for x in parts))
        out = np.zeros((n, bucket(width) if bucket else width), np.uint32)
        for k, x in enumerate(parts):
            out[k, : x.shape[0]] = x
        return out

    def _walk_decoder(self, *, L, G, lut_bits, d_plain, is_delta, legacy,
                      impl):
        """Jitted shard_map: the walk decode over the data axis.

        Substream ranges are shard-independent by construction and the
        quality-before-DNA ordering (ambiguity transfer) is per-record, so
        each shard decodes its record range end-to-end; outputs concatenate
        along records (reference decode primitives: tasks.cpp:625-1101).
        Returns (2, Rp, L) uint8 seq/qual planes."""
        key = (L, G, lut_bits, d_plain, is_delta, legacy, impl)
        fn = self._decode_cache.get(key)
        if fn is not None:
            return fn
        from phyngsc_tpu.pipeline.subblock import decode_streams

        da = self.cfg.data_axis

        def body(words, q_sub_s, d_sub_s, lens_s, q_lens4, d_lens4):
            V = 1 << lut_bits
            Tq = q_lens4.shape[0] // 33
            q_luts = bitpack.luts_from_lens_device(
                q_lens4[: Tq * 32], q_lens4[Tq * 32 :], Tq, V)
            d_luts = bitpack.luts_from_lens_device(
                d_lens4[:32], d_lens4[32:], 1, V)
            qual_t, dna_syms = decode_streams(
                words[0], jnp.int32(0), q_sub_s, d_sub_s, lens_s, q_luts,
                d_luts, L=L, G=G, lut_bits=lut_bits, legacy=legacy,
                d_plain=d_plain, impl=impl)
            seq, qual = dmod.restore_ambiguity(dna_syms, qual_t, lens_s)
            if is_delta:
                seq = dmod.delta_untranslate(seq, lens_s)
            return jnp.stack([seq, qual])

        fn = jax.jit(shard_map(
            body, mesh=self.mesh, check_vma=False,
            in_specs=(P(da, None), P(da), P(da), P(da), P(), P()),
            out_specs=P(None, da, None),
        ))
        self._decode_cache[key] = fn
        return fn

    def decode_walk(self, words, q_sub, d_sub, lens, q_luts, d_luts, *, L,
                    G, lut_bits, d_plain, is_delta, impl):
        """Data-sharded walk decode; see _walk_decoder. words are
        shard_words_np rows; q_luts/d_luts are nibble-packed tables
        (bitpack.pack_lens4_np; d_luts is a placeholder in plain mode)."""
        fn = self._walk_decoder(
            L=L, G=G, lut_bits=lut_bits, d_plain=d_plain, is_delta=is_delta,
            legacy=bool(self.cfg.legacy_tail_trees), impl=impl)
        return fn(words, q_sub, d_sub, lens, q_luts, d_luts)

    def encode(self, qual_t, keep, seq, lens, q_codes, q_lens,
               d_codes, d_lens, G: int, cap_per_shard: int, mode: int,
               pack: str = "scatter", q_off=None, d_off=None):
        """Returns per-shard-concatenated (q_words, q_sub, q_totals (n_data,),
        d_words, d_sub, d_totals). pack="rows" packs per-shard (S, T) row
        planes that concatenate along substreams (the format stays
        shard-count independent); other modes pack linear cap buffers whose
        slack the host trims using the totals."""
        import numpy as _np

        fn = self._encoder(G, cap_per_shard, mode, pack)
        if q_off is None:
            q_off = _np.int32(0)
        if d_off is None:
            d_off = _np.int32(0)
        return fn(qual_t, keep, seq, lens, q_codes, q_lens, d_codes, d_lens,
                  q_off, d_off)
