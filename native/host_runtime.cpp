// Native host runtime for phyngsc_tpu (ctypes-loaded).
//
// The reference spends its host cycles in OpenMP byte scans over the read
// buffer (record indexing, phyNGSC.cpp:254-331) and in Huffman tree builds
// (huffman.cpp:18-85). These are the host-side hot loops of the device pipeline
// too — everything else runs on device — so they get native implementations:
//
//   phyngsc_index_records  — newline-structured record span scan (C3)
//   phyngsc_gather         — padded (R, W) matrix gather for device batching
//   phyngsc_huffman_lengths— batched length-limited Huffman (C8 host side)
//
// Build: make -C native   (g++ -O3 -fopenmp -shared). Python falls back to
// numpy implementations when the library is absent.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Threads the OpenMP loops below may use; 0 when the library was built
// without OpenMP and every loop runs serial.
int phyngsc_openmp_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 0;
#endif
}

// Returns number of complete 4-line records found, or -(1+record_idx) on a
// validation failure at record_idx. Buffer must start at a record start.
int64_t phyngsc_index_records(const uint8_t *buf, int64_t n,
                              int64_t *title_start, int64_t *title_end,
                              int64_t *seq_start, int64_t *seq_end,
                              int64_t *qual_start, int64_t *qual_end,
                              int64_t max_records, int validate) {
  int64_t count = 0;
  const uint8_t *p = buf;
  const uint8_t *end = buf + n;
  while (p < end && count < max_records) {
    const uint8_t *t0 = p;
    const uint8_t *t1 = (const uint8_t *)memchr(t0, '\n', end - t0);
    if (!t1) break;
    const uint8_t *s0 = t1 + 1;
    const uint8_t *s1 = (const uint8_t *)memchr(s0, '\n', end - s0);
    if (!s1) break;
    const uint8_t *p0 = s1 + 1;
    const uint8_t *p1 = (const uint8_t *)memchr(p0, '\n', end - p0);
    if (!p1) break;
    const uint8_t *q0 = p1 + 1;
    const uint8_t *q1 = (const uint8_t *)memchr(q0, '\n', end - q0);
    if (!q1) break;
    if (validate) {
      if (*t0 != '@') return -(1 + count);
      if (p1 - p0 != 1 || *p0 != '+') return -(1 + count);
      if (q1 - q0 != s1 - s0) return -(1 + count);
    }
    title_start[count] = t0 - buf;
    title_end[count] = t1 - buf;
    seq_start[count] = s0 - buf;
    seq_end[count] = s1 - buf;
    qual_start[count] = q0 - buf;
    qual_end[count] = q1 - buf;
    ++count;
    p = q1 + 1;
  }
  return count;
}

// out must be R*W bytes, zero-filled by callee for the padding.
void phyngsc_gather(const uint8_t *buf, int64_t n, const int64_t *starts,
                    const int32_t *lens, int64_t R, int64_t W, uint8_t *out) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < R; ++r) {
    uint8_t *dst = out + r * W;
    int64_t len = lens[r];
    if (len > W) len = W;
    int64_t s = starts[r];
    if (s < 0 || s + len > n) len = 0;
    if (len > 0) memcpy(dst, buf + s, (size_t)len);
    if (len < W) memset(dst + len, 0, (size_t)(W - len));
  }
}

// Fused per-record gather of the three stage-A planes — a record's title,
// sequence and quality bytes are adjacent in the input, so one pass over
// records beats three separate row gathers on cache traffic. Returns the
// max quality byte (stage A's >= 128 validation, saving another plane
// pass). Out rows are zero-padded to their widths.
int32_t phyngsc_gather3(const uint8_t *buf, int64_t n,
                        const int64_t *t_start, const int32_t *t_lens,
                        int64_t TW, const int64_t *s_start,
                        const int64_t *q_start, const int32_t *lens,
                        int64_t W, int64_t R, uint8_t *titles, uint8_t *seq,
                        uint8_t *qual) {
  int32_t qmax = 0;
#pragma omp parallel for schedule(static) reduction(max : qmax)
  for (int64_t r = 0; r < R; ++r) {
    int64_t tl = t_lens[r];
    if (tl > TW) tl = TW;
    int64_t ts = t_start[r];
    if (ts < 0 || ts + tl > n) tl = 0;
    uint8_t *td = titles + r * TW;
    if (tl > 0) memcpy(td, buf + ts, (size_t)tl);
    if (tl < TW) memset(td + tl, 0, (size_t)(TW - tl));
    int64_t len = lens[r];
    if (len > W) len = W;
    int64_t ss = s_start[r], qs = q_start[r];
    if (ss < 0 || ss + len > n || qs < 0 || qs + len > n) len = 0;
    uint8_t *sd = seq + r * W;
    uint8_t *qd = qual + r * W;
    if (len > 0) {
      memcpy(sd, buf + ss, (size_t)len);
      memcpy(qd, buf + qs, (size_t)len);
      for (int64_t i = 0; i < len; ++i)
        if ((int32_t)qd[i] > qmax) qmax = qd[i];
    }
    if (len < W) {
      memset(sd + len, 0, (size_t)(W - len));
      memset(qd + len, 0, (size_t)(W - len));
    }
  }
  return qmax;
}

namespace {

// Single-tree length-limited Huffman (sort + two-queue merge + Kraft repair).
void huffman_one(const int64_t *hist, int32_t A, int32_t max_len,
                 uint8_t *lens, int32_t *singleton) {
  std::vector<int> present;
  present.reserve(A);
  for (int32_t s = 0; s < A; ++s) {
    lens[s] = 0;
    if (hist[s] > 0) present.push_back(s);
  }
  *singleton = -1;
  const int n = (int)present.size();
  if (n == 0) return;
  if (n == 1) {  // zero-bit singleton code
    *singleton = present[0];
    return;
  }
  // sort symbols by (freq, symbol) — stable tiebreak like the host builder
  std::sort(present.begin(), present.end(), [&](int a, int b) {
    return hist[a] != hist[b] ? hist[a] < hist[b] : a < b;
  });
  // Package-merge (Larmore–Hirschberg coin collector): exact optimal
  // length-limited codes. Ordering mirrors ops/huffman.
  // _package_merge_lengths exactly — leaves sorted by (freq, symbol); on
  // weight ties leaves precede packages and earlier items precede later
  // (both inputs to each merge are pre-sorted, so the stable two-pointer
  // merge with leaf priority reproduces numpy's lexsort) — so native and
  // numpy builders emit identical tables.
  std::vector<int64_t> leaf_w(n);
  for (int i = 0; i < n; ++i) leaf_w[i] = hist[present[i]];
  std::vector<int64_t> cur_w(leaf_w);
  std::vector<uint16_t> cur_c((size_t)n * n, 0);  // item-major leaf counts
  for (int i = 0; i < n; ++i) cur_c[(size_t)i * n + i] = 1;
  std::vector<int64_t> pkg_w, mrg_w;
  std::vector<uint16_t> pkg_c, mrg_c;
  for (int level = 0; level < max_len - 1; ++level) {
    const int m = (int)(cur_w.size() / 2) * 2;
    const int np_ = m / 2;
    pkg_w.assign(np_, 0);
    pkg_c.assign((size_t)np_ * n, 0);
    for (int j = 0; j < np_; ++j) {
      pkg_w[j] = cur_w[2 * j] + cur_w[2 * j + 1];
      const uint16_t *a = &cur_c[(size_t)(2 * j) * n];
      const uint16_t *b = &cur_c[(size_t)(2 * j + 1) * n];
      uint16_t *dst = &pkg_c[(size_t)j * n];
      for (int s = 0; s < n; ++s) dst[s] = (uint16_t)(a[s] + b[s]);
    }
    const int total = n + np_;
    mrg_w.assign(total, 0);
    mrg_c.assign((size_t)total * n, 0);
    int li = 0, pi = 0;
    for (int o = 0; o < total; ++o) {
      const bool use_leaf =
          li < n && (pi >= np_ || leaf_w[li] <= pkg_w[pi]);
      if (use_leaf) {
        mrg_w[o] = leaf_w[li];
        mrg_c[(size_t)o * n + li] = 1;
        ++li;
      } else {
        mrg_w[o] = pkg_w[pi];
        memcpy(&mrg_c[(size_t)o * n], &pkg_c[(size_t)pi * n],
               (size_t)n * sizeof(uint16_t));
        ++pi;
      }
    }
    cur_w.swap(mrg_w);
    cur_c.swap(mrg_c);
  }
  const int take_n = 2 * (n - 1);
  for (int i = 0; i < n; ++i) {
    int32_t acc = 0;
    for (int o = 0; o < take_n; ++o) acc += cur_c[(size_t)o * n + i];
    lens[present[i]] = (uint8_t)acc;
  }
}

}  // namespace

void phyngsc_huffman_lengths(const int64_t *hist, int32_t K, int32_t A,
                             int32_t max_len, uint8_t *lens,
                             int32_t *singletons) {
#pragma omp parallel for schedule(static)
  for (int32_t k = 0; k < K; ++k) {
    huffman_one(hist + (int64_t)k * A, A, max_len, lens + (int64_t)k * A,
                &singletons[k]);
  }
}

// Substream-parallel LUT decode walk (twin of ops/bitpack.unpack_substreams_np
// — bit-identical). The walk is inherently sequential per substream (each
// code's length moves the bit cursor), so the host version parallelizes over
// substreams with OpenMP; used for the title char stream, whose per-record
// step counts are data-dependent (the device walk would pay one executable
// per step-count bucket and a per-sub-block H2D of the step maps).
// words: packed uint32 (caller appends >= 2 zero pad words like the numpy
// twin); luts: (n_trees, 2^lut_bits) int32 entries (len<<9 | sym).
void phyngsc_unpack_substreams(const uint32_t *words, int64_t n_words,
                               const int64_t *sub_word_start, int64_t S,
                               const int32_t *luts, int32_t lut_bits,
                               const int32_t *tree_ids, const uint8_t *valid,
                               int64_t T, int32_t *out) {
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < S; ++s) {
    int64_t wi = sub_word_start[s];
    uint32_t bit = 0;
    const int32_t *tid = tree_ids + s * T;
    const uint8_t *v = valid + s * T;
    int32_t *o = out + s * T;
    for (int64_t t = 0; t < T; ++t) {
      uint32_t w1 = (wi >= 0 && wi < n_words) ? words[wi] : 0;
      uint32_t w2 = (wi + 1 >= 0 && wi + 1 < n_words) ? words[wi + 1] : 0;
      uint32_t win = bit ? ((w1 << bit) | (w2 >> (32 - bit))) : w1;
      uint32_t idx = win >> (32 - (uint32_t)lut_bits);
      int32_t entry = luts[((int64_t)tid[t] << lut_bits) | idx];
      o[t] = entry & 0x1FF;
      bit += v[t] ? (uint32_t)(entry >> 9) : 0u;
      wi += bit >> 5;
      bit &= 31u;
    }
  }
}

// Single-pass title scan: separator positions/chars plus per-field canonical
// numeric parse (<= 18 digits, no leading zero unless "0"). Replaces the
// tokenize + per-field digit loops of the title model (models/title.py) —
// the dominant host cost after everything else moved to device.
// sep_tab: 256-entry 0/1 separator table. Field f of record r spans
// [prev_sep+1, sep_pos[r,f]).
void phyngsc_title_scan(const uint8_t *titles, const int32_t *tlens,
                        int64_t R, int64_t TL, const uint8_t *sep_tab,
                        int32_t max_seps,
                        int32_t *nsep,        // (R,)
                        int32_t *sep_pos,     // (R, max_seps)
                        uint8_t *sep_chars,   // (R, max_seps)
                        int64_t *values,      // (R, max_seps+1)
                        uint8_t *numeric_ok   // (R, max_seps+1)
) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < R; ++r) {
    const uint8_t *t = titles + r * TL;
    const int32_t n = tlens[r];
    int32_t ns = 0;
    int32_t field = 0;
    int64_t val = 0;
    int32_t digits = 0;
    bool all_digits = true;
    bool leading_zero = false;
    int64_t *v = values + r * (max_seps + 1);
    uint8_t *ok = numeric_ok + r * (max_seps + 1);
    auto close_field = [&]() {
      if (field <= max_seps) {
        bool good = all_digits && digits >= 1 && digits <= 18 &&
                    !(leading_zero && digits > 1);
        v[field] = good ? val : 0;
        ok[field] = good ? 1 : 0;
      }
      val = 0;
      digits = 0;
      all_digits = true;
      leading_zero = false;
      ++field;
    };
    for (int32_t i = 0; i < n; ++i) {
      uint8_t c = t[i];
      if (sep_tab[c]) {
        close_field();
        if (ns < max_seps) {
          sep_pos[r * max_seps + ns] = i;
          sep_chars[r * max_seps + ns] = c;
        }
        ++ns;
      } else if (c >= '0' && c <= '9') {
        if (digits == 0 && c == '0') leading_zero = true;
        if (digits < 19) val = val * 10 + (c - '0');
        ++digits;
      } else {
        all_digits = false;
      }
    }
    close_field();
    nsep[r] = ns;
  }
}

// Fixed-width MSB-first word packing (ops/transfer._pack_fixed_np twin):
// word i = OR of v[j] << (32 - w*(j+1)) over its `per` values, where v is a
// per-byte transform of the source plane. The numpy version pays ~8 strided
// passes; this is the stage-A H2D pack on the compress critical path
// (reference analogue: the byte copies feeding BitStream, phyNGSC.cpp:690+).
// transform: 0 identity, 1 ACGT 2-bit ((c>>1)&3), 2 ACGTN 3-bit (N->4),
// 3 quality 6-bit (0 stays 0, else c-33).
void phyngsc_pack_fixed(const uint8_t *src, int64_t n, int32_t w,
                        int32_t transform, uint32_t *out) {
  static const int per_tab[9] = {0, 0, 16, 10, 8, 6, 5, 0, 4};
  const int per = per_tab[w];
  const int64_t n_words = (n + per - 1) / per;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_words; ++i) {
    uint32_t acc = 0;
    const int64_t base = i * per;
    const int64_t m = std::min<int64_t>(per, n - base);
    for (int64_t j = 0; j < m; ++j) {
      uint32_t c = src[base + j];
      uint32_t v;
      switch (transform) {
        case 1: v = (c >> 1) & 3u; break;
        case 2: v = (c == 78) ? 4u : ((c >> 1) & 3u); break;
        case 3: v = c ? (c - 33u) : 0u; break;
        default: v = c; break;
      }
      acc |= v << (32 - w * (j + 1));
    }
    out[i] = acc;
  }
}

// Decompressor output-tail fusion (pipeline/subblock.decode_stage_b twin):
// unpack the w-bit alphabet-index lane plane and the 6/8-bit quality lane
// plane, apply the alphabet lookup and (qual8 mode) the host-side ambiguity
// restore (inverse of phyNGSC.cpp:573-588) in ONE elementwise pass — the
// numpy version pays ~8 passes over megabyte planes per sub-block.
void phyngsc_decode_tail(const uint32_t *sw, const uint32_t *qw, int64_t n,
                         int32_t w, int32_t qw_bits, int32_t plus33,
                         int32_t qual8, const uint8_t *alpha,
                         const uint8_t *amb, uint8_t *seq_out,
                         uint8_t *qual_out) {
  static const int per_tab[9] = {0, 0, 16, 10, 8, 6, 5, 0, 4};
  const int ps = per_tab[w];
  const int pq = per_tab[qw_bits];
  const uint32_t ms = (1u << w) - 1;
  const uint32_t mq = (qw_bits == 8) ? 255u : ((1u << qw_bits) - 1);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t idx = (sw[i / ps] >> (32 - w * (i % ps + 1))) & ms;
    const uint32_t q = (qw[i / pq] >> (32 - qw_bits * (i % pq + 1))) & mq;
    uint8_t sv, qv;
    if (qual8 && q >= 128) {
      int code = (int)((q - 112) >> 3);
      if (code > 16) code = 16;
      sv = amb[code];
      qv = (uint8_t)(q - 112 - (uint32_t)(code << 3) + 33);
    } else {
      sv = alpha[idx];
      qv = plus33 ? (uint8_t)(q + 33) : (uint8_t)q;
    }
    seq_out[i] = sv;
    qual_out[i] = qv;
  }
}

// Ascending indices of non-ACGT/0 bytes (the SEQ_2BIT_EXC exception list):
// two-pass OpenMP — per-chunk counts, exclusive prefix, ordered fill.
// Returns the total count; writes at most `cap` indices.
int64_t phyngsc_find_non_acgt(const uint8_t *src, int64_t n,
                              int64_t cap, uint32_t *out_idx) {
  const int64_t chunk = 1 << 16;
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  std::vector<int64_t> counts(n_chunks + 1, 0);
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < n_chunks; ++c) {
    const int64_t e = std::min(n, (c + 1) * chunk);
    int64_t k = 0;
    for (int64_t i = c * chunk; i < e; ++i) {
      const uint8_t b = src[i];
      k += (b == 0 || b == 'A' || b == 'C' || b == 'G' || b == 'T') ? 0 : 1;
    }
    counts[c + 1] = k;
  }
  for (int64_t c = 0; c < n_chunks; ++c) counts[c + 1] += counts[c];
  if (counts[n_chunks] > cap) return counts[n_chunks];
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < n_chunks; ++c) {
    const int64_t e = std::min(n, (c + 1) * chunk);
    int64_t w = counts[c];
    for (int64_t i = c * chunk; i < e; ++i) {
      const uint8_t b = src[i];
      if (!(b == 0 || b == 'A' || b == 'C' || b == 'G' || b == 'T'))
        out_idx[w++] = (uint32_t)i;
    }
  }
  return counts[n_chunks];
}

// One-pass byte census for the pack-mode decisions (replaces ~5 boolean
// numpy passes per plane): counts of non-ACGT/0 bytes, 'N' bytes, bytes
// >= 128, and bytes outside the 6-bit quality window (0 or [33, 96]).
void phyngsc_byte_scan(const uint8_t *src, int64_t n, int64_t *out4) {
  int64_t non_acgt = 0, n_n = 0, ge128 = 0, non_q6 = 0;
#pragma omp parallel for schedule(static) \
    reduction(+ : non_acgt, n_n, ge128, non_q6)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t c = src[i];
    const bool acgt0 =
        c == 0 || c == 'A' || c == 'C' || c == 'G' || c == 'T';
    non_acgt += acgt0 ? 0 : 1;
    n_n += (c == 'N') ? 1 : 0;
    ge128 += (c >= 128) ? 1 : 0;
    non_q6 += (c == 0 || (c >= 33 && c <= 96)) ? 0 : 1;
  }
  out4[0] = non_acgt;
  out4[1] = n_n;
  out4[2] = ge128;
  out4[3] = non_q6;
}

// Numeric-field mode-planner statistics in ONE row-major pass over the
// title scan's (R, F) value matrix (models/title._numeric_pre twin — the
// numpy version pays ~6 strided passes; title analyze is on the compress
// critical path, reference AnalyzeTitleFields tasks.cpp:63-143):
// per field f: vmin/vmax, delta min/max, and per B-record block: const,
// delta-const, first delta (0 when the block has < 2 records — matching the
// pad-with-last-value semantics of the numpy path).
void phyngsc_numeric_stats(const int64_t *V, int64_t R, int64_t F,
                           int64_t stride,                   // row stride of V
                           int64_t B,
                           int64_t *vmin, int64_t *vmax,     // (F,)
                           int64_t *dmin, int64_t *dmax,     // (F,)
                           int64_t *first_d,                 // (nB, F)
                           uint8_t *bconst, uint8_t *bdconst // (nB, F)
) {
  const int64_t nB = (R + B - 1) / B;
  for (int64_t f = 0; f < F; ++f) {
    vmin[f] = INT64_MAX; vmax[f] = INT64_MIN;
    dmin[f] = INT64_MAX; dmax[f] = INT64_MIN;
  }
#pragma omp parallel
  {
    std::vector<int64_t> lvmin(F, INT64_MAX), lvmax(F, INT64_MIN);
    std::vector<int64_t> ldmin(F, INT64_MAX), ldmax(F, INT64_MIN);
#pragma omp for schedule(static)
    for (int64_t g = 0; g < nB; ++g) {
      const int64_t r0 = g * B;
      const int64_t r1 = std::min(r0 + B, R);
      int64_t *fd = first_d + g * F;
      uint8_t *bc = bconst + g * F;
      uint8_t *bd = bdconst + g * F;
      for (int64_t f = 0; f < F; ++f) {
        fd[f] = 0;
        bc[f] = 1;
        bd[f] = (r1 - r0 >= 2) ? 1 : 0;
      }
      for (int64_t r = r0; r < r1; ++r) {
        const int64_t *row = V + r * stride;
        const int64_t *nxt = row + stride; // valid while r < R-1
        for (int64_t f = 0; f < F; ++f) {
          const int64_t v = row[f];
          if (v < lvmin[f]) lvmin[f] = v;
          if (v > lvmax[f]) lvmax[f] = v;
          if (r + 1 < R) { // delta r->r+1 belongs to this block's rows
            const int64_t d = nxt[f] - v;
            if (d < ldmin[f]) ldmin[f] = d;
            if (d > ldmax[f]) ldmax[f] = d;
            if (r + 1 < r1) { // interior delta
              if (r == r0) fd[f] = d;
              else if (d != fd[f]) bd[f] = 0;
              if (d != 0) bc[f] = 0;
            }
          }
        }
      }
    }
#pragma omp critical
    for (int64_t f = 0; f < F; ++f) {
      if (lvmin[f] < vmin[f]) vmin[f] = lvmin[f];
      if (lvmax[f] > vmax[f]) vmax[f] = lvmax[f];
      if (ldmin[f] < dmin[f]) dmin[f] = ldmin[f];
      if (ldmax[f] > dmax[f]) dmax[f] = ldmax[f];
    }
  }
}

// FASTQ text reassembly: per-record memcpy of title/seq/qual rows into the
// output buffer at precomputed record offsets (twin of the decompressor's
// subblock._reassemble scatter — the numpy fancy-indexing version builds
// tens of MB of index arrays per sub-block and was the decode host wall).
// offs: (R,) absolute byte offset of each record in out; layout per record is
// title \n seq \n + \n qual \n (mirrors utils/fastq.index_records spans).
void phyngsc_fastq_assemble(const uint8_t *titles, const int32_t *tlens,
                            int64_t TL, const uint8_t *seq,
                            const uint8_t *qual, const int32_t *lens,
                            int64_t L, const int64_t *offs, int64_t R,
                            uint8_t *out) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < R; ++r) {
    uint8_t *o = out + offs[r];
    const int32_t tl = tlens[r], sl = lens[r];
    memcpy(o, titles + r * TL, (size_t)tl);
    o += tl;
    *o++ = '\n';
    memcpy(o, seq + r * L, (size_t)sl);
    o += sl;
    *o++ = '\n';
    *o++ = '+';
    *o++ = '\n';
    memcpy(o, qual + r * L, (size_t)sl);
    o += sl;
    *o++ = '\n';
  }
}

// Fused title walk: decodes the title char stream substream-parallel and
// writes symbols DIRECTLY into per-field content matrices — the numpy path
// (models/title.decode) materializes (S,T) tree-id/valid maps plus (R,W)
// index matrices per field, which measured as the decompressor's host wall.
// Fields appear in walk order (mirrors title._char_symbols' column order):
//   kind 0 = char field: steps[r,f] symbols, tree = base + min(pos, nt-1)
//   kind 1 = NUM_HUF numeric: 1 symbol/record from the field's shared tree
// out is the concatenation of per-field (R, out_w[f]) int32 row-major blocks
// at out_off[f] (elements).
void phyngsc_title_walk(const uint32_t *words, int64_t n_words,
                        const int64_t *sub_word_start, int64_t S, int64_t G,
                        const int32_t *luts, int32_t lut_bits,
                        int32_t F, const int32_t *tree_base,
                        const int32_t *n_trees, const int32_t *kind,
                        const int32_t *steps /* (R, F) */, int64_t R,
                        const int64_t *out_off, const int32_t *out_w,
                        int32_t *out) {
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < S; ++s) {
    int64_t wi = sub_word_start[s];
    uint32_t bit = 0;
    const int64_t r_end = (s + 1) * G < R ? (s + 1) * G : R;
    for (int64_t r = s * G; r < r_end; ++r) {
      for (int32_t f = 0; f < F; ++f) {
        const int32_t ns = kind[f] ? 1 : steps[r * F + f];
        const int32_t nt = n_trees[f];
        int32_t *o = out + out_off[f] + r * out_w[f];
        for (int32_t pos = 0; pos < ns; ++pos) {
          const int32_t tree =
              tree_base[f] + (pos < nt - 1 ? pos : nt - 1);
          uint32_t w1 = (wi >= 0 && wi < n_words) ? words[wi] : 0;
          uint32_t w2 = (wi + 1 < n_words) ? words[wi + 1] : 0;
          uint32_t win = bit ? ((w1 << bit) | (w2 >> (32 - bit))) : w1;
          uint32_t idx = win >> (32 - (uint32_t)lut_bits);
          int32_t entry = luts[((int64_t)tree << lut_bits) | idx];
          o[pos] = entry & 0x1FF;
          bit += (uint32_t)(entry >> 9);
          wi += bit >> 5;
          bit &= 31u;
        }
      }
    }
  }
}

// Fused title reassembly: write each record's fields (decimal numerics from
// precomputed values + digit counts, raw char bytes) and separators into the
// (R, TL) title matrix. Twin of the numpy scatter tail of title.decode.
//   kinds: 0 numeric, 1 char;  nvals: (R,) int64 per numeric field packed
//   field-major at nval_off[f]*R;  chars: int32 symbol blocks as produced by
//   phyngsc_title_walk, at char_off[f] with row width char_w[f].
void phyngsc_title_assemble(int32_t F, const int32_t *kinds,
                            const int32_t *field_lens /* (R, F) */,
                            const int64_t *nvals, const int64_t *nval_off,
                            const int32_t *chars, const int64_t *char_off,
                            const int32_t *char_w, const uint8_t *seps,
                            int64_t R, int64_t TL, uint8_t *titles) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < R; ++r) {
    uint8_t *t = titles + r * TL;
    int64_t c = 0;
    for (int32_t f = 0; f < F; ++f) {
      const int32_t fl = field_lens[r * F + f];
      if (kinds[f] == 0) {
        int64_t v = nvals[nval_off[f] + r];
        for (int32_t i = fl - 1; i >= 0; --i) {
          t[c + i] = (uint8_t)('0' + (v % 10));
          v /= 10;
        }
        c += fl;
      } else {
        const int32_t *src = chars + char_off[f] + r * char_w[f];
        for (int32_t i = 0; i < fl; ++i) t[c + i] = (uint8_t)src[i];
        c += fl;
      }
      if (f < F - 1) t[c++] = seps[f];
    }
    while (c < TL) t[c++] = 0;
  }
}

}  // extern "C"
