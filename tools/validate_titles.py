"""Per-stream ratio validation against the reference binary.

Builds realistic per-record-variant titles (ERR005195 / SRR README shapes:
instrument, lane, tile, x/y coordinates — tasks.cpp:22-223 field stats are
the behavior being matched), then measures per-stream compressed cost for
BOTH codecs with a difference method: compress the dataset, then compress a
variant with ONE stream neutralized (minimal titles / constant quality /
all-A DNA); the size delta isolates that stream's cost. Our container also
reports exact per-section sizes as a cross-check of the delta method.

Usage:
  python tools/validate_titles.py [--mb 20] [--ref /tmp/phyngsc_ref]

Run on CPU: JAX_PLATFORMS=cpu.
Reference build:
  g++ -O3 -march=native -fopenmp -std=c++11 -I native/mpi_shim \
      /root/reference/*.cpp native/mpi_shim/mpi_shim.c -o /tmp/phyngsc_ref
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_dataset(style: str, n_records: int, seed: int,
                 titles: str = "real", quality: str = "real",
                 dna: str = "real") -> bytes:
    """FASTQ with per-record-variant titles mirroring real SRA headers."""
    rng = np.random.default_rng(seed)
    L = 36 if style == "ERR" else 76
    recs = []
    # tile advances in sorted runs (real flowcell order); x/y random
    tiles = np.sort(rng.integers(1, 121, n_records))
    xs = rng.integers(0, 2048, n_records)
    ys = rng.integers(0, 2048, n_records)
    lanes = rng.integers(1, 9, 1)[0]
    if dna == "real":
        seq_all = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                             p=[.2475, .2475, .2475, .2475, .01],
                             size=(n_records, L)).astype(np.uint8)
    else:
        seq_all = np.full((n_records, L), ord("A"), np.uint8)
    if quality == "real":
        # positional decay: later cycles draw lower phred
        hi = np.clip(40 - (np.arange(L) // 6), 8, 40)
        q_all = (33 + np.clip(rng.normal(hi[None, :], 4,
                                          (n_records, L)), 2, 40)
                 ).astype(np.uint8)
    else:
        q_all = np.full((n_records, L), ord("I"), np.uint8)
    for i in range(n_records):
        if titles == "real":
            if style == "ERR":
                t = b"@ERR005195.%d IL2_62_3:%d:%d:%d:%d" % (
                    i + 1, lanes, tiles[i], xs[i], ys[i])
            else:
                t = (b"@SRR001666.%d 071112_SLXA-EAS1_s_7:%d:%d:%d:%d "
                     b"length=%d" % (i + 1, lanes, tiles[i], xs[i], ys[i], L))
        else:
            t = b"@%d" % (i + 1)
        recs.append(b"%s\n%s\n+\n%s\n" % (
            t, seq_all[i].tobytes(), q_all[i].tobytes()))
    return b"".join(recs)


def ref_compress_size(ref_bin: str, data: bytes, ranks: int = 2,
                      threads: int = 1) -> int:
    with tempfile.TemporaryDirectory() as d:
        inp = os.path.join(d, "in.fastq")
        out = os.path.join(d, "out.ngsc")
        open(inp, "wb").write(data)
        env = dict(os.environ, MPI_SHIM_RANKS=str(ranks))
        subprocess.run([ref_bin, inp, out, str(threads)], env=env,
                       capture_output=True, timeout=600, check=True)
        return os.path.getsize(out)


def ours_compress(data: bytes):
    """Returns (total size, dict of per-stream section bytes)."""
    from phyngsc_tpu.config import CodecConfig
    from phyngsc_tpu.container import block as blockmod
    from phyngsc_tpu.container import footer as footermod
    from phyngsc_tpu.pipeline.compress import compress_bytes

    comp = compress_bytes(data, CodecConfig(), 2)
    foot = footermod.read_footer(comp)
    sizes = foot.block_sizes_in_file_order()

    def blocks():
        off = 0
        for size, wid in zip(sizes, foot.cbo):
            yield wid, bytes(comp[off: off + size])
            off += size

    per = {"meta": 0, "title": 0, "quality": 0, "dna": 0}
    names = list(per)
    for _, payload in blockmod.iter_subblocks(blocks()):
        off = 0
        for name in names:
            n = int.from_bytes(payload[off: off + 4], "big")
            per[name] += n + 4
            off += 4 + n
    return len(comp), per


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=20.0)
    ap.add_argument("--ref", default="/tmp/phyngsc_ref")
    ap.add_argument("--styles", default="ERR,SRR")
    args = ap.parse_args()

    for style in args.styles.split(","):
        rec_bytes = 36 * 2 + 50 if style == "ERR" else 76 * 2 + 64
        n = int(args.mb * 1e6 / rec_bytes)
        base = make_dataset(style, n, seed=11)
        variants = {
            "title": make_dataset(style, n, 11, titles="min"),
            "quality": make_dataset(style, n, 11, quality="const"),
            "dna": make_dataset(style, n, 11, dna="const"),
        }
        ref_full = ref_compress_size(args.ref, base)
        ours_full, ours_sections = ours_compress(base)
        print(f"\n== {style} ({len(base)/1e6:.1f} MB, {n} records) ==")
        print(f"total: ref {ref_full}  ours {ours_full}  "
              f"(ours/ref {ours_full/ref_full:.3f})")
        print(f"ours sections: { {k: v for k, v in ours_sections.items()} }")
        for stream, var in variants.items():
            ref_var = ref_compress_size(args.ref, var)
            ours_var, _ = ours_compress(var)
            ref_delta = ref_full - ref_var
            ours_delta = ours_full - ours_var
            # a stream "loses" when, with the OTHER streams neutralized
            # equal, our total is larger — comparing deltas alone misleads
            # when one codec can't exploit the neutralized variant (the
            # reference spends ~2 bits/base even on constant DNA, so its
            # dna delta is tiny while its variant file is 35% bigger)
            flag = "" if ours_var <= ref_var else "  <-- LOSING"
            print(f"{stream:8s} variant totals: ref {ref_var:9d}  "
                  f"ours {ours_var:9d} (ours/ref {ours_var/ref_var:.3f})  "
                  f"delta ref {ref_delta:9d} ours {ours_delta:9d}{flag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
