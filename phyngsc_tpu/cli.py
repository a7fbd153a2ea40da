"""Command-line driver.

Reference usage: `mpiexec -np P ./phyNGSC in.fastq out.ngsc T` (README.md:56,
arg validation phyNGSC.cpp:61-105). Here:

    python -m phyngsc_tpu compress   in.fastq out.ngsct [--writers P] [...]
    python -m phyngsc_tpu decompress in.ngsct out.fastq
    python -m phyngsc_tpu verify     in.fastq            (round-trip check)

Unlike the reference (>= 2 ranks required, quirk #6), one writer is fine.
"""

from __future__ import annotations

import argparse
import sys
import time

from phyngsc_tpu.config import CodecConfig


def _add_codec_flags(p: argparse.ArgumentParser) -> None:
    d = CodecConfig()
    p.add_argument("--block-size", type=int, default=d.block_size,
                   help="container block size in bytes (default 8 MiB)")
    p.add_argument("--subblock-bytes", type=int, default=d.subblock_input_bytes,
                   help="raw input bytes per sub-block / device batch")
    p.add_argument("--substream-records", type=int, default=d.records_per_substream,
                   help="records per decode substream")
    p.add_argument("--max-code-len", type=int, default=d.max_code_len,
                   help="Huffman code length cap (<= 12)")


def _cfg_from(args) -> CodecConfig:
    return CodecConfig(
        block_size=args.block_size,
        subblock_input_bytes=args.subblock_bytes,
        records_per_substream=args.substream_records,
        max_code_len=args.max_code_len,
        data_shards=getattr(args, "data_shards", 1),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phyngsc_tpu",
                                 description="GPU-accelerated FASTQ compressor")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="FASTQ → .ngsct")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--writers", type=int, default=1,
                   help="number of logical writers (file regions)")
    c.add_argument("--data-shards", type=int, default=1,
                   help="shard stream encoders over this many devices")
    c.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace to DIR")
    _add_codec_flags(c)

    d = sub.add_parser("decompress", help=".ngsct → FASTQ")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--data-shards", type=int, default=1,
                   help="shard the walk decode over N mesh devices "
                        "(substreams are shard-independent)")

    imp = sub.add_parser(
        "import-ngsc",
        help="decode a reference phyNGSC .ngsc container to FASTQ (the "
             "decompressor the reference never shipped)")
    imp.add_argument("input")
    imp.add_argument("output")

    exp = sub.add_parser(
        "export-ngsc",
        help="write a reference-format phyNGSC .ngsc container from FASTQ "
             "(host-side compatibility writer; verified against import-ngsc)")
    exp.add_argument("input")
    exp.add_argument("output")

    v = sub.add_parser("verify",
                       help="compress+decompress+compare (streams via temp "
                            "files — flat RSS at any input size)")
    v.add_argument("input")
    v.add_argument("--writers", type=int, default=1)
    _add_codec_flags(v)

    args = ap.parse_args(argv)
    if args.cmd in ("compress", "decompress", "verify"):
        from phyngsc_tpu import backend
        from phyngsc_tpu.utils import native

        backend.enable_compile_cache()
        print(f"[I] device {backend.device_summary()}  "
              f"decode walk {backend.walk_impl()}  "
              f"host loops {native.summary()}")

    if args.cmd == "compress":
        from phyngsc_tpu.pipeline.compress import compress_file
        from phyngsc_tpu.utils.logging import trace

        stats: list = []
        t0 = time.perf_counter()
        with trace(args.profile):
            compress_file(args.input, args.output, _cfg_from(args),
                          args.writers, stats)
        dt = time.perf_counter() - t0
        for s in stats:
            print(f"[I] writer {s.writer_id}: {s.seconds:.3f}s "
                  f"blocks={s.n_blocks} subblocks={s.n_subblocks} "
                  f"in={s.input_bytes} out={s.output_bytes}")
        total_in = sum(s.input_bytes for s in stats)
        print(f"[I] total {dt:.3f}s  {total_in / max(dt, 1e-9) / 1e6:.2f} MB/s")
        return 0

    if args.cmd == "decompress":
        from phyngsc_tpu.pipeline.decompress import decompress_file

        t0 = time.perf_counter()
        cfg = (CodecConfig(data_shards=args.data_shards)
               if args.data_shards > 1 else None)
        decompress_file(args.input, args.output, cfg)
        print(f"[I] decompressed in {time.perf_counter() - t0:.3f}s")
        return 0

    if args.cmd == "import-ngsc":
        from phyngsc_tpu.container.ngsc_import import import_ngsc_file

        t0 = time.perf_counter()
        n = import_ngsc_file(args.input, args.output)
        print(f"[I] imported {n} FASTQ bytes from .ngsc in "
              f"{time.perf_counter() - t0:.3f}s")
        return 0

    if args.cmd == "export-ngsc":
        from phyngsc_tpu.container.ngsc_export import export_ngsc_file

        t0 = time.perf_counter()
        n = export_ngsc_file(args.input, args.output)
        print(f"[I] exported {n} .ngsc bytes in "
              f"{time.perf_counter() - t0:.3f}s")
        return 0

    if args.cmd == "verify":
        # disk-streamed round trip: memmapped compress → temp container →
        # pwrite-decompress → chunked compare; RSS stays flat so 100 GB
        # inputs verify on a small host (the in-memory version misled at
        # the GB scale)
        import os
        import tempfile

        from phyngsc_tpu.pipeline.compress import compress_file
        from phyngsc_tpu.pipeline.decompress import decompress_file

        in_size = os.path.getsize(args.input)
        with tempfile.TemporaryDirectory(
                dir=os.path.dirname(os.path.abspath(args.input))) as td:
            comp_path = os.path.join(td, "verify.ngsct")
            back_path = os.path.join(td, "verify.fastq")
            compress_file(args.input, comp_path, _cfg_from(args), args.writers)
            comp_size = os.path.getsize(comp_path)
            decompress_file(comp_path, back_path)
            ok = os.path.getsize(back_path) == in_size
            if ok:
                with open(args.input, "rb") as fa, open(back_path, "rb") as fb:
                    while True:
                        a = fa.read(8 << 20)
                        b = fb.read(8 << 20)
                        if a != b:
                            ok = False
                            break
                        if not a:
                            break
        ratio = in_size / max(comp_size, 1)
        print(f"[I] round-trip {'OK' if ok else 'FAILED'}  "
              f"{in_size} → {comp_size} bytes  ratio {ratio:.3f}x")
        return 0 if ok else 1

    return 2


if __name__ == "__main__":
    sys.exit(main())
