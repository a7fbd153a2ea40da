"""On-GPU smoke test: the whole compress/decompress path on one NVIDIA GPU.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --multi   # four GPUs: --data-shards 4 against 1 GPU

Phases (each fatal):
  1. card and device: nvidia-smi's name and power limit; JAX's backend is gpu
  2. file-to-file round trips through the CLI (cli.main, in this process):
     >= 1 GB ERR005195-style 36 bp, SRR-style 76 bp, 1000 bp and
     variable-length corpora, each compared byte for byte
  3. the decode ran the walk kernel compiled for the GPU, never interpret
  4. kernels against plain numpy references at 65536 x 36 and 1000 bp:
     the walk (bitpack.unpack_substreams_np), the position histogram
     (np.add.at) and the code lookup (np.take), all exact
  5. walk kernel against the XLA walk: device-only and decompress end to end
  6. the tests marked gpu (pytest, in this process)
With --multi only the 4-GPU phase runs: the 36 bp corpus compressed with
--data-shards 4 must give the 1-GPU container byte for byte, and decompress
with --data-shards 4 must restore the input.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Everything runs in this one process (a JAX process reserves most of the
card's memory). Exits non-zero, with no result line, on any failure or when
JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

MB = 1_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def write_corpus(path: str, target_bytes: int, chunk_records: int,
                 **kw) -> int:
    """Synthesize chunks from consecutive seeds until target_bytes."""
    from phyngsc_tpu.utils.fastq import synthesize_fastq

    n = 0
    seed = kw.pop("seed")
    with open(path, "wb") as f:
        while n < target_bytes:
            chunk = synthesize_fastq(chunk_records, seed=seed, **kw)
            f.write(chunk)
            n += len(chunk)
            seed += 1
    return n


def same_files(a: str, b: str) -> bool:
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(64 << 20), fb.read(64 << 20)
            if x != y:
                return False
            if not x:
                return True


def cli(*argv: str) -> float:
    from phyngsc_tpu import cli as climod

    t0 = time.perf_counter()
    rc = climod.main(list(argv))
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")
    return time.perf_counter() - t0


def roundtrip(name: str, src: str, work: str, *extra: str) -> dict:
    comp = os.path.join(work, name + ".ngsct")
    back = os.path.join(work, name + ".back.fastq")
    n_in = os.path.getsize(src)
    tc = cli("compress", src, comp, *extra)
    n_out = os.path.getsize(comp)
    td = cli("decompress", comp, back, *extra)
    if not same_files(src, back):
        raise AssertionError(f"{name}: round trip is not byte-exact")
    os.unlink(back)
    row = {"corpus": name, "input_mb": n_in / MB, "ratio": n_in / n_out,
           "compress_mbps": n_in / tc / MB, "decompress_mbps": n_in / td / MB,
           "compress_s": tc, "decompress_s": td}
    log(f"[roundtrip] {json.dumps(row)}")
    return row


def timed(fn, reps: int = 5) -> float:
    """Best device time of `reps` calls (each ended by block_until_ready),
    after one warm call."""
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def check_walk(R: int, L: int, G: int) -> None:
    """Walk kernel (compiled) and XLA walk against the host walk, on one
    real quality stream at (R, L); prints both device times."""
    import jax.numpy as jnp

    from phyngsc_tpu.config import CodecConfig
    from phyngsc_tpu.models import quality
    from phyngsc_tpu.ops import bitpack, walk

    rng = np.random.default_rng(R + L)
    trend = 70 - np.arange(L) * 30.0 / L
    qual = np.clip(np.rint(trend[None] + rng.normal(0, 4, size=(R, L))),
                   33, 104).astype(np.uint8)
    lens = rng.integers(L // 2, L + 1, size=R).astype(np.int32)
    lens[: R // 2] = L                       # half uniform, half shorter
    valid = np.arange(L)[None, :] < lens[:, None]
    qual = np.where(valid, qual, 0).astype(np.uint8)
    tabs, group = quality.build_tables_adaptive(
        np.asarray(quality.analyze(jnp.asarray(qual), jnp.asarray(lens))),
        CodecConfig())
    cap = R * L // 2 + R // G + 8
    words, sub, _ = quality.encode_device(
        jnp.asarray(qual), jnp.asarray(lens), jnp.asarray(tabs.codes),
        jnp.asarray(tabs.lens), G, cap, group)
    sub = np.asarray(sub)
    S, T = R // G, G * L
    start = np.concatenate([[0], np.cumsum(sub)[:-1]]).astype(np.int32)
    luts = tabs.luts(12)
    tree = np.asarray(quality.tree_of_position(
        jnp.arange(T, dtype=jnp.int32) % L, tabs.n_trees, L))
    mask = valid.reshape(S, T).T
    ref = bitpack.unpack_substreams_np(
        np.asarray(words)[: int(sub.sum())], start, luts,
        np.broadcast_to(tree, (S, T)), mask.T, T, 12).T
    ref = np.where(mask, ref, 0)
    if not np.array_equal(ref, qual.reshape(S, T).T):
        raise AssertionError("host walk disagrees with the encoded symbols")
    args = (words, jnp.asarray(start), jnp.asarray(luts), jnp.asarray(tree),
            jnp.asarray(mask))
    times = {}
    for impl, fn in (("kernel", walk.walk_slots_kernel),
                     ("xla", walk.walk_slots_xla)):
        got = np.asarray(fn(*args, 12))
        if not np.array_equal(got, ref):
            raise AssertionError(f"walk {impl} differs from the host walk "
                                 f"at {R}x{L}")
        times[impl] = timed(lambda: fn(*args, 12))
    log(f"[kernel] walk {R}x{L} G={G} S={S} steps={T}: exact vs "
        f"bitpack.unpack_substreams_np")
    log(f"[walk-timing] {R}x{L} G={G}: kernel {times['kernel'] * 1e3:.3f} ms"
        f"  xla {times['xla'] * 1e3:.3f} ms  "
        f"(x{times['xla'] / times['kernel']:.1f})")


def check_histogram_lookup(R: int, L: int) -> None:
    import jax.numpy as jnp

    from phyngsc_tpu.ops import histogram, lookup

    rng = np.random.default_rng(R * 7 + L)
    sym = rng.integers(0, 256, size=(R, L)).astype(np.uint8)
    valid = rng.random((R, L)) < 0.9
    got = np.asarray(histogram.position_histogram(jnp.asarray(sym),
                                                  jnp.asarray(valid), 256))
    ref = np.zeros(L * 256, np.int64)
    pos = np.broadcast_to(np.arange(L)[None, :], (R, L))
    np.add.at(ref, (pos * 256 + sym)[valid], 1)
    if not np.array_equal(got, ref.reshape(L, 256)):
        raise AssertionError(f"position_histogram differs at {R}x{L}")
    t_hist = timed(lambda: histogram.position_histogram(
        jnp.asarray(sym), jnp.asarray(valid), 256))

    tab = rng.integers(0, 1 << 16, size=(L, 256)).astype(np.int32)
    got = np.asarray(lookup.fused_lookup(jnp.asarray(sym), jnp.asarray(tab)))
    ref = np.stack([np.take(tab[p], sym[:, p]) for p in range(L)], axis=1)
    if not np.array_equal(got, ref):
        raise AssertionError(f"fused_lookup differs at {R}x{L}")
    t_look = timed(lambda: lookup.fused_lookup(jnp.asarray(sym),
                                               jnp.asarray(tab)))
    log(f"[kernel] {R}x{L}: position_histogram == np.add.at "
        f"({t_hist * 1e3:.3f} ms), fused_lookup == np.take "
        f"({t_look * 1e3:.3f} ms)")


def walk_spy():
    """Record the walk implementation of every walk-graph decode."""
    from phyngsc_tpu.pipeline import subblock

    seen: list = []
    orig = subblock._decode_walk_fused

    def spy(*a, **kw):
        seen.append(kw.get("impl"))
        return orig(*a, **kw)

    subblock._decode_walk_fused = spy
    return seen


#: corpus -> (bytes, synthesize_fastq arguments)
CORPORA = {
    "err36": (1100 * MB, dict(chunk_records=900_000, read_len=36,
                              style="ERR005195", seed=100)),
    "srr76": (110 * MB, dict(chunk_records=200_000, read_len=76,
                             style="SRR", seed=200)),
    "long1000": (260 * MB, dict(chunk_records=20_000, read_len=1000,
                                seed=300)),
    "var100": (100 * MB, dict(chunk_records=150_000, read_len=100,
                              variable_length=True, seed=400)),
}


def single(work: str, corpora=CORPORA) -> None:
    from phyngsc_tpu import backend

    paths = {}
    for name, (size, kw) in corpora.items():
        kw = dict(kw)
        paths[name] = os.path.join(work, name + ".fastq")
        t0 = time.perf_counter()
        n = write_corpus(paths[name], size, **kw)
        log(f"[corpus] {name}: {n / MB:.1f} MB synthesized in "
            f"{time.perf_counter() - t0:.1f}s")

    # phases 2 + 3: CLI round trips, and the walk that ran
    seen = walk_spy()
    for name in corpora:
        roundtrip(name, paths[name], work)
    if backend.walk_impl() != backend.KERNEL or not seen or any(
            s != backend.KERNEL for s in seen):
        raise AssertionError(f"decode did not run the compiled walk kernel: "
                             f"policy={backend.walk_impl()} seen={set(seen)}")
    log(f"[walk] {len(seen)} sub-block decodes ran the compiled walk kernel "
        "(impl=kernel, no interpret mode)")

    # phase 4 + 5: kernels against references, and timings
    check_walk(65536, 36, 64)
    check_walk(4096, 1000, 8)
    check_histogram_lookup(65536, 36)
    check_histogram_lookup(2048, 1000)
    for name in ("err36", "long1000"):
        # both walks warm: the kernel graph compiled in the round trip, the
        # XLA graph compiles in its first pass here
        comp = os.path.join(work, name + ".ngsct")
        back = os.path.join(work, name + ".xla.fastq")
        os.environ["PHYNGSC_WALK"] = "xla"
        try:
            cli("decompress", comp, back)
            t_xla = cli("decompress", comp, back)
        finally:
            del os.environ["PHYNGSC_WALK"]
        if not same_files(paths[name], back):
            raise AssertionError(f"{name}: XLA-walk decompress not exact")
        os.unlink(back)
        t_k = cli("decompress", comp, back)
        os.unlink(back)
        mb = os.path.getsize(paths[name]) / MB
        log(f"[walk-timing] decompress {name} end to end, warm: kernel "
            f"{mb / t_k:.1f} MB/s ({t_k:.3f}s)  xla {mb / t_xla:.1f} MB/s "
            f"({t_xla:.3f}s)")

    # phase 6: tests marked gpu
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(os.path.dirname(os.path.abspath(
                          __file__)), "tests")])
    if rc != 0:
        raise AssertionError(f"tests marked gpu failed (pytest exit {rc})")
    log("[tests] gpu-marked tests passed")


def multi(work: str) -> None:
    import jax

    n = len(jax.devices())
    if n < 4:
        raise RuntimeError(f"--multi needs 4 GPUs, JAX sees {n}")
    src = os.path.join(work, "err36.fastq")
    size = write_corpus(src, 1100 * MB, chunk_records=900_000, read_len=36,
                        style="ERR005195", seed=100)
    log(f"[corpus] err36: {size / MB:.1f} MB")
    one = os.path.join(work, "one.ngsct")
    four = os.path.join(work, "four.ngsct")
    t1 = cli("compress", src, one)
    t4 = cli("compress", src, four, "--data-shards", "4")
    if not same_files(one, four):
        raise AssertionError("--data-shards 4 container differs from the "
                             "1-GPU container")
    log(f"[multi] --data-shards 4 container byte-identical to 1-GPU "
        f"({os.path.getsize(one)} B); compress {size / MB / t1:.1f} MB/s "
        f"(1 GPU) vs {size / MB / t4:.1f} MB/s (4 GPUs)")
    back = os.path.join(work, "four.back.fastq")
    from phyngsc_tpu.parallel import mesh

    mesh_calls = []
    orig = mesh.ShardedSubblockCodec.decode_walk

    def spy(self, *a, **kw):
        mesh_calls.append(kw.get("impl"))
        return orig(self, *a, **kw)

    mesh.ShardedSubblockCodec.decode_walk = spy
    td4 = [cli("decompress", four, back, "--data-shards", "4")
           for _ in range(2)]
    if not same_files(src, back):
        raise AssertionError("--data-shards 4 decompress not byte-exact")
    if not mesh_calls or any(c != "kernel" for c in mesh_calls):
        raise AssertionError(f"sharded decode did not run the kernel on the "
                             f"mesh: {set(mesh_calls)}")
    os.unlink(back)
    td1 = [cli("decompress", four, back) for _ in range(2)]
    log(f"[multi] --data-shards 4 decompress exact, {len(mesh_calls)} "
        f"sub-block decodes on the 4-GPU mesh; cold/warm "
        f"{size / MB / td4[0]:.1f}/{size / MB / td4[1]:.1f} MB/s vs "
        f"{size / MB / td1[0]:.1f}/{size / MB / td1[1]:.1f} MB/s on 1 GPU")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the 4-GPU --data-shards phase only")
    args = ap.parse_args()

    import jax

    from phyngsc_tpu import backend

    backend.enable_compile_cache()
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1
    log(card())                   # name, power limit as nvidia-smi gives them
    from phyngsc_tpu.utils import native

    log(f"[device] {backend.device_summary()}  host loops {native.summary()}")
    with tempfile.TemporaryDirectory(prefix="phyngsc_smoke_") as work:
        (multi if args.multi else single)(work)
    dev = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
