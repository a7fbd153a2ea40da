"""Benchmark: end-to-end FASTQ compression throughput on the current backend.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "MB/s", "extra": ...}
with the device it ran on (platform, kind, count) in "extra".

No speedup against the reference is computed: its only CPU measurement
(BASELINE_MEASURED.json, the reference built against the serial MPI shim in
native/mpi_shim, on a 2-vCPU host) was taken on another machine. It is
reported as-is under "extra.reference_cpu_measurement", with its host.

Protocol: 1 GB input by default, one warm pass, then the MEDIAN of 3 timed
passes on an otherwise-idle host is the recorded number.

Env knobs: BENCH_MB (default 1000), BENCH_VERIFY=0 to skip the round-trip
check, BENCH_WRITERS (default 2), BENCH_SHAPES=0 to skip the per-read-length
device rows, BENCH_SCALING=0 to skip the 1-vs-2-process CPU proxy,
BENCH_SCALING_MB (default 48).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time


def _device_encode_row(R, L, G, cfg, rec_bytes):
    """Device-only encode throughput at (R, L): analyze + encode graph,
    timed over n_it dispatches ended by block_until_ready."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from phyngsc_tpu.models import dna as dmod
    from phyngsc_tpu.models import quality as qmod
    from phyngsc_tpu.ops import bitpack as bpmod
    from phyngsc_tpu.ops import lookup as lkmod
    from phyngsc_tpu.ops import transfer as trmod
    from phyngsc_tpu.pipeline import subblock as sbmod

    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seq_np = acgt[rng.integers(0, 4, size=(R, L))]
    qual_np = rng.integers(33, 74, size=(R, L)).astype(np.uint8)
    s_mode, s_words = trmod.pack_seq_np(seq_np)
    q_mode, q_words = trmod.pack_qual_np(qual_np)
    d_small = trmod.seq_alpha_small(s_mode, seq_np)
    blob_in = jnp.array(np.concatenate([s_words, q_words]))
    lens = jnp.array(np.full(R, L, np.int32))
    seq, qual_t, keep, counts_blob = sbmod._analyze_all(
        blob_in, lens, seq_mode=s_mode, qual_mode=q_mode, L=L,
        d_small=d_small)
    counts = np.asarray(counts_blob)
    nq = min(L, qmod.MAX_TREES) * 256
    qc = counts[:nq].reshape(-1, 256)
    tables, q_group = qmod.build_tables_adaptive(qc, cfg)
    d_plan = dmod.plan(counts[nq:], cfg)
    d_group = (lkmod.group_for(int(d_plan.lens_tab.max()) or 1)
               if d_plan.mode == dmod.MODE_HUFFMAN else 2)
    S = R // G
    pack = bpmod.pack_mode()
    if pack == "rows":
        q_cap = d_cap = 0
    else:
        worst = sbmod._word_cap(R, L, G)
        q_cap = sbmod._exact_cap(
            qc, qmod.lens_rows_for(tables, qc.shape[0]), S, worst)
        d_lens_for_cap = (np.full(256, 2, np.int64)
                          if d_plan.mode == dmod.MODE_PLAIN else d_plan.lens_tab)
        d_cap = sbmod._exact_cap(counts[nq:], d_lens_for_cap, S, worst)
    qc_j = jnp.array(tables.codes)
    ql_j = jnp.array(tables.lens)
    dc_j = jnp.array(d_plan.codes_tab)
    dl_j = jnp.array(d_plan.lens_tab)

    def step():
        _, qt, kp, blob_c = sbmod._analyze_all(
            blob_in, lens, seq_mode=s_mode, qual_mode=q_mode, L=L,
            d_small=d_small)
        return sbmod._encode_all(
            qt, kp, seq, lens, qc_j, ql_j, dc_j, dl_j,
            d_plan.mode, G, q_cap, d_cap, q_group, d_group, pack)

    jax.block_until_ready(step())  # warm/compile
    n_it = 8
    t0 = time.perf_counter()
    for _ in range(n_it):
        r = step()
    jax.block_until_ready(r)
    per = (time.perf_counter() - t0) / n_it
    return R * rec_bytes / per / 1e6


def _device_decode_row(R, L, cfg, rec_bytes, seed=11):
    """Device-only decode throughput at (R, L): compress one sub-block of
    real synthesized data, hoist H2D, time the fused decode graph. Returns
    (MB/s, the decode walk that ran)."""
    import dataclasses

    import jax

    from phyngsc_tpu.container import block as blockmod
    from phyngsc_tpu.container import footer as footermod
    from phyngsc_tpu.pipeline import subblock as sbmod
    from phyngsc_tpu.pipeline.compress import compress_bytes
    from phyngsc_tpu.utils.fastq import synthesize_fastq

    cfg = dataclasses.replace(cfg, max_records_per_subblock=R)
    data = synthesize_fastq(R, read_len=L, seed=seed)
    comp = compress_bytes(data, cfg, 1)
    foot = footermod.read_footer(comp)
    sizes = foot.block_sizes_in_file_order()

    def blocks():
        off = 0
        for size, wid in zip(sizes, foot.cbo):
            yield wid, bytes(comp[off : off + size])
            off += size

    payload = next(iter(blockmod.iter_subblocks(blocks())))[1]
    # decode with the container's geometry (auto_substream may have shrunk
    # G for long reads; the real driver reads it from the footer)
    cfg = dataclasses.replace(
        cfg, records_per_substream=foot.records_per_substream)
    p = sbmod._decode_parse(payload, cfg)
    dev_in = sbmod._decode_device_inputs(p, cfg)
    jax.block_until_ready(sbmod._decode_device(p, dev_in, cfg))  # warm
    n_it = 8
    t0 = time.perf_counter()
    for _ in range(n_it):
        rr = sbmod._decode_device(p, dev_in, cfg)
    jax.block_until_ready(rr)
    per = (time.perf_counter() - t0) / n_it
    return p.R * rec_bytes / per / 1e6, p.walk


def _title_stage_mbps(data, cfg):
    """Host-side title encode/decode throughput (MB/s of raw input) on one
    bench-shaped sub-block."""
    import numpy as np

    from phyngsc_tpu.models import title
    from phyngsc_tpu.pipeline.subblock import _gather_matrix
    from phyngsc_tpu.utils.bitio import BitReader, BitWriter
    from phyngsc_tpu.utils.fastq import index_records

    buf = np.frombuffer(data, np.uint8)
    idx = index_records(buf[: 130 << 20] if buf.shape[0] > (130 << 20)
                        else buf)
    n = min(idx.n_records, 1 << 16)
    span = int(idx.qual_end[n - 1] + 1)
    tlens = (idx.title_end[:n] - idx.title_start[:n]).astype(np.int32)
    titles = _gather_matrix(buf, idx.title_start[:n],
                            tlens.astype(np.int64), int(tlens.max()))
    enc = title.encode(titles, tlens, cfg)  # warm
    t0 = time.perf_counter()
    for _ in range(3):
        enc = title.encode(titles, tlens, cfg)
    t_enc = (time.perf_counter() - t0) / 3
    bw = BitWriter()
    title.write_header(bw, enc)
    bw.flush()
    plan2, _, _, _sub = title.read_header(BitReader(bw.getvalue()), n)
    sub_np = np.asarray(enc.char_sub_n_words)
    title.decode(plan2, enc.fixed_words, enc.char_words, sub_np, n, cfg)
    t0 = time.perf_counter()
    for _ in range(3):
        title.decode(plan2, enc.fixed_words, enc.char_words, sub_np, n, cfg)
    t_dec = (time.perf_counter() - t0) / 3
    return round(span / t_enc / 1e6, 1), round(span / t_dec / 1e6, 1)


_PROXY_WORKER = r"""
import sys, time
import jax
jax.config.update("jax_platforms", "cpu")
n = int(sys.argv[2])
if n > 1:
    jax.distributed.initialize(coordinator_address=sys.argv[1],
                               num_processes=n, process_id=int(sys.argv[3]))
from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.parallel.distributed import (compress_file_distributed,
                                              decompress_file_distributed)
cfg = CodecConfig(records_per_substream=64)
# warm pass: compiles hit the persistent cache after the first process; the
# timed pass then measures the pipeline, not XLA compilation
compress_file_distributed(sys.argv[4], sys.argv[5], cfg)
decompress_file_distributed(sys.argv[5], sys.argv[6], cfg)
t0 = time.perf_counter()
compress_file_distributed(sys.argv[4], sys.argv[5], cfg)
t1 = time.perf_counter()
decompress_file_distributed(sys.argv[5], sys.argv[6], cfg)
t2 = time.perf_counter()
print("PROXY", t1 - t0, t2 - t1, flush=True)
"""


def _cpu_scaling_proxy(mb: float):
    """1-vs-2-process distributed compress+decompress on the CPU backend
    (the offset protocol and pwrite fan-out are exactly the multi-host
    path). Each process is pinned to its own core (taskset) so efficiency
    measures the protocol, not timeslicing: eff = p2_agg / (2 x
    p1_on_1_core).
    Workers run one warm pass first (compiles hit the shared persistent
    cache). Returns dict or None."""
    import shutil
    import socket
    import subprocess
    import tempfile

    from phyngsc_tpu.utils.fastq import synthesize_fastq

    rec = synthesize_fastq(int(mb * 1e6 / 121), read_len=36, seed=17)
    out = {"input_mb": round(len(rec) / 1e6, 2)}
    have_taskset = shutil.which("taskset") is not None
    out["core_pinned"] = have_taskset
    with tempfile.TemporaryDirectory() as td:
        in_path = os.path.join(td, "in.fastq")
        with open(in_path, "wb") as f:
            f.write(rec)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) \
            + os.pathsep + env.get("PYTHONPATH", "")
        def run_once(n):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                coord = f"127.0.0.1:{s.getsockname()[1]}"
            procs = [
                subprocess.Popen(
                    (["taskset", "-c", str(i)] if have_taskset else [])
                    + [sys.executable, "-c", _PROXY_WORKER, coord, str(n),
                       str(i), in_path, os.path.join(td, f"o{n}.ngsct"),
                       os.path.join(td, f"b{n}.fastq")],
                    env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL, text=True)
                for i in range(n)
            ]
            comp_s = dec_s = 0.0
            ok = True
            for p in procs:
                try:
                    o, _ = p.communicate(timeout=1200)
                except subprocess.TimeoutExpired:
                    p.kill()
                    ok = False
                    continue
                ok = ok and p.returncode == 0
                for line in (o or "").splitlines():
                    if line.startswith("PROXY"):
                        _, c, d = line.split()
                        comp_s = max(comp_s, float(c))
                        dec_s = max(dec_s, float(d))
            if not ok or not comp_s:
                return None
            with open(os.path.join(td, f"b{n}.fastq"), "rb") as f:
                if f.read() != rec:
                    return None
            return comp_s, dec_s

        for n in (1, 2):
            # best of 2: host background noise otherwise lands on one
            # configuration and skews the efficiency
            best = None
            for _ in range(2):
                r = run_once(n)
                if r is not None and (best is None or r[0] < best[0]):
                    best = (r[0], min(r[1], best[1]) if best else r[1])
            if best is None:
                return None
            out[f"p{n}_compress_mbps"] = round(len(rec) / best[0] / 1e6, 2)
            out[f"p{n}_decompress_mbps"] = round(len(rec) / best[1] / 1e6, 2)
    out["compress_efficiency_pct"] = round(
        100 * out["p2_compress_mbps"] / (2 * out["p1_compress_mbps"]), 1)
    out["decompress_efficiency_pct"] = round(
        100 * out["p2_decompress_mbps"] / (2 * out["p1_decompress_mbps"]), 1)
    return out


def main() -> int:
    import jax

    from phyngsc_tpu import backend
    from phyngsc_tpu.utils import native

    backend.enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

    # executable census: one trace event per distinct
    # (jaxpr, shapes) executable per process; backend compiles that missed
    # the persistent cache are counted separately
    import logging

    class _CompileCensus(logging.Handler):
        """Counts trace/compile events. `traced` includes the nested traces
        of jax's own jitted numpy operators (add/less/where/...), which fire
        by the hundreds INSIDE each big graph trace — r3's 718 was this, not
        jit-cache churn. `major` breaks out traces taking >= 5 ms (the real
        graph entries, one per distinct signature per process)."""

        def __init__(self):
            super().__init__(level=logging.DEBUG)
            self.traced = 0
            self.compiled = 0
            self.major = {}

        def emit(self, record):
            msg = record.getMessage()
            if "Finished tracing + transforming" in msg:
                self.traced += 1
                try:
                    head, t = msg.rsplit(" in ", 1)
                    if float(t.split()[0]) >= 0.005:
                        name = head.split(
                            "Finished tracing + transforming ", 1)[1]
                        name = name.split(" for ", 1)[0]
                        self.major[name] = self.major.get(name, 0) + 1
                except (ValueError, IndexError):
                    pass
            elif "Finished XLA compilation" in msg:
                self.compiled += 1

    census = _CompileCensus()
    jax.config.update("jax_log_compiles", True)  # events log at WARNING
    logging.getLogger("jax").addHandler(census)
    logging.getLogger("jax").propagate = False  # keep them off stderr

    from phyngsc_tpu.config import CodecConfig
    from phyngsc_tpu.pipeline.compress import compress_bytes
    from phyngsc_tpu.pipeline.decompress import decompress_bytes
    from phyngsc_tpu.utils.fastq import synthesize_fastq

    mb = float(os.environ.get("BENCH_MB", "1000"))
    n_writers = int(os.environ.get("BENCH_WRITERS", "2"))
    verify = os.environ.get("BENCH_VERIFY", "1") != "0"
    style = os.environ.get("BENCH_STYLE", "ERR005195")  # or "SRR" (76 bp)
    read_len = 76 if style == "SRR" else 36
    rec_bytes = 208 if style == "SRR" else 121

    # uniform device batches: split by record count, not bytes
    # (BENCH_SUBREC knob).
    sub_rec = int(os.environ.get("BENCH_SUBREC", str(1 << 16)))
    cfg = CodecConfig(
        subblock_input_bytes=1 << 30,
        max_records_per_subblock=sub_rec,
        records_per_substream=64,
    )
    # synthesis is python-format-bound (~7 MB/s); tile a ~100 MB chunk to
    # the target size. The codec is memoryless across sub-blocks, so
    # repeated content neither helps nor hurts ratio/throughput — verified
    # equal at 100 MB fresh vs tiled.
    t0 = time.perf_counter()
    chunk_mb = min(mb, 103.0)
    chunk = synthesize_fastq(int(chunk_mb * 1e6 / rec_bytes),
                             read_len=read_len, style=style, seed=7)
    reps = max(1, round(mb * 1e6 / len(chunk)))
    data = chunk * reps
    synth_s = time.perf_counter() - t0

    # per-stage budgets captured on the median runs
    os.environ["PHYNGSC_TIMING"] = "1"
    from phyngsc_tpu.pipeline import subblock as sbmod

    # warm-up: compile every kernel shape + one full pass
    t0 = time.perf_counter()
    comp = compress_bytes(data, cfg, n_writers)
    warm_s = time.perf_counter() - t0

    # MEDIAN of 3 timed passes
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        comp = compress_bytes(data, cfg, n_writers)
        runs.append((time.perf_counter() - t0, dict(sbmod.TIMING or {})))
    comp_s = statistics.median(r[0] for r in runs)
    comp_budget = next(b for t, b in runs if t == comp_s)

    t0 = time.perf_counter()
    back = decompress_bytes(comp)
    dwarm_s = time.perf_counter() - t0
    ok = (back == data) if verify else True
    del back
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        back = decompress_bytes(comp)
        runs.append((time.perf_counter() - t0, dict(sbmod.TIMING or {})))
        del back
    dec_s = statistics.median(r[0] for r in runs)
    dec_budget = next(b for t, b in runs if t == dec_s)

    # device-only throughput per read length; decode rows record the walk
    # that ran. A row that fails fails the bench.
    G = cfg.records_per_substream
    dev_rows = {}
    dev_mbps = dev_dec_mbps = None
    if os.environ.get("BENCH_SHAPES", "1") != "0":
        for (Rr, Ll) in ((65536, 36), (32768, 76), (24576, 100),
                         (2048, 1000)):
            rb = 2 * Ll + 40  # title ~36 B + newlines + '+' line
            dmb, walked = _device_decode_row(Rr, Ll, cfg, rb)
            dev_rows[f"{Ll}bp"] = {
                "encode_mbps": round(_device_encode_row(Rr, Ll, G, cfg, rb),
                                     1),
                "decode_mbps": round(dmb, 1),
                "walk": walked,
            }
        dev_mbps = dev_rows.get("36bp", {}).get("encode_mbps")
        dev_dec_mbps = dev_rows.get("36bp", {}).get("decode_mbps")

    # host-side title stage in isolation
    try:
        title_enc_mbps, title_dec_mbps = _title_stage_mbps(chunk, cfg)
    except Exception:
        title_enc_mbps = title_dec_mbps = None

    def _bytes(budget):
        """(h2d_mb, d2h_mb) from a stage budget; pops the byte counters so
        the printed budget stays seconds-only."""
        if not budget:
            return None, None
        return (round(budget.pop("h2d_bytes", 0.0) / 1e6, 2),
                round(budget.pop("d2h_bytes", 0.0) / 1e6, 2))

    c_h2d, c_d2h = _bytes(comp_budget)
    d_h2d, d_d2h = _bytes(dec_budget)

    mbps = len(data) / comp_s / 1e6
    dec_mbps = len(data) / dec_s / 1e6

    # ---- 1-vs-2-process CPU scaling proxy ---------------------------------
    scaling = None
    if os.environ.get("BENCH_SCALING", "1") != "0":
        try:
            scaling = _cpu_scaling_proxy(
                float(os.environ.get("BENCH_SCALING_MB", "48")))
        except Exception:
            scaling = None

    reference = None
    try:
        with open(os.path.join(os.path.dirname(__file__),
                               "BASELINE_MEASURED.json")) as f:
            ref = json.load(f)
        reference = {"compress_mbps": ref["compress_mbps"],
                     "config": ref["compress_mbps_config"],
                     "host": "2-vCPU CPU host, not this machine",
                     "measured_utc": ref["measured_utc"]}
    except (OSError, KeyError, ValueError):
        pass

    result = {
        "metric": "fastq_compress_throughput",
        "value": round(mbps, 3),
        "unit": "MB/s",
        "extra": {
            "input_mb": round(len(data) / 1e6, 2),
            "ratio": round(len(data) / len(comp), 3),
            "roundtrip_ok": ok,
            "warm_s": round(warm_s, 2),
            "decompress_mbps": round(dec_mbps, 3),
            "decompress_warm_s": round(dwarm_s, 2),
            "compress_budget_s": {k: round(v, 2)
                                  for k, v in (comp_budget or {}).items()},
            "decompress_budget_s": {k: round(v, 2)
                                    for k, v in (dec_budget or {}).items()},
            "compress_wall_s": round(comp_s, 3),
            "decompress_wall_s": round(dec_s, 3),
            "compress_transfer": {"h2d_mb": c_h2d, "d2h_mb": c_d2h},
            "decompress_transfer": {"h2d_mb": d_h2d, "d2h_mb": d_d2h},
            "synth_s": round(synth_s, 2),
            "synth_tiled": reps,
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())},
            "host_loops": native.summary(),
            "writers": n_writers,
            "reference_cpu_measurement": reference,
            "device_only_mbps": dev_mbps,
            "device_only_decode_mbps": dev_dec_mbps,
            "device_shapes": dev_rows,
            "title_stage_mbps": {"encode": title_enc_mbps,
                                 "decode": title_dec_mbps},
            "cpu_scaling_proxy": scaling,
            "executable_census": {
                "traced": census.traced,
                "xla_compiles": census.compiled,
                # one line per real graph entry (trace >= 5 ms); the rest of
                # `traced` is jax's jitted numpy operators re-tracing inside
                # these - not executable churn
                "major": dict(sorted(census.major.items(),
                                     key=lambda kv: -kv[1])),
            },
        },
    }
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
