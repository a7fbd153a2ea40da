"""Multi-process compression over a 2-process CPU "pod slice"
(SURVEY §4 layering (d): jax.distributed with the CPU backend standing in
for multi-host)."""

import os
import socket
import subprocess
import sys

import pytest

from phyngsc_tpu.pipeline.decompress import decompress_bytes
from phyngsc_tpu.utils.fastq import synthesize_fastq

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=sys.argv[1],
                           num_processes=2, process_id=int(sys.argv[2]))
from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.parallel.distributed import (compress_file_distributed,
                                              decompress_file_distributed)
cfg = CodecConfig(subblock_input_bytes=64 << 10, records_per_substream=16)
compress_file_distributed(sys.argv[3], sys.argv[4], cfg)
# mirror: N-process decompression of the container just written (each
# process decodes its writer subset and pwrites at absolute offsets)
decompress_file_distributed(sys.argv[4], sys.argv[5], cfg)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_compress(tmp_path):
    data = synthesize_fastq(1500, read_len=36, seed=31)
    in_path = tmp_path / "in.fastq"
    out_path = tmp_path / "out.ngsct"
    back_path = tmp_path / "back.fastq"
    in_path.write_bytes(data)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, coord, str(i), str(in_path),
             str(out_path), str(back_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=210)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        if os.environ.get("PHYNGSC_ALLOW_DIST_SKIP"):
            pytest.skip("jax.distributed did not come up in this environment")
        raise AssertionError(
            "jax.distributed 2-process run timed out. This test passes on "
            "the dev image; set PHYNGSC_ALLOW_DIST_SKIP=1 only on "
            "environments known to lack loopback multiprocessing.")
    for rc, out, err in outs:
        if (rc != 0 and b"distributed" in err.lower()
                and b"initialize" in err.lower()
                and os.environ.get("PHYNGSC_ALLOW_DIST_SKIP")):
            pytest.skip(f"jax.distributed unavailable: {err[-200:]!r}")
        assert rc == 0, err.decode()[-2000:]
    blob = out_path.read_bytes()
    assert decompress_bytes(blob) == data
    # the 2-process distributed decode must agree byte-exactly too
    assert back_path.read_bytes() == data


_WORKER_LONG = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=sys.argv[1],
                           num_processes=2, process_id=int(sys.argv[2]))
from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.parallel.distributed import compress_file_distributed
# defaults: auto_substream must resolve the SAME G on every rank (each peeks
# the same first record), or the shared container would be inconsistent
cfg = CodecConfig(subblock_input_bytes=256 << 10)
compress_file_distributed(sys.argv[3], sys.argv[4], cfg)
"""


def test_two_process_auto_substream_consistent(tmp_path):
    """Long-read multi-process compression: every rank resolves the same
    auto substream width from the shared input's first record, the footer
    records it, and the container round-trips."""
    rng_data = synthesize_fastq(600, read_len=1000, seed=47)
    in_path = tmp_path / "long.fastq"
    out_path = tmp_path / "long.ngsct"
    in_path.write_bytes(rng_data)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER_LONG, coord, str(i),
             str(in_path), str(out_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)
    ]
    try:
        for p in procs:
            out, err = p.communicate(timeout=210)
            assert p.returncode == 0, err.decode()[-2000:]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        if os.environ.get("PHYNGSC_ALLOW_DIST_SKIP"):
            pytest.skip("jax.distributed unavailable")
        raise
    from phyngsc_tpu.container import footer as footermod

    blob = out_path.read_bytes()
    assert footermod.read_footer(blob).records_per_substream == 8
    assert decompress_bytes(blob) == rng_data
