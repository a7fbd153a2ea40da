"""Reference-container interop: build the REAL phyNGSC compressor (via the
fork-based mini-MPI shim), compress FASTQ with it, and byte-exactly recover
the input with our .ngsc importer — direct proof that the capability mapping
(SURVEY C4-C12) is semantically faithful, not just analogous.

The reference binary is cached at /tmp/phyngsc_ref_test; tests skip if the
toolchain or /root/reference is unavailable.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from phyngsc_tpu.container import ngsc_import

REF_SRC = "/root/reference"
REF_BIN = "/tmp/phyngsc_ref_test"
SHIM = os.path.join(os.path.dirname(__file__), "..", "native", "mpi_shim")


@pytest.fixture(scope="session")
def ref_binary():
    if not os.path.isdir(REF_SRC):
        pytest.skip("reference source unavailable")
    if not os.path.exists(REF_BIN):
        srcs = [os.path.join(REF_SRC, f)
                for f in ("phyNGSC.cpp", "tasks.cpp", "bit_stream.cpp",
                          "huffman.cpp")]
        cmd = ["g++", "-O2", "-fopenmp", "-std=c++11", "-I", SHIM,
               *srcs, os.path.join(SHIM, "mpi_shim.c"), "-o", REF_BIN]
        r = subprocess.run(cmd, capture_output=True)
        if r.returncode != 0:
            pytest.skip(f"reference build failed: {r.stderr[-500:]!r}")
    return REF_BIN


def _run_ref(binary, in_path, out_path, ranks=2, threads=2):
    env = dict(os.environ)
    env["MPI_SHIM_RANKS"] = str(ranks)
    r = subprocess.run([binary, str(in_path), str(out_path), str(threads)],
                       env=env, capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-1000:]


def _fastq(n, read_len=36, seed=0, iupac=0.0, var_len=False,
           qmin=33, qmax=40):
    rng = np.random.default_rng(seed)
    alphabet = b"ACGT" + (b"NYRWS" if iupac else b"")
    probs = None
    if iupac:
        probs = np.full(len(alphabet), iupac / (len(alphabet) - 4))
        probs[:4] = (1 - iupac) / 4
    recs = []
    tile = 1
    for i in range(n):
        if i % 100 == 0:
            tile += int(rng.integers(0, 3))
        L = int(rng.integers(20, read_len + 1)) if var_len else read_len
        seq = rng.choice(np.frombuffer(alphabet, np.uint8), size=L, p=probs)
        qual = rng.integers(qmin, qmax + 1, size=L).astype(np.uint8)
        recs.append(b"@SRR001.%d FC3:%d:%d:%d len=%d\n" % (
            i + 1, tile, int(rng.integers(0, 2048)),
            int(rng.integers(0, 2048)), L)
            + seq.tobytes() + b"\n+\n" + qual.tobytes() + b"\n")
    return b"".join(recs)


def _roundtrip(ref_binary, tmp_path, data, ranks=2):
    in_path = tmp_path / "in.fastq"
    ngsc_path = tmp_path / "out.ngsc"
    in_path.write_bytes(data)
    _run_ref(ref_binary, in_path, ngsc_path, ranks=ranks)
    got = ngsc_import.decompress_ngsc(ngsc_path.read_bytes())
    assert got == data


def test_import_basic(ref_binary, tmp_path):
    _roundtrip(ref_binary, tmp_path, _fastq(4000, seed=1))


def test_import_ambiguity_transfer(ref_binary, tmp_path):
    # IUPAC symbols with qualities in [33, 40] exercise the DNA→quality
    # ambiguity transfer (phyNGSC.cpp:573-588) and our restore inverse
    _roundtrip(ref_binary, tmp_path, _fastq(3000, seed=2, iupac=0.03))


def test_import_variable_length(ref_binary, tmp_path):
    _roundtrip(ref_binary, tmp_path, _fastq(3000, seed=3, var_len=True))


def test_import_huffman_dna(ref_binary, tmp_path):
    # skewed symbol counts defeat the plain-DNA rule (tasks.cpp:239-256):
    # one dominant base forces sym_tmp[0] > sym_tmp[2] + sym_tmp[3]
    rng = np.random.default_rng(4)
    recs = []
    for i in range(2000):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=36,
                         p=[0.94, 0.02, 0.02, 0.02])
        qual = rng.integers(33, 41, size=36).astype(np.uint8)
        recs.append(b"@H.%d x\n" % i + seq.tobytes() + b"\n+\n"
                    + qual.tobytes() + b"\n")
    _roundtrip(ref_binary, tmp_path, b"".join(recs))


def test_import_four_ranks(ref_binary, tmp_path):
    _roundtrip(ref_binary, tmp_path, _fastq(6000, seed=5), ranks=4)


def test_import_wide_quality(ref_binary, tmp_path):
    # full printable phred range → larger quality alphabet, deeper trees
    _roundtrip(ref_binary, tmp_path,
               _fastq(2500, seed=6, qmin=33, qmax=73))


def test_import_solid_refused(ref_binary, tmp_path):
    # SOLiD color-space: the reference encoder destroys the quality line
    # while delta-translating (phyNGSC.cpp:533-534) — the importer must
    # refuse loudly rather than emit wrong bytes
    rng = np.random.default_rng(7)
    recs = []
    for i in range(600):
        colors = rng.choice(np.frombuffer(b"0123", np.uint8), size=35)
        qual = rng.integers(33, 41, size=36).astype(np.uint8)
        recs.append(b"@S.%d x\nT" % i + colors.tobytes() + b"\n+\n"
                    + qual.tobytes() + b"\n")
    data = b"".join(recs)
    in_path = tmp_path / "in.fastq"
    ngsc_path = tmp_path / "out.ngsc"
    in_path.write_bytes(data)
    _run_ref(ref_binary, in_path, ngsc_path)
    with pytest.raises(ngsc_import.NgscUnsupportedError):
        ngsc_import.decompress_ngsc(ngsc_path.read_bytes())
