"""GPU-only checks: the walk kernel as compiled for the card. They skip on
the CPU; on the card run `python -m pytest tests/ -m gpu` (chip_smoke.py
runs them)."""

import numpy as np
import pytest

import jax.numpy as jnp

from phyngsc_tpu import backend
from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.models import quality
from phyngsc_tpu.ops import bitpack, walk

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("R,L,G", [(8192, 36, 64), (512, 1000, 8)])
def test_walk_kernel_compiled_matches_host_walk(R, L, G):
    rng = np.random.default_rng(R + L)
    qual = rng.integers(33, 74, size=(R, L)).astype(np.uint8)
    lens = np.full(R, L, np.int32)
    lens[::3] = L // 2
    valid = np.arange(L)[None, :] < lens[:, None]
    qual = np.where(valid, qual, 0).astype(np.uint8)
    tabs, group = quality.build_tables_adaptive(
        np.asarray(quality.analyze(jnp.asarray(qual), jnp.asarray(lens))),
        CodecConfig())
    words, sub, _ = quality.encode_device(
        jnp.asarray(qual), jnp.asarray(lens), jnp.asarray(tabs.codes),
        jnp.asarray(tabs.lens), G, R * L // 2 + R // G + 8, group)
    sub = np.asarray(sub)
    S, T = R // G, G * L
    start = np.concatenate([[0], np.cumsum(sub)[:-1]]).astype(np.int32)
    tree = np.asarray(quality.tree_of_position(
        jnp.arange(T, dtype=jnp.int32) % L, tabs.n_trees, L))
    mask = valid.reshape(S, T).T
    luts = tabs.luts(12)
    ref = bitpack.unpack_substreams_np(
        np.asarray(words)[: int(sub.sum())], start, luts,
        np.broadcast_to(tree, (S, T)), mask.T, T, 12).T
    got = np.asarray(walk.walk_slots_kernel(
        words, jnp.asarray(start), jnp.asarray(luts), jnp.asarray(tree),
        jnp.asarray(mask), 12))
    np.testing.assert_array_equal(got, np.where(mask, ref, 0))
    np.testing.assert_array_equal(got, qual.reshape(S, T).T)


def test_decode_runs_compiled_kernel(monkeypatch):
    from phyngsc_tpu.pipeline import subblock
    from phyngsc_tpu.pipeline.compress import compress_bytes
    from phyngsc_tpu.pipeline.decompress import decompress_bytes
    from phyngsc_tpu.utils.fastq import synthesize_fastq

    monkeypatch.delenv("PHYNGSC_WALK", raising=False)
    assert backend.walk_impl() == backend.KERNEL
    seen = []
    orig = subblock._decode_walk_fused

    def spy(*a, **kw):
        seen.append(kw.get("impl"))
        return orig(*a, **kw)

    monkeypatch.setattr(subblock, "_decode_walk_fused", spy)
    data = synthesize_fastq(20000, read_len=76, style="SRR", seed=5,
                            variable_length=True)
    cfg = CodecConfig(subblock_input_bytes=1 << 20)
    assert decompress_bytes(compress_bytes(data, cfg)) == data
    assert seen and set(seen) == {backend.KERNEL}
