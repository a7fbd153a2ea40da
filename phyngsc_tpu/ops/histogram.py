"""Batched per-position symbol histograms.

Replaces the reference's thread-local count loops + critical-section merge
(quality_stats accumulation, tasks.cpp:260-286 and the omp critical reduction
phyNGSC.cpp:622-653). On the device, histograms are a masked-compare
reduction over record chunks, accumulated with `lax.scan` so XLA can fuse
the (chunk × positions × alphabet) one-hot into the reduction. The cross-
device merge is a `psum` over the data mesh axis (see parallel/).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("alphabet_size", "chunk"))
def position_histogram(symbols: jnp.ndarray, valid: jnp.ndarray,
                       alphabet_size: int = 256, chunk: int = 2048) -> jnp.ndarray:
    """Per-position histogram.

    symbols (R, L) uint8/int32, valid (R, L) bool → counts (L, alphabet) int32,
    by a chunked lax.scan whose (chunk, L, A) one-hot compare is reduced
    inside each step.
    """
    R, L = symbols.shape
    pad = (-R) % chunk
    if pad:
        symbols = jnp.pad(symbols, ((0, pad), (0, 0)))
        valid = jnp.pad(valid, ((0, pad), (0, 0)))
    n_chunks = symbols.shape[0] // chunk
    sym = symbols.reshape(n_chunks, chunk, L).astype(jnp.int32)
    msk = valid.reshape(n_chunks, chunk, L)
    ids = jnp.arange(alphabet_size, dtype=jnp.int32)

    def step(acc, xs):
        s, m = xs
        onehot = (s[:, :, None] == ids[None, None, :]) & m[:, :, None]
        return acc + jnp.sum(onehot.astype(jnp.int32), axis=0), None

    init = jnp.zeros((L, alphabet_size), jnp.int32)
    counts, _ = jax.lax.scan(step, init, (sym, msk))
    return counts


@functools.partial(jax.jit, static_argnames=("alphabet_size", "chunk"))
def global_histogram(symbols: jnp.ndarray, valid: jnp.ndarray,
                     alphabet_size: int = 256, chunk: int = 2048) -> jnp.ndarray:
    """Whole-stream histogram (the reference's dna_occ / quality_stats[0] row,
    phyNGSC.cpp:595-598, tasks.cpp:280-284): counts (alphabet,) int32."""
    return jnp.sum(
        position_histogram(symbols, valid, alphabet_size, chunk), axis=0
    )
