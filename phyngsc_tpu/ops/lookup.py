"""Code-table lookups and code grouping for the stream encoders.

A per-position code-table lookup out[r, p] = tab[p, sym[r, p]] is one XLA
gather over fused (len << CODE_BITS) | code entries; `group_codes` and
`group_fixed2` then combine adjacent codes so the bitpack scatters fewer,
wider elements.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

#: fused entry layout: (len << CODE_BITS) | code
CODE_BITS = 12


def group_for(max_len: int) -> int:
    """Grouping factor for group_codes: the largest k with
    k * max_len <= 32, clamped to [2, 8]."""
    return max(2, min(32 // max(max_len, 1), 8))


def fuse_tables(codes, lens):
    """(T, A) uint32 codes + (T, A) uint8 lens → (T, A) int32 fused entries.
    Requires code < 2**CODE_BITS (i.e. max_code_len <= 12)."""
    return (lens.astype(jnp.int32) << CODE_BITS) | codes.astype(jnp.int32)


def window_np(counts) -> tuple:
    """Alphabet window (off, A) for a (..., 256) symbol-count array.

    Real alphabets occupy a narrow byte range (quality ~[33, 104], DNA
    letters ~[45, 89]), so the encoder uploads its tables sliced to
    A ∈ {64, 128, 256} columns starting
    at `off` and looks up clip(sym - off, 0, A-1). Safe whenever every
    symbol that can occur at an unmasked position has a nonzero count
    (callers mask invalid positions after the lookup, exactly as they
    already do at full width). A is bucketed so executables don't
    proliferate per dataset."""
    import numpy as np

    c = np.asarray(counts).reshape(-1, counts.shape[-1])
    nz = np.flatnonzero(c.any(axis=0))
    if nz.size == 0:
        return 0, 64
    width = int(nz[-1]) - int(nz[0]) + 1
    for A in (64, 128, 256):
        if width <= A:
            return min(int(nz[0]), c.shape[1] - A), A
    raise AssertionError("symbol alphabet exceeds 256")


@jax.jit
def fused_lookup(symbols: jnp.ndarray, fused_tab: jnp.ndarray) -> jnp.ndarray:
    """symbols (R, L) uint8/int32, fused_tab (L, A) int32 (one row per
    position; caller clamps tree indices) → fused entries (R, L) int32."""
    pos = jnp.arange(symbols.shape[1], dtype=jnp.int32)[None, :]
    return fused_tab[pos, symbols.astype(jnp.int32)]


def split_fused(fused: jnp.ndarray):
    """fused entries → (codes uint32, lens int32)."""
    return ((fused & ((1 << CODE_BITS) - 1)).astype(jnp.uint32),
            (fused >> CODE_BITS).astype(jnp.int32))


# ---------------------------------------------------------------------------
# Symbol pairing: halve the scatter count by emitting two codes per element.
# Bit layout is unchanged (first symbol occupies the higher bits), so decode
# is unaffected. Requires combined length <= 32 and combined code < 2^32:
# guaranteed for max_code_len <= 16.
# ---------------------------------------------------------------------------

@jax.jit
def pair_codes(codes: jnp.ndarray, lens: jnp.ndarray):
    """(R, L) → (R, ceil(L/2)) combined codes/lens."""
    return group_codes(codes, lens, 2)


@functools.partial(jax.jit, static_argnames=("k",))
def group_codes(codes: jnp.ndarray, lens: jnp.ndarray, k: int):
    """Combine k adjacent codes per element: (R, L) → (R, ceil(L/k)).

    Requires k * max_code_len <= 32 (the caller picks k = 32 //
    max_code_len) and that zero-length symbols carry code value 0 (the
    encoders mask invalid positions before grouping). Bit layout is
    unchanged — earlier symbols occupy higher bits — so decode is
    unaffected; the scatter count drops k×."""
    R, L = codes.shape
    pad = (-L) % k
    if pad:
        codes = jnp.pad(codes, ((0, 0), (0, pad)))
        lens = jnp.pad(lens, ((0, 0), (0, pad)))
    c = codes[:, 0::k].astype(jnp.uint32)
    l = lens[:, 0::k].astype(jnp.int32)
    for i in range(1, k):
        ci = codes[:, i::k].astype(jnp.uint32)
        li = lens[:, i::k].astype(jnp.int32)
        c = (c << jnp.clip(li, 0, 31).astype(jnp.uint32)) | ci
        l = l + li
    return c, l


@functools.partial(jax.jit, static_argnames=("group",))
def group_fixed2(values: jnp.ndarray, keep: jnp.ndarray, group: int = 16):
    """Pack 2-bit symbols in groups: (R, L) values/keep →
    (R, ceil(L/group)) codes/lens. Kept symbols concatenate MSB-first in
    position order; dropped positions contribute nothing. With group=16 the
    scatter count drops 16× for the DNA plain stream."""
    R, L = values.shape
    pad = (-L) % group
    v = jnp.pad(values.astype(jnp.uint32), ((0, 0), (0, pad)))
    k = jnp.pad(keep.astype(jnp.int32), ((0, 0), (0, pad)))
    Lp = v.shape[1]
    vg = v.reshape(R, Lp // group, group)
    kg = k.reshape(R, Lp // group, group)
    bits_before = (jnp.cumsum(kg, axis=2) - kg) * 2
    total = jnp.sum(kg, axis=2) * 2                      # (R, n_groups)
    shift = total[:, :, None] - bits_before - 2
    contrib = jnp.where(
        kg > 0, vg << jnp.clip(shift, 0, 31).astype(jnp.uint32), 0)
    return jnp.sum(contrib, axis=2).astype(jnp.uint32), total.astype(jnp.int32)