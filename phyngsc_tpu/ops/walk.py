"""Slot-masked LUT walk: the decode hot path.

Every quality symbol and every Huffman-coded base is decoded here. The
stream is cut into S substreams (word-aligned, independent), and each
substream is a lane. Decode step t is an output SLOT shared by all lanes:
slot t of lane s consumes the lane's next code iff mask[t, s] is set,
emitting its symbol there (unset slots emit 0 and do not advance). With
slots laid out as (record-in-substream g, position p), decoded symbols land
directly in (R, L) order, so no step -> (record, position) gather is needed.
Each slot's decode table is shared by the lanes (step_tree[t]: the quality
tree of position p, or tree 0 for DNA).

One step of one lane: gather the two window words at the lane's cursor,
look the top `lut_bits` bits up in the slot's table (a packed
(len << 9) | sym int32 entry, huffman.decode_lut layout), and advance the
cursor by len. The steps of a lane are a dependent chain, so the lanes are
the only parallelism.

Two implementations with identical outputs:

- ``walk_slots_kernel``: a Pallas kernel through Triton. One program per
  block of LANES lanes runs the whole step loop; the next window word is
  loaded a step ahead, so only the table lookup sits on the dependency
  chain. Tables (4096 int32 entries = 16 KB per tree) stay cache-resident.
  Stores are step-major, so neighbouring lanes store together.
- ``walk_slots_xla``: the same loop as a ``lax.fori_loop`` of gathers over
  all lanes. Each iteration is a round of device launches on a GPU, so this
  is the CPU path (backend.walk_impl).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from phyngsc_tpu import backend

#: substream lanes per kernel program (one warp: a lane per thread)
LANES = 32


def _window(w1, w2, b):
    """32-bit window starting b bits into w1 (w2 follows w1). Shifts by 32
    are undefined on the GPU, so the w2 shift is clamped and its result
    dropped at b == 0."""
    hi = w1 << b.astype(jnp.uint32)
    sh = jnp.minimum(32 - b, 31).astype(jnp.uint32)
    return hi | jnp.where(b == 0, jnp.uint32(0), w2 >> sh)


def _nonempty(words):
    """words as uint32, with one zero word when there are none: zero-bit
    singleton trees give streams without payload words, and every lane
    still loads its window."""
    words = words.astype(jnp.uint32)
    return words if words.shape[0] else jnp.zeros((1,), jnp.uint32)


def _walk_kernel(words_ref, start_ref, lut_ref, tree_ref, mask_ref, out_ref,
                 *, lut_bits: int, n_steps: int, n_words: int, sp: int):
    lanes = pl.program_id(0) * LANES + jnp.arange(LANES, dtype=jnp.int32)
    base = start_ref[lanes]
    last = n_words - 1
    w1 = words_ref[jnp.minimum(base, last)]
    w2 = words_ref[jnp.minimum(base + 1, last)]
    shift = jnp.uint32(32 - lut_bits)

    def step(t, carry):
        wi, bi, w1, w2 = carry
        # the word after the window, fetched ahead: its address is known
        # before this step's lookup resolves
        w3 = words_ref[jnp.minimum(base + wi + 2, last)]
        idx = (_window(w1, w2, bi) >> shift).astype(jnp.int32)
        entry = lut_ref[(tree_ref[t] << lut_bits) + idx]
        take = mask_ref[t * sp + lanes] != 0
        out_ref[t * sp + lanes] = jnp.where(take, entry & 0x1FF, 0)
        b2 = bi + jnp.where(take, entry >> 9, 0)
        # codes are <= 15 bits, so a step advances at most one word
        adv = (b2 >> 5) != 0
        return (wi + (b2 >> 5), b2 & 31,
                jnp.where(adv, w2, w1), jnp.where(adv, w3, w2))

    zero = jnp.zeros((LANES,), jnp.int32)
    jax.lax.fori_loop(0, n_steps, step, (zero, zero, w1, w2))


@functools.partial(jax.jit, static_argnames=("lut_bits", "interpret"))
def walk_slots_kernel(words, sub_word_start, luts, step_tree, mask,
                      lut_bits: int, interpret: bool = False):
    """Pallas/Triton slot walk; see the module docstring.

    words          (W,) uint32 — substreams' words
    sub_word_start (S,) int32  — each lane's first word in `words`
    luts           (n_trees, 2**lut_bits) int32 packed decode tables
    step_tree      (T,) int32  — table of each slot
    mask           (T, S) bool — slot consumes the lane's next code
    Returns (T, S) int32 symbols, 0 at unset slots."""
    T, S = mask.shape
    words = _nonempty(words)
    sp = max(LANES, -(-S // LANES) * LANES)
    start = jnp.pad(sub_word_start.astype(jnp.int32), (0, sp - S))
    m = jnp.pad(mask.astype(jnp.int8), ((0, 0), (0, sp - S)))
    out = pl.pallas_call(
        functools.partial(_walk_kernel, lut_bits=lut_bits, n_steps=T,
                          n_words=words.shape[0], sp=sp),
        out_shape=jax.ShapeDtypeStruct((T * sp,), jnp.int32),
        grid=(sp // LANES,),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="phyngsc_walk_slots",
    )(words, start, luts.astype(jnp.int32).reshape(-1),
      step_tree.astype(jnp.int32), m.reshape(-1))
    return out.reshape(T, sp)[:, :S]


@functools.partial(jax.jit, static_argnames=("lut_bits",))
def walk_slots_xla(words, sub_word_start, luts, step_tree, mask,
                   lut_bits: int):
    """XLA twin of walk_slots_kernel (same arguments, same output)."""
    T, S = mask.shape
    words = _nonempty(words)
    last = words.shape[0] - 1
    start = sub_word_start.astype(jnp.int32)
    luts = luts.astype(jnp.int32)
    shift = jnp.uint32(32 - lut_bits)

    def step(t, carry):
        wi, bi, out = carry
        base = start + wi
        w1 = words[jnp.minimum(base, last)]
        w2 = words[jnp.minimum(base + 1, last)]
        idx = (_window(w1, w2, bi) >> shift).astype(jnp.int32)
        entry = luts[step_tree[t], idx]
        take = mask[t]
        out = out.at[t].set(jnp.where(take, entry & 0x1FF, 0))
        b2 = bi + jnp.where(take, entry >> 9, 0)
        return wi + (b2 >> 5), b2 & 31, out

    zero = jnp.zeros((S,), jnp.int32)
    _, _, out = jax.lax.fori_loop(
        0, T, step, (zero, zero, jnp.zeros((T, S), jnp.int32)))
    return out


def walk_slots(words, sub_word_start, luts, step_tree, mask, lut_bits: int,
               impl: str):
    """Slot walk by implementation name (backend.walk_impl)."""
    if impl == backend.XLA:
        return walk_slots_xla(words, sub_word_start, luts, step_tree, mask,
                              lut_bits)
    if impl not in (backend.KERNEL, backend.INTERPRET):
        raise ValueError(f"unknown walk implementation {impl!r}")
    return walk_slots_kernel(words, sub_word_start, luts, step_tree, mask,
                             lut_bits, interpret=impl == backend.INTERPRET)
