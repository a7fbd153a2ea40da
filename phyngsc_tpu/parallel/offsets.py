"""Deterministic block-placement protocol.

Replaces the reference's non-deterministic shared-file-pointer writes +
timestamp-ordering footer pass (C13/C14: MPI_File_write_shared
phyNGSC.cpp:875, MPI_Wtime :877, gather/sort/verify :934-1033). The reference
needed that protocol because ranks could not cheaply agree on block offsets
up front; here the block *sizes* are tiny metadata that ride device
collectives, so every writer computes its file offsets with an exclusive
prefix sum and `pwrite`s at deterministic positions. Ordering becomes
deterministic — strictly stronger than the reference's guarantee — while the
footer keeps the same block→writer metadata (CBO).

Two implementations, same math:
- `offsets_from_counts` — host-side (single process, W logical writers)
- `exchange_offsets_sharded` — `shard_map` collective over a mesh axis
  (all_gather over the device interconnect), used by the multi-chip path and the dry-run.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def offsets_from_counts(block_sizes_per_writer: Sequence[Sequence[int]]
                        ) -> Tuple[List[int], List[int]]:
    """Writer-major placement: returns (per-writer starting byte offset,
    CBO writer-per-block list in file order)."""
    offsets = []
    cbo: List[int] = []
    pos = 0
    for w, sizes in enumerate(block_sizes_per_writer):
        offsets.append(pos)
        pos += int(np.sum(np.asarray(sizes, dtype=np.int64))) if len(sizes) else 0
        cbo.extend([w] * len(sizes))
    return offsets, cbo


def exchange_offsets_sharded(mesh: Mesh, axis: str):
    """Returns a jitted fn: local block sizes (B,) int32 per device →
    (start_offset () int64-ish int32, all sizes (n_dev, B)).

    Each device learns every device's block sizes via all_gather and computes
    its own starting offset as the exclusive prefix sum — the collective
    equivalent of MPI_Gather + rank-0 ordering (phyNGSC.cpp:964-1009), except
    symmetric and deterministic.
    """

    n_dev = mesh.shape[axis]

    def body(local_sizes: jnp.ndarray):
        gathered = jax.lax.all_gather(local_sizes, axis, tiled=True)  # (n_dev*B,)
        totals = jnp.sum(gathered.reshape(n_dev, -1), axis=1)         # (n_dev,)
        my = jax.lax.axis_index(axis)
        start = jnp.sum(jnp.where(jnp.arange(n_dev) < my, totals, 0))
        # int32 on device; hosts widen to int64 byte offsets from the sizes
        return start.reshape(1).astype(jnp.int32), gathered.reshape(n_dev, -1)

    return jax.jit(
        shard_map(
            body, mesh=mesh, check_vma=False,
            in_specs=(P(axis),),
            out_specs=(P(axis), P()),
        )
    )
