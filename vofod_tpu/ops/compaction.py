"""Fixed-capacity stream compaction without large scatters or sorts.

``masked_compact(mask, capacity)`` returns the flat indices of the first
``capacity`` set elements of a boolean grid.  This is the dense
replacement for the reference's dynamic containers (PCL index vectors,
std::vector<PointIndices>) and is the bridge from dense grids to the small
per-cluster computations of the classification stage.

It avoids ``top_k``, sorts, large scatters and full-array prefix sums (the
no-large-gather/scatter rule of DESIGN.md §1, chosen before GPU measurements
existed; ROADMAP.md §3.4 re-measures it).  Instead:

1. dense per-block totals (one fast reduce) + an exclusive scan over ~2.5k
   block totals (tiny),
2. per output slot, a dense rank over block starts ([capacity, nblocks]
   compare+sum) and a contiguous row-gather of the chosen blocks,
3. in-block running counts for JUST the gathered rows via one triangular
   matmul ([capacity, B] @ [B, B] — 0/1 rows, so f32 counts are exact),
   then a dense rank for the in-block position.

Everything is O(N + capacity*(nblocks+blocksize)) dense work plus one
row-gather of ``capacity`` contiguous 1k slices and one small matmul.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

_BLOCK = 1024


@functools.lru_cache(maxsize=None)
def _tri_np() -> np.ndarray:
    """[B, B] lower-triangular-inclusive ones: T[j, k] = 1 iff j <= k, so
    (rows @ T)[s, k] = #set elements in row s at or before column k.
    NumPy (not jnp) so the cache never captures a tracer."""
    i = np.arange(_BLOCK)
    return (i[:, None] <= i[None, :]).astype(np.float32)


def masked_compact(mask: Array, capacity: int) -> tuple[Array, Array, Array]:
    """Extract flat indices of set elements, in ascending index order.

    Args:
      mask: boolean array (any shape; flattened internally).
      capacity: static output size.

    Returns:
      (ids, valid, total):
        ids   int32 [capacity] — flat indices of the first ``capacity`` set
              elements (ascending); entries beyond ``total`` are clamped
              to 0 and flagged invalid.
        valid bool  [capacity] — slot validity.
        total int32 scalar — number of set elements in the whole mask
              (may exceed capacity; callers use this as the overflow signal).
    """
    flat = mask.reshape(-1).astype(jnp.int32)
    n = flat.shape[0]
    nb = -(-n // _BLOCK)
    padded = jnp.zeros((nb * _BLOCK,), jnp.int32).at[:n].set(flat)
    blocks = padded.reshape(nb, _BLOCK)
    btot = blocks.sum(axis=1)  # [nb]
    bstart = jnp.cumsum(btot) - btot  # exclusive prefix over blocks [nb]
    total = btot.sum()

    q = jnp.arange(capacity, dtype=jnp.int32)

    # block containing the q-th set element: last block with bstart <= q.
    # Dense vectorized rank instead of a scalar-gather binary search:
    # [capacity, nb] compare + row-sum.
    blk = (
        jnp.sum(bstart[None, :] <= q[:, None], axis=1).astype(jnp.int32) - 1
    )
    blk = jnp.maximum(blk, 0)
    local_rank = q - bstart[blk]  # 0-based rank inside block

    # position inside the block: first column with running count > rank.
    # Row-gather the needed 0/1 blocks (contiguous 1024-slices), build their
    # inclusive running counts with one triangular matmul, dense-rank the
    # position.  Default precision is exact here: 0/1 operands are exact in
    # bf16 and TF32 alike, and the f32 accumulator holds counts <= 1024
    # exactly.
    rows = blocks[blk].astype(jnp.float32)  # [capacity, _BLOCK]
    run_rows = jax.lax.dot(rows, jnp.asarray(_tri_np()))  # [capacity, _BLOCK]
    pos = jnp.sum(
        run_rows <= local_rank[:, None].astype(jnp.float32), axis=1
    ).astype(jnp.int32)
    ids = blk * _BLOCK + pos
    valid = q < total
    ids = jnp.where(valid, jnp.minimum(ids, n - 1), 0).astype(jnp.int32)
    return ids, valid, total.astype(jnp.int32)
