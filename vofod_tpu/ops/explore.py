"""Bounded flood-fill to ground: the exploreToGround kernel.

The reference decides whether a candidate cluster is *floating* by running,
from each cluster point, a DFS through "unknown-band" voxels
(frontiers < score <= new_obstacles), bounded by a Manhattan radius; touching
a ground voxel (score > new_obstacles) or the search shell means the point is
connected to ground (ref src/voxel_map.cpp:402-488, call site
src/vofod_nodelet.cpp:1692-1718).  Unknown voxels explored by a failed
(floating) search are demoted to the frontiers score (:1709-1716).

Dense formulation: each query extracts a fixed SxSxS submap around its voxel
(one dynamic_slice from a halo-padded grid) and runs a batched masked BFS —
iterated 6-neighbor dilation through the unknown band inside the Manhattan
ball — under one lax.while_loop for the whole query batch.  Reachability,
ground contact and shell contact are read off the converged masks.  This is
semantically the reference DFS evaluated *independently per query* (the
deterministic-schedule reading of SURVEY.md §7(c)); the reference's
order-dependent coupling, where demotions by earlier failed points can block
later points' searches within the same scan, is intentionally not reproduced.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from vofod_tpu.geometry import GridSpec


Array = jnp.ndarray


def explore_to_ground(
    grid: GridSpec,
    vmap_grid: Array,
    qx: Array,
    qy: Array,
    qz: Array,
    qvalid: Array,
    max_manhattan: Array,
    thr_frontiers: Array,
    thr_ground: Array,
    submap: int,
    max_iters: int = 96,
    *,
    z_halo: bool = False,
    z_off: Array | int = 0,
) -> tuple[Array, Array, Array]:
    """Batched bounded flood-fill.

    Args:
      vmap_grid: (nz, ny, nx) float32 occupancy-confidence grid.
      qx, qy, qz: [Q] int32 query voxel indices.
      qvalid: [Q] bool.
      max_manhattan: [Q] int32 per-query Manhattan bound
        (= (obb_size + max_explore_distance) / voxel, truncated like the
        reference's int cast at vofod_nodelet.cpp:1694).
      thr_frontiers / thr_ground: traced scalars (unknown/ground thresholds).
      submap: static submap side S; queries with 2*bound+1 > S are clamped
        (bound capped at S//2 - 1, conservative toward "connected").
      z_halo / z_off: grid-sharded mode (parallel/gridops.ZShardOps) —
        ``vmap_grid`` is a LOCAL z-shard already extended by S//2 halo rows
        on each side, and ``z_off`` is the shard's first global z row.  Only
        y/x get padded here; queries outside the shard produce clamped
        garbage that the caller discards by ownership.

    Returns:
      connected: [Q] bool — point is connected to ground (not floating).
      reached:   [Q, S, S, S] bool — explored unknown-band voxels
                 (the demotion set for floating points).
      corners:   [Q, 3] int32 — (z, y, x) submap corner in *grid* coords
                 (may be negative; write-back uses the same halo padding).
    """
    S = submap
    half = S // 2
    pad = half
    big_neg = jnp.float32(-1e30)  # outside-grid reads: certain air
    if z_halo:
        padded = jnp.pad(
            vmap_grid, ((0, 0), (pad, pad), (pad, pad)), constant_values=big_neg
        )
    else:
        padded = jnp.pad(vmap_grid, pad, constant_values=big_neg)

    bound = jnp.minimum(max_manhattan, half - 1)

    # submap extraction: padded[z0:z0+S, ...] with z0 = qz - half + pad = qz ...
    def extract(ix, iy, iz):
        return lax.dynamic_slice(
            padded,
            (iz - z_off - half + pad, iy - half + pad, ix - half + pad),
            (S, S, S),
        )

    # [Q, S, S*S] layout for the BFS: the (y, x) plane flattens into one
    # minor dimension (a layout choice that predates GPU measurements;
    # re-measure, ROADMAP.md §3.4).  x-shifts crossing a
    # row boundary are masked out (precomputed row masks).
    vals = jax.vmap(extract)(qx, qy, qz).reshape(-1, S, S * S)

    # Manhattan distance from the center voxel
    r = jnp.arange(S, dtype=jnp.int32) - half
    manh = (
        jnp.abs(r)[:, None, None]
        + jnp.abs(r)[None, :, None]
        + jnp.abs(r)[None, None, :]
    ).reshape(S, S * S)[None]  # [1, S, S²]

    unknown = (vals > thr_frontiers) & (vals <= thr_ground)
    ground = vals > thr_ground
    ball = manh <= bound[:, None, None]
    expandable = unknown & ball

    center = (
        jnp.zeros((S, S * S), jnp.bool_).at[half, half * S + half].set(True)[None]
    )
    reached0 = expandable & center

    col = jnp.arange(S * S, dtype=jnp.int32)
    ok_xp = (col % S) != S - 1  # +x neighbor stays in the row
    ok_xm = (col % S) != 0

    def dil6_flat(m):
        """6-neighbor dilation in the flat layout (exactly ops/morphology
        dilate6 on the unflattened view)."""
        zp = jnp.concatenate([m[:, 1:], jnp.zeros_like(m[:, :1])], axis=1)
        zm = jnp.concatenate([jnp.zeros_like(m[:, :1]), m[:, :-1]], axis=1)
        yp = jnp.concatenate([m[:, :, S:], jnp.zeros_like(m[:, :, :S])], axis=2)
        ym = jnp.concatenate([jnp.zeros_like(m[:, :, :S]), m[:, :, :-S]], axis=2)
        xp = jnp.concatenate([m[:, :, 1:], jnp.zeros_like(m[:, :, :1])], axis=2)
        xm = jnp.concatenate([jnp.zeros_like(m[:, :, :1]), m[:, :, :-1]], axis=2)
        return m | zp | zm | yp | ym | (xp & ok_xp) | (xm & ok_xm)

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    def body(state):
        cur, _, it = state
        new = cur | (expandable & dil6_flat(cur))
        return new, jnp.any(new != cur), it + 1

    reached, _, _ = lax.while_loop(cond, body, (reached0, jnp.bool_(True), jnp.int32(0)))

    # popped set = start ∪ (neighbors of reached unknowns within the ball)
    closure = center | (dil6_flat(reached) & ball)
    hit_ground = jnp.any(closure & ground, axis=(1, 2))
    hit_shell = jnp.any(
        reached & (manh == (bound - 1)[:, None, None]), axis=(1, 2)
    )
    reached = reached.reshape(-1, S, S, S)
    # grid-edge starts are "connected" by definition (ref voxel_map.cpp:410-414)
    at_edge = (
        (qx <= 0)
        | (qy <= 0)
        | (qz <= 0)
        | (qx >= grid.nx - 1)
        | (qy >= grid.ny - 1)
        | (qz >= grid.nz - 1)
    )
    connected = (hit_ground | hit_shell | at_edge) & qvalid
    corners = jnp.stack([qz - half, qy - half, qx - half], axis=-1).astype(jnp.int32)
    return connected, reached, corners


def apply_demotions(
    vmap_grid: Array,
    reached: Array,
    corners: Array,
    demote: Array,
    thr_frontiers: Array,
    *,
    z_halo: bool = False,
    z_off: Array | int = 0,
) -> Array:
    """Write explored-unknown voxels of failed searches back to the frontiers
    score (ref vofod_nodelet.cpp:1709-1716).  Sequential read-modify-write of
    SxSxS patches on a halo-padded copy (min-combine, so overlaps and repeats
    are idempotent — each covered voxel ends at min(value, thr) regardless of
    application order).

    With ``z_halo`` (grid-sharded mode), ``vmap_grid`` is a local z-shard
    already extended by S//2 rows each side; the updated z-extended array is
    returned (cropped in y/x only) so the caller can min-fold halo rows back
    onto their owning shards (parallel/gridops.ZShardOps.demote).  Queries
    whose ``demote`` flag is False write their patch back unchanged, so
    clamped out-of-shard slices are harmless no-ops.
    """
    Q, S = reached.shape[0], reached.shape[1]
    pad = S // 2
    if z_halo:
        padded = jnp.pad(
            vmap_grid, ((0, 0), (pad, pad), (pad, pad)),
            constant_values=jnp.float32(0),
        )
    else:
        padded = jnp.pad(vmap_grid, pad, constant_values=jnp.float32(0))

    # iterate only over the queries that actually demote: the sequential
    # read-modify-write is the cost (each patch op is tiny but serialized),
    # and demoting queries are typically a handful out of Q slots.  The
    # compaction of a [Q] mask is negligible; the fori bound is traced
    # (lowers to while), trading unrolling for ~Q/n_demote fewer steps.
    from vofod_tpu.ops.compaction import masked_compact

    dids, _, dtotal = masked_compact(demote, Q)

    def body(i, acc):
        k = dids[i]
        z0 = corners[k, 0] - z_off + pad
        y0 = corners[k, 1] + pad
        x0 = corners[k, 2] + pad
        patch = lax.dynamic_slice(acc, (z0, y0, x0), (S, S, S))
        mask = reached[k] & demote[k]
        new = jnp.where(mask, jnp.minimum(patch, thr_frontiers), patch)
        return lax.dynamic_update_slice(acc, new, (z0, y0, x0))

    padded = lax.fori_loop(0, jnp.minimum(dtotal, Q), body, padded)
    nz, ny, nx = vmap_grid.shape
    if z_halo:
        return padded[:, pad : pad + ny, pad : pad + nx]
    return padded[pad : pad + nz, pad : pad + ny, pad : pad + nx]
