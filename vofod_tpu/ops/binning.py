"""Point-to-voxel binning: the VoxelGridWeighted / VoxelGridCounted analogue.

The reference downsamples each scan to one point per occupied voxel carrying
the point count as a weight, via sort + run-length segmentation on CPU
(src/voxel_grid_weighted.cpp:119-190).  Because our bins ARE the global map
lattice, the whole op collapses to a histogram: a scatter-add of ones into the
dense count grid.  The grid-alignment machinery of the reference
(setVoxelAlign, voxel_grid_weighted.cpp:80-106) vanishes by construction.

VoxelGridCounted (src/voxel_grid_counted.cpp:176-195) is the same histogram
with a second thresholded-value channel; it is only needed by the separated-
background maintenance, which in this design works directly on dense masks
(see pipeline/sepclusters.py), so only the generic helper lives here.
"""

from __future__ import annotations

import jax.numpy as jnp

from vofod_tpu.geometry import GridSpec

Array = jnp.ndarray


def point_fids(
    grid: GridSpec, pts: Array, valid: Array
) -> tuple[Array, Array]:
    """Shared point→voxel-id front half of the binning scatter: clamped flat
    ids + in-bounds mask.  Both the dense histogram below and the Z-sharded
    scatter (parallel/gridops.ZShardOps.bin_points) build on this, so the
    masking/clipping semantics can never diverge between the two providers.

    Returns (fid int32 [N] clamped into the grid, inb bool [N])."""
    ix, iy, iz = grid.coord_to_idx(pts)
    inb = grid.in_limits_idx(ix, iy, iz) & valid
    fid = grid.flat_id(
        jnp.clip(ix, 0, grid.nx - 1),
        jnp.clip(iy, 0, grid.ny - 1),
        jnp.clip(iz, 0, grid.nz - 1),
    )
    return fid, inb


def bin_points(
    grid: GridSpec, pts: Array, valid: Array, weights: Array | None = None
) -> Array:
    """Histogram points into the voxel grid.

    Args:
      grid: grid geometry.
      pts: [N, 3] world-frame points.
      valid: [N] bool — invalid points are dropped (the fixed-shape
        replacement of the reference's CropBox compaction,
        vofod_nodelet.cpp:626-655).
      weights: optional [N] per-point weights (default 1).

    Returns:
      counts: int32 (nz, ny, nx) — number of (weighted) points per voxel.
      The weighted-downsample "cloud" of the reference is exactly
      {voxel centers of counts>0, weight=counts}.
    """
    fid, inb = point_fids(grid, pts, valid)
    if weights is None:
        w = inb.astype(jnp.int32)
    else:
        w = jnp.where(inb, weights, 0).astype(jnp.int32)
    # single flat scatter-add over the 131k points
    counts = jnp.zeros((grid.n_voxels,), jnp.int32).at[fid].add(
        w, mode="drop", indices_are_sorted=False
    )
    return counts.reshape(grid.shape)


def bin_points_multi(
    grid: GridSpec, pts: Array, channel_weights: Array
) -> Array:
    """Multi-channel histogram in ONE scatter: channel_weights [N, C] ->
    int32 [C, nz, ny, nx].  Scatter indexing dominates the cost, so fusing
    the filtered-counts and raycast-blocker channels roughly halves the
    frontend's scatter time."""
    ix, iy, iz = grid.coord_to_idx(pts)
    inb = grid.in_limits_idx(ix, iy, iz)
    fid = grid.flat_id(
        jnp.clip(ix, 0, grid.nx - 1),
        jnp.clip(iy, 0, grid.ny - 1),
        jnp.clip(iz, 0, grid.nz - 1),
    )
    w = jnp.where(inb[:, None], channel_weights, 0).astype(jnp.int32)  # [N, C]
    c = channel_weights.shape[1]
    flat = jnp.zeros((grid.n_voxels, c), jnp.int32).at[fid].add(w, mode="drop")
    return jnp.moveaxis(flat.reshape(grid.shape + (c,)), -1, 0)


def voxel_grid_counted(
    pts: Array,
    intensity: Array,
    valid: Array,
    leaf_size: float,
    threshold: Array | float,
    origin=(0.0, 0.0, 0.0),
    out_shape: tuple[int, int, int] = (64, 64, 64),
    compat_indexing: bool = False,
) -> tuple[Array, Array]:
    """Standalone VoxelGridCounted parity op (ref src/voxel_grid_counted.cpp).

    Coarse-bins intensity-carrying points; per occupied cell returns the
    total point count and the count of points with ``intensity > threshold``
    (the reference's ``range`` output channel, :176-195).

    ``compat_indexing`` reproduces the reference's 4th-pass indexing quirk
    bug-for-bug (:185-187): the reference counts over ``input_->points[
    first_index..last_index)`` where first/last are positions in the
    *sorted-by-cell-id index vector*, not remapped point indices — so each
    cell's "sure" count is actually taken over the raw input points whose
    positions fall in that cell's sorted-rank range.  Unless the input
    happens to be ordered by ascending cell id, counts are permuted across
    cells (only the total is preserved).  Dense formulation via prefix sums:
    quirk_count(c) = S[first_c + count_c] - S[first_c] with S the inclusive
    prefix of ``intensity > threshold`` over raw input order and first_c the
    exclusive prefix of per-cell counts in ascending cell-id order
    (PCL ids are x-fastest, matching this grid's (z, y, x) ravel).

    Returns (counts, sure_counts), each int32 with ``out_shape`` (z, y, x)
    cells of size ``leaf_size`` anchored at ``origin``.
    """
    g = GridSpec(tuple(float(o) for o in origin), tuple(out_shape), float(leaf_size))
    ix, iy, iz = g.coord_to_idx(pts)
    inb = g.in_limits_idx(ix, iy, iz) & valid
    fid = g.flat_id(
        jnp.clip(ix, 0, g.nx - 1), jnp.clip(iy, 0, g.ny - 1), jnp.clip(iz, 0, g.nz - 1)
    )
    if compat_indexing:
        counts = (
            jnp.zeros((g.n_voxels,), jnp.int32)
            .at[fid]
            .add(inb.astype(jnp.int32), mode="drop")
        )
        first = jnp.cumsum(counts) - counts  # exclusive, ascending cell id
        s = jnp.concatenate(
            [
                jnp.zeros((1,), jnp.int32),
                jnp.cumsum((intensity > threshold).astype(jnp.int32)),
            ]
        )  # raw input order, invalid points included (ref indexes the raw array)
        sure_counts = jnp.where(counts > 0, s[first + counts] - s[first], 0)
        return counts.reshape(g.shape), sure_counts.reshape(g.shape)
    sure = inb & (intensity > threshold)
    w = jnp.stack([inb, sure], axis=-1).astype(jnp.int32)
    flat = jnp.zeros((g.n_voxels, 2), jnp.int32).at[fid].add(w, mode="drop")
    out = flat.reshape(g.shape + (2,))
    return out[..., 0], out[..., 1]
