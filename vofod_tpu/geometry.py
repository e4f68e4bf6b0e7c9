"""Grid geometry core: coordinate <-> index math, limits, SE(3) helpers.

Equivalent of the reference VoxelMap's coordinate layer
(src/voxel_map.cpp:592-619 coordToIdx/idxToCoord, :288-303 inLimits).

Grid arrays are stored as ``(nz, ny, nx)`` with X as the fastest-varying
(minor) dimension, the longest axis of every supported operation area.

Flat voxel ids are ``(z * ny + y) * nx + x`` and are used as cluster labels by
the connected-components kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
from jax import lax

Array = jnp.ndarray


@dataclass(frozen=True)
class GridSpec:
    """Static description of the dense voxel grid (hashable)."""

    origin: tuple[float, float, float]  # world coords of the low corner of voxel 0,0,0
    shape: tuple[int, int, int]  # (nz, ny, nx)
    voxel_size: float

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_center(center, dimensions, voxel_size: float) -> "GridSpec":
        """ref VoxelMap::resize(center, dims, vs) (voxel_map.cpp:11-19):
        offset = center - dims/2; sizes = ceil(dims/vs) + 1."""
        cx, cy, cz = (float(v) for v in center)
        dx, dy, dz = (float(v) for v in dimensions)
        origin = (cx - dx / 2.0, cy - dy / 2.0, cz - dz / 2.0)
        nx = int(np.ceil(dx / voxel_size)) + 1
        ny = int(np.ceil(dy / voxel_size)) + 1
        nz = int(np.ceil(dz / voxel_size)) + 1
        return GridSpec(origin, (nz, ny, nx), float(voxel_size))

    @staticmethod
    def from_config(cfg) -> "GridSpec":
        return GridSpec(cfg.grid_origin, cfg.grid_shape, cfg.voxel_size)

    # -- derived constants ---------------------------------------------------
    @property
    def nz(self) -> int:
        return self.shape[0]

    @property
    def ny(self) -> int:
        return self.shape[1]

    @property
    def nx(self) -> int:
        return self.shape[2]

    @property
    def n_voxels(self) -> int:
        return self.nz * self.ny * self.nx

    @property
    def inv_voxel(self) -> float:
        return 1.0 / self.voxel_size

    # -- coordinate math (all element-wise, jit-safe) -------------------------
    def coord_to_idx(self, xyz: Array) -> tuple[Array, Array, Array]:
        """World coords [..., 3] -> integer voxel indices (ix, iy, iz).

        ``idx = floor((coord - origin) / voxel)`` (ref voxel_map.cpp:592-599).
        Indices may lie outside the grid; combine with :meth:`in_limits_idx`.
        """
        ox, oy, oz = self.origin
        inv = self.inv_voxel
        ix = jnp.floor((xyz[..., 0] - ox) * inv).astype(jnp.int32)
        iy = jnp.floor((xyz[..., 1] - oy) * inv).astype(jnp.int32)
        iz = jnp.floor((xyz[..., 2] - oz) * inv).astype(jnp.int32)
        return ix, iy, iz

    def idx_to_coord(self, ix: Array, iy: Array, iz: Array) -> Array:
        """Voxel indices -> world coords of the voxel *center*
        (ref voxel_map.cpp:607-613: ``(idx + 0.5) * voxel + origin``)."""
        ox, oy, oz = self.origin
        vs = self.voxel_size
        x = (ix.astype(jnp.float32) + 0.5) * vs + ox
        y = (iy.astype(jnp.float32) + 0.5) * vs + oy
        z = (iz.astype(jnp.float32) + 0.5) * vs + oz
        return jnp.stack([x, y, z], axis=-1)

    def in_limits_idx(self, ix: Array, iy: Array, iz: Array) -> Array:
        return (
            (ix >= 0)
            & (ix < self.nx)
            & (iy >= 0)
            & (iy < self.ny)
            & (iz >= 0)
            & (iz < self.nz)
        )

    def in_limits(self, xyz: Array) -> Array:
        ix, iy, iz = self.coord_to_idx(xyz)
        return self.in_limits_idx(ix, iy, iz)

    def flat_id(self, ix: Array, iy: Array, iz: Array) -> Array:
        """Flat voxel id for (z, y, x)-ordered grids."""
        return (iz * self.ny + iy) * self.nx + ix

    def unflatten_id(self, fid: Array) -> tuple[Array, Array, Array]:
        ix = fid % self.nx
        rem = fid // self.nx
        iy = rem % self.ny
        iz = rem // self.ny
        return ix, iy, iz

    def voxel_centers(self) -> tuple[Array, Array, Array]:
        """Broadcastable world-coordinate center grids (x, y, z), each shaped
        to broadcast against a (nz, ny, nx) grid array."""
        ox, oy, oz = self.origin
        vs = self.voxel_size
        xs = (jnp.arange(self.nx, dtype=jnp.float32) + 0.5) * vs + ox
        ys = (jnp.arange(self.ny, dtype=jnp.float32) + 0.5) * vs + oy
        zs = (jnp.arange(self.nz, dtype=jnp.float32) + 0.5) * vs + oz
        return xs[None, None, :], ys[None, :, None], zs[:, None, None]


# =============================================================================
# SE(3) helpers — replaces tf2 lookups on the host side
# =============================================================================


def se3_from_rt(rotation: Array, translation: Array) -> Array:
    """Build a 4x4 homogeneous transform from a 3x3 rotation and 3-vector."""
    T = jnp.eye(4, dtype=jnp.float32)
    T = T.at[:3, :3].set(rotation.astype(jnp.float32))
    T = T.at[:3, 3].set(translation.astype(jnp.float32))
    return T


def se3_apply(T: Array, pts: Array) -> Array:
    """Apply a 4x4 transform to points [..., 3].

    One matmul over the point batch (the reference does per-point Eigen
    transforms, vofod_nodelet.cpp:640).  Full f32 precision: the result is
    binned at voxel resolution and must agree with the host binner, and a
    default-precision f32 matmul may run in TF32 (~10 mantissa bits) on a
    GPU, which moves points across voxel boundaries tens of metres out.
    """
    R = T[:3, :3]
    t = T[:3, 3]
    return jnp.matmul(pts, R.T, precision=lax.Precision.HIGHEST) + t


def se3_rotate(T: Array, vecs: Array) -> Array:
    """Rotate vectors [..., 3] by T's rotation (full f32, see se3_apply)."""
    return jnp.matmul(vecs, T[:3, :3].T, precision=lax.Precision.HIGHEST)


def yaw_rotation(yaw_rad: float) -> np.ndarray:
    c, s = np.cos(yaw_rad), np.sin(yaw_rad)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=np.float32)


def box_mask(pts: Array, lo, hi) -> Array:
    """Points [..., 3] inside the closed AABB [lo, hi] (PCL CropBox semantics,
    ref vofod_nodelet.cpp:626-655)."""
    lo = jnp.asarray(lo, dtype=pts.dtype)
    hi = jnp.asarray(hi, dtype=pts.dtype)
    return jnp.all((pts >= lo) & (pts <= hi), axis=-1)
