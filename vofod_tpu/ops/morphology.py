"""Dense 3-D morphology over the voxel grid: Euclidean-ball pooling.

These stencils implement the neighborhood queries of the reference as single
fused grid passes:

* ``ball_pool_max`` over the background mask ≡ VoxelMap::hasCloseTo ball query
  (ref src/voxel_map.cpp:376-400) evaluated for *every* voxel at once.
* iterated ``ball_pool_min`` over label grids ≡ Euclidean cluster extraction
  (ref vofod_nodelet.cpp:689-698, PCL kd-tree ECE) — two voxel-center points
  are neighbors iff ``voxel_size * ||Δidx||₂ <= tolerance``.
* ``ball_pool_sum`` is used for local "sure voxel" counts in the separated-
  background-cluster maintenance (ref vofod_nodelet.cpp:1174-1206).

The Euclidean ball of radius r is decomposed into x-direction running pools
(widths shared across rows) followed by one shifted combine per (dz, dy) row —
~35 fused passes for r=3 instead of 123 naive taps.

Grids are (nz, ny, nx); radii are in voxel units and may be fractional.
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
from jax import lax

Array = jnp.ndarray


@functools.lru_cache(maxsize=None)
def ball_offsets(radius: float) -> tuple[tuple[int, int, int], ...]:
    """Integer offsets (dz, dy, dx) with ||d||₂ <= radius (inclusive)."""
    r = int(math.floor(radius))
    out = []
    r2 = radius * radius + 1e-9
    for dz in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dz * dz + dy * dy + dx * dx <= r2:
                    out.append((dz, dy, dx))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _ball_rows(radius: float) -> tuple[tuple[int, int, int], ...]:
    """(dz, dy, half_width_x) rows covering the ball."""
    r = int(math.floor(radius))
    r2 = radius * radius + 1e-9
    rows = []
    for dz in range(-r, r + 1):
        for dy in range(-r, r + 1):
            rem = r2 - dz * dz - dy * dy
            if rem >= 0:
                rows.append((dz, dy, int(math.floor(math.sqrt(rem)))))
    return tuple(rows)


def shift3(a: Array, dz: int, dy: int, dx: int, fill) -> Array:
    """Shift a 3-D array so out[z,y,x] = a[z+dz, y+dy, x+dx], edge-filled."""
    pz, py, px = abs(dz), abs(dy), abs(dx)
    if pz == py == px == 0:
        return a
    p = jnp.pad(a, ((pz, pz), (py, py), (px, px)), constant_values=fill)
    return lax.dynamic_slice(p, (pz + dz, py + dy, px + dx), a.shape)


def _ball_pool(a: Array, radius: float, combine, fill) -> Array:
    """Generic decomposed ball pool: out[v] = combine over ball(radius) of a."""
    rows = _ball_rows(radius)
    widths = sorted({w for _, _, w in rows})
    # x-direction running pools, built incrementally
    xpool = {0: a}
    prev_w, prev = 0, a
    max_w = widths[-1]
    if max_w > 0:
        pz = 0
        pad = jnp.pad(a, ((0, 0), (0, 0), (max_w, max_w)), constant_values=fill)

        def shx(d):
            return lax.dynamic_slice(pad, (pz, 0, max_w + d), a.shape)

        for w in range(1, max_w + 1):
            prev = combine(combine(shx(-w), prev), shx(w))
            if w in widths:
                xpool[w] = prev
    # combine rows with (dz, dy) shifts
    max_zy = max(max(abs(dz), abs(dy)) for dz, dy, _ in rows)
    padded = {
        w: jnp.pad(
            xpool[w], ((max_zy, max_zy), (max_zy, max_zy), (0, 0)), constant_values=fill
        )
        for w in widths
    }
    out = None
    for dz, dy, w in rows:
        s = lax.dynamic_slice(padded[w], (max_zy + dz, max_zy + dy, 0), a.shape)
        out = s if out is None else combine(out, s)
    return out


def ball_pool_min(a: Array, radius: float, fill=None) -> Array:
    if fill is None:
        fill = jnp.iinfo(a.dtype).max if jnp.issubdtype(a.dtype, jnp.integer) else jnp.inf
    return _ball_pool(a, radius, jnp.minimum, fill)


def ball_pool_max(a: Array, radius: float, fill=None) -> Array:
    if fill is None:
        fill = (
            jnp.iinfo(a.dtype).min if jnp.issubdtype(a.dtype, jnp.integer) else -jnp.inf
        )
    return _ball_pool(a, radius, jnp.maximum, fill)


def ball_pool_sum(a: Array, radius: float) -> Array:
    return _ball_pool(a, radius, lax.add, 0)


def ball_pool_min_naive(a: Array, radius: float, fill=None) -> Array:
    """Straightforward 123-tap version; test oracle for the decomposition."""
    if fill is None:
        fill = jnp.iinfo(a.dtype).max if jnp.issubdtype(a.dtype, jnp.integer) else jnp.inf
    out = None
    for dz, dy, dx in ball_offsets(radius):
        s = shift3(a, dz, dy, dx, fill)
        out = s if out is None else jnp.minimum(out, s)
    return out


@functools.lru_cache(maxsize=None)
def ball_shells(bound: float) -> tuple[tuple[int, tuple], ...]:
    """Offsets within ``bound`` grouped into shells of equal squared index
    distance, ascending: ((r2, ((dz, dy, dx), ...)), ...).  The traced-radius
    pools below include a shell iff ``r2_shell <= r2_traced``."""
    shells: dict[int, list] = {}
    for o in ball_offsets(bound):
        r2 = o[0] * o[0] + o[1] * o[1] + o[2] * o[2]
        shells.setdefault(r2, []).append(o)
    return tuple(
        (r2, tuple(offs)) for r2, offs in sorted(shells.items())
    )


def _ball_pool_traced(a: Array, r2, bound: float, combine, fill) -> Array:
    """Ball pool whose radius is a TRACED scalar (squared, index units),
    compiled at a static ``bound``: each equal-distance shell is pooled
    statically and combined only where ``shell_r2 <= r2``.  This is how the
    reference's live-tunable stencil radii (ground_points_max_distance,
    sepclusters/max_bg_distance — dynamic_reconfigure params,
    DetectionParams.cfg:16-44) move between steps WITHOUT recompiling.

    Cost: the shell decomposition cannot share row pools, so this runs the
    naive tap set (~123 shifts at bound 3 vs ~35 for the static
    decomposition) — the price of `cfg.dynamic_radii`; the static path
    stays the default."""
    out = a  # shell 0
    for r2_shell, offs in ball_shells(bound):
        if r2_shell == 0:
            continue
        sp = None
        for dz, dy, dx in offs:
            s = shift3(a, dz, dy, dx, fill)
            sp = s if sp is None else combine(sp, s)
        out = jnp.where(r2_shell <= r2, combine(out, sp), out)
    return out


def ball_pool_max_traced(a: Array, r2, bound: float, fill=None) -> Array:
    if fill is None:
        fill = (
            jnp.iinfo(a.dtype).min
            if jnp.issubdtype(a.dtype, jnp.integer)
            else -jnp.inf
        )
    return _ball_pool_traced(a, r2, bound, jnp.maximum, fill)


def ball_pool_min_traced(a: Array, r2, bound: float, fill=None) -> Array:
    if fill is None:
        fill = (
            jnp.iinfo(a.dtype).max
            if jnp.issubdtype(a.dtype, jnp.integer)
            else jnp.inf
        )
    return _ball_pool_traced(a, r2, bound, jnp.minimum, fill)


def ball_pool_sum_traced(a: Array, r2, bound: float) -> Array:
    return _ball_pool_traced(a, r2, bound, lax.add, 0)


def hascloseto_pool_any(mask: Array, radius: float) -> Array:
    """Reference-exact hasCloseTo evaluated for every voxel at once
    (voxel_map.cpp:376-400): True where some ``mask`` voxel lies within
    euclidean index distance ``radius`` inside the search box
    ``[idx - ceil(r), idx + ceil(r))`` — note the EXCLUSIVE upper bound: the
    +ceil(r) layer per axis is never searched, so at exactly-integer radii
    the positive axis-extreme offsets are (bug-for-bug) missing.  Compat path
    only (``cfg.compat_hascloseto_bounds``); the symmetric :func:`ball_pool_max`
    is the spec-correct production query."""
    mvd = int(math.ceil(radius))
    r2 = radius * radius + 1e-9
    out = None
    for dz in range(-mvd, mvd):
        for dy in range(-mvd, mvd):
            for dx in range(-mvd, mvd):
                if dz * dz + dy * dy + dx * dx > r2:
                    continue
                s = shift3(mask, dz, dy, dx, False)
                out = s if out is None else (out | s)
    return out


def is_floating(grid_vals: Array, threshold) -> Array:
    """Per-voxel 26-neighborhood emptiness: True where no voxel in the 3x3x3
    neighborhood (self included) exceeds ``threshold``; always False on the
    grid border (ref VoxelMap::isFloatingIdx, src/voxel_map.cpp:491-516)."""
    over = (grid_vals > threshold).astype(jnp.int32)
    near = _ball_pool(over, 1.8, jnp.maximum, 0) > 0  # ball(1.8) = full cube
    out = ~near
    border = jnp.zeros_like(out)
    border = border.at[1:-1, 1:-1, 1:-1].set(out[1:-1, 1:-1, 1:-1])
    return border


def dilate6(mask: Array) -> Array:
    """One step of 6-neighborhood (face-adjacent) binary dilation — the BFS
    expansion step of the reference's exploreToGround DFS
    (ref src/voxel_map.cpp:436-478 expands ±x, ±y, ±z only)."""
    m = mask
    for axis in range(mask.ndim - 3, mask.ndim):
        hi = jnp.concatenate(
            [lax.slice_in_dim(mask, 1, mask.shape[axis], axis=axis),
             jnp.zeros_like(lax.slice_in_dim(mask, 0, 1, axis=axis))], axis=axis)
        lo = jnp.concatenate(
            [jnp.zeros_like(lax.slice_in_dim(mask, 0, 1, axis=axis)),
             lax.slice_in_dim(mask, 0, mask.shape[axis] - 1, axis=axis)], axis=axis)
        m = m | hi | lo
    return m
