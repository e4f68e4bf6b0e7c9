"""Freespace raycast: per-voxel accumulated ray-intersection length.

The reference spawns a thread per scan that walks every one of ~131k rays
through the grid with Amanatides–Woo DDA, accumulating the chord length each
ray spends in each voxel (ref src/vofod_nodelet.cpp:1396-1606 raycast_cloud,
src/voxel_map.cpp:229-263 forEachRay).  The result feeds an EMA update that
pulls ray-swept voxels toward the "ray" (empty) score.

Two implementations:

* :func:`raycast_dda` — exact vectorized DDA (lax.scan over ray steps +
  one scatter-add).  Bit-faithful to the reference traversal; used as the
  correctness oracle and as an opt-in "exact" mode.  The 9.4M-element
  scatter-add was the costliest op of the step before GPU measurements
  existed, so it is not the production path (ROADMAP.md §3.3 re-decides).

* :func:`raycast_sweep` — the production redesign: a gather/scatter-free
  plane-sweep transmittance propagation.  Rays are straight lines from one
  origin, so per-voxel transmittance T (fraction of rays from the sensor that
  reach the voxel unobstructed) obeys a recurrence along any axis-aligned
  sweep away from the sensor: T(v) = T(parent(v)) * (1 - opacity(parent)),
  where parent is the point one plane closer to the sensor along the ray —
  a *separable bilinear* sample of the previous plane (the sample coordinate
  in each lateral axis depends only on that axis).  Six axis cones (+x, -x,
  +y, -y, +z, -z) cover all directions; each is one lax.scan of cheap
  [plane]-sized stencil steps.  The accumulated chord length is then the
  continuum identity  sum_of_chords(v) = ray_density(v) * voxel_volume / d²,
  with ray density per steradian taken from the sensor's angular resolution,
  times T(v) — all elementwise.  No gathers, no scatters: ~1-3 ms/scan.

  Deviations from per-ray DDA (documented, all second-order for the EMA):
  ray-count quantization near the footprint limit and clearing up to the
  surface voxel instead of range - voxel_size before it.  Per-pixel
  intensity/FOV-mask gates (ref vofod_nodelet.cpp:1449-1450) are honored
  through the **angular gate**: the per-scan active-ray image is pooled to a
  coarse angular texture, sampled onto six world-frame cube faces (one per
  sweep cone, gather-free one-hot matmuls), and each face is expanded
  separably onto the voxel grid as a multiplicative ray-density factor —
  see :func:`make_angular_gate` / :func:`gate_faces`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from vofod_tpu.geometry import GridSpec

Array = jnp.ndarray
_HIGHEST = lax.Precision.HIGHEST


# =============================================================================
# Exact DDA (oracle / compat mode)
# =============================================================================


def raycast_dda(
    grid: GridSpec,
    starts: Array,
    dirs: Array,
    lengths: Array,
    valid: Array,
    max_length: float,
) -> Array:
    """Exact Amanatides–Woo accumulation (ref voxel_map.cpp:229-263).

    Args:
      starts: [R, 3] world ray starts (must lie inside the grid; the caller
        gates like the reference does at vofod_nodelet.cpp:1481-1483).
      dirs: [R, 3] unit directions.
      lengths: [R] traversal lengths (callers pass
        ``range==0 ? max_dist : min(range - voxel, max_dist)``,
        ref vofod_nodelet.cpp:1455-1457).
      valid: [R] ray gate (intensity/mask, ref :1449-1450).
      max_length: static bound used to size the step loop.

    Returns: float32 (nz, ny, nx) accumulated intersection lengths.
    """
    fids, ws = dda_emissions(grid, starts, dirs, lengths, valid, max_length)
    flat = jnp.zeros((grid.n_voxels,), jnp.float32).at[fids].add(
        ws, mode="drop"
    )
    return flat.reshape(grid.shape)


def dda_emissions(
    grid: GridSpec,
    starts: Array,
    dirs: Array,
    lengths: Array,
    valid: Array,
    max_length: float,
) -> tuple[Array, Array]:
    """The DDA walk's raw (flat voxel id, chord length) emission stream,
    flattened in (step, ray) order — split out so the grid-sharded step can
    scatter only locally-owned emissions (parallel/gridops.ZShardOps
    .raycast_dda) while the order per voxel stays identical to the unsharded
    accumulation (bit-exact f32 sums)."""
    vs = grid.voxel_size
    n_steps = int(math.ceil(max_length / vs * math.sqrt(3.0))) + 3

    absdir = jnp.abs(dirs)
    step = jnp.sign(dirs).astype(jnp.int32)  # [R, 3]
    tdelta = jnp.where(absdir > 0, vs / absdir, jnp.inf)

    ix, iy, iz = grid.coord_to_idx(starts)
    cur = jnp.stack([ix, iy, iz], axis=-1)  # [R, 3] (x, y, z) order
    ctr = grid.idx_to_coord(ix, iy, iz) - starts
    tmax = jnp.where(
        absdir > 0, (vs / 2.0 + step.astype(starts.dtype) * ctr) / absdir, jnp.inf
    )
    last = jnp.where(
        step > 0,
        jnp.array([grid.nx - 1, grid.ny - 1, grid.nz - 1], jnp.int32),
        0,
    )

    def body(carry, _):
        cur, tmax, prev, alive = carry
        dist = jnp.min(tmax, axis=-1)  # [R]
        axis = jnp.argmin(tmax, axis=-1)  # [R]
        ddist = jnp.maximum(jnp.minimum(dist, lengths) - prev, 0.0)
        emit_w = jnp.where(alive & valid, ddist, 0.0)
        fid = grid.flat_id(cur[:, 0], cur[:, 1], cur[:, 2])
        onehot = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
        at_edge = jnp.sum(onehot * (cur == last), axis=-1) > 0
        alive = alive & (dist < lengths) & ~at_edge
        cur = cur + onehot * step
        # select, don't multiply: tdelta is inf on zero-direction axes and
        # 0 * inf = NaN would poison exactly-axis-aligned rays
        tmax = jnp.where(onehot > 0, tmax + tdelta, tmax)
        return (cur, tmax, dist, alive), (fid, emit_w)

    alive0 = valid & (lengths > 0)
    (_, _, _, _), (fids, ws) = lax.scan(
        body, (cur, tmax, jnp.zeros_like(lengths), alive0), None, length=n_steps
    )
    return fids.reshape(-1), ws.reshape(-1)


# =============================================================================
# Plane-sweep transmittance raycast (production mode)
# =============================================================================


def _shifted(p: Array, d: int, axis: int) -> Array:
    """out[..i..] = p[..i+d..] along `axis`, 1.0 outside."""
    n = p.shape[axis]
    if d == 0:
        return p
    if d > 0:
        sl = lax.slice_in_dim(p, d, n, axis=axis)
        fill = jnp.ones_like(lax.slice_in_dim(p, 0, d, axis=axis))
        return jnp.concatenate([sl, fill], axis=axis)
    sl = lax.slice_in_dim(p, 0, n + d, axis=axis)
    fill = jnp.ones_like(lax.slice_in_dim(p, 0, -d, axis=axis))
    return jnp.concatenate([fill, sl], axis=axis)


def _tap_weights(rel_s: Array, rel_lat: Array) -> Array:
    """Separable 4-tap interpolation weights for sampling the previous plane
    at lateral coordinate ``-rel_lat / rel_s`` (clipped to ±1 voxel/plane).
    Depends only on (plane, cone, lateral index) — precomputed vectorized so
    the scan body is pure fma.  rel_s: [nS, C]; rel_lat: [C, n] ->
    [nS, C, n, 4]."""
    rs_safe = jnp.where(jnp.abs(rel_s) < 0.5, 0.5, rel_s)  # [nS, C]
    f = jnp.clip(
        -rel_lat[None, :, :] / rs_safe[:, :, None], -1.0, 1.0
    )  # [nS, C, n_lat]
    lo = jnp.floor(f)
    frac = f - lo
    lo = lo.astype(jnp.int32)  # in {-1, 0, 1}
    w_m1 = jnp.where(lo == -1, 1.0 - frac, 0.0)
    w_0 = jnp.where(lo == -1, frac, 0.0) + jnp.where(lo == 0, 1.0 - frac, 0.0)
    w_p1 = jnp.where(lo == 0, frac, 0.0) + jnp.where(lo == 1, 1.0 - frac, 0.0)
    w_p2 = jnp.where(lo == 1, frac, 0.0)
    return jnp.stack([w_m1, w_0, w_p1, w_p2], axis=-1)  # [nS, C, n, 4]


def _cone_scan_step(carry, inp):
    """One transmittance plane step (shared by the unsharded scan and the
    z-pipelined sharded scan): bilinear-resample the carry toward the sensor,
    seed planes at/behind the sensor, attenuate by plane opacity."""
    opaq_plane, wa_p, wb_p, seed_p = inp
    C = carry.shape[0]

    def lerp(p, w, axis):
        shape = [C, 1, 1, 4]
        shape[axis + 1] = w.shape[1]
        w = w.reshape(shape)
        return (
            w[..., 0] * _shifted(p, -1, axis + 1)
            + w[..., 1] * p
            + w[..., 2] * _shifted(p, 1, axis + 1)
            + w[..., 3] * _shifted(p, 2, axis + 1)
        )

    t_in = lerp(lerp(carry, wb_p, 1), wa_p, 0)
    # seed: the first plane at/after the sensor starts fully lit
    t_in = jnp.where(seed_p, jnp.bfloat16(1.0), t_in)
    carry_new = t_in * (jnp.bfloat16(1.0) - opaq_plane)
    return carry_new, t_in


def _sweep_cones(opaq_sc: Array, rel_s: Array, rel_a: Array, rel_b: Array) -> Array:
    """Transmittance sweep for C cones batched into ONE scan.

    The sequential plane steps dominate the cost, so as many cones as share
    a (padded) plane shape ride one scan: both directions of an axis, and
    whole axes padded to a common lateral shape.

    Args:
      opaq_sc: [nS, C, nA, nB] opacity (1 = blocked), sweep axis leading,
        every cone oriented so the sensor sits before plane 0.  Cones whose
        true axis is shorter than nS are padded with transparent planes.
      rel_s: [nS, C] voxel-center offsets from the sensor along each cone's
        sweep axis (monotonically increasing; positive past the sensor).
      rel_a: [C, nA], rel_b: [C, nB] lateral offsets per cone (padding
        values are arbitrary finite numbers — callers discard those lanes).

    Returns: [nS, C, nA, nB] transmittance T arriving at each voxel (valid
      only inside each cone — the caller masks).
    """
    C, nA, nB = opaq_sc.shape[1], opaq_sc.shape[2], opaq_sc.shape[3]

    # bf16 throughout the scan: transmittance needs ~3 significant digits
    # (it only modulates an EMA rate) and halving the loop's memory traffic
    # is the dominant cost lever
    wa = _tap_weights(rel_s, rel_a).astype(jnp.bfloat16)  # [nS, C, nA, 4]
    wb = _tap_weights(rel_s, rel_b).astype(jnp.bfloat16)  # [nS, C, nB, 4]
    seed = (rel_s <= 1.0)[:, :, None, None]  # [nS, C, 1, 1]

    init = jnp.ones((C, nA, nB), jnp.bfloat16)
    # unroll: each device-loop iteration advances several planes — the scan
    # is overhead-bound (tiny per-plane stencils)
    _, t = lax.scan(
        _cone_scan_step, init, (opaq_sc.astype(jnp.bfloat16), wa, wb, seed),
        unroll=8,
    )
    return t.astype(jnp.float32)


def _sweep_cones_lat_sharded(
    opaq_sc: Array, rel_s: Array, rel_a_loc: Array, rel_b: Array,
    axis: str, n: int, pin_rows: Array | None = None,
) -> Array:
    """:func:`_sweep_cones` with the lateral A axis sharded over mesh axis
    ``axis`` (grid-sharded x/y cones: A = the Z grid axis).  Per plane step
    the post-B-lerp carry exchanges its A-halo rows (1 low, 2 high — the
    4-tap support) with the neighbor shards; global edges fill 1.0
    exactly like :func:`_shifted`.  Arithmetic per interior element is
    identical to the unsharded scan.  Must run inside shard_map.

    ``pin_rows`` (optional bool [nAl]): local A rows held at carry T=1.0
    after every step — alignment padding rows behave exactly like the edge
    fill beyond the true lateral extent (used by the transposed z cones)."""
    C, nAl, nB = opaq_sc.shape[1], opaq_sc.shape[2], opaq_sc.shape[3]
    assert nAl >= 2, "lateral shard must hold >= 2 rows for the 4-tap halo"

    wa = _tap_weights(rel_s, rel_a_loc).astype(jnp.bfloat16)  # [nS, C, nAl, 4]
    wb = _tap_weights(rel_s, rel_b).astype(jnp.bfloat16)
    seed = (rel_s <= 1.0)[:, :, None, None]
    my = lax.axis_index(axis)
    perm_up = [(i, i + 1) for i in range(n - 1)]
    perm_dn = [(i, i - 1) for i in range(1, n)]

    def step(carry, inp):
        opaq_plane, wa_p, wb_p, seed_p = inp
        wbr = wb_p.reshape(C, 1, nB, 4)
        q = (
            wbr[..., 0] * _shifted(carry, -1, 2)
            + wbr[..., 1] * carry
            + wbr[..., 2] * _shifted(carry, 1, 2)
            + wbr[..., 3] * _shifted(carry, 2, 2)
        )
        if pin_rows is not None:
            # pad rows read as EXACTLY the 1.0 edge fill of _shifted — pin
            # the post-B-lerp plane the A-taps (and halo sends) consume
            q = jnp.where(pin_rows[None, :, None], jnp.bfloat16(1.0), q)
        last1 = lax.ppermute(q[:, nAl - 1 : nAl, :], axis, perm_up)
        first2 = lax.ppermute(q[:, :2, :], axis, perm_dn)
        lo = jnp.where(my > 0, last1, jnp.ones_like(q[:, :1, :]))
        hi = jnp.where(my < n - 1, first2, jnp.ones_like(q[:, :2, :]))
        ext = jnp.concatenate([lo, q, hi], axis=1)  # [C, nAl+3, nB]
        war = wa_p.reshape(C, nAl, 1, 4)
        t_in = (
            war[..., 0] * ext[:, 0:nAl]
            + war[..., 1] * ext[:, 1 : nAl + 1]
            + war[..., 2] * ext[:, 2 : nAl + 2]
            + war[..., 3] * ext[:, 3 : nAl + 3]
        )
        t_in = jnp.where(seed_p, jnp.bfloat16(1.0), t_in)
        carry_new = t_in * (jnp.bfloat16(1.0) - opaq_plane)
        return carry_new, t_in

    init = jnp.ones((C, nAl, nB), jnp.bfloat16)
    _, t = lax.scan(
        step, init, (opaq_sc.astype(jnp.bfloat16), wa, wb, seed), unroll=8
    )
    return t.astype(jnp.float32)


def _sweep_cones_z_transposed(
    op: Array, rel_z_global: Array, rel_a: Array, rel_b: Array,
    axis: str, n: int,
) -> Array:
    """Both z cones with the grid transposed to LATERAL(Y)-sharded via
    all_to_all, instead of sweep-sharded/pipelined: each shard sweeps all nz
    planes over a 1/n-wide y slab, so per-shard FLOPs drop n× relative to
    :func:`_sweep_cones_z_pipelined` (which replays the full-plane scan n
    times and keeps one round per shard).  Two volume all_to_alls (bf16)
    bracket the scan; wall-clock keeps the inherent nz sequential plane
    steps but each step touches 1/n of the plane.

    When the (windowed) y extent doesn't divide n, alignment pad rows are
    pinned to carry T=1.0 every step — exactly the :func:`_shifted` edge
    fill beyond the true extent — so the result is bit-identical to the
    unsharded z-cone sweep.  Must run inside shard_map.

    Args: ``op`` local (nzl, ny, nx) opacity slab; ``rel_z_global`` [nz]
    GLOBAL sweep offsets; ``rel_a`` [ny] lateral y offsets; ``rel_b`` [nx].
    Returns: [nzl, 2, ny, nx] local z-slab transmittance (cone 0 ascending,
    cone 1 stored reversed like :func:`_sweep_cones`' z output).
    """
    nzl, ny, nx = op.shape
    ny_pad = ((ny + n - 1) // n) * n
    if ny_pad != ny:
        op = jnp.pad(op, ((0, 0), (0, ny_pad - ny), (0, 0)))
        tail = rel_a[-1] + jnp.arange(1, ny_pad - ny + 1, dtype=rel_a.dtype)
        rel_a = jnp.concatenate([rel_a, tail])
    nyl = ny_pad // n
    # local slab -> all planes of a 1/n y slab (blocks arrive in shard order,
    # so axis 0 is globally-ascending z)
    g = lax.all_to_all(op, axis, split_axis=1, concat_axis=0, tiled=True)
    my = lax.axis_index(axis)
    ra_loc = lax.dynamic_slice_in_dim(rel_a, my * nyl, nyl)
    pin = (my * nyl + jnp.arange(nyl)) >= ny

    planes = jnp.stack([g, g[::-1]], axis=1)  # [nz, 2, nyl, nx]
    rs = jnp.stack([rel_z_global, -rel_z_global[::-1]], axis=1)
    ra = jnp.broadcast_to(ra_loc[None, :], (2, nyl))
    rb = jnp.broadcast_to(rel_b[None, :], (2, nx))
    t = _sweep_cones_lat_sharded(planes, rs, ra, rb, axis, n, pin_rows=pin)
    # back to z-sharded: cone 0's scan rows ARE ascending global z; cone 1
    # swept reversed planes, so flip to ascending first and re-reverse
    # locally after the transpose (the caller indexes t_z[::-1, 1] on the
    # local slab, matching the pipelined/unsharded layout)
    t0 = lax.all_to_all(t[:, 0], axis, split_axis=0, concat_axis=1, tiled=True)
    t1 = lax.all_to_all(
        t[::-1, 1], axis, split_axis=0, concat_axis=1, tiled=True
    )
    out = jnp.stack([t0, t1[::-1]], axis=1)  # [nzl, 2, ny_pad, nx]
    return out[:, :, :ny, :]


def _sweep_cones_z_pipelined(
    opaq_sc: Array, rel_s: Array, rel_a: Array, rel_b: Array,
    axis: str, n: int,
) -> Array:
    """Both z cones with the SWEEP axis sharded (each shard holds nz/n
    planes), pipelined across shards: n rounds of the local scan, the carry
    plane riding ppermute to the next shard in the sweep direction after
    each round (cone 0 sweeps shard 0 -> n-1, cone 1 sweeps n-1 -> 0).
    Shard s keeps cone-0 output from round s and cone-1 output from round
    n-1-s; off-round local scans compute discarded values (the recurrence is
    inherently sequential — wall-clock matches unsharded, memory scales).
    Must run inside shard_map."""
    nzl, C = opaq_sc.shape[0], opaq_sc.shape[1]
    assert C == 2
    wa = _tap_weights(rel_s, rel_a).astype(jnp.bfloat16)
    wb = _tap_weights(rel_s, rel_b).astype(jnp.bfloat16)
    seed = (rel_s <= 1.0)[:, :, None, None]
    inputs = (opaq_sc.astype(jnp.bfloat16), wa, wb, seed)
    my = lax.axis_index(axis)
    perm_up = [(i, i + 1) for i in range(n - 1)]
    perm_dn = [(i, i - 1) for i in range(1, n)]

    carry = jnp.ones((C,) + opaq_sc.shape[2:], jnp.bfloat16)
    t_out = jnp.zeros(opaq_sc.shape, jnp.bfloat16)
    for r in range(n):
        carry_fin, t = lax.scan(_cone_scan_step, carry, inputs, unroll=8)
        keep = jnp.stack([my == r, my == (n - 1 - r)])  # [C]
        t_out = jnp.where(keep[None, :, None, None], t, t_out)
        if r < n - 1:
            c0 = lax.ppermute(carry_fin[0], axis, perm_up)
            c1 = lax.ppermute(carry_fin[1], axis, perm_dn)
            carry = jnp.stack([c0, c1])
    return t_out.astype(jnp.float32)


# -----------------------------------------------------------------------------
# Angular gate: per-pixel FOV-mask / intensity gates for the sweep
# -----------------------------------------------------------------------------
#
# The reference skips a pixel's ray when ``intensity < min_intensity`` or when
# the pixel is masked and has no return (ref vofod_nodelet.cpp:1449-1450), so
# e.g. an airframe-shadow sector never clears freespace.  The sweep models ray
# density as a continuum, so the per-pixel gate becomes a *direction-dependent
# active-ray fraction*: raylen(v) = T(v) · density(v) · gate(dir(v)) · ...
#
# gate(dir) is evaluated gather-free: the [H, W] active image is mean-pooled
# to a coarse angular texture G, G is sampled at the texels of six cube faces
# (world-frame cone axes; tiny one-hot matmuls), and each face is expanded
# onto the voxel grid separably (texel coords u' = lat_A/sweep, v' = lat_B/
# sweep depend on one lateral axis each) — two small batched einsums per cone
# group.


class AngularGate(NamedTuple):
    """Static (trace-time) description of the pixel-lattice → angle mapping.

    Built once per sensor LUT by :func:`make_angular_gate`.  The col↔azimuth
    map is a linear fit of the LUT — exact for the ideal spherical model and
    the Ouster encoder-azimuth model (θ_e is linear in the column by
    construction, vofod_nodelet.cpp:358-371).  The row↔elevation map is
    linear ONLY when the LUT's beam-altitude table is itself linear in the
    row (sim LUTs, uniform Ousters); calibrated non-uniform tables
    (gradient/gamma-spaced beams) deviate by MULTIPLE pooled bins — measured
    1.5-2.5 bins for OS-style gradient tables — so for those
    :func:`make_angular_gate` stores the per-row elevation table ``el_rows``
    and :func:`gate_faces` inverts it exactly (monotone rank-by-comparison +
    one-hot matmul, gather-free, still static).  Pinned by
    tests/test_raycast.py::TestAngularGateCalibratedLut.
    """

    el_a: float  # row_f = (el - el_b) / el_a  (linear fallback / FOV window)
    el_b: float
    az_a: float  # col_f = (az_unwrapped - az_b) / az_a
    az_b: float
    pool_v: int
    pool_h: int
    n_rows: int  # pooled gate-texture shape
    n_cols: int
    col_period: float  # azimuth period in pooled-column units (wraps)
    face_dirs: np.ndarray  # [6, F, F, 3] world-frame cube-face texel dirs
    # [H] per-row mean elevation (monotone), or None when the linear fit is
    # exact to <0.1 row — then the cheaper linear map is used, bit-identical
    # to the pre-table behavior for sim/uniform LUTs
    el_rows: np.ndarray | None = None


def _largest_divisor_leq(n: int, k: int) -> int:
    for d in range(max(1, min(n, k)), 0, -1):
        if n % d == 0:
            return d
    return 1


def _face_dirs(face_res: int) -> np.ndarray:
    """[6, F, F, 3] unit directions for cube-face texels, face order matching
    the sweep's cone stacking: x+, x-, y+, y-, z+, z-.  Texel (i, j) sits at
    lateral-ratio coords u' = rel_A/rel_sweep, v' = rel_B/rel_sweep in
    [-1, 1]² (x cones: A=z, B=y; y cones: A=z, B=x; z cones: A=y, B=x)."""
    F = face_res
    u = np.linspace(-1.0, 1.0, F)
    U, V = np.meshgrid(u, u, indexing="ij")  # U = u' (axis A), V = v' (axis B)
    one = np.ones_like(U)
    faces = np.stack(
        [
            np.stack([one, V, U], -1),  # x+
            np.stack([-one, V, U], -1),  # x-
            np.stack([V, one, U], -1),  # y+
            np.stack([V, -one, U], -1),  # y-
            np.stack([V, U, one], -1),  # z+
            np.stack([V, U, -one], -1),  # z-
        ]
    )
    return (faces / np.linalg.norm(faces, axis=-1, keepdims=True)).astype(
        np.float32
    )


def make_angular_gate(
    lut,
    *,
    face_res: int = 33,
    target_rows: int = 32,
    target_cols: int = 128,
) -> AngularGate:
    """Fit the pixel↔angle maps from the sensor LUT (a static constant)."""
    H, W = lut.height, lut.width
    dirs = np.asarray(lut.directions, np.float64).reshape(H, W, 3)

    el_row = np.arcsin(np.clip(dirs[..., 2], -1.0, 1.0)).mean(axis=1)  # [H]
    if H > 1:
        el_a, el_b = np.polyfit(np.arange(H), el_row, 1)
    else:
        el_a, el_b = 1.0, float(el_row[0])
    # keep the cheap linear row map only when it IS the table (sim / uniform
    # beam spacing); calibrated non-uniform altitude tables get the exact
    # per-row inverse in gate_faces (deviation measured at 1.5-2.5 pooled
    # bins for gradient-spaced Ousters — far past the documented bound)
    el_rows = None
    if H > 1:
        row_lin = (el_row - el_b) / el_a
        if np.abs(row_lin - np.arange(H)).max() > 0.1:
            d = np.diff(el_row)
            assert (d > 0).all() or (d < 0).all(), (
                "beam-altitude table must be monotone in the row"
            )
            el_rows = el_row.astype(np.float64)

    mid = dirs[H // 2]
    az_col = np.unwrap(np.arctan2(mid[:, 1], mid[:, 0]))
    if W > 1:
        az_a, az_b = np.polyfit(np.arange(W), az_col, 1)
    else:
        az_a, az_b = 1.0, float(az_col[0])

    pool_v = _largest_divisor_leq(H, max(1, H // target_rows))
    pool_h = _largest_divisor_leq(W, max(1, W // target_cols))
    return AngularGate(
        el_a=float(el_a),
        el_b=float(el_b),
        az_a=float(az_a),
        az_b=float(az_b),
        pool_v=pool_v,
        pool_h=pool_h,
        n_rows=H // pool_v,
        n_cols=W // pool_h,
        col_period=float(2.0 * np.pi / abs(az_a) / pool_h),
        face_dirs=_face_dirs(face_res),
        el_rows=el_rows,
    )


def _row_from_elevation(gate: AngularGate, el: Array) -> Array:
    """Continuous full-resolution row coordinate for elevations ``el`` [P].

    Linear map when the LUT's altitude table is linear; otherwise the exact
    monotone inverse of ``gate.el_rows``: segment index by rank (a [P, H]
    comparison sum — no gather), segment endpoints by one-hot matmul, linear
    within the segment (exact at every row center) and end-segment-slope
    extrapolation beyond the table (so row tents vanish past the FOV exactly
    like the linear map).
    """
    if gate.el_rows is None:
        return (el - gate.el_b) / gate.el_a
    tbl = np.asarray(gate.el_rows, np.float32)
    sgn = 1.0 if tbl[-1] > tbl[0] else -1.0
    f = jnp.asarray(sgn * tbl)  # [H] increasing, static constant
    t = sgn * el  # [P]
    H = f.shape[0]
    idx = jnp.clip(
        jnp.sum((t[:, None] >= f[None, :]).astype(jnp.int32), axis=-1) - 1,
        0, H - 2,
    )  # [P] segment index
    onehot = (idx[:, None] == jnp.arange(H - 1)[None, :]).astype(jnp.float32)
    # full f32: TF32 would round the selected elevations to ~1e-3 rad, a
    # sizeable fraction of one row's spacing
    f0 = jnp.matmul(onehot, f[:-1], precision=_HIGHEST)  # [P]
    f1 = jnp.matmul(onehot, f[1:], precision=_HIGHEST)
    return idx.astype(jnp.float32) + (t - f0) / (f1 - f0)


def gate_faces(gate: AngularGate, active_hw: Array, rot_s2w: Array) -> Array:
    """Sample the pooled active-ray fraction onto the six cube faces.

    Args:
      active_hw: [H, W] bool/float — pixels that actually cast a ray this
        scan: ``~(intensity < min_intensity) & (mask | range > 0)`` —
        the negated reference skip rule, so NaN intensity passes
        (ref vofod_nodelet.cpp:1449-1450).
      rot_s2w: [3, 3] sensor-to-world rotation (traced).

    Returns: float32 [6, F, F] active fraction per face texel; 0 outside the
      sensor's vertical FOV (which also makes the gate the accurate FOV
      window).  Gather-free: tent weights + two small matmuls.
    """
    H, W = active_hw.shape
    G = (
        active_hw.astype(jnp.float32)
        .reshape(gate.n_rows, gate.pool_v, gate.n_cols, gate.pool_h)
        .mean(axis=(1, 3))
    )  # [V', H']

    d_w = jnp.asarray(gate.face_dirs.reshape(-1, 3))  # [P, 3] static
    # sensor frame: s = Rᵀ w (row-vector form), full f32 like the row table
    d_s = jnp.matmul(d_w, rot_s2w, precision=_HIGHEST)
    el = jnp.arcsin(jnp.clip(d_s[:, 2], -1.0, 1.0))
    az = jnp.arctan2(d_s[:, 1], d_s[:, 0])

    g_r = (_row_from_elevation(gate, el) + 0.5) / gate.pool_v - 0.5  # [P]
    g_c = jnp.mod(
        ((az - gate.az_b) / gate.az_a + 0.5) / gate.pool_h - 0.5,
        gate.col_period,
    )

    kr = jnp.arange(gate.n_rows, dtype=jnp.float32)
    kc = jnp.arange(gate.n_cols, dtype=jnp.float32)
    # rows: plain tent, weights vanish outside the FOV (no clamping)
    w_r = jnp.maximum(0.0, 1.0 - jnp.abs(g_r[:, None] - kr[None, :]))
    # cols: circular tent with the true azimuth period
    d0 = jnp.abs(g_c[:, None] - kc[None, :])
    dwrap = jnp.minimum(
        d0,
        jnp.minimum(
            jnp.abs(g_c[:, None] - gate.col_period - kc[None, :]),
            jnp.abs(g_c[:, None] + gate.col_period - kc[None, :]),
        ),
    )
    w_c = jnp.maximum(0.0, 1.0 - dwrap)
    # normalize azimuth weights: when the azimuth period is not an integer
    # number of pooled columns (e.g. the sim LUT duplicates the seam column)
    # the wrap tents overlap/gap slightly at the seam
    w_c = w_c / jnp.maximum(w_c.sum(axis=-1, keepdims=True), 1e-6)

    vals = jnp.sum(
        w_r * jnp.matmul(w_c, G.T, precision=_HIGHEST), axis=-1
    )  # [P]
    F = gate.face_dirs.shape[1]
    return vals.reshape(6, F, F)


def _expand_gate(faces: Array, rel_s: Array, rel_a: Array, rel_b: Array) -> Array:
    """Expand per-cone face textures onto the stacked sweep layout.

    faces: [C, F, F]; rel_s: [nS, C]; rel_a: [C, nA]; rel_b: [C, nB]
    -> [nS, C, nA, nB] multiplicative gate factor (valid inside each cone;
    planes at/behind the sensor produce garbage that the cone partition
    discards, exactly like the transmittance itself).
    """
    F = faces.shape[-1]
    rs = jnp.where(jnp.abs(rel_s) < 0.5, 0.5, rel_s)  # [nS, C]
    u = jnp.clip(rel_a[None, :, :] / rs[:, :, None], -1.0, 1.0)  # [nS, C, nA]
    v = jnp.clip(rel_b[None, :, :] / rs[:, :, None], -1.0, 1.0)  # [nS, C, nB]

    k = jnp.arange(F, dtype=jnp.float32)

    def tent(x):
        g = (x + 1.0) * ((F - 1) / 2.0)
        return jnp.maximum(0.0, 1.0 - jnp.abs(g[..., None] - k)).astype(
            jnp.bfloat16
        )

    # bf16 by design: tent weights and the gate face in bf16 (8 mantissa
    # bits) keep the gate factor within ~0.4% relative — second-order for
    # the ray EMA, inside the sweep's documented error budget (DESIGN.md §9)
    wu = tent(u)  # [nS, C, nA, F]
    wv = tent(v)  # [nS, C, nB, F]
    tmp = jnp.einsum("scaf,cfg->scag", wu, faces.astype(jnp.bfloat16))
    return jnp.einsum("scag,scbg->scab", tmp, wv).astype(jnp.float32)


def raycast_sweep(
    grid: GridSpec,
    opaque: Array,
    origin_world: Array,
    rot_s2w: Array,
    *,
    max_distance: Array,
    vertical_fov: float,
    v_rays: int,
    h_rays: int,
    gate: Array | None = None,
    max_distance_bound: float | None = None,
) -> Array:
    """Gather-free accumulated-ray-length field (see module docstring).

    Args:
      opaque: (nz, ny, nx) bool — voxels containing scan returns (rays stop
        here, matching DDA truncation at the measured range).
      origin_world: [3] sensor origin (world frame).
      rot_s2w: [3, 3] sensor-to-world rotation (world rays = R @ lut dirs,
        ref vofod_nodelet.cpp:1452).
      max_distance: traced scalar — raycast/max_distance (20 m default).
      vertical_fov, v_rays, h_rays: static sensor angular geometry used for
        the per-steradian ray density (ideal spherical model,
        ref initialize_sensor_lut_simulation :374-420).
      gate: optional [6, F, F] per-cone active-ray-fraction faces from
        :func:`gate_faces` — honors the reference's per-pixel FOV-mask and
        intensity gates (ref vofod_nodelet.cpp:1449-1450) as a multiplicative
        ray-density factor.
      max_distance_bound: optional STATIC upper bound on max_distance
        (cfg.raycast_max_distance_bound).  When given, the sweep runs on a
        static x/y window of ±(bound/voxel + margin) voxels around the
        sensor — everything farther is masked to 0 by ``in_range`` anyway,
        and the sweep cost is proportional to swept volume, so the
        flagship window sweeps ~4× less volume than the full frame.  Values inside range are unchanged up to the smoothing-tail
        influence of blockers beyond bound+margin (≲1e-3 relative; the
        window edge fills 1.0 = empty space, exactly like the grid edge).

    Returns: float32 (nz, ny, nx) raylen field (≈ sum of ray chord lengths).
    """
    nz, ny, nx = grid.shape
    vs = grid.voxel_size
    ox, oy, oz = grid.origin
    gx = (origin_world[0] - ox) / vs  # sensor position in voxel units
    gy = (origin_world[1] - oy) / vs
    gz = (origin_world[2] - oz) / vs
    rel_z = jnp.arange(nz, dtype=jnp.float32) + 0.5 - gz

    wx, wy = _window_sizes(nx, ny, vs, max_distance_bound)
    if (wx, wy) != (nx, ny):
        x0 = jnp.clip(
            jnp.floor(gx).astype(jnp.int32) - wx // 2, 0, nx - wx
        )
        y0 = jnp.clip(
            jnp.floor(gy).astype(jnp.int32) - wy // 2, 0, ny - wy
        )
        op_w = lax.dynamic_slice(opaque, (0, y0, x0), (nz, wy, wx))
        rel_x = (
            jnp.arange(wx, dtype=jnp.float32) + x0.astype(jnp.float32)
            + 0.5 - gx
        )
        rel_y = (
            jnp.arange(wy, dtype=jnp.float32) + y0.astype(jnp.float32)
            + 0.5 - gy
        )
        raylen_w = _sweep_frame(
            vs, op_w, rel_x, rel_y, rel_z, rot_s2w, gate,
            max_distance, vertical_fov, v_rays, h_rays,
        )
        return lax.dynamic_update_slice(
            jnp.zeros((nz, ny, nx), jnp.float32), raylen_w, (0, y0, x0)
        )

    rel_x = jnp.arange(nx, dtype=jnp.float32) + 0.5 - gx  # [nx]
    rel_y = jnp.arange(ny, dtype=jnp.float32) + 0.5 - gy
    return _sweep_frame(
        vs, opaque, rel_x, rel_y, rel_z, rot_s2w, gate,
        max_distance, vertical_fov, v_rays, h_rays,
    )


# margin (voxels) beyond the max-distance ball kept inside the sweep window:
# generous cover for the interpolation tents' lateral support so in-range
# values are unaffected by the crop (see raycast_sweep docstring)
_WINDOW_MARGIN = 8


def _window_sizes(
    nx: int, ny: int, vs: float, bound: float | None
) -> tuple[int, int]:
    if bound is None:
        return nx, ny
    r = int(math.ceil(bound / vs)) + _WINDOW_MARGIN
    w = 2 * r + 1
    return min(nx, w), min(ny, w)


def _sweep_frame(
    vs, opaque, rel_x, rel_y, rel_z, rot_s2w, gate,
    max_distance, vertical_fov, v_rays, h_rays,
):
    """The six cone sweeps + assembly on one (possibly windowed) frame."""
    nz, ny, nx = opaque.shape
    sweep_cones = _sweep_cones
    op = opaque.astype(jnp.float32)

    # --- six cone sweeps, grouped to minimize sequential steps ----------------
    # grid layout is (z, y, x).  The x± and y± cones share one 4-wide scan
    # over max(nx, ny) steps with lateral planes padded to a common shape;
    # z± ride a second 2-wide scan of nz steps.  Sequential plane steps are
    # the dominant cost (measured): nx+nz vs 2*(nx+ny+nz) of naive sweeps.
    def _pad_tail(a, axis, n, value):
        if a.shape[axis] >= n:
            return a
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, n - a.shape[axis])
        return jnp.pad(a, widths, constant_values=value)

    def _extend_rel(rel, n):
        k = n - rel.shape[0]
        if k <= 0:
            return rel
        tail = rel[-1] + jnp.arange(1, k + 1, dtype=rel.dtype)
        return jnp.concatenate([rel, tail])

    ns_a = max(nx, ny)
    pb = max(nx, ny)
    op_x = jnp.moveaxis(op, 2, 0)  # [nx, nz, ny]
    op_y = jnp.moveaxis(op, 1, 0)  # [ny, nz, nx]
    planes_a = jnp.stack(
        [
            _pad_tail(_pad_tail(op_x, 2, pb, 0.0), 0, ns_a, 0.0),
            _pad_tail(_pad_tail(op_x[::-1], 2, pb, 0.0), 0, ns_a, 0.0),
            _pad_tail(_pad_tail(op_y, 2, pb, 0.0), 0, ns_a, 0.0),
            _pad_tail(_pad_tail(op_y[::-1], 2, pb, 0.0), 0, ns_a, 0.0),
        ],
        axis=1,
    )  # [ns_a, 4, nz, pb]
    rs_a = jnp.stack(
        [
            _extend_rel(rel_x, ns_a),
            _extend_rel(-rel_x[::-1], ns_a),
            _extend_rel(rel_y, ns_a),
            _extend_rel(-rel_y[::-1], ns_a),
        ],
        axis=1,
    )  # [ns_a, 4]
    ra_a = jnp.broadcast_to(rel_z[None, :], (4, nz))
    rb_a = jnp.stack(
        [
            _extend_rel(rel_y, pb),
            _extend_rel(rel_y, pb),
            _extend_rel(rel_x, pb),
            _extend_rel(rel_x, pb),
        ]
    )  # [4, pb]
    t_a = sweep_cones(planes_a, rs_a, ra_a, rb_a)
    if gate is not None:
        t_a = t_a * _expand_gate(gate[:4], rs_a, ra_a, rb_a)
    tx_f = jnp.moveaxis(t_a[:nx, 0, :, :ny], 0, 2)  # -> (nz, ny, nx)
    tx_b = jnp.moveaxis(t_a[:nx, 1, :, :ny][::-1], 0, 2)
    ty_f = jnp.moveaxis(t_a[:ny, 2, :, :nx], 0, 1)  # -> (nz, ny, nx)
    ty_b = jnp.moveaxis(t_a[:ny, 3, :, :nx][::-1], 0, 1)

    planes_z = jnp.stack([op, op[::-1]], axis=1)  # [nz, 2, ny, nx]
    rs_z = jnp.stack([rel_z, -rel_z[::-1]], axis=1)
    ra_z = jnp.broadcast_to(rel_y[None, :], (2, ny))
    rb_z = jnp.broadcast_to(rel_x[None, :], (2, nx))
    t_z = sweep_cones(planes_z, rs_z, ra_z, rb_z)
    if gate is not None:
        t_z = t_z * _expand_gate(gate[4:], rs_z, ra_z, rb_z)
    tz_f, tz_b = t_z[:, 0], t_z[::-1, 1]

    return _assemble_raylen(
        vs, rel_x, rel_y, rel_z, tx_f, tx_b, ty_f, ty_b, tz_f, tz_b,
        rot_s2w, max_distance, vertical_fov, v_rays, h_rays,
    )


def _assemble_raylen(
    vs, rel_x, rel_y, rel_z, tx_f, tx_b, ty_f, ty_b, tz_f, tz_b,
    rot_s2w, max_distance, vertical_fov, v_rays, h_rays,
):
    """Cone partition + chord-length density (elementwise tail shared by the
    unsharded and z-sharded sweeps; ``rel_z`` and the t-fields may be local
    z-slabs)."""
    # --- cone partition (priority x > y > z on ties) --------------------------
    ax = jnp.abs(rel_x)[None, None, :]
    ay = jnp.abs(rel_y)[None, :, None]
    az = jnp.abs(rel_z)[:, None, None]
    in_x = (ax >= ay) & (ax >= az)
    in_y = (~in_x) & (ay >= az)
    in_z = ~(in_x | in_y)
    pos_x = rel_x[None, None, :] > 0
    pos_y = rel_y[None, :, None] > 0
    pos_z = rel_z[:, None, None] > 0

    T = (
        jnp.where(in_x & pos_x, tx_f, 0.0)
        + jnp.where(in_x & ~pos_x, tx_b, 0.0)
        + jnp.where(in_y & pos_y, ty_f, 0.0)
        + jnp.where(in_y & ~pos_y, ty_b, 0.0)
        + jnp.where(in_z & pos_z, tz_f, 0.0)
        + jnp.where(in_z & ~pos_z, tz_b, 0.0)
    )

    # --- chord-length density (continuum identity) ----------------------------
    rx = rel_x[None, None, :] * vs
    ry = rel_y[None, :, None] * vs
    rz = rel_z[:, None, None] * vs
    d2 = rx * rx + ry * ry + rz * rz
    d = jnp.sqrt(d2)
    d_safe = jnp.maximum(d, vs)

    # elevation in the SENSOR frame: s = R^T (c - o)
    Rt = rot_s2w.T
    sz = Rt[2, 0] * rx + Rt[2, 1] * ry + Rt[2, 2] * rz
    sin_el = jnp.clip(sz / d_safe, -1.0, 1.0)
    el = jnp.arcsin(sin_el)
    cos_el = jnp.maximum(jnp.cos(el), 0.05)

    d_az = 2.0 * math.pi / max(h_rays - 1, 1)
    d_el = vertical_fov / max(v_rays - 1, 1)
    density = 1.0 / (d_az * d_el * cos_el)  # rays per steradian

    fov = jnp.abs(el) <= (vertical_fov / 2.0 + d_el)
    in_range = d <= max_distance

    raylen = T * density * (vs**3) / jnp.maximum(d2, vs * vs)
    return jnp.where(fov & in_range, raylen, 0.0).astype(jnp.float32)


def raycast_sweep_zsharded(
    grid: GridSpec,
    opaque: Array,
    origin_world: Array,
    rot_s2w: Array,
    *,
    max_distance: Array,
    vertical_fov: float,
    v_rays: int,
    h_rays: int,
    gate: Array | None = None,
    max_distance_bound: float | None = None,
    axis: str,
    n_shards: int,
    zcone_mode: str = "pipelined",
) -> Array:
    """:func:`raycast_sweep` over a grid Z-sharded across ``n_shards`` mesh
    devices (``opaque`` is the local (nz/n, ny, nx) slab; must run inside
    shard_map).  The x/y cone group runs lateral-sharded (per-plane carry
    halos between devices, :func:`_sweep_cones_lat_sharded`); the z cone group runs
    per ``zcone_mode``: ``"pipelined"`` = sweep-sharded rounds
    (:func:`_sweep_cones_z_pipelined` — compute replicated n×, minimal
    traffic between devices),
    ``"transpose"`` = all_to_all to lateral(Y)-sharded and back
    (:func:`_sweep_cones_z_transposed` — per-shard FLOPs 1/n, two bf16
    volume all_to_alls).  Both modes match the unsharded sweep bit-for-bit
    (tests/test_grid_step.py) — including the static x/y window around the
    sensor (window offsets are replicated; only unsharded axes are
    cropped)."""
    nz, ny, nx = grid.shape  # GLOBAL
    nzl = opaque.shape[0]
    vs = grid.voxel_size
    ox, oy, oz = grid.origin
    gx = (origin_world[0] - ox) / vs
    gy = (origin_world[1] - oy) / vs
    gz = (origin_world[2] - oz) / vs

    z0 = lax.axis_index(axis) * nzl
    rel_z = (
        jnp.arange(nzl, dtype=jnp.float32) + z0.astype(jnp.float32) + 0.5 - gz
    )
    # global sweep offsets for the transposed z-cone mode (z is never cropped)
    rel_z_g = jnp.arange(nz, dtype=jnp.float32) + 0.5 - gz

    wx, wy = _window_sizes(nx, ny, vs, max_distance_bound)
    if (wx, wy) != (nx, ny):
        x0 = jnp.clip(jnp.floor(gx).astype(jnp.int32) - wx // 2, 0, nx - wx)
        y0 = jnp.clip(jnp.floor(gy).astype(jnp.int32) - wy // 2, 0, ny - wy)
        op_w = lax.dynamic_slice(opaque, (0, y0, x0), (nzl, wy, wx))
        rel_x = (
            jnp.arange(wx, dtype=jnp.float32) + x0.astype(jnp.float32)
            + 0.5 - gx
        )
        rel_y = (
            jnp.arange(wy, dtype=jnp.float32) + y0.astype(jnp.float32)
            + 0.5 - gy
        )
        raylen_w = _sweep_frame_zsharded(
            vs, op_w, rel_x, rel_y, rel_z, rel_z_g, rot_s2w, gate,
            max_distance, vertical_fov, v_rays, h_rays, axis, n_shards,
            zcone_mode,
        )
        return lax.dynamic_update_slice(
            jnp.zeros((nzl, ny, nx), jnp.float32), raylen_w, (0, y0, x0)
        )

    rel_x = jnp.arange(nx, dtype=jnp.float32) + 0.5 - gx
    rel_y = jnp.arange(ny, dtype=jnp.float32) + 0.5 - gy
    return _sweep_frame_zsharded(
        vs, opaque, rel_x, rel_y, rel_z, rel_z_g, rot_s2w, gate,
        max_distance, vertical_fov, v_rays, h_rays, axis, n_shards,
        zcone_mode,
    )


def _sweep_frame_zsharded(
    vs, opaque, rel_x, rel_y, rel_z, rel_z_global, rot_s2w, gate,
    max_distance, vertical_fov, v_rays, h_rays, axis, n_shards, zcone_mode,
):
    """The six Z-sharded cone sweeps + assembly on one (windowed) frame."""
    nzl, ny, nx = opaque.shape
    op = opaque.astype(jnp.float32)

    def _pad_tail(a, axis_i, n, value):
        if a.shape[axis_i] >= n:
            return a
        widths = [(0, 0)] * a.ndim
        widths[axis_i] = (0, n - a.shape[axis_i])
        return jnp.pad(a, widths, constant_values=value)

    def _extend_rel(rel, n):
        k = n - rel.shape[0]
        if k <= 0:
            return rel
        tail = rel[-1] + jnp.arange(1, k + 1, dtype=rel.dtype)
        return jnp.concatenate([rel, tail])

    # --- x/y cones: sweep axes unsharded, lateral A (= grid z) sharded -------
    ns_a = max(nx, ny)
    pb = max(nx, ny)
    op_x = jnp.moveaxis(op, 2, 0)  # [nx, nzl, ny]
    op_y = jnp.moveaxis(op, 1, 0)  # [ny, nzl, nx]
    planes_a = jnp.stack(
        [
            _pad_tail(_pad_tail(op_x, 2, pb, 0.0), 0, ns_a, 0.0),
            _pad_tail(_pad_tail(op_x[::-1], 2, pb, 0.0), 0, ns_a, 0.0),
            _pad_tail(_pad_tail(op_y, 2, pb, 0.0), 0, ns_a, 0.0),
            _pad_tail(_pad_tail(op_y[::-1], 2, pb, 0.0), 0, ns_a, 0.0),
        ],
        axis=1,
    )  # [ns_a, 4, nzl, pb]
    rs_a = jnp.stack(
        [
            _extend_rel(rel_x, ns_a),
            _extend_rel(-rel_x[::-1], ns_a),
            _extend_rel(rel_y, ns_a),
            _extend_rel(-rel_y[::-1], ns_a),
        ],
        axis=1,
    )
    ra_a = jnp.broadcast_to(rel_z[None, :], (4, nzl))
    rb_a = jnp.stack(
        [
            _extend_rel(rel_y, pb),
            _extend_rel(rel_y, pb),
            _extend_rel(rel_x, pb),
            _extend_rel(rel_x, pb),
        ]
    )
    t_a = _sweep_cones_lat_sharded(planes_a, rs_a, ra_a, rb_a, axis, n_shards)
    if gate is not None:
        t_a = t_a * _expand_gate(gate[:4], rs_a, ra_a, rb_a)
    tx_f = jnp.moveaxis(t_a[:nx, 0, :, :ny], 0, 2)  # -> (nzl, ny, nx)
    tx_b = jnp.moveaxis(t_a[:nx, 1, :, :ny][::-1], 0, 2)
    ty_f = jnp.moveaxis(t_a[:ny, 2, :, :nx], 0, 1)
    ty_b = jnp.moveaxis(t_a[:ny, 3, :, :nx][::-1], 0, 1)

    # --- z cones: sweep-sharded/pipelined, or transposed to lateral-sharded --
    rs_z = jnp.stack([rel_z, -rel_z[::-1]], axis=1)
    ra_z = jnp.broadcast_to(rel_y[None, :], (2, ny))
    rb_z = jnp.broadcast_to(rel_x[None, :], (2, nx))
    if zcone_mode == "transpose":
        t_z = _sweep_cones_z_transposed(
            op, rel_z_global, rel_y, rel_x, axis, n_shards
        )
    else:
        planes_z = jnp.stack([op, op[::-1]], axis=1)  # [nzl, 2, ny, nx]
        t_z = _sweep_cones_z_pipelined(
            planes_z, rs_z, ra_z, rb_z, axis, n_shards
        )
    if gate is not None:
        t_z = t_z * _expand_gate(gate[4:], rs_z, ra_z, rb_z)
    tz_f, tz_b = t_z[:, 0], t_z[::-1, 1]

    return _assemble_raylen(
        vs, rel_x, rel_y, rel_z, tx_f, tx_b, ty_f, ty_b, tz_f, tz_b,
        rot_s2w, max_distance, vertical_fov, v_rays, h_rays,
    )
