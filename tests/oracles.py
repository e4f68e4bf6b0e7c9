"""NumPy reference implementations of the reference-C++ semantics.

Written from the behavior of /root/reference (cited per function), these are
the golden oracles the JAX kernels are tested against on tiny grids.
"""

from __future__ import annotations

import math

import numpy as np


def ball_offsets_np(radius: float):
    r = int(math.floor(radius))
    out = []
    for dz in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dz * dz + dy * dy + dx * dx <= radius * radius + 1e-9:
                    out.append((dz, dy, dx))
    return out


def ball_pool_min_np(a: np.ndarray, radius: float) -> np.ndarray:
    fill = np.iinfo(a.dtype).max if a.dtype.kind == "i" else np.inf
    out = np.full_like(a, fill)
    nz, ny, nx = a.shape
    for dz, dy, dx in ball_offsets_np(radius):
        src = np.full_like(out, fill)
        zs = slice(max(0, -dz), min(nz, nz - dz))
        ys = slice(max(0, -dy), min(ny, ny - dy))
        xs = slice(max(0, -dx), min(nx, nx - dx))
        zs2 = slice(max(0, dz), min(nz, nz + dz))
        ys2 = slice(max(0, dy), min(ny, ny + dy))
        xs2 = slice(max(0, dx), min(nx, nx + dx))
        src[zs, ys, xs] = a[zs2, ys2, xs2]
        out = np.minimum(out, src)
    return out


def euclidean_clusters_np(occupied: np.ndarray, radius: float):
    """ECE over occupied voxels with tolerance = radius index units
    (ref vofod_nodelet.cpp:689-698 on voxel-center points)."""
    offs = ball_offsets_np(radius)
    labels = -np.ones(occupied.shape, np.int64)
    nz, ny, nx = occupied.shape
    comp = 0
    for z0, y0, x0 in zip(*np.nonzero(occupied)):
        if labels[z0, y0, x0] >= 0:
            continue
        stack = [(z0, y0, x0)]
        labels[z0, y0, x0] = comp
        while stack:
            z, y, x = stack.pop()
            for dz, dy, dx in offs:
                zz, yy, xx = z + dz, y + dy, x + dx
                if 0 <= zz < nz and 0 <= yy < ny and 0 <= xx < nx:
                    if occupied[zz, yy, xx] and labels[zz, yy, xx] < 0:
                        labels[zz, yy, xx] = comp
                        stack.append((zz, yy, xx))
        comp += 1
    return labels, comp


def dda_raylen_np(
    shape, origin, voxel, starts, dirs, lengths, valid
) -> np.ndarray:
    """Per-ray Amanatides–Woo accumulation (ref voxel_map.cpp:229-263).

    shape = (nz, ny, nx); origin = world coords of voxel (0,0,0) low corner.
    """
    nz, ny, nx = shape
    out = np.zeros(shape, np.float64)
    ox, oy, oz = origin
    for s, d, L, v in zip(starts, dirs, lengths, valid):
        if not v or L <= 0:
            continue
        absdir = np.abs(d)
        step = np.sign(d).astype(int)
        with np.errstate(divide="ignore"):
            tdelta = np.where(absdir > 0, voxel / absdir, np.inf)
        cur = np.floor((s - [ox, oy, oz]) / voxel).astype(int)  # (x, y, z)
        ctr = (cur + 0.5) * voxel + [ox, oy, oz] - s
        with np.errstate(divide="ignore", invalid="ignore"):
            tmax = np.where(
                absdir > 0, (voxel / 2 + step * ctr) / absdir, np.inf
            )
        last = np.where(step > 0, [nx - 1, ny - 1, nz - 1], 0)
        prev = 0.0
        while prev < L:
            i = int(np.argmin(tmax))
            dist = tmax[i]
            dd = min(dist, L) - prev
            out[cur[2], cur[1], cur[0]] += dd
            prev = dist
            if cur[i] == last[i]:
                break
            cur[i] += step[i]
            tmax[i] += tdelta[i]
    return out


def explore_to_ground_np(
    vals: np.ndarray, start_xyz, unknown_thr, ground_thr, max_voxel_dist
):
    """DFS of ref voxel_map.cpp:402-488. start_xyz = (ix, iy, iz).

    Returns (connected, explored_unknown set of (ix, iy, iz))."""
    nz, ny, nx = vals.shape
    x0, y0, z0 = start_xyz
    if x0 <= 0 or y0 <= 0 or z0 <= 0:
        return True, set()
    if x0 >= nx - 1 or y0 >= ny - 1 or z0 >= nz - 1:
        return True, set()
    explored = set()
    explored_unknown = []
    to_explore = [(x0, y0, z0)]
    while to_explore:
        cur = to_explore.pop()
        x, y, z = cur
        v = vals[z, y, x]
        if v > ground_thr:
            return True, set()
        if v > unknown_thr:
            explored_unknown.append(cur)
            manh = abs(x - x0) + abs(y - y0) + abs(z - z0)
            if manh == max_voxel_dist - 1:
                return True, set()
            for dx, dy, dz in (
                (1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0), (0, -1, 0), (0, 0, -1),
            ):
                xx, yy, zz = x + dx, y + dy, z + dz
                if not (0 <= xx < nx and 0 <= yy < ny and 0 <= zz < nz):
                    continue
                # ref bounds guards (expand only if strictly inside)
                if dx > 0 and x >= nx - 1:
                    continue
                if dy > 0 and y >= ny - 1:
                    continue
                if dz > 0 and z >= nz - 1:
                    continue
                if dx < 0 and x <= 0:
                    continue
                if dy < 0 and y <= 0:
                    continue
                if dz < 0 and z <= 0:
                    continue
                cand = (xx, yy, zz)
                manh2 = abs(xx - x0) + abs(yy - y0) + abs(zz - z0)
                if cand not in explored and manh2 <= max_voxel_dist:
                    to_explore.append(cand)
        explored.add(cur)
    return False, set(explored_unknown)


def voxel_grid_counted_quirk_np(
    pts, intensity, valid, leaf, threshold, origin, out_shape
):
    """Verbatim VoxelGridCounted with the 4th-pass indexing quirk
    (ref src/voxel_grid_counted.cpp:124-199): build (cell_id, point_idx)
    for valid points in input order, sort by cell id, then per run count
    ``intensity > threshold`` over RAW INPUT POSITIONS [first, last)
    (:185-187) — not the stored point indices."""
    nz, ny, nx = out_shape
    o = np.asarray(origin, np.float64)
    index_vector = []  # (cell_id, point_idx) in input order
    for i, (p, v) in enumerate(zip(pts, valid)):
        if not v:
            continue
        c = np.floor((np.asarray(p, np.float64) - o) / leaf).astype(int)
        if (c < 0).any() or c[0] >= nx or c[1] >= ny or c[2] >= nz:
            continue
        cell_id = c[0] + c[1] * nx + c[2] * nx * ny  # PCL: x fastest
        index_vector.append((cell_id, i, tuple(c)))
    index_vector.sort(key=lambda t: t[0])  # std::sort by idx only
    counts = np.zeros(out_shape, np.int64)
    sure = np.zeros(out_shape, np.int64)
    k = 0
    while k < len(index_vector):
        j = k + 1
        while j < len(index_vector) and index_vector[j][0] == index_vector[k][0]:
            j += 1
        cx, cy, cz = index_vector[k][2]
        counts[cz, cy, cx] = j - k
        # QUIRK: count over raw input positions [k, j), not point indices
        sure[cz, cy, cx] = sum(
            1 for r in range(k, j) if intensity[r] > threshold
        )
        k = j
    return counts, sure


def sepclusters_exact_np(
    vals,
    thr_new,
    thr_sure,
    min_sure_points,
    max_dist_idx,
    score_ray,
    its_diff,
    quirk_indexing,
):
    """Verbatim updateSeparatedBGClusters (ref vofod_nodelet.cpp:1124-1294)
    on a (nz, ny, nx) value grid, coarse lattice anchored at the grid origin
    (documented deviation from PCL's data-min anchor; identical membership
    for leaf size 1).  Returns (new_vals, sure_sufficient)."""
    nz, ny, nx = vals.shape
    mv = math.ceil(max_dist_idx)  # max_voxel_dist (ref :1143)
    lsz = max(mv - 1, 1)  # ref :1162 (PCL breaks at 0)

    # voxelsAsVoxelPC: x outer, y, z fastest (ref voxel_map.cpp:190-196);
    # point = (ix, iy, iz), intensity = mapval
    export = []
    for x in range(nx):
        for y in range(ny):
            for z in range(nz):
                if vals[z, y, x] > thr_new:
                    export.append(((x, y, z), vals[z, y, x]))
    if not export:
        return vals.copy(), False

    ncx = (nx + lsz - 1) // lsz
    ncy = (ny + lsz - 1) // lsz
    ncz = (nz + lsz - 1) // lsz
    pts = np.array([p for p, _ in export], np.float64)
    inten = np.array([i for _, i in export], np.float64)
    counts, sure = (
        voxel_grid_counted_quirk_np(
            pts, inten, np.ones(len(export), bool), lsz, thr_sure,
            (0.0, 0.0, 0.0), (ncz, ncy, ncx),
        )
        if quirk_indexing
        else _counted_spec_np(
            pts, inten, lsz, thr_sure, (ncz, ncy, ncx)
        )
    )

    # cluster coarse cells: centers lsz apart, tolerance mv (ref :1171)
    occ_c = counts > 0
    labels, ncomp = euclidean_clusters_np(occ_c, mv / lsz)
    new_vals = vals.copy()
    sure_sufficient = False
    cluster_sure = [
        sure[labels == c].sum() for c in range(ncomp)
    ]
    if not any(s >= min_sure_points for s in cluster_sure):
        return new_vals, False  # early return, no demotion (ref :1197-1206)
    sure_sufficient = True
    w1 = min(max(0.5**its_diff, 0.0), 1.0)
    offs = ball_offsets_np(max_dist_idx)
    for c in range(ncomp):
        if cluster_sure[c] >= min_sure_points:
            continue
        for cz, cy, cx in zip(*np.nonzero(labels == c)):
            # demotion around the coarse cell center cast<int> (ref :1253)
            pz, py, px = cz * lsz + lsz // 2, cy * lsz + lsz // 2, cx * lsz + lsz // 2
            for dz, dy, dx in offs:
                z, y, x = pz + dz, py + dy, px + dx
                if 0 <= z < nz and 0 <= y < ny and 0 <= x < nx:
                    new_vals[z, y, x] = (
                        w1 * new_vals[z, y, x] + (1 - w1) * score_ray
                    )
    return new_vals, sure_sufficient


def _counted_spec_np(pts, inten, leaf, thr, out_shape):
    counts = np.zeros(out_shape, np.int64)
    sure = np.zeros(out_shape, np.int64)
    for p, i in zip(pts, inten):
        c = np.floor(np.asarray(p, np.float64) / leaf).astype(int)
        counts[c[2], c[1], c[0]] += 1
        if i > thr:
            sure[c[2], c[1], c[0]] += 1
    return counts, sure


def gate_faces_np(gate, lut, active, R):
    """Angular-gate faces (ops/raycast.py gate_faces) in float64, an
    independent per-texel ground truth: pool the active image, invert the
    TRUE per-row elevation table per texel (searchsorted + linear
    extrapolation with the end-segment slope), tent-sample."""
    H, W = lut.height, lut.width
    G = np.asarray(active, np.float64).reshape(
        gate.n_rows, gate.pool_v, gate.n_cols, gate.pool_h
    ).mean(axis=(1, 3))
    el_row = np.arcsin(
        np.clip(lut.directions.reshape(H, W, 3)[..., 2], -1, 1)
    ).mean(axis=1)

    d_s = gate.face_dirs.reshape(-1, 3).astype(np.float64) @ np.asarray(R)
    el = np.arcsin(np.clip(d_s[:, 2], -1, 1))
    az = np.arctan2(d_s[:, 1], d_s[:, 0])

    # invert el_row (monotone decreasing for top-down tables)
    sgn = 1.0 if el_row[-1] > el_row[0] else -1.0
    f = sgn * el_row
    t = sgn * el
    seg = np.clip(np.searchsorted(f, t, side="right") - 1, 0, H - 2)
    row_f = seg + (t - f[seg]) / (f[seg + 1] - f[seg])
    g_r = (row_f + 0.5) / gate.pool_v - 0.5
    g_c = np.mod(
        ((az - gate.az_b) / gate.az_a + 0.5) / gate.pool_h - 0.5,
        gate.col_period,
    )
    kr = np.arange(gate.n_rows)
    kc = np.arange(gate.n_cols)
    w_r = np.maximum(0.0, 1.0 - np.abs(g_r[:, None] - kr[None, :]))
    d0 = np.abs(g_c[:, None] - kc[None, :])
    dwrap = np.minimum(
        d0,
        np.minimum(
            np.abs(g_c[:, None] - gate.col_period - kc[None, :]),
            np.abs(g_c[:, None] + gate.col_period - kc[None, :]),
        ),
    )
    w_c = np.maximum(0.0, 1.0 - dwrap)
    w_c = w_c / np.maximum(w_c.sum(axis=-1, keepdims=True), 1e-6)
    vals = np.sum(w_r * (w_c @ G.T), axis=-1)
    F = gate.face_dirs.shape[1]
    return vals.reshape(6, F, F)
