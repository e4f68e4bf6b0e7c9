"""Whole-pipeline NumPy oracle: the reference's scan -> detections semantics.

A faithful scan-for-scan replay of the reference nodelet's processing, composed
from the per-kernel oracles in tests/oracles.py, run under the deterministic
schedule (DESIGN.md §4) that replaces the reference's thread interleaving:

  CNC (processMsg, /root/reference/src/vofod_nodelet.cpp:882-1096):
    filterAndTransform (:619-686) -> VoxelGridWeighted binning
    (voxel_grid_weighted.cpp:119-190) -> ECE clustering (:689-698) ->
    findCloseFarClusters with the hasCloseTo asymmetric-bounds behavior
    (voxel_map.cpp:376-400) -> updateVMaps EMA (:776-796) ->
    classify_cluster with SEQUENTIAL exploreToGround + live demotion
    (:1647-1731, voxel_map.cpp:402-488) -> extractDetections (:833-880).
  RAYCASTING (raycast_cloud, :1396-1606): per-pixel DDA chord accumulation
    (voxel_map.cpp:229-263) + flag-guarded EMA, both update rules,
    its_diff = raycast_every.
  SEPBGCLUSTERS (updateSeparatedBGClusters, :1124-1294): every
    ``sepclusters_every`` steps via oracles.sepclusters_exact_np.

Documented modeling choices (places where the reference's behavior is
ambiguous or thread-timing-dependent; all follow the deterministic schedule):

* cluster extraction order = ascending minimum flat voxel id (PCL ECE seeds
  clusters in cloud order, which is ascending cell id; PCL additionally
  re-sorts extracted clusters by size, which can permute SAME-SCAN detection
  ids — parity tests therefore match detections by position, not id).
* ECE adjacency resolves exact-tolerance lattice ties INCLUSIVELY
  (||Δidx|| <= tol/voxel + eps), the same convention as ops/morphology.
* the raycast flags window is the current scan's occupied set (exact for
  raycast_every == 1; the async reference accumulates flags over the scans
  elapsed while its raycast thread runs).

Map values are float32 throughout, like the reference's VoxelMap::data_t.
"""

from __future__ import annotations

import math

import numpy as np

from tests.oracles import (
    dda_raylen_np,
    euclidean_clusters_np,
    explore_to_ground_np,
    sepclusters_exact_np,
)

F32 = np.float32


def _in_box(pts, lo, hi):
    lo = np.asarray(lo, F32)
    hi = np.asarray(hi, F32)
    return np.all((pts >= lo) & (pts <= hi), axis=-1)


class RefPipeline:
    """NumPy replay of the reference pipeline (see module docstring).

    Drives the same VoFODConfig / DynParams / XyzLut as the JAX step, so a
    parity test feeds identical scans to both and compares outputs.
    """

    def __init__(self, cfg, dyn, lut, mask=None, raycast_every: int = 1):
        self.cfg = cfg
        self.dyn = dyn
        self.raycast_every = int(raycast_every)
        self.dirs = np.asarray(lut.directions, F32)
        self.offs = np.asarray(lut.offsets, F32)
        n = self.dirs.shape[0]
        self.mask = (
            np.ones(n, bool) if mask is None else np.asarray(mask).reshape(-1) > 0
        )

        self.shape = cfg.grid_shape  # (nz, ny, nx)
        self.origin = np.asarray(cfg.grid_origin, F32)
        self.voxel = F32(cfg.voxel_size)
        self.vmap = np.full(self.shape, F32(dyn.score_init), F32)
        self.bg_sufficient = False  # sticky m_background_pts_sufficient
        self.sure_bg_sufficient = False  # m_sure_background_sufficient
        self.det_counter = 0  # m_last_detection_id
        self.step_i = 0

    # -- live-tunable stencil radii (cfg.dynamic_radii) -----------------------
    def _ground_radius_idx(self) -> float:
        """Clustering/close-split radius in voxels: the DynParams field when
        cfg.dynamic_radii is on (pipeline/background.py:48-56), else the
        static config value — the reference tunes both radii live via
        dynamic_reconfigure (DetectionParams.cfg)."""
        m = (
            self.dyn.ground_points_max_distance
            if getattr(self.cfg, "dynamic_radii", False)
            else self.cfg.ground_points_max_distance
        )
        return m / self.cfg.voxel_size

    def _sep_radius_idx(self) -> float:
        """Sepclusters adjacency/demotion radius in voxels (see
        pipeline/sepclusters.py:85-96)."""
        m = (
            self.dyn.sepclusters_max_bg_distance
            if getattr(self.cfg, "dynamic_radii", False)
            else self.cfg.sepclusters_max_bg_distance
        )
        return m / self.cfg.voxel_size

    # -- coordinate math (float32, like VoxelMap) ----------------------------
    def _coord_to_idx(self, pts):
        return np.floor(
            (pts.astype(F32) - self.origin) * F32(1.0 / self.voxel)
        ).astype(np.int64)

    def _centers(self, idx):
        return (idx.astype(F32) + F32(0.5)) * self.voxel + self.origin

    def _in_limits_idx(self, idx):
        nz, ny, nx = self.shape
        return np.all((idx >= 0) & (idx < np.array([nx, ny, nz])), axis=-1)

    # -- rangefinder fusion ----------------------------------------------------
    def rangefinder(self, rng, min_range, max_range, pose):
        """Fuse a downward rangefinder hit (ref processMsg(Range),
        vofod_nodelet.cpp:580-613): validity gate, transform the range
        along sensor +x to world, and half-EMA the hit voxel toward
        dyn.score_point.  Spec-correct || validity by default; the
        reference's && quirk (:585) behind cfg.compat_rangefinder_validity.
        Returns whether the measurement was fused."""
        if getattr(self.cfg, "compat_rangefinder_validity", False):
            if rng <= min_range and rng >= max_range:
                return False
        else:
            if rng <= min_range or rng >= max_range:
                return False
        T = np.asarray(pose, F32)
        pt = (T @ np.array([rng, 0.0, 0.0, 1.0], F32))[:3]
        idx = self._coord_to_idx(pt[None, :])
        if not self._in_limits_idx(idx)[0]:
            return False
        x, y, z = idx[0]
        self.vmap[z, y, x] = F32(
            (self.vmap[z, y, x] + F32(self.dyn.score_point)) / 2.0
        )
        return True

    # -- CNC stage ------------------------------------------------------------
    def _frontend(self, ranges_mm, pose):
        """filterAndTransform + VoxelGridWeighted: counts grid over the map
        lattice (weighted cloud == {voxel centers, weight=count})."""
        cfg = self.cfg
        r = ranges_mm.astype(F32) * F32(0.001)
        pts_s = self.dirs * r[:, None] + self.offs
        excl = _in_box(pts_s, cfg.exclude_box.lo, cfg.exclude_box.hi)
        R = np.asarray(pose, F32)[:3, :3]
        t = np.asarray(pose, F32)[:3, 3]
        pts_w = pts_s @ R.T + t
        inop = _in_box(pts_w, cfg.oparea.lo, cfg.oparea.hi)
        valid = ~excl & inop

        idx = self._coord_to_idx(pts_w[valid])
        inb = self._in_limits_idx(idx)
        idx = idx[inb]
        nz, ny, nx = self.shape
        counts = np.zeros(self.shape, np.int64)
        np.add.at(counts, (idx[:, 2], idx[:, 1], idx[:, 0]), 1)
        return counts, r, pts_w

    def _has_close_to(self, bg_mask, q, mvd, max_dist_idx):
        """ref VoxelMap::hasCloseTo (voxel_map.cpp:376-400): search box
        [q - mvd, q + mvd) per axis (EXCLUSIVE upper bound), euclidean index
        distance <= max_dist_idx."""
        nz, ny, nx = self.shape
        qx, qy, qz = q
        for x in range(max(0, qx - mvd), min(nx, qx + mvd)):
            for y in range(max(0, qy - mvd), min(ny, qy + mvd)):
                for z in range(max(0, qz - mvd), min(nz, qz + mvd)):
                    if bg_mask[z, y, x] and math.sqrt(
                        (x - qx) ** 2 + (y - qy) ** 2 + (z - qz) ** 2
                    ) <= max_dist_idx:
                        return True
        return False

    def _classify_and_detect(self, clusters, is_close, sensor_pos):
        """classify_cluster (:1647-1731) with SEQUENTIAL explore + live
        demotion, then extractDetections (:833-880)."""
        cfg, dyn = self.cfg, self.dyn
        nz, ny, nx = self.shape
        detections = []
        clusters_out = []
        for ci, members in enumerate(clusters):
            if is_close[ci]:
                continue
            mem = np.array(sorted(members))  # [M] flat ids, ascending
            mx = mem % nx
            myy = (mem // nx) % ny
            mz = mem // (nx * ny)
            centers = self._centers(np.stack([mx, myy, mz], axis=1))
            aabb_min = centers.min(axis=0)
            aabb_max = centers.max(axis=0)
            n = len(mem)

            mean = centers.mean(axis=0, dtype=np.float64)
            d = centers.astype(np.float64) - mean
            cov = (d.T @ d) / n
            evals, evecs = np.linalg.eigh(cov)  # ascending
            major, middle = evecs[:, 2], evecs[:, 1]
            minor = np.cross(major, middle)
            axes = np.stack([major, middle, minor])  # rows
            proj = d @ axes.T
            pmin, pmax = proj.min(axis=0), proj.max(axis=0)
            obb_center = (mean + axes.T @ ((pmin + pmax) / 2)).astype(F32)
            obb_size = float(np.linalg.norm(pmax - pmin))

            cclass = "invalid"
            dist = float(np.linalg.norm(sensor_pos - obb_center))
            gated = (
                n >= dyn.cls_min_points
                and dist <= dyn.cls_max_distance
                and obb_size <= dyn.cls_max_size
            )
            if gated:
                if self.bg_sufficient and self.sure_bg_sufficient:
                    floating = True
                    mvdist = int(
                        (obb_size + dyn.cls_max_explore_distance) / cfg.voxel_size
                    )
                    for x, y, z in zip(mx, myy, mz):
                        connected, explored = explore_to_ground_np(
                            self.vmap,
                            (x, y, z),
                            dyn.thr_frontiers,
                            dyn.thr_new_obstacles,
                            mvdist,
                        )
                        if connected:
                            floating = False
                            break
                        # demote immediately (ref :1709-1716) — visible to
                        # the remaining queries
                        for ex, ey, ez in explored:
                            self.vmap[ez, ey, ex] = F32(dyn.thr_frontiers)
                else:
                    floating = False
                cclass = "mav" if floating else "unknown"
            clusters_out.append(
                dict(n=n, cclass=cclass, obb_center=obb_center, obb_size=obb_size)
            )
            if cclass != "mav":
                continue

            # --- extractDetections (:833-880) -------------------------------
            lo_i = self._coord_to_idx(aabb_min[None, :])[0]
            hi_i = self._coord_to_idx(aabb_max[None, :])[0]
            sizes = np.array([nx, ny, nz])
            lo_i = np.clip(lo_i - 2, 0, sizes - 1)
            hi_i = np.clip(hi_i + 2, 0, sizes - 1)
            sub = self.vmap[
                lo_i[2] : hi_i[2] + 1, lo_i[1] : hi_i[1] + 1, lo_i[0] : hi_i[0] + 1
            ].copy()
            sub[mz - lo_i[2], myy - lo_i[1], mx - lo_i[0]] = F32(dyn.score_ray)
            unc = float(np.sum(1.0 - sub.astype(np.float64) / dyn.score_ray)) / n
            confidence = math.exp(-unc)

            vres = self.cfg.sensor.vertical_fov / self.cfg.sensor.vertical_rays
            hres = 2.0 * math.pi / self.cfg.sensor.horizontal_rays
            ang = math.atan(1.0 / dist) if dist > 0 else math.pi / 2
            pdet = min(ang / (vres * dyn.cls_min_points), 1.0) * min(
                ang / hres, 1.0
            )

            detections.append(
                dict(
                    id=self.det_counter,
                    position=obb_center,
                    n_points=n,
                    confidence=confidence,
                    detection_probability=pdet,
                    covariance=math.sqrt(dist) * dyn.output_position_sigma,
                    aabb_min=aabb_min,
                    aabb_max=aabb_max,
                )
            )
            self.det_counter += 1
        return detections, clusters_out

    # -- RAYCASTING stage ------------------------------------------------------
    def _raycast(self, ranges_mm, intensity, pose, occupied):
        cfg, dyn = self.cfg, self.dyn
        if dyn.raycast_pause:
            return
        R = np.asarray(pose, np.float64)[:3, :3]
        t = np.asarray(pose, np.float64)[:3, 3]
        oidx = self._coord_to_idx(np.asarray(t, F32)[None, :])[0]
        if not self._in_limits_idx(oidx[None, :])[0]:
            return  # sensor outside the oparea: no raycast (:1432, :1527)
        r = ranges_mm.astype(np.float64) * 0.001
        dirs_w = self.dirs.astype(np.float64) @ R.T
        starts = self.offs.astype(np.float64) @ R.T + t
        lengths = np.where(
            r == 0.0, dyn.raycast_max_distance,
            np.minimum(r - cfg.voxel_size, dyn.raycast_max_distance),
        )
        sidx = self._coord_to_idx(starts.astype(F32))
        valid = (
            # negated ref skip rule (:1449) — NaN intensity passes
            ~(intensity < dyn.raycast_min_intensity)
            & (self.mask | (r > 0))
            & self._in_limits_idx(sidx)
        )
        raylen = dda_raylen_np(
            self.shape, self.origin, float(cfg.voxel_size), starts, dirs_w,
            lengths, valid,
        ).astype(F32)
        max_val = float(raylen.max())
        if max_val == 0.0:
            return  # ref :1551-1556

        its = F32(self.raycast_every)
        active = (~occupied) & (raylen > 0)
        if dyn.raycast_new_update_rule:
            voxel_diag = F32(math.sqrt(3.0) * cfg.voxel_size)
            n_int = F32(dyn.raycast_weight_coefficient) / voxel_diag * raylen
            w1 = np.exp2(-its * n_int, dtype=F32)
        else:
            w_single = F32(dyn.raycast_weight_coefficient) * np.sqrt(
                raylen / F32(max_val), dtype=F32
            )
            w1 = np.clip((F32(1.0) - w_single) ** its, 0.0, 1.0).astype(F32)
        updated = w1 * self.vmap + (F32(1.0) - w1) * F32(dyn.score_ray)
        self.vmap = np.where(active, updated, self.vmap).astype(F32)

    # -- the full step ---------------------------------------------------------
    def step(self, ranges_mm, intensity, pose):
        """One scan through the deterministic schedule.  Returns
        (detections, diag dict)."""
        cfg, dyn = self.cfg, self.dyn
        ranges_mm = np.asarray(ranges_mm).reshape(-1)
        intensity = np.asarray(intensity).reshape(-1)
        sensor_pos = np.asarray(pose, F32)[:3, 3]

        # 1. frontend
        counts, r, pts_w = self._frontend(ranges_mm, pose)
        occupied = counts > 0

        # 2. background sufficiency (pre-update map; sticky, ref :713-725)
        bg_mask = self.vmap > F32(dyn.thr_new_obstacles)
        n_bg = int(bg_mask.sum())
        if n_bg > cfg.background_min_sufficient_pts:
            self.bg_sufficient = True

        # 3. ECE clustering + close/far split
        radius = self._ground_radius_idx()
        labels, ncomp = euclidean_clusters_np(occupied, radius)
        nz, ny, nx = self.shape
        flat_ids = {}
        for z, y, x in zip(*np.nonzero(occupied)):
            flat_ids.setdefault(labels[z, y, x], []).append((z * ny + y) * nx + x)
        clusters = [flat_ids[c] for c in range(ncomp)]

        mvd = int(math.ceil(radius))
        is_close = []
        for members in clusters:
            close = False
            for fid in sorted(members):
                x = fid % nx
                y = (fid // nx) % ny
                z = fid // (nx * ny)
                if self._has_close_to(bg_mask, (x, y, z), mvd, radius):
                    close = True
                    break
            is_close.append(close)

        # 4. point EMA update (ref updateVoxel :776-796)
        w = np.exp2(-np.clip(counts, 0, 63).astype(F32))
        score = np.zeros(self.shape, F32)
        for ci, members in enumerate(clusters):
            s = dyn.score_point if is_close[ci] else dyn.score_unknown
            for fid in members:
                z, rem = divmod(fid, nx * ny)
                y, x = divmod(rem, nx)
                score[z, y, x] = s
        self.vmap = np.where(
            occupied, w * self.vmap + (F32(1.0) - w) * score.astype(F32), self.vmap
        ).astype(F32)

        # 5. classification (+ sequential demotions) + detections
        detections, clusters_out = self._classify_and_detect(
            clusters, is_close, sensor_pos
        )

        # 6. raycast + flag-guarded ray EMA
        if self.step_i % self.raycast_every == self.raycast_every - 1:
            self._raycast(ranges_mm, intensity, pose, occupied)

        # 7. separated-background maintenance
        if self.step_i % cfg.sepclusters_every == 0 and not dyn.sepclusters_pause:
            if np.any(self.vmap > F32(dyn.thr_new_obstacles)):
                new_vals, sure = sepclusters_exact_np(
                    self.vmap,
                    dyn.thr_new_obstacles,
                    dyn.thr_sure_obstacles,
                    dyn.sepclusters_min_sure_points,
                    self._sep_radius_idx(),
                    dyn.score_ray,
                    float(cfg.sepclusters_every),
                    quirk_indexing=cfg.compat_counted_indexing,
                )
                self.vmap = new_vals.astype(F32)
                self.sure_bg_sufficient = bool(sure)
            # empty background: sure flag unchanged (ref :1155-1159)

        self.step_i += 1
        diag = dict(
            n_bg_voxels=n_bg,
            bg_sufficient=self.bg_sufficient,
            sure_bg_sufficient=self.sure_bg_sufficient,
            n_occupied=int(occupied.sum()),
            n_clusters=ncomp,
            clusters=clusters_out,
        )
        return detections, diag
