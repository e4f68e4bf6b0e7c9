"""Far-cluster classification: gates, OBB, floatingness, demotion.

Reference: classifyClusters / classify_cluster (vofod_nodelet.cpp:818-831,
1647-1731).  Far components are labeled densely, their member voxels are
compacted to a fixed-capacity list (ops/compaction.py), and every per-cluster
quantity (counts, AABB, PCA OBB replacing PCL MomentOfInertia, gates) is
computed on that list — no full-grid pass per cluster.

Two capacity tiers keep worst cases bounded:
* the *stats* list (max_far_voxels) holds all far voxels; sparse distant
  ground legitimately produces hundreds (they form large ring-like clusters
  that fail the max_size gate, exactly as in the reference);
* the *query* list (max_queries) holds only member voxels of clusters that
  passed the gates — physically small objects — and feeds the bounded
  flood-fill + demotion.

Cluster classes mirror the reference enum (cluster_class_t, :85-119):
invalid = failed a gate; mav = floating; unknown = grounded/undecidable.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vofod_tpu.config import DynParams, VoFODConfig
from vofod_tpu.geometry import GridSpec
from vofod_tpu.ops.components import SENTINEL
from vofod_tpu.ops.eigh3 import eigh3
from vofod_tpu.parallel.gridops import DENSE

Array = jnp.ndarray

CLS_INVALID = 0
CLS_MAV = 1
CLS_UNKNOWN = 2


class ClassifyOut(NamedTuple):
    grid: Array  # confidence grid after frontier demotions
    cluster_valid: Array  # bool [K] — slot holds a real far cluster
    cluster_class: Array  # int32 [K]
    n_points: Array  # int32 [K] (weighted-cloud points == member voxels)
    aabb_min: Array  # f32 [K, 3]
    aabb_max: Array  # f32 [K, 3]
    obb_center: Array  # f32 [K, 3]
    obb_axes: Array  # f32 [K, 3, 3] (rows = principal axes)
    obb_extent: Array  # f32 [K, 3] (half extents)
    obb_size: Array  # f32 [K] — OBB diagonal (ref :1688)
    reps: Array  # int32 [K] — component labels (flat voxel ids)
    labels: Array  # int32 dense component-label grid (detect needs members)
    n_far: Array
    far_overflow: Array
    labels_converged: Array


_BIG = 3.0e38
# f32 matmuls below run at full precision: at default precision a GPU may use
# TF32 (~10 mantissa bits), which moves OBB sizes near the gate thresholds of
# clusters ~100 m from the world origin
_HIGHEST = jax.lax.Precision.HIGHEST


def pca_obb(centers: Array, slot: Array):
    """PCA oriented bounding box per cluster slot (replaces PCL
    MomentOfInertiaEstimation, ref :1655-1673).

    centers: f32 [F, 3] member voxel centers (world); slot: bool [F, K]
    membership.  Returns (obb_center [K, 3], axes [K, 3, 3] rows = major,
    middle, minor, right-handed; half extents [K, 3]; OBB diagonal [K])."""
    mvalid = slot[:, :, None]
    denom = jnp.maximum(slot.sum(axis=0), 1).astype(jnp.float32)
    mean = jnp.matmul(
        slot.astype(jnp.float32).T, centers, precision=_HIGHEST
    ) / denom[:, None]  # [K, 3]
    d = centers[:, None, :] - mean[None, :, :]  # [F, K, 3]
    dm = jnp.where(mvalid, d, 0.0)
    cov = jnp.einsum(
        "fki,fkj->kij", dm, dm, precision=_HIGHEST
    ) / denom[:, None, None]
    cov = cov + 1e-6 * jnp.eye(3)[None]
    evals, evecs = eigh3(cov)  # ascending; evecs columns (closed form)
    # major/middle/minor ordering, right-handed (PCL MoI convention)
    axes_cols = jnp.flip(evecs, axis=-1)  # columns: major, middle, minor
    major, middle = axes_cols[:, :, 0], axes_cols[:, :, 1]
    minor = jnp.cross(major, middle)
    axes = jnp.stack([major, middle, minor], axis=1)  # rows = axes [K, 3, 3]
    proj = jnp.einsum("fkj,kaj->fka", d, axes, precision=_HIGHEST)  # [F, K, 3]
    pmin = jnp.min(jnp.where(mvalid, proj, _BIG), axis=0)
    pmax = jnp.max(jnp.where(mvalid, proj, -_BIG), axis=0)
    obb_center = mean + jnp.einsum(
        "kaj,ka->kj", axes, (pmin + pmax) / 2.0, precision=_HIGHEST
    )
    obb_extent = (pmax - pmin) / 2.0
    obb_size = jnp.linalg.norm(pmax - pmin, axis=-1)  # OBB diagonal
    return obb_center, axes, obb_extent, obb_size


def classify(
    cfg: VoFODConfig,
    dyn: DynParams,
    grid: GridSpec,
    grid_vals: Array,
    far: Array,
    labels: Array,  # component labels from the seeded propagation
    labels_converged: Array,
    sensor_pos: Array,  # [3] world
    bg_sufficient: Array,
    sure_bg_sufficient: Array,
    ops=DENSE,
) -> ClassifyOut:
    K = cfg.max_clusters
    F = cfg.max_far_voxels
    Q = cfg.max_queries
    conv = labels_converged

    fids, fvalid, ftotal = ops.compact(far, F)
    overflow = ftotal > F
    fx, fy, fz = grid.unflatten_id(fids)
    centers = grid.idx_to_coord(fx, fy, fz)  # [F, 3] world
    flabels = jnp.where(fvalid, ops.lookup(labels, fids), SENTINEL)

    # --- distinct component labels into K slots (ascending) -----------------
    # rank-based (one [F, F] compare pass + a K-element scatter-min) instead
    # of a K-step sequential min-above-previous scan of K tiny dispatches.
    # reps[r] = the distinct label with exactly r smaller distinct labels —
    # identical output.
    lab = jnp.where(fvalid, flabels, SENTINEL)
    idx_f = jnp.arange(F)
    seen_before = jnp.any(
        (lab[None, :] == lab[:, None]) & (idx_f[None, :] < idx_f[:, None]),
        axis=1,
    )
    is_rep = fvalid & ~seen_before  # first occurrence of each distinct label
    rank = jnp.sum(
        is_rep[None, :] & (lab[None, :] < lab[:, None]), axis=1
    )  # #distinct labels smaller than mine
    reps = (
        jnp.full((K,), SENTINEL, jnp.int32)
        .at[jnp.where(is_rep & (rank < K), rank, K)]
        .min(lab, mode="drop")
    )
    slot_valid = reps < SENTINEL  # [K]
    slot = fvalid[:, None] & (flabels[:, None] == reps[None, :])  # [F, K]
    # clusters beyond the K cap exist if some valid far voxel matched no slot
    cluster_overflow = jnp.any(fvalid & ~jnp.any(slot, axis=1))

    npts = slot.sum(axis=0).astype(jnp.int32)  # [K]

    # --- AABB over member voxel centers (ref MoI getAABB) --------------------
    cexp = centers[:, None, :]  # [F, 1, 3]
    mvalid = slot[:, :, None]
    aabb_min = jnp.min(jnp.where(mvalid, cexp, _BIG), axis=0)
    aabb_max = jnp.max(jnp.where(mvalid, cexp, -_BIG), axis=0)

    obb_center, axes, obb_extent, obb_size = pca_obb(centers, slot)

    # --- gates (ref :1679-1690) ----------------------------------------------
    dist = jnp.linalg.norm(obb_center - sensor_pos[None, :], axis=-1)
    gated = (
        slot_valid
        & (npts.astype(jnp.float32) >= dyn.cls_min_points)
        & (dist <= dyn.cls_max_distance)
        & (obb_size <= dyn.cls_max_size)
    )

    # --- floating check (ref :1692-1718) --------------------------------------
    explore_on = bg_sufficient & sure_bg_sufficient & ~overflow
    m_k = jnp.floor(
        (obb_size + dyn.cls_max_explore_distance) / cfg.voxel_size
    ).astype(jnp.int32)
    qgate = gated & explore_on  # [K]

    # dense mask of member voxels of gated clusters -> second compaction
    rep_sel = jnp.where(qgate, reps, jnp.int32(-2))  # -2 matches nothing
    # broadcast compare instead of jnp.isin, whose sorting-based lowering
    # is the slower form at a K=32 set size
    qmask = far & jnp.any(
        labels[..., None] == rep_sel, axis=-1
    )
    qids, qvalid, qtotal = ops.compact(qmask, Q)
    query_overflow = qtotal > Q
    qx, qy, qz = grid.unflatten_id(qids)
    qlabels = jnp.where(qvalid, ops.lookup(labels, qids), SENTINEL)
    qslot = qvalid[:, None] & (qlabels[:, None] == reps[None, :])  # [Q, K]
    m_q = (qslot.astype(jnp.int32) @ m_k).astype(jnp.int32)  # [Q]

    def make_explore(n):
        """Explore/demote over the first ``n`` query slots.  Queries fill in
        ascending order, so when qtotal <= n this is EXACTLY the full-capacity
        result — the fast path below trims the batched BFS (its cost scales
        with the [n, S, S, S] arrays) to the common case of a handful of
        gated-cluster members."""

        def run(vals):
            connected, reached, corners = ops.explore(
                grid,
                vals,
                qx[:n],
                qy[:n],
                qz[:n],
                qvalid[:n],
                m_q[:n],
                dyn.thr_frontiers,
                dyn.thr_new_obstacles,
                cfg.explore_submap,
            )
            cluster_connected = jnp.any(
                qslot[:n] & connected[:, None], axis=0
            )  # [K]
            # under query overflow some members were never explored:
            # conservative
            floating = qgate & ~cluster_connected & ~query_overflow
            demote = qvalid[:n] & jnp.any(qslot[:n] & floating[None, :], axis=1)
            # ctrl_any: under the 2D streams×grid composition the demote
            # branch (halo-exchange collectives) must run on every stream
            # group whenever ANY group demotes — a no-op where demote is
            # all-false (apply_demotions writes only masked submaps)
            new_vals = jax.lax.cond(
                ops.ctrl_any(demote),
                lambda v: ops.demote(
                    v, reached, corners, demote, dyn.thr_frontiers
                ),
                lambda v: v,
                vals,
            )
            return floating, new_vals

        return run

    if cfg.sequential_explore:
        # reference-faithful SEQUENTIAL explore (ref vofod_nodelet.cpp
        # :1692-1718): queries run one at a time in the reference's
        # (cluster extraction order, member id) order — ascending
        # (component label, flat voxel id) — each seeing every earlier
        # failed query's demotions, a failed query demoting its explored
        # frontier immediately (persisting even if a later member connects),
        # and members of an already-connected cluster skipped (the
        # reference breaks out of its member loop on the first success).
        # A lax.scan of single-query BFS dispatches: the parity instrument;
        # the batched tier path below is the production mode.
        order = jnp.lexsort((qids, qlabels))

        def seq_body(carry, j):
            vals, conn_k = carry
            jj = order[j]
            kmask = qslot[jj]  # [K] one-hot cluster of this query
            already = jnp.any(kmask & conn_k)

            def explore_one(args):
                vals, conn_k = args
                connected, reached, corners = ops.explore(
                    grid,
                    vals,
                    qx[jj][None],
                    qy[jj][None],
                    qz[jj][None],
                    jnp.ones((1,), jnp.bool_),
                    m_q[jj][None],
                    dyn.thr_frontiers,
                    dyn.thr_new_obstacles,
                    cfg.explore_submap,
                )
                c = connected[0]
                vals = jax.lax.cond(
                    c,
                    lambda v: v,
                    lambda v: ops.demote(
                        v, reached, corners, jnp.ones((1,), jnp.bool_),
                        dyn.thr_frontiers,
                    ),
                    vals,
                )
                return vals, conn_k | (kmask & c)

            skip = (~qvalid[jj]) | already | query_overflow
            vals, conn_k = jax.lax.cond(
                skip, lambda a: a, explore_one, (vals, conn_k)
            )
            return (vals, conn_k), None

        (new_vals, cluster_connected), _ = jax.lax.scan(
            seq_body,
            (grid_vals, jnp.zeros((K,), jnp.bool_)),
            jnp.arange(Q),
        )
        floating = qgate & ~cluster_connected & ~query_overflow
    else:
        tiers = cfg.explore_fast_queries
        if isinstance(tiers, int):
            tiers = (tiers,) if tiers > 0 else ()
        # ascending distinct capacities, max_queries always the final fallback
        tiers = tuple(sorted({min(int(t), Q) for t in tiers if int(t) > 0}))
        if not tiers or tiers[-1] != Q:
            tiers = tiers + (Q,)
        # smallest tier that fits qtotal (tiers ascend, so this counts the
        # tiers it exceeds); overflow (qtotal > Q) stays on the full branch
        tier_idx = jnp.sum(qtotal > jnp.asarray(tiers[:-1], jnp.int32)) if (
            len(tiers) > 1
        ) else jnp.int32(0)
        # ctrl_branch aligns the tier choice across lockstep (stream) groups —
        # running a LARGER tier than a stream needs is result-invariant (the
        # tier-ladder property, tests/test_classify_fuzz.py
        # test_explore_tier_ladder_invariance), and branch 0 equals a
        # tier run with zero valid queries, so forcing the max branch
        # everywhere only costs the slowest stream's tier
        branch = ops.ctrl_branch(
            jnp.where(~jnp.any(qvalid), 0, 1 + tier_idx)
        )
        floating, new_vals = jax.lax.switch(
            branch,
            [lambda vals: (jnp.zeros((K,), jnp.bool_), vals)]
            + [make_explore(t) for t in tiers],
            grid_vals,
        )

    cls = jnp.where(
        gated,
        jnp.where(floating, CLS_MAV, CLS_UNKNOWN),
        CLS_INVALID,
    ).astype(jnp.int32)
    cls = jnp.where(slot_valid, cls, CLS_INVALID)

    return ClassifyOut(
        grid=new_vals,
        cluster_valid=slot_valid,
        cluster_class=cls,
        n_points=npts,
        aabb_min=aabb_min,
        aabb_max=aabb_max,
        obb_center=obb_center,
        obb_axes=axes,
        obb_extent=obb_extent,
        obb_size=obb_size,
        reps=reps,
        labels=labels,
        n_far=ftotal,
        far_overflow=overflow | cluster_overflow,
        labels_converged=conv,
    )
