"""Euclidean-tolerance connected components and reachability on voxel masks.

Dense replacement for PCL EuclideanClusterExtraction (ref
vofod_nodelet.cpp:689-698) and the close/far cluster split (ref
findCloseFarClusters :701-751).

Semantics: two occupied voxels are adjacent iff the Euclidean distance of
their integer indices is <= ``radius`` (for voxel-center points this is
exactly the ECE tolerance ``radius * voxel_size``).  Components are maximal
sets under this adjacency.

* :func:`propagate_reach` computes, for every occupied voxel, whether its
  component contains a seed voxel.  Run to convergence this is *exactly*
  "cluster contains a point with a background voxel within
  ground_points_max_distance" — the reference's is_close flag — because
  closeness is a component-wide property.  Iteration count is data-dependent
  (lax.while_loop) but small in steady state: once the map is warm, nearly
  every ground voxel is itself seed-adjacent, so the fixpoint is reached in a
  couple of sweeps.

* :func:`label_components` labels each component with the minimum flat voxel
  id of its members.  It is used only on the *far* (non-background) voxels,
  whose components are physically small (a flying object is <= max_size), so
  plain propagation converges in a few sweeps; the while_loop carries a
  convergence flag surfaced in the step diagnostics.

Pointer-jumping is deliberately NOT used: it needs full-grid gathers (the
no-large-gather rule of DESIGN.md §1, to be re-measured on the GPU).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vofod_tpu.ops.morphology import (
    ball_pool_max,
    ball_pool_max_traced,
    ball_pool_min,
    ball_pool_min_traced,
)

Array = jnp.ndarray

# sentinel label for non-occupied voxels (any value > all flat ids)
SENTINEL = jnp.int32(2**31 - 1)


def propagate_reach(
    occupied: Array, seed: Array, radius: float, max_iters: int,
    traced_r2=None,
) -> tuple[Array, Array]:
    """Grow ``seed & occupied`` through ``occupied`` under ball adjacency.

    Returns (reached, converged): ``reached`` is the set of occupied voxels
    whose component contains a seed; ``converged`` is False iff the iteration
    cap was hit before the fixpoint (diagnostic).

    ``traced_r2``: optional TRACED squared adjacency radius — ``radius``
    then acts as the static compile bound (cfg.dynamic_radii; see
    ops/morphology._ball_pool_traced).
    """
    occ = occupied.astype(jnp.bool_)
    cur = occ & seed.astype(jnp.bool_)

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    def body(state):
        cur, _, it = state
        # int8: the mask is binary and the pool is memory-bandwidth-bound
        c8 = cur.astype(jnp.int8)
        if traced_r2 is not None:
            pooled = ball_pool_max_traced(c8, traced_r2, radius, fill=0)
        else:
            pooled = ball_pool_max(c8, radius, fill=0)
        grown = occ & (pooled > 0)
        new = cur | grown
        return new, jnp.any(new != cur), it + 1

    # one unconditional sweep so `changed` starts meaningfully
    state = (cur, jnp.bool_(True), jnp.int32(0))
    cur, changed, _ = jax.lax.while_loop(cond, body, state)
    return cur, ~changed


def label_components_seeded(
    occupied: Array, seed: Array, radius: float, max_iters: int,
    traced_r2=None,
) -> tuple[Array, Array, Array, Array]:
    """One propagation computing components AND seed-reachability together.

    The seed flag is embedded in the propagated key:
    ``key0 = flat_id + (1 - seed) * NV``; the min over a component is
    ``min(seeded flat ids)`` if the component contains a seed, else
    ``min(flat ids) + NV``.  So after convergence ``key < NV`` is exactly
    "component contains a seed" (the reference's cluster is_close,
    vofod_nodelet.cpp:728-750) and ``key mod NV`` is a consistent component
    label — one stencil loop instead of two.

    Returns (labels, seed_reached, converged, iters): labels = SENTINEL
    off-mask; ``iters`` is the sweep index after which the labels stopped
    changing this call (a real measure of scene connectivity complexity —
    ``max_iters`` when the cap was hit before the fixpoint).
    """
    occ = occupied.astype(jnp.bool_)
    nz, ny, nx = occ.shape
    nv = jnp.int32(nz * ny * nx)
    # Labels are REVERSED flat ids: downstream cluster slots fill in
    # ascending label order, and with z the slowest grid axis this gives
    # priority to the highest-altitude components — flying objects by
    # definition — so large low-lying ground remnants can never starve a
    # target out of the fixed slot table.
    flat = jnp.arange(nz * ny * nx, dtype=jnp.int32).reshape(occ.shape)
    rid = (nv - 1) - flat
    key0 = rid + jnp.where(seed & occ, 0, nv)
    keys = jnp.where(occ, key0, SENTINEL)

    # FIXED sweep count instead of running to the global fixpoint.  Rationale
    # (physics bounds the useful work):
    # * a component of diameter <= radius*T converges exactly in T sweeps —
    #   with T=8, r=3 that is every cluster up to ~24 voxels (12 m) across,
    #   4x the classification max_size gate;
    # * larger components may be left with multiple label patches, but any
    #   patch either exceeds the size gate (extent grows ~radius/sweep) or is
    #   a transient sliver inside a big structure whose floating check walks
    #   into the rest of the structure and returns "connected" regardless of
    #   labels — no spurious detections either way (DESIGN.md §4);
    # * seed-reachability (closeness) spreads radius*T voxels per scan —
    #   far faster than the background can physically grow.
    # Waiting for min-label agreement across huge background/ring components
    # costs ~diameter/radius sweeps per scan for information nothing consumes
    # (measured: the flagship scene pins any convergence loop at its cap).
    def pool(k):
        # traced_r2: live-tunable adjacency radius compiled at bound
        # ``radius`` (cfg.dynamic_radii; ops/morphology._ball_pool_traced)
        if traced_r2 is not None:
            return ball_pool_min_traced(k, traced_r2, radius)
        return ball_pool_min(k, radius)

    def body(it, carry):
        keys, iters = carry
        pooled = pool(keys)
        new = jnp.where(occ, jnp.minimum(keys, pooled), SENTINEL)
        # record the last sweep that changed anything (cheap full-grid
        # compare+reduce per sweep; the pools dominate)
        iters = jnp.where(jnp.any(new != keys), it + 1, iters)
        return new, iters

    keys, iters = jax.lax.fori_loop(
        0, max_iters, body, (keys, jnp.int32(0)), unroll=4
    )
    # Convergence diagnostic straight from the in-loop tracker: min-pooling
    # is monotone, so one sweep that changed nothing proves every later
    # sweep is a no-op — iters < max_iters ⇔ fixpoint reached inside the
    # loop.  (A fixpoint reached exactly ON the last sweep reports
    # not-converged — conservative; this replaces a 9th full ball pool that
    # existed only for this flag, ~1/9 of the clustering stage.)
    converged = iters < max_iters
    reached = occ & (keys < nv)
    labels = jnp.where(occ, jnp.where(keys < nv, keys, keys - nv), SENTINEL)
    return labels, reached, converged, iters


def label_components(
    occupied: Array, radius: float, max_iters: int
) -> tuple[Array, Array]:
    """Label components of ``occupied`` with the min member flat id.

    Returns (labels int32 grid with SENTINEL on empty voxels, converged flag).
    """
    occ = occupied.astype(jnp.bool_)
    nz, ny, nx = occ.shape
    flat = jnp.arange(nz * ny * nx, dtype=jnp.int32).reshape(occ.shape)
    labels = jnp.where(occ, flat, SENTINEL)

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    def body(state):
        labels, _, it = state
        pooled = ball_pool_min(labels, radius)
        new = jnp.where(occ, jnp.minimum(labels, pooled), SENTINEL)
        return new, jnp.any(new != labels), it + 1

    state = (labels, jnp.bool_(True), jnp.int32(0))
    labels, changed, _ = jax.lax.while_loop(cond, body, state)
    return labels, ~changed
