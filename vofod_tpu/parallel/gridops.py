"""Dense-grid operation seam: one pipeline, two grid layouts.

Every stage of the detection pipeline touches the dense (nz, ny, nx) grid
through a small set of primitives (stencil pools, histogram scatters,
compaction, submap slices, the sweep raycast, global reductions).  This
module defines that primitive set as a provider object so the SAME stage
code (pipeline/frontend.py, background.py, classify.py, detect.py,
sepclusters.py, step.py) runs in two modes:

* :class:`DenseOps` — the grid lives on one device; primitives are the plain
  ops from ``vofod_tpu.ops`` (this is the production one-device path and is
  byte-identical to the pre-seam code).

* :class:`ZShardOps` — the grid is sharded along Z over a mesh axis and the
  stage code executes inside ``shard_map``.  Stencils exchange halo slabs
  between devices (``jax.lax.ppermute``), histograms scatter only locally-owned
  points, compactions merge per-shard lists (ascending flat ids are shard-
  major because Z is the leading grid axis, so concatenation preserves
  order), submap reads ride halo exchange + one small ``psum``, and the
  plane-sweep raycast runs lateral-sharded/pipelined
  (ops/raycast.py ``raycast_sweep_zsharded``).

The sharded implementations are arithmetic-identical per element — the grid-
sharded step is tested bit-for-bit against the unsharded step on an 8-device
mesh (tests/test_grid_step.py).  This is the scaling axis SURVEY.md §5 calls
out for operation areas beyond one device's memory (the reference caps its map at
one machine's RAM; workload 2.47M voxels, config/apriori_maps/sim.yaml:8-15).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from vofod_tpu.geometry import GridSpec
from vofod_tpu.ops import binning
from vofod_tpu.ops.compaction import masked_compact
from vofod_tpu.ops.components import (
    SENTINEL,
    label_components,
    label_components_seeded,
    propagate_reach,
)
from vofod_tpu.ops.explore import apply_demotions, explore_to_ground
from vofod_tpu.ops.morphology import (
    _ball_pool,
    _ball_pool_traced,
    ball_pool_max,
    ball_pool_max_traced,
    ball_pool_min,
    ball_pool_min_traced,
    ball_pool_sum,
    ball_pool_sum_traced,
)
from vofod_tpu.ops.raycast import (
    dda_emissions,
    raycast_dda,
    raycast_sweep,
    raycast_sweep_zsharded,
)

Array = jnp.ndarray

_INT_MAX = jnp.int32(2**31 - 1)


class DenseOps:
    """Single-device primitives (the default provider)."""

    is_sharded = False
    cache_key = "dense"

    # ---- global reductions --------------------------------------------------
    def gsum(self, x: Array) -> Array:
        return jnp.sum(x)

    def gany(self, x: Array) -> Array:
        return jnp.any(x)

    def gmax(self, x: Array) -> Array:
        return jnp.max(x)

    # ---- control-flow reductions ---------------------------------------------
    # Predicates that pick a lax.cond/switch branch or continue a while_loop
    # whose body contains COLLECTIVES must agree on every device of the mesh,
    # not just this detector's grid shards: under the 2D streams×grid
    # composition (grid_step.make_fleet_grid_step) a stream group that stops
    # iterating early stops issuing its collectives, and the other groups'
    # collective rendezvous never completes (SPMD lockstep).  ``ctrl_any`` /
    # ``ctrl_branch`` therefore reduce over the grid axis PLUS any lockstep
    # axes; extra fixpoint sweeps / larger explore tiers forced on
    # already-converged streams are no-ops, so results stay bit-identical
    # (tier-ladder invariance: tests/test_classify_fuzz.py).

    def ctrl_any(self, x: Array) -> Array:
        return jnp.any(x)

    def ctrl_branch(self, b: Array) -> Array:
        return b

    # ---- stencils -----------------------------------------------------------
    # ``traced_r2``: optional TRACED squared radius (index units) — ``radius``
    # then acts as the static compile bound and taps are gated by an r²
    # compare (cfg.dynamic_radii; ops/morphology._ball_pool_traced).
    def pool_max(self, a: Array, radius: float, fill=None, traced_r2=None) -> Array:
        if traced_r2 is not None:
            return ball_pool_max_traced(a, traced_r2, radius, fill=fill)
        return ball_pool_max(a, radius, fill=fill)

    def pool_min(self, a: Array, radius: float, fill=None, traced_r2=None) -> Array:
        if traced_r2 is not None:
            return ball_pool_min_traced(a, traced_r2, radius, fill=fill)
        return ball_pool_min(a, radius, fill=fill)

    def pool_sum(self, a: Array, radius: float, traced_r2=None) -> Array:
        if traced_r2 is not None:
            return ball_pool_sum_traced(a, traced_r2, radius)
        return ball_pool_sum(a, radius)

    def label_seeded(self, occupied, seed, radius, max_iters, traced_r2=None):
        return label_components_seeded(
            occupied, seed, radius, max_iters, traced_r2=traced_r2
        )

    def propagate_reach(self, occupied, seed, radius, max_iters, traced_r2=None):
        return propagate_reach(
            occupied, seed, radius, max_iters, traced_r2=traced_r2
        )

    def label_components(self, occupied, radius, max_iters):
        return label_components(occupied, radius, max_iters)

    def label_census(self, labels, vals, ncv: int):
        """Sum ``vals`` into each label's bucket and read back per cell:
        the per-component census of the exact sepclusters mode
        (ref vofod_nodelet.cpp:1174-1183)."""
        census = (
            jnp.zeros((ncv,), jnp.int32)
            .at[labels.reshape(-1)]
            .add(vals.reshape(-1), mode="drop")
        )
        return census[jnp.minimum(labels, ncv - 1)]

    # ---- histogram scatter --------------------------------------------------
    def scatter_add(self, grid: GridSpec, fid: Array, w: Array) -> Array:
        """int32 grid += w at flat ids (w already masked to 0 where invalid)."""
        return (
            jnp.zeros((grid.n_voxels,), jnp.int32)
            .at[fid]
            .add(w, mode="drop")
            .reshape(grid.shape)
        )

    def bin_points(self, grid: GridSpec, pts: Array, valid: Array) -> Array:
        return binning.bin_points(grid, pts, valid)

    # ---- compaction / list bridge -------------------------------------------
    def compact(self, mask: Array, capacity: int):
        return masked_compact(mask, capacity)

    def lookup(self, dense: Array, fids: Array) -> Array:
        return dense.reshape(-1)[fids]

    # ---- submap ops ----------------------------------------------------------
    def explore(self, grid, vals, qx, qy, qz, qvalid, m_q, thr_frontiers,
                thr_ground, submap):
        return explore_to_ground(
            grid, vals, qx, qy, qz, qvalid, m_q, thr_frontiers, thr_ground,
            submap,
        )

    def demote(self, vals, reached, corners, demote, thr_frontiers):
        return apply_demotions(vals, reached, corners, demote, thr_frontiers)

    def submaps3(self, vals: Array, far: Array, labels: Array,
                 ctr_i: Array, cs: int):
        """Per-cluster CS³ windows of (vals, far, labels) around integer
        centers ctr_i [K, 3] (x, y, z) — ref getSubmapCopy
        (voxel_map.cpp:547-571); out-of-grid reads: 0 / False / INT_MAX."""
        half = cs // 2
        pad = half
        pv = jnp.pad(vals, pad, constant_values=jnp.float32(0))
        pf = jnp.pad(far, pad, constant_values=False)
        pl = jnp.pad(labels, pad, constant_values=_INT_MAX)

        def one(k):
            cx, cy, cz = ctr_i[k, 0], ctr_i[k, 1], ctr_i[k, 2]
            start = (cz - half + pad, cy - half + pad, cx - half + pad)
            return (
                lax.dynamic_slice(pv, start, (cs, cs, cs)),
                lax.dynamic_slice(pf, start, (cs, cs, cs)),
                lax.dynamic_slice(pl, start, (cs, cs, cs)),
            )

        return jax.vmap(one)(jnp.arange(ctr_i.shape[0]))

    # ---- raycast -------------------------------------------------------------
    def raycast_sweep(self, grid, opaque, origin, rot, **kw):
        return raycast_sweep(grid, opaque, origin, rot, **kw)

    def raycast_dda(self, grid, starts, dirs, lengths, valid, max_length):
        return raycast_dda(grid, starts, dirs, lengths, valid, max_length)


DENSE = DenseOps()


class ZShardOps:
    """Z-sharded primitives; methods must be called inside ``shard_map`` over
    mesh axis ``axis`` with every dense grid argument being the LOCAL
    (nz/n, ny, nx) shard.  Point-space arrays and compacted lists are
    replicated.  All results match :class:`DenseOps` bit-for-bit (the halo /
    merge constructions feed each output element the same operands in the
    same order)."""

    is_sharded = True

    def __init__(
        self,
        axis: str,
        n: int,
        zcone_mode: str = "pipelined",
        lockstep_axes: tuple = (),
    ):
        if zcone_mode not in ("pipelined", "transpose"):
            raise ValueError(f"unknown zcone_mode {zcone_mode!r}")
        self.axis = axis
        self.n = n
        self.zcone_mode = zcone_mode
        # extra mesh axes that must stay in lockstep through collective-
        # bearing control flow (the "data" axis of the 2D streams×grid
        # composition; see DenseOps control-flow reduction notes)
        self.lockstep_axes = tuple(lockstep_axes)
        self.cache_key = ("zshard", axis, n, zcone_mode, self.lockstep_axes)

    # ---- shard topology helpers ----------------------------------------------
    def _z0_rows(self, nzl: int) -> Array:
        return lax.axis_index(self.axis) * nzl

    def halo_exchange(self, g: Array, r: int, fill) -> Array:
        """Extend the local shard by r rows of true neighbor content on each
        side (``fill`` beyond the global boundary).  Multi-hop when r exceeds
        the shard height."""
        if r <= 0:
            return g
        nzl = g.shape[0]
        idx = lax.axis_index(self.axis)
        n = self.n
        lo_parts: list[Array] = []
        hi_parts: list[Array] = []
        need = r
        h = 0
        while need > 0:
            h += 1
            take = min(nzl, need)
            need -= take
            if h >= n:
                # no shard that far away: global-boundary fill
                shape = (take,) + g.shape[1:]
                lo_parts.insert(0, jnp.full(shape, fill, g.dtype))
                hi_parts.append(jnp.full(shape, fill, g.dtype))
                continue
            up = lax.ppermute(
                g[-take:], self.axis, [(i, i + h) for i in range(n - h)]
            )
            dn = lax.ppermute(
                g[:take], self.axis, [(i, i - h) for i in range(h, n)]
            )
            edge = jnp.full_like(g[:take], fill)
            lo_parts.insert(0, jnp.where(idx >= h, up, edge))
            hi_parts.append(jnp.where(idx <= n - 1 - h, dn, edge))
        return jnp.concatenate(lo_parts + [g] + hi_parts, axis=0)

    def halo_fold_min(self, ext: Array, r: int) -> Array:
        """Inverse of :meth:`halo_exchange` for min-combining writes: fold the
        (possibly updated) halo rows back onto their owners' interiors with
        elementwise min, and return the local interior."""
        nzl = ext.shape[0] - 2 * r
        interior = ext[r : r + nzl]
        idx = lax.axis_index(self.axis)
        n = self.n
        need = r
        h = 0
        off = 0  # rows consumed from the inner edge of each halo
        while need > 0:
            h += 1
            take = min(nzl, need)
            need -= take
            if h >= n:
                break
            # my lo-halo hop-h block = shard (i-h)'s rows [nzl-take, nzl)
            lo_blk = ext[r - off - take : r - off]
            # my hi-halo hop-h block = shard (i+h)'s rows [0, take)
            hi_blk = ext[r + nzl + off : r + nzl + off + take]
            # send back to owners
            from_next = lax.ppermute(
                lo_blk, self.axis, [(i, i - h) for i in range(h, n)]
            )
            from_prev = lax.ppermute(
                hi_blk, self.axis, [(i, i + h) for i in range(n - h)]
            )
            big = jnp.full_like(from_next, jnp.inf)
            from_next = jnp.where(idx <= n - 1 - h, from_next, big)
            from_prev = jnp.where(idx >= h, from_prev, big)
            # min-updates, NOT .set(): when 2*take > nzl (halo radius >=
            # shard_height/2, the multi-hop regime) the head/tail row ranges
            # overlap, and a .set() of one would drop the other's min
            # contribution.  min is commutative/idempotent, so the fold is
            # order-independent.
            interior = interior.at[nzl - take :].min(from_next)
            interior = interior.at[:take].min(from_prev)
            off += take
        return interior

    # ---- global reductions ----------------------------------------------------
    def gsum(self, x: Array) -> Array:
        return lax.psum(jnp.sum(x), self.axis)

    def gany(self, x: Array) -> Array:
        return lax.psum(jnp.any(x).astype(jnp.int32), self.axis) > 0

    def gmax(self, x: Array) -> Array:
        return lax.pmax(jnp.max(x), self.axis)

    def ctrl_any(self, x: Array) -> Array:
        axes = (self.axis,) + self.lockstep_axes
        return lax.psum(jnp.any(x).astype(jnp.int32), axes) > 0

    def ctrl_branch(self, b: Array) -> Array:
        # branch selectors are already replicated across the grid axis (they
        # derive from compact()/psum outputs); align them across stream groups
        if self.lockstep_axes:
            return lax.pmax(b, self.lockstep_axes)
        return b

    # ---- stencils ---------------------------------------------------------------
    # ``traced_r2`` as in DenseOps: the halo width comes from the STATIC bound
    # ``radius`` (traced radii never exceed it by construction), so the
    # exchange pattern is compile-time fixed and the traced gating runs on the
    # halo-extended slab — per-element identical to the unsharded traced pool.
    def _pool(self, a, radius, combine, fill, traced_r2=None):
        import math

        r = int(math.floor(radius))
        ext = self.halo_exchange(a, r, fill)
        if traced_r2 is not None:
            pooled = _ball_pool_traced(ext, traced_r2, radius, combine, fill)
        else:
            pooled = _ball_pool(ext, radius, combine, fill)
        return pooled[r : r + a.shape[0]] if r else pooled

    def pool_max(self, a, radius, fill=None, traced_r2=None):
        if fill is None:
            fill = (
                jnp.iinfo(a.dtype).min
                if jnp.issubdtype(a.dtype, jnp.integer)
                else -jnp.inf
            )
        return self._pool(a, radius, jnp.maximum, fill, traced_r2=traced_r2)

    def pool_min(self, a, radius, fill=None, traced_r2=None):
        if fill is None:
            fill = (
                jnp.iinfo(a.dtype).max
                if jnp.issubdtype(a.dtype, jnp.integer)
                else jnp.inf
            )
        return self._pool(a, radius, jnp.minimum, fill, traced_r2=traced_r2)

    def pool_sum(self, a, radius, traced_r2=None):
        return self._pool(a, radius, lax.add, 0, traced_r2=traced_r2)

    def label_seeded(self, occupied, seed, radius, max_iters, traced_r2=None):
        """Sharded twin of ops/components.py:label_components_seeded — global
        reversed-flat-id keys, halo'd min-pool sweeps, psum'd change flags."""
        occ = occupied.astype(jnp.bool_)
        nzl, ny, nx = occ.shape
        nz = nzl * self.n
        nv = jnp.int32(nz * ny * nx)
        z0v = self._z0_rows(nzl) * (ny * nx)
        flat = jnp.arange(nzl * ny * nx, dtype=jnp.int32).reshape(occ.shape) + z0v
        rid = (nv - 1) - flat
        key0 = rid + jnp.where(seed & occ, 0, nv)
        keys = jnp.where(occ, key0, SENTINEL)

        def body(it, carry):
            keys, iters = carry
            pooled = self.pool_min(keys, radius, traced_r2=traced_r2)
            new = jnp.where(occ, jnp.minimum(keys, pooled), SENTINEL)
            iters = jnp.where(self.gany(new != keys), it + 1, iters)
            return new, iters

        keys, iters = lax.fori_loop(
            0, max_iters, body, (keys, jnp.int32(0)), unroll=4
        )
        # convergence from the in-loop tracker, exactly as the dense twin
        # (ops/components.py label_components_seeded): iters < max_iters ⇔
        # some trailing sweep changed nothing ⇔ fixpoint — drops the extra
        # diagnostic pool AND its halo exchange
        converged = iters < max_iters
        reached = occ & (keys < nv)
        labels = jnp.where(
            occ, jnp.where(keys < nv, keys, keys - nv), SENTINEL
        )
        return labels, reached, converged, iters

    def label_components(self, occupied, radius, max_iters):
        """Sharded twin of ops/components.py:label_components: global flat
        ids, halo'd min-pool sweeps to convergence, psum'd change flag."""
        occ = occupied.astype(jnp.bool_)
        nzl, ny, nx = occ.shape
        z0v = self._z0_rows(nzl) * (ny * nx)
        flat = (
            jnp.arange(nzl * ny * nx, dtype=jnp.int32).reshape(occ.shape)
            + z0v
        )
        labels = jnp.where(occ, flat, SENTINEL)

        # the loop-continue flag reduces over grid AND lockstep axes (the body
        # pools -> halo-exchanges, a collective: every device of the mesh must
        # agree on the trip count); the per-detector convergence verdict stays
        # grid-local — extra sweeps past a detector's fixpoint are no-ops, so
        # its local flag is False there and the verdict matches the dense twin
        def cond(state):
            _, cont, _, it = state
            return cont & (it < max_iters)

        def body(state):
            labels, _, _, it = state
            pooled = self.pool_min(labels, radius)
            new = jnp.where(occ, jnp.minimum(labels, pooled), SENTINEL)
            diff = new != labels
            return new, self.ctrl_any(diff), self.gany(diff), it + 1

        state = (labels, jnp.bool_(True), jnp.bool_(True), jnp.int32(0))
        labels, _, changed_l, _ = lax.while_loop(cond, body, state)
        return labels, ~changed_l

    def label_census(self, labels, vals, ncv: int):
        """Per-component census across shards: shard-local scatter into the
        global label space + psum, then a local read-back gather."""
        census = (
            jnp.zeros((ncv,), jnp.int32)
            .at[labels.reshape(-1)]
            .add(vals.reshape(-1), mode="drop")
        )
        census = lax.psum(census, self.axis)
        return census[jnp.minimum(labels, ncv - 1)]

    def propagate_reach(self, occupied, seed, radius, max_iters, traced_r2=None):
        """Sharded twin of ops/components.py:propagate_reach (the global
        change flag moves into the body so the while condition stays a
        replicated scalar)."""
        occ = occupied.astype(jnp.bool_)
        cur = occ & seed.astype(jnp.bool_)

        # continue-flag over grid+lockstep axes, per-detector verdict local
        # (same reasoning as label_components above)
        def cond(state):
            _, cont, _, it = state
            return cont & (it < max_iters)

        def body(state):
            cur, _, _, it = state
            grown = occ & (
                self.pool_max(
                    cur.astype(jnp.int8), radius, fill=0, traced_r2=traced_r2
                )
                > 0
            )
            new = cur | grown
            diff = new != cur
            return new, self.ctrl_any(diff), self.gany(diff), it + 1

        state = (cur, jnp.bool_(True), jnp.bool_(True), jnp.int32(0))
        cur, _, changed_l, _ = lax.while_loop(cond, body, state)
        return cur, ~changed_l

    # ---- histogram scatter -------------------------------------------------------
    def scatter_add(self, grid: GridSpec, fid: Array, w: Array) -> Array:
        nzl = grid.nz // self.n
        nynx = grid.ny * grid.nx
        nvl = nzl * nynx
        z0v = self._z0_rows(nzl) * nynx
        lfid = fid - z0v
        own = (lfid >= 0) & (lfid < nvl)
        wl = jnp.where(own, w, 0)
        lfid = jnp.clip(lfid, 0, nvl - 1)
        return (
            jnp.zeros((nvl,), jnp.int32)
            .at[lfid]
            .add(wl, mode="drop")
            .reshape(nzl, grid.ny, grid.nx)
        )

    def bin_points(self, grid: GridSpec, pts: Array, valid: Array) -> Array:
        fid, inb = binning.point_fids(grid, pts, valid)
        return self.scatter_add(grid, fid, inb.astype(jnp.int32))

    # ---- compaction / list bridge ---------------------------------------------------
    def compact(self, mask: Array, capacity: int):
        """Per-shard compact + ordered merge.  Z is the leading grid axis, so
        shard-major concatenation of per-shard ascending lists is globally
        ascending; the first ``capacity`` valid entries of the concatenation
        equal the unsharded result (each shard's contribution to any global
        prefix is a prefix of its own list)."""
        nzl = mask.shape[0]
        nynx = mask.shape[1] * mask.shape[2]
        ids_l, valid_l, tot_l = masked_compact(mask, capacity)
        gids_l = jnp.where(valid_l, ids_l + self._z0_rows(nzl) * nynx, 0)
        all_ids = lax.all_gather(gids_l, self.axis).reshape(-1)
        all_valid = lax.all_gather(valid_l, self.axis).reshape(-1)
        sel, svalid, _ = masked_compact(all_valid, capacity)
        ids = jnp.where(svalid, all_ids[sel], 0).astype(jnp.int32)
        total = lax.psum(tot_l, self.axis)
        valid = jnp.arange(capacity, dtype=jnp.int32) < total
        return ids, valid, total

    def lookup(self, dense: Array, fids: Array) -> Array:
        nzl = dense.shape[0]
        nynx = dense.shape[1] * dense.shape[2]
        nvl = nzl * nynx
        z0v = self._z0_rows(nzl) * nynx
        lf = fids - z0v
        own = (lf >= 0) & (lf < nvl)
        vals = dense.reshape(-1)[jnp.clip(lf, 0, nvl - 1)]
        zero = jnp.zeros((), dense.dtype)
        return lax.psum(jnp.where(own, vals, zero), self.axis)

    # ---- submap ops ---------------------------------------------------------------------
    def explore(self, grid, vals, qx, qy, qz, qvalid, m_q, thr_frontiers,
                thr_ground, submap):
        pad = submap // 2
        nzl = vals.shape[0]
        z0 = self._z0_rows(nzl)
        ext = self.halo_exchange(vals, pad, jnp.float32(-1e30))
        conn, reached, corners = explore_to_ground(
            grid, ext, qx, qy, qz, qvalid, m_q, thr_frontiers, thr_ground,
            submap, z_halo=True, z_off=z0,
        )
        own = (qz >= z0) & (qz < z0 + nzl)
        conn = lax.psum((conn & own).astype(jnp.int32), self.axis) > 0
        # `reached` stays shard-local: only the owner's rows are meaningful,
        # and only the owner stamps demotions (halo-folded in demote()).
        return conn, reached, corners

    def demote(self, vals, reached, corners, demote, thr_frontiers):
        S = reached.shape[1]
        pad = S // 2
        nzl = vals.shape[0]
        z0 = self._z0_rows(nzl)
        qz = corners[:, 0] + pad  # query z = corner + half
        own = (qz >= z0) & (qz < z0 + nzl)
        ext = self.halo_exchange(vals, pad, jnp.float32(0))
        ext = apply_demotions(
            ext, reached, corners, demote & own, thr_frontiers,
            z_halo=True, z_off=z0,
        )
        return self.halo_fold_min(ext, pad)

    def submaps3(self, vals: Array, far: Array, labels: Array,
                 ctr_i: Array, cs: int):
        half = cs // 2
        pad = half
        nzl = vals.shape[0]
        z0 = self._z0_rows(nzl)
        widths = ((0, 0), (pad, pad), (pad, pad))
        pv = jnp.pad(self.halo_exchange(vals, pad, jnp.float32(0)),
                     widths, constant_values=jnp.float32(0))
        pf = jnp.pad(self.halo_exchange(far, pad, False),
                     widths, constant_values=False)
        pl = jnp.pad(self.halo_exchange(labels, pad, _INT_MAX),
                     widths, constant_values=_INT_MAX)

        def one(k):
            cx, cy, cz = ctr_i[k, 0], ctr_i[k, 1], ctr_i[k, 2]
            start = (cz - z0 - half + pad, cy - half + pad, cx - half + pad)
            return (
                lax.dynamic_slice(pv, start, (cs, cs, cs)),
                lax.dynamic_slice(pf, start, (cs, cs, cs)),
                lax.dynamic_slice(pl, start, (cs, cs, cs)),
            )

        v, f, l = jax.vmap(one)(jnp.arange(ctr_i.shape[0]))
        cz = ctr_i[:, 2]
        own = ((cz >= z0) & (cz < z0 + nzl))[:, None, None, None]
        v = lax.psum(jnp.where(own, v, 0.0), self.axis)
        f = lax.psum(jnp.where(own, f, False).astype(jnp.int32), self.axis) > 0
        l = lax.psum(jnp.where(own, l, 0), self.axis)
        return v, f, l

    # ---- raycast -----------------------------------------------------------------------------
    def raycast_sweep(self, grid, opaque, origin, rot, **kw):
        return raycast_sweep_zsharded(
            grid, opaque, origin, rot, axis=self.axis, n_shards=self.n,
            zcone_mode=self.zcone_mode, **kw
        )

    def raycast_dda(self, grid, starts, dirs, lengths, valid, max_length):
        """Exact DDA on the Z-sharded grid: the ray walk is replicated (it is
        ray-space work), each shard scatters only locally-owned emissions.
        Per voxel the accumulation order equals the unsharded scatter's
        (emissions keep their (step, ray) order; dropping non-owned entries
        cannot reorder a voxel's own adds), so the result is bit-exact —
        this is the parity mode for operation areas beyond one device's
        memory."""
        fids, ws = dda_emissions(grid, starts, dirs, lengths, valid, max_length)
        nzl = grid.nz // self.n
        nynx = grid.ny * grid.nx
        nvl = nzl * nynx
        z0v = self._z0_rows(nzl) * nynx
        lfid = fids - z0v
        own = (lfid >= 0) & (lfid < nvl)
        wl = jnp.where(own, ws, 0.0)
        lfid = jnp.clip(lfid, 0, nvl - 1)
        flat = jnp.zeros((nvl,), jnp.float32).at[lfid].add(wl, mode="drop")
        return flat.reshape(nzl, grid.ny, grid.nx)
