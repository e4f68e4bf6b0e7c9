"""Multi-chip scaling: data-parallel scan streams + grid-sharded stencils.

The reference's concurrency is threads over one shared map on one machine
(SURVEY.md §2 parallelism inventory).  The scaling axes here are:

* **Stream data-parallelism** (production serving): one detector state per
  sensor stream, sharded over the mesh "data" axis with shard_map — N
  independent UAV/sensor feeds per mesh, zero cross-device traffic in
  steady state.  :func:`make_batched_step` builds this.  Inside each shard
  the local streams run through the UNBATCHED step under lax.scan
  (sequential per device): the scan keeps every stream's program identical
  to the single-stream hot path, so per-device throughput is exactly serial
  and scaling across devices is linear.  vmap batching (whose explore
  submap dynamic-slices and compaction row-gathers become batched gathers)
  lost to the scan before GPU measurements existed; ROADMAP.md §1.4 queues
  the GPU comparison.

* **Grid sharding** (single giant operation areas): the dense grid is split
  along Z across devices; stencil ops exchange halos between devices with
  jax.lax.ppermute inside shard_map.  :func:`halo_ball_pool_min` demonstrates
  the pattern for the ball-pool stencil that dominates the pipeline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vofod_tpu.config import DynParams, VoFODConfig
from vofod_tpu.pipeline.state import VoFODState, init_state
from vofod_tpu.pipeline.step import make_step_fn
from vofod_tpu.sensor import XyzLut


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


# =============================================================================
# Data-parallel scan streams
# =============================================================================


def init_batched_state(
    cfg: VoFODConfig, dyn: DynParams, batch: int, mesh: Mesh, axis: str = "data"
) -> VoFODState:
    """One detector state per stream, sharded over the mesh.

    Built by a jitted initializer with explicit out_shardings (not a host
    broadcast + device_put), so it works unchanged on a multi-host mesh where
    this process cannot address every device: each host materializes only its
    local shards.
    """
    sharding = NamedSharding(mesh, P(axis))

    def _init() -> VoFODState:
        s0 = init_state(cfg, dyn)
        return jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), s0)

    return jax.jit(_init, out_shardings=sharding)()


def make_batched_step(
    cfg: VoFODConfig,
    lut: XyzLut,
    mesh: Mesh,
    axis: str = "data",
    **step_kw,
):
    """Stream-sharded step: shard_map over the mesh, lax.scan per shard.

    Each chip owns B/D streams and runs the UNBATCHED step program for each,
    sequentially — no collectives on the hot path, no batched-gather lowering
    (see module docstring for the measured vmap pessimization this replaces).
    The batch size must be divisible by the mesh axis size.
    """
    step = make_step_fn(cfg, lut, donate=False, jit=False, **step_kw)
    n = mesh.shape[axis]

    def local_block(state_blk, scan_blk, dyn):
        # leaves have leading dim B/D (the chip's local streams)
        def body(_, args):
            st, sc = args
            new_st, out = step(st, sc, dyn)
            return None, (new_st, out)

        _, (new_states, outs) = jax.lax.scan(body, None, (state_blk, scan_blk))
        return new_states, outs

    sharded = shard_map(
        local_block,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P()),  # pytree prefixes
        out_specs=(P(axis), P(axis)),
        # the block is fully local (no collectives); the step's internal
        # while/fori carries start from unvarying constants, which the
        # varying-manual-axes checker would reject
        check_vma=False,
    )

    def checked(state, scans, dyn):
        b = jax.tree.leaves(scans)[0].shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by mesh axis size {n}")
        return sharded(state, scans, dyn)

    return jax.jit(checked, donate_argnums=(0,))


# =============================================================================
# Grid sharding with halo exchange
# =============================================================================


def _halo_pool(grid: jnp.ndarray, radius: float, mesh: Mesh, axis: str, op: str):
    """Ball pool over a grid sharded along Z, halos exchanged between devices.

    Each shard sends its boundary slabs of thickness r to the neighbors with
    jax.lax.ppermute, pads, pools locally, and crops — numerically identical
    to the unsharded pools in ops/morphology.py.
    """
    import math

    from vofod_tpu.ops.morphology import (
        ball_pool_max,
        ball_pool_min,
        ball_pool_sum,
    )

    pools = {"min": ball_pool_min, "max": ball_pool_max, "sum": ball_pool_sum}
    fills = {
        "min": _fill_for(grid.dtype, True),
        "max": _fill_for(grid.dtype, False),
        "sum": 0,
    }
    pool, fill = pools[op], fills[op]
    r = int(math.floor(radius))
    n = mesh.shape[axis]

    def body(g):  # g: local shard [nz/n, ny, nx]
        idx = jax.lax.axis_index(axis)
        edge_fill = jnp.full_like(g[:r], fill)
        # send top slab down / bottom slab up
        up = jax.lax.ppermute(g[-r:], axis, [(i, i + 1) for i in range(n - 1)])
        dn = jax.lax.ppermute(g[:r], axis, [(i, i - 1) for i in range(1, n)])
        lo = jnp.where(idx > 0, up, edge_fill)
        hi = jnp.where(idx < n - 1, dn, edge_fill)
        ext = jnp.concatenate([lo, g, hi], axis=0)
        pooled = pool(ext, radius) if op != "sum" else ball_pool_sum(ext, radius)
        return pooled[r:-r]

    spec = P(axis, None, None)
    return shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec)(grid)


def halo_ball_pool_min(grid, radius: float, mesh: Mesh, axis: str = "data"):
    return _halo_pool(grid, radius, mesh, axis, "min")


def halo_ball_pool_max(grid, radius: float, mesh: Mesh, axis: str = "data"):
    return _halo_pool(grid, radius, mesh, axis, "max")


def halo_ball_pool_sum(grid, radius: float, mesh: Mesh, axis: str = "data"):
    return _halo_pool(grid, radius, mesh, axis, "sum")


def halo_propagate_reach(
    occupied, seed, radius: float, sweeps: int, mesh: Mesh, axis: str = "data"
):
    """Grid-sharded seeded reachability: the clustering propagation pattern
    with halo exchange per sweep — demonstrates that the whole CC stage
    shards along Z with one ppermute pair per sweep (DESIGN.md §6)."""
    occ = occupied.astype(jnp.int32)
    cur = (occ * seed.astype(jnp.int32)).astype(jnp.int32)
    for _ in range(sweeps):
        grown = halo_ball_pool_max(cur, radius, mesh, axis)
        cur = occ * jnp.maximum(cur, (grown > 0).astype(jnp.int32))
    return cur > 0


def _fill_for(dtype, is_min=True):
    if jnp.issubdtype(dtype, jnp.integer):
        return jnp.iinfo(dtype).max if is_min else jnp.iinfo(dtype).min
    return jnp.inf if is_min else -jnp.inf
