"""Grid-sharded full detection step: one operation area across many devices.

The stream-DP path (parallel/sharding.py) scales the number of independent
sensor feeds; THIS module scales a single feed's operation area beyond one
device's memory, the axis SURVEY.md §5 names for giant maps (the reference caps
its VoxelMap at one machine's RAM; its 2.47M-voxel sim workload uses ~10 MB;
a 0.5 m voxel over a 500 m × 500 m × 250 m oparea is ~2 GB of f32 state —
already several devices' worth once the pipeline's working set (halos, pools,
label keys, sweep carries) multiplies it).  Flat voxel ids and label keys
are int32 with a seed-flag offset of n_voxels, so the supported ceiling is
n_voxels ≤ 2^30 (~4 GB of f32 grid per array) — validated with a clear
error in :func:`make_grid_sharded_step`; beyond that the id math would need
int64 throughout.

Design: the confidence grid and the sepclusters warm-start mask shard along
Z (the leading, slowest-varying grid axis, so each shard is one contiguous
block).  The WHOLE step runs inside ONE shard_map with the stage code of
pipeline/*.py unchanged — every dense-grid primitive routes through
parallel/gridops.ZShardOps:

* stencil pools / label propagation: halo slabs between devices per sweep
  (multi-hop when the halo exceeds the shard height);
* point binning: the scan is replicated (131k points ≪ grid); each shard
  scatters only locally-owned points — no all-to-all at all;
* compaction: per-shard lists + all_gather + ordered merge (Z-major flat
  ids make shard-major concatenation globally ascending);
* explore/demotions: owner-shard submap extraction on halo-extended slabs;
  demotion min-writes fold back onto neighbors (min is idempotent and
  commutative, so the fold is exact);
* sweep raycast: x/y cones lateral-sharded (carry-halo ppermute per plane),
  z cones pipelined across shards (ops/raycast.py);
* scalars/flags/detection lists: replicated via psum/pmax.

Every output matches the unsharded step BIT-FOR-BIT (tests/test_grid_step.py
asserts exact equality of grids, detections and diagnostics on an 8-device
mesh), so the sharded step is a drop-in for oversized operation areas.

The module also composes BOTH scaling axes: :func:`make_fleet_grid_step`
runs N data-parallel streams, each with its grid Z-sharded, in one
shard_map over a 2D (data, grid) mesh — a fleet sharing one map geometry
too large for one device (tests/test_fleet_grid.py pins per-stream
bit-equality with the dense step).

Cost model: steady-state halo traffic per step is ~stencil_sweeps ×
2r × ny × nx × 4 B ≈ a few MB between devices per step.  The z-cone pipeline is the one
sequential stage: wall-clock equal to the unsharded sweep (the recurrence
is inherently ordered), compute replicated n×, memory 1/n — acceptable
because the z cones are the cheapest pair (nz ≪ nx, ny in every real
config).
"""

from __future__ import annotations

import jax
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vofod_tpu.config import DynParams, VoFODConfig
from vofod_tpu.parallel.gridops import ZShardOps
from vofod_tpu.pipeline.state import VoFODState, init_state
from vofod_tpu.pipeline.step import make_step_fn
from vofod_tpu.sensor import XyzLut


def _state_specs(axis: str) -> VoFODState:
    g = P(axis, None, None)
    return VoFODState(
        grid=g,
        safe=g,
        det_counter=P(),
        step=P(),
        sure_bg_sufficient=P(),
        bg_sufficient=P(),
    )


def init_grid_sharded_state(
    cfg: VoFODConfig,
    dyn: DynParams,
    mesh: Mesh,
    axis: str = "grid",
) -> VoFODState:
    """Fresh state with the dense grids Z-sharded over the mesh."""
    s0 = init_state(cfg, dyn)
    specs = _state_specs(axis)
    return jax.tree.map(
        lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), s0, specs
    )


def shard_state(state: VoFODState, mesh: Mesh, axis: str = "grid") -> VoFODState:
    """Re-shard an existing (e.g. snapshot-loaded) state onto the mesh."""
    specs = _state_specs(axis)
    return jax.tree.map(
        lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), state, specs
    )


def _validate_grid_sharding(cfg: VoFODConfig, n: int, axis: str) -> None:
    nz, _, _ = cfg.grid_shape
    if nz % n:
        raise ValueError(
            f"grid nz={nz} not divisible by mesh axis '{axis}' size {n}; "
            "pad the operation-area height"
        )
    if nz // n < 2:
        raise ValueError(f"shard height {nz // n} < 2 planes (nz={nz}, n={n})")
    nv = cfg.grid_shape[0] * cfg.grid_shape[1] * cfg.grid_shape[2]
    if nv > 2**30:
        # label_seeded keys use flat_id + (1-seed)*n_voxels in int32, so
        # 2*n_voxels must stay below 2^31 — larger grids would silently
        # overflow ids/labels rather than fail.
        raise ValueError(
            f"n_voxels={nv} exceeds the int32 id/key ceiling of 2^30 "
            "(~4 GB f32 grid); shrink the oparea or coarsen the voxel size"
        )
    if cfg.sepclusters_exact_census:
        import math

        mv = math.ceil(cfg.sepclusters_max_bg_distance / cfg.voxel_size)
        lsz = max(mv - 1, 1)
        if (nz // n) % lsz:
            raise ValueError(
                f"exact-census coarse leaf {lsz} must divide the shard "
                f"height {nz // n} (pad the operation-area height)"
            )
        # compat_counted_indexing composes (pipeline/sepclusters.py
        # _quirk_sure_counts_sharded) — it replicates one int32 rank table
        # of the full grid size, a documented parity-mode cost


def make_grid_sharded_step(
    cfg: VoFODConfig,
    lut: XyzLut,
    mesh: Mesh,
    axis: str = "grid",
    zcone_mode: str = "pipelined",
    **step_kw,
):
    """Build the jitted Z-sharded step (same signature as make_step_fn's
    product: ``(state, scan, dyn) -> (state, StepOutput)`` with state grids
    sharded ``P(axis, None, None)`` and everything else replicated).

    Requires ``nz % mesh.shape[axis] == 0`` (pad the operation-area height to
    a multiple — the extra planes are inert) and a shard height of at least
    2 planes for the sweep's lateral halo taps.

    ``zcone_mode`` selects the sweep raycast's z-cone strategy (bit-identical
    results either way, ops/raycast.py raycast_sweep_zsharded): "pipelined"
    replays the full-plane scan once per shard (minimal traffic between
    devices, compute replicated n×); "transpose" all_to_alls the cone volume to
    lateral-sharded and back so per-shard z-cone FLOPs drop n× — prefer it
    once n is large enough that the replicated full-plane z scan rivals the
    sharded x/y group's per-shard work (expected at n ≳ 3 on the flagship
    geometry; not measured on the GPU yet).
    """
    n = int(mesh.shape[axis])
    _validate_grid_sharding(cfg, n, axis)
    ops = ZShardOps(axis, n, zcone_mode=zcone_mode)
    step = make_step_fn(
        cfg, lut, donate=False, jit=False, ops=ops, **step_kw
    )
    sspec = _state_specs(axis)
    if step_kw.get("frontend_mode") == "prebinned":
        # the packed host-binned count grid shards along Z with the state;
        # active mask / pose / stats are replicated (pipeline/state.py)
        from vofod_tpu.pipeline.state import PrebinnedScan

        scan_spec = PrebinnedScan(
            packed=P(axis, None, None), active=P(), pose=P(), stats=P()
        )
    else:
        scan_spec = P()
    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(sspec, scan_spec, P()),
        out_specs=(sspec, P()),
        # replicated-output inference would have to see through psum-carried
        # while loops; outputs are replicated by construction (psum/pmax)
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0,))


def make_grid_mesh(n_devices: int | None = None, axis: str = "grid") -> Mesh:
    devs = jax.devices()
    nd = n_devices or len(devs)
    return Mesh(np.array(devs[:nd]), (axis,))


# =============================================================================
# 2D composition: stream data-parallelism x grid sharding
# =============================================================================


def make_fleet_grid_mesh(
    n_data: int,
    n_grid: int,
    data_axis: str = "data",
    grid_axis: str = "grid",
) -> Mesh:
    """2D device mesh: ``n_data`` stream groups x ``n_grid`` grid shards.

    The grid axis is the mesh's MINOR (fastest-varying) dimension so the
    per-step halo/ppermute traffic stays between one stream group's
    devices; stream groups never communicate.
    """
    if n_data < 1 or n_grid < 1:
        raise ValueError(
            f"mesh {n_data}x{n_grid}: both axes must be >= 1 (grid_shards "
            "larger than the device count truncates n_data to 0)"
        )
    devs = jax.devices()
    need = n_data * n_grid
    if len(devs) < need:
        raise ValueError(
            f"mesh {n_data}x{n_grid} needs {need} devices, have {len(devs)}"
        )
    return Mesh(
        np.array(devs[:need]).reshape(n_data, n_grid), (data_axis, grid_axis)
    )


def _fleet_state_specs(data_axis: str, grid_axis: str) -> VoFODState:
    # per-stream leading dim shards over `data_axis`; the dense grids
    # additionally shard their Z axis over `grid_axis`
    return jax.tree.map(
        lambda sp: P(data_axis, *sp), _state_specs(grid_axis)
    )


def init_fleet_grid_state(
    cfg: VoFODConfig,
    dyn: DynParams,
    batch: int,
    mesh: Mesh,
    data_axis: str = "data",
    grid_axis: str = "grid",
) -> VoFODState:
    """``batch`` detector states, stream-sharded over ``data_axis`` with each
    stream's dense grids Z-sharded over ``grid_axis``.  Jitted initializer
    with explicit out_shardings (multi-host safe, like
    sharding.init_batched_state)."""
    specs = _fleet_state_specs(data_axis, grid_axis)
    shardings = jax.tree.map(lambda sp: NamedSharding(mesh, sp), specs)

    def _init() -> VoFODState:
        import jax.numpy as jnp

        s0 = init_state(cfg, dyn)
        return jax.tree.map(
            lambda x: jnp.broadcast_to(x, (batch,) + x.shape), s0
        )

    return jax.jit(_init, out_shardings=shardings)()


def make_fleet_grid_step(
    cfg: VoFODConfig,
    lut: XyzLut,
    mesh: Mesh,
    data_axis: str = "data",
    grid_axis: str = "grid",
    zcone_mode: str = "pipelined",
    **step_kw,
):
    """Both scaling axes in ONE program: N sensor streams data-parallel over
    ``data_axis``, each stream's oversized operation area Z-sharded over
    ``grid_axis`` — a fleet of UAVs sharing one map geometry too large for
    one device (reference scope: one map, one machine — vofod_nodelet.cpp
    holds a single VoxelMap under a mutex; SURVEY.md §5 scaling axis).

    Signature: ``(state, scans, dyn) -> (state, outs)`` where every scan/out
    leaf carries a leading stream dim B (divisible by the data-axis size).
    Each device owns B/n_data streams x nz/n_grid grid planes.  The body is
    the grid-sharded step of :func:`make_grid_sharded_step` (ZShardOps
    collectives resolve against ``grid_axis`` inside the 2D shard_map, so
    halos/psums stay within one stream group's grid shards) wrapped in the
    per-shard stream lax.scan of sharding.make_batched_step — zero
    cross-stream traffic, bit-identical per-stream results to the 1D
    grid-sharded step (tests/test_fleet_grid.py).
    """
    n_g = int(mesh.shape[grid_axis])
    n_d = int(mesh.shape[data_axis])
    _validate_grid_sharding(cfg, n_g, grid_axis)
    if cfg.sequential_explore:
        raise ValueError(
            "sequential_explore (the demotion-coupling parity instrument) "
            "cannot compose with the 2D streams×grid mesh: its per-query "
            "cond branches contain collectives and diverge across stream "
            "groups (SPMD lockstep) — run parity studies on the 1D "
            "grid-sharded step instead"
        )
    # lockstep_axes: collective-bearing control flow (fixpoint while_loops,
    # the explore tier switch, demote conds) must agree across stream groups,
    # or a group that stops iterating early deadlocks the others' collective
    # rendezvous — see gridops.DenseOps control-flow reduction notes
    ops = ZShardOps(
        grid_axis, n_g, zcone_mode=zcone_mode, lockstep_axes=(data_axis,)
    )
    step = make_step_fn(cfg, lut, donate=False, jit=False, ops=ops, **step_kw)

    sspec = _fleet_state_specs(data_axis, grid_axis)
    if step_kw.get("frontend_mode") == "prebinned":
        from vofod_tpu.pipeline.state import PrebinnedScan

        scan_spec = PrebinnedScan(
            packed=P(data_axis, grid_axis, None, None),
            active=P(data_axis),
            pose=P(data_axis),
            stats=P(data_axis),
        )
    else:
        scan_spec = P(data_axis)

    def local_block(state_blk, scan_blk, dyn):
        # leaves carry leading dim B/n_data (this device's streams); each
        # stream steps its LOCAL grid shard, with grid-axis collectives
        def body(_, args):
            st, sc = args
            new_st, out = step(st, sc, dyn)
            return None, (new_st, out)

        _, (new_states, outs) = jax.lax.scan(body, None, (state_blk, scan_blk))
        return new_states, outs

    sharded = shard_map(
        local_block,
        mesh=mesh,
        in_specs=(sspec, scan_spec, P()),
        out_specs=(sspec, P(data_axis)),
        # per-stream outputs are replicated across the grid axis by
        # construction (psum/pmax inside the step); the checker cannot see
        # through psum-carried while loops
        check_vma=False,
    )

    def checked(state, scans, dyn):
        b = jax.tree.leaves(scans)[0].shape[0]
        if b % n_d:
            raise ValueError(
                f"batch {b} not divisible by data-axis size {n_d}"
            )
        return sharded(state, scans, dyn)

    return jax.jit(checked, donate_argnums=(0,))
