"""FleetVoFOD: multi-stream serving over a device mesh.

The production scaling story (DESIGN.md §6): N independent sensor streams,
one detector state each, sharded over the mesh "data" axis with shard_map;
each chip runs its local streams through the UNBATCHED step under lax.scan
(parallel/sharding.py::make_batched_step; whether vmap batching beats the
scan on the GPU is not measured yet, ROADMAP.md §1.4).  Throughput scales
linearly with devices since no collectives appear on the hot path.

This replaces (and massively widens) the reference's N pointcloud_loop worker
threads over one shared map (vofod_nodelet.cpp:1324-1328) — the reference
parallelizes scans of ONE sensor into one map, the fleet parallelizes whole
detectors.

``grid_shards > 1`` engages the 2D streams×grid composition
(parallel/grid_step.make_fleet_grid_step): each stream's dense grids
additionally shard along Z over that many devices — the fleet shape for
operation areas beyond one device's memory.  Checkpoints round-trip with both
sharding axes intact (tests/test_checkpoint.py).

Multi-host serving (one mesh spanning several hosts)
----------------------------------------------------
JAX multi-host is SPMD: every host runs this same program over one global
mesh and only feeds/fetches the shards its local chips own.  The runbook:

1. on every host: ``initialize_multihost(coordinator, num_processes,
   process_id)`` (before any other JAX call), then build the SAME
   ``FleetVoFOD(cfg, dyn, n_streams=...)`` — ``make_mesh()`` spans the
   global device list, and state init materializes local shards only.
2. each host attaches its own sensors to its local streams
   (:attr:`FleetVoFOD.local_streams`) and calls
   :meth:`process_local_scans` with ONLY those streams' scans each tick
   (every host must call it — it is one global SPMD dispatch); detections
   come back for the local streams only.  ``dyn`` updates must be applied
   identically on every host (ship the YAML, see runtime/param_watch.py).

Single-host, ``process_local_scans`` degenerates to :meth:`process_scans`
with a dict return — the 8-device CPU mesh tests drive exactly the
multi-host code path (make_array_from_process_local_data + per-shard
fetch), which is what makes the multi-host story testable on one host.
"""

from __future__ import annotations

import logging
import time

import jax
import jax.numpy as jnp
import numpy as np

from vofod_tpu.config import DynParams, VoFODConfig
from vofod_tpu.geometry import GridSpec
from vofod_tpu.io.msgs import Detection, Detections, Header
from vofod_tpu.parallel.grid_step import (
    init_fleet_grid_state,
    make_fleet_grid_mesh,
    make_fleet_grid_step,
)
from vofod_tpu.parallel.sharding import (
    init_batched_state,
    make_batched_step,
    make_mesh,
)
from vofod_tpu.pipeline.state import ScanInput
from vofod_tpu.sensor import make_lut


def initialize_multihost(
    coordinator_address: str, num_processes: int, process_id: int, **kw
) -> None:
    """Join a multi-host fleet (call before any other JAX API, on every host).

    Thin wrapper over ``jax.distributed.initialize`` so the serving entry
    point doesn't need to import jax directly; after it returns,
    ``jax.devices()`` spans the whole slice and ``make_mesh()`` builds the
    global mesh every host must share.
    """
    jax.distributed.initialize(
        coordinator_address, num_processes=num_processes, process_id=process_id, **kw
    )


def pick_stream_knee(n_devices: int = 1) -> int:
    """Streams to serve for ``serve_fleet --streams auto``: 32 per device.

    An unmeasured default — no run has yet found the largest fleet that
    meets the 10 Hz sensor cadence on a GPU; a cadence-validated knee
    replaces it once one has."""
    return 32 * n_devices


class FleetVoFOD:
    """Batch-of-detectors; call :meth:`process_scans` with per-stream scans."""

    def __init__(
        self,
        cfg: VoFODConfig | None = None,
        dyn: DynParams | None = None,
        n_streams: int | None = None,
        mesh=None,
        grid_shards: int = 1,
        **step_kw,
    ):
        """``grid_shards > 1`` engages the 2D streams×grid composition
        (parallel/grid_step.make_fleet_grid_step): every stream's dense
        grids additionally shard along Z over ``grid_shards`` devices — the
        fleet shape for operation areas beyond one device's memory.  The mesh
        then spans n_data × grid_shards devices with grid minor
        (n_data = device_count // grid_shards — devices beyond the largest
        full mesh idle; grid_shards > device_count is rejected)."""
        self.cfg = cfg or VoFODConfig()
        self.dyn = dyn or DynParams()
        self.grid_shards = int(grid_shards)
        if mesh is None:
            if self.grid_shards > 1:
                n_data = len(jax.devices()) // self.grid_shards
                mesh = make_fleet_grid_mesh(n_data, self.grid_shards)
            else:
                mesh = make_mesh()
        self.mesh = mesh
        n_data = int(self.mesh.shape["data"])
        self.n_streams = n_streams or n_data
        if self.n_streams % n_data != 0:
            raise ValueError(
                "n_streams must be a multiple of the mesh's data-axis size"
            )
        self.grid_spec = GridSpec.from_config(self.cfg)
        self.lut = make_lut(self.cfg.sensor)
        if self.grid_shards > 1:
            self._step = make_fleet_grid_step(
                self.cfg, self.lut, self.mesh, **step_kw
            )
            self.state = init_fleet_grid_state(
                self.cfg, self.dyn, self.n_streams, self.mesh
            )
            from jax.sharding import PartitionSpec as P

            self._grid_pspec = P("data", "grid", None, None)
        else:
            self._step = make_batched_step(
                self.cfg, self.lut, self.mesh, **step_kw
            )
            self.state = init_batched_state(
                self.cfg, self.dyn, self.n_streams, self.mesh
            )
            from jax.sharding import PartitionSpec as P

            self._grid_pspec = P("data")
        self.last_diag = None
        self._apriori_upd = None
        self._reset_upd = None
        # per-stream count of scans consumed as null scans for a non-finite
        # pose (lost TF — see _sanitize_rows)
        self.n_pose_rejected = np.zeros(self.n_streams, np.int64)
        self._log = logging.getLogger("vofod_tpu.fleet")
        # throttle clock for pose-rejection warnings (ref throttles this
        # exact message: NODELET_ERROR_THROTTLE(1.0), vofod_nodelet.cpp:919)
        self._last_pose_warn = 0.0
        self.pose_warn_period = 1.0
        # cached all-ones intensity buffers (see process_scans /
        # process_local_scans)
        self._ones_dev = None
        self._ones_dist = None

    def _sanitize_rows(
        self, r: np.ndarray, p: np.ndarray, global_ids
    ) -> tuple[np.ndarray, np.ndarray]:
        """Non-finite pose (lost TF) -> NULL scan for that stream.

        The single-stream node skips such a scan before any device work
        (runtime/node.py process_scan_async; ref transform-failure return,
        vofod_nodelet.cpp:900-914).  Under SPMD lockstep a stream cannot sit
        a step out — every stream enters the same program — so the rejected
        stream consumes the step as a null scan instead: zero returns (the
        frontend bins nothing, the EMA is fully masked) and a sentinel pose
        far outside the operation area (``in_limits`` False -> its raycast
        masks off through the lockstep conds, parallel/gridops ctrl seam).
        Unlike the node path its schedule counters DO advance — exactly as
        if the sensor had seen nothing this tick."""
        bad = ~np.isfinite(p.reshape(p.shape[0], -1)).all(axis=1)
        if bad.any():
            r, p = r.copy(), p.copy()
            sentinel = np.eye(4, dtype=np.float32)
            sentinel[:3, 3] = (
                np.asarray(self.cfg.oparea.lo, np.float32) - 1.0e6
            )
            r[bad] = 0.0
            p[bad] = sentinel
            bad_streams = []
            for li in np.nonzero(bad)[0]:
                g = global_ids[li]
                self.n_pose_rejected[g] += 1
                bad_streams.append(int(g))
            # one throttled line for ALL rejected streams this step: a fleet
            # TF outage at sensor rate x N streams must not flood the log
            now = time.time()
            if now - self._last_pose_warn >= self.pose_warn_period:
                self._last_pose_warn = now
                self._log.warning(
                    "streams %s: non-finite pose — null scan "
                    "(%d rejected total)",
                    bad_streams, int(self.n_pose_rejected.sum()),
                )
        return r, p

    @property
    def local_streams(self) -> list[int]:
        """Global stream indices whose state lives on this process's chips.

        Single-host this is every stream; on a multi-host mesh each host sees
        its own contiguous block (the "data"-axis shards it can address).
        """
        rows: set[int] = set()
        for s in self.state.grid.addressable_shards:
            sl = s.index[0]
            stop = self.n_streams if sl.stop is None else sl.stop
            rows.update(range(sl.start or 0, stop))
        return sorted(rows)

    def process_local_scans(
        self,
        ranges_mm: np.ndarray,
        poses: np.ndarray,
        stamp: float = 0.0,
        intensity: np.ndarray | None = None,
    ) -> dict[int, Detections]:
        """Multi-host entry point: feed ONLY this host's streams, in
        :attr:`local_streams` order; returns ``{global stream id: Detections}``
        for those streams.

        Every host must call this each tick — it is one global SPMD dispatch
        assembled with ``jax.make_array_from_process_local_data``.  Single
        host it is equivalent to :meth:`process_scans` with a dict return.
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        local = self.local_streams
        Bl, B = len(local), self.n_streams
        n_pts = self.cfg.sensor.n_points
        sharding = NamedSharding(self.mesh, P("data"))

        def dist(x, shape):
            return jax.make_array_from_process_local_data(
                sharding, np.ascontiguousarray(x), shape
            )

        r = np.asarray(ranges_mm, np.float32).reshape(Bl, n_pts)
        p = np.asarray(poses, np.float32).reshape(Bl, 4, 4)
        r, p = self._sanitize_rows(r, p, local)
        if intensity is None:
            # cached device-resident all-ones (the step never donates scan
            # args — same reuse contract as runtime/node.py _ones_dev);
            # rebuilding per tick would redistribute 524 KB x Bl every scan
            if self._ones_dist is None:
                self._ones_dist = dist(
                    np.ones((Bl, n_pts), np.float32), (B, n_pts)
                )
            inten = self._ones_dist
        else:
            inten = dist(
                np.asarray(intensity, np.float32).reshape(Bl, n_pts),
                (B, n_pts),
            )
        scans = ScanInput(
            ranges_mm=dist(r, (B, n_pts)),
            intensity=inten,
            pose=dist(p, (B, 4, 4)),
        )
        self.state, out = self._step(self.state, scans, self.dyn.as_arrays())
        ids = None
        arrs = {}
        for name, leaf in zip(out.detections._fields, out.detections):
            ids, arrs[name] = _host_local_rows(leaf, B)
        self.last_diag = jax.tree.map(
            lambda a: _host_local_rows(a, B)[1], out.diag
        )
        return {
            b: _row_to_msg(arrs, li, b, stamp) for li, b in enumerate(ids)
        }

    def process_scans(
        self,
        ranges_mm: np.ndarray,
        poses: np.ndarray,
        stamp: float = 0.0,
        intensity: np.ndarray | None = None,
    ) -> list[Detections]:
        """ranges_mm: [B, H*W]; poses: [B, 4, 4]; intensity: optional
        [B, H*W] (sources without the channel substitute all-ones, same as
        the single-stream node — the ``raycast/min_intensity`` gate,
        vofod_nodelet.cpp:1449, is live under the batched step either way).
        Returns one Detections message per stream."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        B = self.n_streams
        r = np.asarray(ranges_mm, np.float32).reshape(B, -1)
        p = np.asarray(poses, np.float32).reshape(B, 4, 4)
        r, p = self._sanitize_rows(r, p, range(B))
        # upload each stream's rows straight to the device that owns it
        # (the step's "data" sharding) instead of staging all on device 0
        rows = NamedSharding(self.mesh, P("data"))
        if intensity is None:
            # cached all-ones device buffer (reuse is safe: the step never
            # donates scan args — same contract as runtime/node.py _ones_dev)
            if self._ones_dev is None:
                self._ones_dev = jax.device_put(
                    np.ones((B, self.cfg.sensor.n_points), np.float32), rows
                )
            i = self._ones_dev
        else:
            i = jax.device_put(
                np.asarray(intensity, np.float32).reshape(
                    B, self.cfg.sensor.n_points
                ),
                rows,
            )
        scans = ScanInput(
            ranges_mm=jax.device_put(r, rows),
            intensity=i,
            pose=jax.device_put(p, rows),
        )
        self.state, out = self._step(self.state, scans, self.dyn.as_arrays())
        d = jax.device_get(out.detections)
        self.last_diag = jax.device_get(out.diag)
        arrs = {name: np.asarray(leaf) for name, leaf in zip(d._fields, d)}
        return [_row_to_msg(arrs, b, b, stamp) for b in range(B)]

    def load_apriori_map(self, points_xyz: np.ndarray, stream: int | None = None):
        """Stamp an apriori cloud into one stream's map (or all streams).

        Runs as a jitted masked write on the sharded grid (no host round-trip
        of the state), so it works on a multi-host mesh too — call it with the
        same cloud on every host.

        The config's ``apriori_map/tf`` + ``sim_correction`` placement is
        applied exactly like the single-stream node (ref
        vofod_nodelet.cpp:224-225: ``p' = R_yaw @ (p + t + sim_correction)``).
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        from vofod_tpu.geometry import yaw_rotation

        g = self.grid_spec
        pts = np.asarray(points_xyz, np.float32)
        if pts.size:
            t = np.asarray(self.cfg.apriori_tf, np.float32) + np.asarray(
                self.cfg.apriori_sim_correction, np.float32
            )
            R = yaw_rotation(np.deg2rad(self.cfg.apriori_tf_yaw_deg))
            pts = (pts + t) @ R.T
        ox, oy, oz = g.origin
        idx = np.floor((pts - np.array([ox, oy, oz])) / g.voxel_size).astype(np.int64)
        ok = (
            (idx[:, 0] >= 0) & (idx[:, 0] < g.nx)
            & (idx[:, 1] >= 0) & (idx[:, 1] < g.ny)
            & (idx[:, 2] >= 0) & (idx[:, 2] < g.nz)
        )
        idx = idx[ok]
        mask = np.zeros(self.cfg.grid_shape, bool)
        mask[idx[:, 2], idx[:, 1], idx[:, 0]] = True
        sel = np.zeros((self.n_streams,), bool)
        sel[np.arange(self.n_streams) if stream is None else [stream]] = True
        if self._apriori_upd is None:
            sharding = NamedSharding(self.mesh, self._grid_pspec)
            rep = NamedSharding(self.mesh, P())

            def _upd(grid, m, s):
                return jnp.where(s[:, None, None, None] & m[None], jnp.inf, grid)

            upd = jax.jit(_upd, out_shardings=sharding, donate_argnums=(0,))
            self._apriori_upd = lambda grid, m, s: upd(
                grid,
                jax.make_array_from_process_local_data(rep, m),
                jax.make_array_from_process_local_data(rep, s),
            )
        self.state = self.state._replace(
            grid=self._apriori_upd(self.state.grid, mask, sel)
        )
        return int(idx.shape[0])

    def reset_stream(self, stream: int | None = None) -> None:
        """The reference's ``~reset`` service (vofod_nodelet.cpp:1610-1632)
        lifted to the fleet: re-initialize ONE stream's detector state to
        cold start (or all streams with ``stream=None``) while the rest of
        the fleet keeps flying — a UAV relaunching mid-mission.

        A jitted masked select on the sharded state (no host round-trip,
        multi-host safe like :meth:`load_apriori_map` — call with the same
        ``stream`` on every host).  Like the reference's reset, the apriori
        bootstrap is separate: re-stamp with ``load_apriori_map(pts,
        stream=...)`` afterwards.  The reset stream's step counter restarts
        at 0, so its raycast/sepclusters schedule diverges from the other
        stream groups — safe under the 2D streams×grid mesh because the
        schedule conds are lockstep-reduced (pipeline/step.py)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        sel = np.zeros((self.n_streams,), bool)
        sel[np.arange(self.n_streams) if stream is None else [stream]] = True
        if self.grid_shards > 1:
            fresh = init_fleet_grid_state(
                self.cfg, self.dyn, self.n_streams, self.mesh
            )
        else:
            fresh = init_batched_state(
                self.cfg, self.dyn, self.n_streams, self.mesh
            )
        if self._reset_upd is None:
            rep = NamedSharding(self.mesh, P())
            shardings = jax.tree.map(lambda leaf: leaf.sharding, fresh)

            def _upd(cur, new, s):
                return jax.tree.map(
                    lambda c, n: jnp.where(
                        s.reshape((-1,) + (1,) * (c.ndim - 1)), n, c
                    ),
                    cur,
                    new,
                )

            upd = jax.jit(_upd, out_shardings=shardings, donate_argnums=(0,))
            self._reset_upd = lambda cur, new, s: upd(
                cur, new, jax.make_array_from_process_local_data(rep, s)
            )
        self.state = self._reset_upd(self.state, fresh, sel)


def _host_local_rows(arr, n_rows: int) -> tuple[list[int], np.ndarray]:
    """(global row ids, concatenated host-local rows) of a [B, ...] sharded
    array — the per-host view of a "data"-sharded batch."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start or 0)
    ids: list[int] = []
    blocks = []
    seen: set[int] = set()
    for s in shards:
        sl = s.index[0]
        start = sl.start or 0
        if start in seen:
            # under the 2D streams×grid mesh, detection leaves are sharded
            # over "data" only — each stream group's rows are replicated on
            # its grid-axis devices; take one copy
            continue
        seen.add(start)
        stop = n_rows if sl.stop is None else sl.stop
        ids.extend(range(start, stop))
        blocks.append(np.asarray(s.data))
    return ids, np.concatenate(blocks, axis=0)


def _row_to_msg(
    arrs: dict[str, np.ndarray], row: int, stream: int, stamp: float
) -> Detections:
    """Detections message for one stream's row of the batched step output."""
    msg = Detections(header=Header(stamp, f"stream{stream}"))
    for k in range(arrs["valid"].shape[1]):
        if not arrs["valid"][row, k]:
            continue
        msg.detections.append(
            Detection(
                id=int(arrs["id"][row, k]),
                confidence=float(arrs["confidence"][row, k]),
                n_points=int(arrs["n_points"][row, k]),
                position=tuple(float(v) for v in arrs["position"][row, k]),
                covariance=tuple(
                    float(v) for v in arrs["covariance"][row, k].reshape(-1)
                ),
                detection_probability=float(
                    arrs["detection_probability"][row, k]
                ),
            )
        )
    return msg
