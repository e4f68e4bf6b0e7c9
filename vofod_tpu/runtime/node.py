"""VoFOD host node: the thin shim that feeds scans to the jitted pipeline.

Replaces the reference ROS nodelet shell (vofod_nodelet.cpp:141-303 onInit,
1296-1393 main_loop): owns the device-resident state, runs the step per scan,
converts fixed-shape device outputs to Detections messages, and provides the
reset service, rangefinder fusion, apriori-map initialization, NPZ
checkpointing and profiling events.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from vofod_tpu.config import DynParams, VoFODConfig
from vofod_tpu.geometry import GridSpec
from vofod_tpu.io.msgs import Detection, Detections, Header, ProfilingInfo, Status
from vofod_tpu.pipeline.state import ScanInput, VoFODState, init_state
from vofod_tpu.pipeline.step import make_step_fn
from vofod_tpu.runtime.profiling import ProfilingStream, ScopeTimer
from vofod_tpu.sensor import XyzLut, make_lut


@dataclass
class NodeOptions:
    raycast_mode: str = "sweep"  # "sweep" | "exact" | "off"
    raycast_every: int = 1
    world_frame_id: str = "world"
    throttle_period: float = 1.0
    mask_path: str = ""  # FOV mask (ref raycast/mask_filename)
    mask_mangle: bool = False  # destagger+transpose quirk (ref :527-543)
    check_consistency: bool = False  # LUT vs points check (ref :1869-1917)
    # run the pipeline as three separately-timed dispatches so the
    # ProfilingInfo routine events carry REAL per-stage device durations
    # (the profiling mode; the fused default emits sequence-only markers
    # for RAYCASTING/SEPBGCLUSTERS — see process_scan)
    profile_stages: bool = False
    # "prebinned": the production serving ingest — the host bins each scan
    # (io/binner.py, native/frontend.cpp) and the packed count grid rides
    # the upload; the device frontend is a pure elementwise unpack
    # (no histogram scatter).  Pairs with the sweep raycast only.
    # "auto": measure both ingests once at startup (uploads, a warm host
    # bin and each device frontend, io/binner.py probe_ingest_mode) and
    # pick the cheaper.
    frontend_mode: str = "raw"
    # jax.profiler device-trace capture (SURVEY §5's per-kernel attribution
    # tool, pairing with the ProfilingInfo event stream): when set, ONE
    # trace window covering scans [trace_skip, trace_skip + trace_scans) is
    # written to this directory (TensorBoard/xprof format).  trace_skip
    # defaults past the compile scan so the window holds steady-state
    # dispatches; works for both the fused step and StagedStep (whose three
    # per-stage dispatches land in the same window, individually visible).
    trace_dir: str = ""
    trace_skip: int = 2
    trace_scans: int = 3


class VoFOD:
    """The detector node.  Thread-free: call :meth:`process_scan` per scan."""

    def __init__(
        self,
        cfg: VoFODConfig | None = None,
        dyn: DynParams | None = None,
        options: NodeOptions | None = None,
        lut: XyzLut | None = None,
    ):
        self.cfg = cfg or VoFODConfig()
        self.dyn = dyn or DynParams()
        self.options = options or NodeOptions()
        self.grid_spec = GridSpec.from_config(self.cfg)
        self.lut = lut or make_lut(self.cfg.sensor)
        self.profiling = ProfilingStream()
        from vofod_tpu.sensor import load_mask

        self.mask = load_mask(
            self.options.mask_path,
            self.cfg.sensor.horizontal_rays,
            self.cfg.sensor.vertical_rays,
            mangle=self.options.mask_mangle,
        )
        if self.options.frontend_mode == "auto":
            from dataclasses import replace as _dc_replace

            from vofod_tpu.io.binner import probe_ingest_mode

            mode, probe = probe_ingest_mode(self.cfg, self.lut, mask=self.mask)
            logging.getLogger("vofod_tpu").info(
                "ingest probe picked %r: %s", mode, probe
            )
            self.options = _dc_replace(self.options, frontend_mode=mode)
            self.ingest_probe = probe
        kw = dict(
            raycast_mode=self.options.raycast_mode,
            raycast_every=self.options.raycast_every,
            mask=self.mask,
            frontend_mode=self.options.frontend_mode,
        )
        if self.options.profile_stages:
            from vofod_tpu.pipeline.step import StagedStep

            self._step = StagedStep(self.cfg, self.lut, **kw)
        else:
            self._step = make_step_fn(self.cfg, self.lut, **kw)
        self._binner = None
        self._ones_dev = None  # cached all-ones intensity (see process_scan_async)
        if self.options.frontend_mode == "prebinned":
            from vofod_tpu.io.binner import HostBinner

            self._binner = HostBinner(self.cfg, self.lut, mask=self.mask)
        self._rangefinder_update = jax.jit(self._make_rangefinder_update())
        self.state: VoFODState = init_state(self.cfg, self.dyn)
        # host-side mirror of state.step: reading the device scalar per scan
        # costs a synchronous transfer and breaks async pipelining
        self._host_step = 0
        self.n_pose_rejected = 0  # scans skipped for a non-finite pose
        self._apriori_loaded = False
        self._sensor_checked = False
        self._sensor_params_ok = True
        self.last_diag = None
        self._log = logging.getLogger("vofod_tpu")
        self._last_log = 0.0
        self._last_pose_warn = 0.0  # throttle clock for pose-rejection warnings
        # device-trace window state: "pending" -> "on" -> "done"
        self._trace_state = "pending" if self.options.trace_dir else "done"
        if self.options.trace_dir:
            # close-out: a run shorter than trace_skip+trace_scans (short
            # recording, pose outage) would otherwise leave the profiler
            # running and the capture unwritten.  weakref so the hook never
            # extends the node's lifetime.
            import atexit
            import weakref

            ref = weakref.ref(self)
            atexit.register(lambda: ref() is not None and ref().close_trace())

    # ------------------------------------------------------------------ scans
    def process_scan(
        self, ranges_mm: np.ndarray, intensity: np.ndarray | None, pose: np.ndarray,
        stamp: float = 0.0, points_xyz: np.ndarray | None = None,
    ) -> Detections:
        """Run one scan through the pipeline.

        ranges_mm: [H*W] or [H, W] uint32/float (0 = no return).
        intensity: same shape (None = all ones).
        pose: [4, 4] world_T_sensor.
        points_xyz: optional sensor-frame points for the one-time LUT
          consistency check (ref check_sensor_params, gated like
          sensor/check_consistency; vofod_nodelet.cpp:903-904).
        """
        return self.fetch_result(
            self.process_scan_async(ranges_mm, intensity, pose, stamp,
                                    points_xyz=points_xyz)
        )

    def process_scan_async(
        self, ranges_mm: np.ndarray, intensity: np.ndarray | None, pose: np.ndarray,
        stamp: float = 0.0, points_xyz: np.ndarray | None = None,
    ):
        """Dispatch one scan without blocking on its results.

        JAX dispatch is asynchronous, so the returned pending handle lets a
        caller overlap the next scan's host work (binning, upload) with this
        scan's device step — the stream runner's one-deep pipeline
        (StreamRunner(pipeline_depth=1)).  Resolve with :meth:`fetch_result`.
        """
        n = self.cfg.sensor.n_points
        r = np.asarray(ranges_mm).reshape(-1)
        if (
            self.options.check_consistency
            and not self._sensor_checked
            and points_xyz is not None
        ):
            self._sensor_params_ok = self.check_scan_consistency(
                np.asarray(points_xyz).reshape(-1, 3), r
            )
            self._sensor_checked = True
        if r.shape[0] != n:
            raise ValueError(
                f"unexpected scan size {r.shape[0]}, expected {n} "
                f"({self.cfg.sensor.vertical_rays}x{self.cfg.sensor.horizontal_rays})"
            )  # ref size guard, vofod_nodelet.cpp:895-899
        # named checkpoints around the dispatch (ref mrs_lib::ScopeTimer
        # checkpoints through processMsg, vofod_nodelet.cpp:887-964)
        stimer = ScopeTimer(f"pc proc #{self._host_step}")
        pose_np = np.asarray(pose, np.float32)
        if not np.isfinite(pose_np).all():
            # Lost/invalid TF: the reference skips the scan entirely when the
            # world transform cannot be obtained (vofod_nodelet.cpp:900-914
            # getTransformToWorld guard + return); a NaN/Inf pose here is the
            # same failure arriving as data.  Skip BEFORE any device work —
            # a NaN translation only wastes a step (in_limits masks the
            # raycast), but a NaN ROTATION with a finite translation would
            # reach the raycast gate math.  Contract: tests/test_hostile_inputs.py.
            self.n_pose_rejected += 1
            # throttled like the reference's transform-failure error
            # (NODELET_ERROR_THROTTLE(1.0), vofod_nodelet.cpp:919): a
            # persistent TF outage at sensor rate must not flood the log;
            # the n_pose_rejected counter stays exact either way
            now = time.time()
            if now - self._last_pose_warn >= self.options.throttle_period:
                self._last_pose_warn = now
                self._log.warning(
                    "non-finite pose — scan skipped (%d rejected so far)",
                    self.n_pose_rejected,
                )
            return None, stamp, stimer
        if self._binner is not None:
            inten_np = (
                None if intensity is None
                else np.asarray(intensity, np.float32).reshape(-1)
            )
            b = self._binner.bin(
                r, pose_np, intensity=inten_np,
                min_intensity=float(self.dyn.raycast_min_intensity),
            )
            stimer.checkpoint("host bin")
            scan = b.to_device()
        else:
            if intensity is None:
                # sources without an intensity channel substitute all-ones;
                # upload that constant ONCE and reuse the device buffer —
                # per-scan it would be 524 KB of ones on the wire (half the
                # raw path's transfer), and the step never donates its scan
                # arguments, so reuse is safe
                if self._ones_dev is None:
                    self._ones_dev = jnp.ones(n, jnp.float32)
                inten_dev = self._ones_dev
            else:
                inten_dev = jnp.asarray(
                    np.asarray(intensity, np.float32).reshape(-1)
                )
            scan = ScanInput(
                ranges_mm=jnp.asarray(r.astype(np.float32)),
                intensity=inten_dev,
                pose=jnp.asarray(pose_np),
            )
        stimer.checkpoint("upload")
        if (
            self._trace_state == "pending"
            and self._host_step >= self.options.trace_skip
        ):
            jax.profiler.start_trace(self.options.trace_dir)
            self._trace_state = "on"
        if self.options.profile_stages:
            # staged pipeline: three timed dispatches -> routine events with
            # REAL per-stage device durations (ref per-thread events,
            # vofod_nodelet.cpp:2178-2203)
            self.state, out = self._emit_staged(scan)
        else:
            with self.profiling.routine(ProfilingInfo.ROUTINE_CNC):
                self.state, out = self._step(self.state, scan, self.dyn)
        stimer.checkpoint("dispatch")
        self._host_step += 1
        if (
            self._trace_state == "on"
            and self._host_step
            >= self.options.trace_skip + self.options.trace_scans
        ):
            # block so the traced window holds COMPLETED device activity,
            # not just the async dispatches
            jax.block_until_ready(self.state)
            jax.profiler.stop_trace()
            self._trace_state = "done"
            self._log.info(
                "device trace (%d scans) written to %s",
                self.options.trace_scans, self.options.trace_dir,
            )
        if not self.options.profile_stages:
            # the fused step subsumes the reference's raycast and sepclusters
            # threads; emit their START/END markers so downstream
            # ProfilingInfo consumers see the same routine SEQUENCE.  These
            # markers carry no duration by design — only CNC times the fused
            # dispatch; enable options.profile_stages for real per-routine
            # durations.
            # schedule parity: the device ran the stage this scan iff the
            # PRE-increment step index matched its period (step.py do_ray /
            # run_sep), and the reference returns BEFORE its profile_start
            # when paused (vofod_nodelet.cpp:1128-1133, 1400-1405) — so a
            # paused routine emits nothing.
            prev = self._host_step - 1
            ray_due = (
                prev % max(self.options.raycast_every, 1)
                == max(self.options.raycast_every, 1) - 1
            )
            if (
                self.options.raycast_mode != "off"
                and ray_due
                and not self.dyn.raycast_pause
            ):
                with self.profiling.routine(ProfilingInfo.ROUTINE_RAYCASTING):
                    pass
            sep_due = prev % max(self.cfg.sepclusters_every, 1) == 0
            if sep_due and not self.dyn.sepclusters_pause:
                with self.profiling.routine(ProfilingInfo.ROUTINE_SEPBGCLUSTERS):
                    pass
        return out, stamp, stimer

    def fetch_result(self, pending) -> Detections:
        """Block on a :meth:`process_scan_async` handle and convert to the
        Detections message (the host-to-host tail).  ONE fused device_get:
        diag + detections ride one readback."""
        out, stamp, stimer = pending
        if out is None:  # scan was skipped (non-finite pose) — empty message
            return Detections(header=Header(stamp, self.options.world_frame_id))
        self.last_diag, dets = jax.device_get((out.diag, out.detections))
        stimer.checkpoint("readback")
        self.last_scope_timer = stimer
        self._log_throttled()
        return self._to_msg_host(dets, stamp)

    _ROUTINE_BY_STAGE = {
        "cnc": ProfilingInfo.ROUTINE_CNC,
        "raycasting": ProfilingInfo.ROUTINE_RAYCASTING,
        "sepbgclusters": ProfilingInfo.ROUTINE_SEPBGCLUSTERS,
    }

    def _emit_staged(self, scan):
        """Drive the StagedStep, bracketing each stage dispatch with its
        routine's START/END events (truthful stamps AND durations) via the
        stage_ctx hook — one pipeline drive, no duplicated stage logic."""
        return self._step(
            self.state, scan, self.dyn,
            stage_ctx=lambda name: self.profiling.routine(
                self._ROUTINE_BY_STAGE[name]
            ),
        )

    def _log_throttled(self):
        """Throttled status logging (the reference logs per scan with
        NODELET_INFO_THROTTLE at throttle_period; e.g. vofod_nodelet.cpp:987,
        1094-1095)."""
        now = time.time()
        if now - self._last_log < self.options.throttle_period:
            return
        self._last_log = now
        d = self.last_diag
        self._log.info(
            "step=%d dets=%d occ=%d far=%d bg=%d active=%s cc_ok=%s",
            self._host_step, int(d.n_detections), int(d.n_occupied),
            int(d.n_far), int(d.n_bg_voxels),
            bool(d.bg_sufficient and d.sure_bg_sufficient),
            bool(d.cc_converged),
        )
        if not d.bg_sufficient:
            self._log.warning(
                "insufficient background (%d voxels) — classification inactive",
                int(d.n_bg_voxels),
            )  # ref :724

    def _to_msg(self, dets, stamp: float) -> Detections:
        return self._to_msg_host(jax.device_get(dets), stamp)

    def _to_msg_host(self, d, stamp: float) -> Detections:
        msg = Detections(header=Header(stamp, self.options.world_frame_id))
        for k in range(d.valid.shape[0]):
            if not d.valid[k]:
                continue
            msg.detections.append(
                Detection(
                    id=int(d.id[k]),
                    confidence=float(d.confidence[k]),
                    n_points=int(d.n_points[k]),
                    position=tuple(float(v) for v in d.position[k]),
                    covariance=tuple(float(v) for v in d.covariance[k].reshape(-1)),
                    detection_probability=float(d.detection_probability[k]),
                )
            )
        return msg

    # ------------------------------------------------------------ rangefinder
    def _make_rangefinder_update(self):
        grid = self.grid_spec

        def update(state: VoFODState, pt_world, score_point):
            ix, iy, iz = grid.coord_to_idx(pt_world[None, :])
            ok = grid.in_limits_idx(ix, iy, iz)[0]
            fid = grid.flat_id(ix, iy, iz)[0]
            flat = state.grid.reshape(-1)
            # mapval = (mapval + point_score) / 2 (ref vofod_nodelet.cpp:608-611)
            newval = (flat[fid] + score_point) / 2.0
            flat = jnp.where(ok, flat.at[fid].set(newval), flat)
            return state._replace(grid=flat.reshape(state.grid.shape))

        return update

    def process_rangefinder(
        self, rng: float, min_range: float, max_range: float, pose: np.ndarray
    ) -> bool:
        """Fuse a downward rangefinder hit (ref processMsg(Range), :579-613).

        The reference's validity check uses && where || was intended (ref
        :585); the spec-correct check is the default, the quirk is available
        via cfg.compat_rangefinder_validity.
        """
        if self.cfg.compat_rangefinder_validity:
            invalid = rng <= min_range and rng >= max_range  # ref quirk
        else:
            invalid = rng <= min_range or rng >= max_range
        if invalid:
            return False
        pt = np.asarray(pose, np.float32) @ np.array([rng, 0, 0, 1], np.float32)
        # in-limits check on the host (same f32 floor math as the device's
        # GridSpec.coord_to_idx): the reference skips out-of-area hits with an
        # error log (:600-604), and rejecting here both reports the skip
        # truthfully and saves a no-op device dispatch
        g = self.grid_spec
        idx = np.floor(
            (pt[:3] - np.asarray(g.origin, np.float32))
            * np.float32(g.inv_voxel)
        ).astype(np.int64)
        nxyz = (g.nx, g.ny, g.nz)
        if not all(0 <= idx[a] < nxyz[a] for a in range(3)):
            self._log.error("rangefinder hit outside the operation area")
            return False
        self.state = self._rangefinder_update(
            self.state, jnp.asarray(pt[:3]), jnp.float32(self.dyn.score_point)
        )
        return True

    # ------------------------------------------------------------ apriori map
    def load_apriori_map(
        self, points_xyz: np.ndarray, yaw_deg: float | None = None,
        translation=None,
    ) -> int:
        """Stamp an apriori static cloud into the map as +inf background
        (ref initialize_apriori_map, vofod_nodelet.cpp:305-355).

        yaw_deg/translation default to the config's ``apriori_map/tf`` with
        ``sim_correction`` folded into the translation, composed as the
        reference does (vofod_nodelet.cpp:224-225: Eigen ``rotate`` then
        ``translate`` right-multiply, so the map transform is ``R * T`` and
        ``p' = R @ (p + t + sim_correction)``).

        Returns the number of stamped voxels."""
        from vofod_tpu.geometry import yaw_rotation

        if yaw_deg is None:
            yaw_deg = self.cfg.apriori_tf_yaw_deg
        if translation is None:
            translation = tuple(
                t + c for t, c in zip(
                    self.cfg.apriori_tf, self.cfg.apriori_sim_correction
                )
            )
        pts = np.asarray(points_xyz, np.float32)
        if pts.size == 0:
            self._apriori_loaded = True
            return 0
        R = yaw_rotation(np.deg2rad(yaw_deg))
        pts = (pts + np.asarray(translation, np.float32)) @ R.T
        g = self.grid_spec
        ox, oy, oz = g.origin
        idx = np.floor((pts - np.array([ox, oy, oz])) / g.voxel_size).astype(np.int64)
        ok = (
            (idx[:, 0] >= 0) & (idx[:, 0] < g.nx)
            & (idx[:, 1] >= 0) & (idx[:, 1] < g.ny)
            & (idx[:, 2] >= 0) & (idx[:, 2] < g.nz)
        )
        idx = idx[ok]
        vals = np.array(self.state.grid)  # host copy (device arrays are read-only)
        vals[idx[:, 2], idx[:, 1], idx[:, 0]] = np.inf  # ref stamps +inf (:341)
        self.state = self.state._replace(grid=jnp.asarray(vals))
        self._apriori_loaded = True
        return int(idx.shape[0])

    # -------------------------------------------------------------- live tuning
    def update_params(self, **kwargs) -> None:
        """Change scores/thresholds/gates between scans without recompiling —
        the dynamic_reconfigure analogue (ref DetectionParams.cfg params are
        read every scan, vofod_nodelet.cpp m_drmgr_ptr->config.*).

        The two stencil radii (``ground_points_max_distance``,
        ``sepclusters_max_bg_distance``) are live-tunable only when the node
        was built with ``cfg.dynamic_radii`` — otherwise the static
        VoFODConfig values apply and changing them here would silently do
        nothing, so it raises instead."""
        import dataclasses as _dc

        if not self.cfg.dynamic_radii:
            for k in ("ground_points_max_distance",
                      "sepclusters_max_bg_distance"):
                if k in kwargs:
                    raise ValueError(
                        f"{k} shapes compiled stencils; it is static unless "
                        "the node is built with cfg.dynamic_radii=True "
                        "(which compiles at the *_bound radii and traces "
                        "the value — see VoFODConfig.dynamic_radii)"
                    )
        self.dyn = _dc.replace(self.dyn, **kwargs)

    def check_scan_consistency(
        self, points_xyz: np.ndarray, ranges_mm: np.ndarray
    ) -> bool:
        """Validate received points against the LUT ray model
        (ref check_sensor_params, vofod_nodelet.cpp:1869-1917)."""
        from vofod_tpu.sensor import check_sensor_params

        return check_sensor_params(self.lut, points_xyz, ranges_mm)

    # ----------------------------------------------------------------- status
    def status(self) -> Status:
        d = self.last_diag
        enabled = bool(d.bg_sufficient and d.sure_bg_sufficient) if d else False
        return Status(detection_enabled=True, detection_active=enabled)

    def reset(self):
        """The ~reset service (ref reset_callback :566-572)."""
        self.state = init_state(self.cfg, self.dyn)
        self._host_step = 0

    # -------------------------------------------------------------- exports
    def export_voxels(self, threshold: float, above: bool = True) -> np.ndarray:
        """Voxel centers with value above (or below-or-equal) a threshold —
        the ~background_pc / ~sure_air_pc debug clouds (ref voxelsAsPC,
        voxel_map.cpp:157-184; publishers vofod_nodelet.cpp:1001-1016)."""
        vals = np.asarray(jax.device_get(self.state.grid))
        m = vals > threshold if above else ~(vals > threshold)
        zz, yy, xx = np.nonzero(m)
        g = self.grid_spec
        ox, oy, oz = g.origin
        return np.stack(
            [
                (xx + 0.5) * g.voxel_size + ox,
                (yy + 0.5) * g.voxel_size + oy,
                (zz + 0.5) * g.voxel_size + oz,
            ],
            axis=1,
        ).astype(np.float32)

    # ------------------------------------------------------------------ replay
    def close_trace(self):
        """Flush an open device-trace window (``options.trace_dir`` mode).

        ``process_scan`` closes the window itself once ``trace_scans`` scans
        have run; this close-out covers runs that end earlier (short
        recordings, a pose outage after the window opened) so the capture is
        written rather than lost.  Idempotent; called from ``replay`` and an
        atexit hook."""
        if self._trace_state != "on":
            return
        try:
            jax.block_until_ready(self.state)
            jax.profiler.stop_trace()
            self._log.info(
                "device trace flushed early at scan %d (trace_scans=%d) "
                "to %s",
                self._host_step,
                self.options.trace_scans,
                self.options.trace_dir,
            )
        finally:
            self._trace_state = "done"

    def replay(
        self, npz_path: str, intensity=None, before_scan=None
    ) -> list[Detections]:
        """Run a recorded scan sequence (the rosbag-replay analogue,
        SURVEY.md §4; fixtures written by io.scan_source.save_scans_npz).

        ``before_scan``: optional ``f(scan_index)`` called before each scan
        (e.g. a runtime.param_watch.ParamWatcher.poll for live tuning)."""
        from vofod_tpu.io.scan_source import load_scans_npz

        ranges, poses, stamps, inten = load_scans_npz(npz_path)
        if intensity is not None:  # explicit arg overrides the recording
            inten = None
        out = []
        try:
            for k, (r, p, t) in enumerate(zip(ranges, poses, stamps)):
                if before_scan is not None:
                    # per-scan hook: live param polling (runtime/param_watch.py
                    # — the reference reads dynamic_reconfigure values every
                    # scan, vofod_nodelet.cpp m_drmgr_ptr->config.*), etc.
                    before_scan(k)
                i = intensity if intensity is not None else (
                    inten[k] if inten is not None else None
                )
                out.append(self.process_scan(r, i, p, float(t)))
        finally:
            # a recording shorter than the trace window must still flush it
            self.close_trace()
        return out

    # ----------------------------------------------------------- checkpointing
    def save_snapshot(self, path: str):
        """Snapshot of the full detector state (the reference has no map
        checkpointing — SURVEY.md §5 gap, closed here).

        ``*.npz`` paths write a host NPZ; any other path writes an Orbax
        checkpoint directory (runtime/checkpoint.py — per-shard device
        writes, the format the sharded/fleet runtimes use)."""
        if not path.endswith(".npz"):
            from vofod_tpu.runtime.checkpoint import save_state

            save_state(path, self.state)
            return
        s = jax.device_get(self.state)
        np.savez_compressed(
            path,
            grid=s.grid,
            safe=s.safe,
            det_counter=s.det_counter,
            step=s.step,
            sure_bg_sufficient=s.sure_bg_sufficient,
            bg_sufficient=s.bg_sufficient,
        )

    def load_snapshot(self, path: str):
        if not path.endswith(".npz"):
            from vofod_tpu.runtime.checkpoint import restore_state

            self.state = restore_state(path, self.state)
            self._host_step = int(np.asarray(self.state.step))
            return
        z = np.load(path)
        self.state = VoFODState(
            grid=jnp.asarray(z["grid"]),
            safe=jnp.asarray(z["safe"]),
            det_counter=jnp.asarray(z["det_counter"]),
            step=jnp.asarray(z["step"]),
            sure_bg_sufficient=jnp.asarray(z["sure_bg_sufficient"]),
            bg_sufficient=jnp.asarray(z["bg_sufficient"]),
        )
        self._host_step = int(z["step"])
