"""The end-to-end jitted step: scan -> (new state, detections, diagnostics).

Deterministic schedule replacing the reference's thread interleaving
(SURVEY.md §7 design stance; ref vofod_nodelet.cpp:882-1096 + the raycast and
sepclusters threads):

  1. frontend: filter + transform + voxel binning      (ref :928)
  2. background sufficiency + close/far split           (ref :932-936)
  3. point EMA update of the confidence grid            (ref :946-948)
  4. classification + floating check + demotions        (ref :961)
  5. detection extraction                               (ref :963)
  6. freespace raycast + flag-guarded ray EMA update    (ref raycast_cloud)
  7. every sepclusters_every steps: background maint.   (ref bgclusters_loop)

The raycast is applied with detection_its_diff = raycast_every and only to
voxels without a point this scan — exactly the invariant the reference's
mutex + flags machinery enforces (flags ``unmarked``, ref :1557-1601).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from vofod_tpu.config import DynParams, VoFODConfig
from vofod_tpu.geometry import GridSpec, se3_apply, se3_rotate
from vofod_tpu.ops.raycast import gate_faces, make_angular_gate
from vofod_tpu.parallel.gridops import DENSE
from vofod_tpu.pipeline.background import split_and_update
from vofod_tpu.pipeline.classify import classify
from vofod_tpu.pipeline.detect import extract_detections
from vofod_tpu.pipeline.frontend import run_frontend, run_frontend_prebinned
from vofod_tpu.pipeline.sepclusters import run_sepclusters
from vofod_tpu.pipeline.state import (
    Detections,
    ScanInput,
    StepDiagnostics,
    VoFODState,
)
from vofod_tpu.sensor import RANGE_TO_METERS, XyzLut

Array = jnp.ndarray


class StepOutput(NamedTuple):
    detections: Detections
    diag: StepDiagnostics


def ray_update(
    cfg: VoFODConfig,
    dyn: DynParams,
    grid_vals: Array,
    raylen: Array,
    had_point: Array,
    its_diff: Array,
    ops=DENSE,
) -> Array:
    """Flag-guarded EMA toward the ray score (both reference update rules,
    vofod_nodelet.cpp:1550-1601)."""
    active = (~had_point) & (raylen > 0.0)

    # new rule (ref :1550-1573)
    voxel_diag = math.sqrt(3.0) * cfg.voxel_size
    n_int = (dyn.raycast_weight_coefficient / voxel_diag) * raylen
    w1_new = jnp.exp2(-its_diff * n_int)

    # old rule (ref :1574-1601): normalize by the max cell value
    max_val = jnp.maximum(ops.gmax(raylen), 1e-20)
    w_single = dyn.raycast_weight_coefficient * jnp.sqrt(raylen / max_val)
    w1_old = jnp.clip(jnp.power(1.0 - w_single, its_diff), 0.0, 1.0)

    w1 = jnp.where(dyn.raycast_new_update_rule, w1_new, w1_old)
    updated = w1 * grid_vals + (1.0 - w1) * dyn.score_ray
    return jnp.where(active, updated, grid_vals)


_STEP_CACHE: dict = {}


def make_step_fn(
    cfg: VoFODConfig,
    lut: XyzLut,
    *,
    raycast_mode: str = "sweep",
    raycast_every: int = 1,
    donate: bool = True,
    jit: bool = True,
    mask=None,
    raycast_gate: bool = True,
    ops=DENSE,
    frontend_mode: str = "raw",
) -> Callable[[VoFODState, ScanInput, DynParams], tuple[VoFODState, StepOutput]]:
    """Build (or fetch from the process-level cache) the jitted step.

    Identical (config, LUT, mask, mode) requests return the same jitted
    callable, so constructing several detector nodes with the same setup
    compiles once (jax.jit caching is per-callable; without this cache every
    node would re-trace and re-compile an identical program).
    """
    import hashlib

    key = (
        cfg,
        raycast_mode,
        raycast_every,
        donate,
        jit,
        raycast_gate,
        frontend_mode,
        ops.cache_key,
        hashlib.sha1(lut.directions.tobytes() + lut.offsets.tobytes()).hexdigest(),
        hashlib.sha1(
            b"" if mask is None else __import__("numpy").asarray(mask).tobytes()
        ).hexdigest(),
    )
    cached = _STEP_CACHE.get(key)
    if cached is not None:
        return cached
    fn = _make_step_fn(
        cfg, lut, raycast_mode=raycast_mode, raycast_every=raycast_every,
        donate=donate, jit=jit, mask=mask, raycast_gate=raycast_gate, ops=ops,
        frontend_mode=frontend_mode,
    )
    _STEP_CACHE[key] = fn
    return fn


def _make_step_fn(
    cfg: VoFODConfig,
    lut: XyzLut,
    *,
    raycast_mode: str = "sweep",
    raycast_every: int = 1,
    donate: bool = True,
    jit: bool = True,
    mask=None,
    raycast_gate: bool = True,
    ops=DENSE,
    frontend_mode: str = "raw",
    _return_stages: bool = False,
) -> Callable[[VoFODState, ScanInput, DynParams], tuple[VoFODState, StepOutput]]:
    """Build the jitted step function.

    raycast_mode: "sweep" (gather/scatter-free transmittance sweep,
      production), "exact" (per-ray DDA + scatter; bit-faithful), or
      "off".
    frontend_mode: "raw" (the step takes ScanInput and bins on device) or
      "prebinned" (the step takes PrebinnedScan from io/binner.py — the host
      already filtered+binned the scan; the production serving path).  The
      exact DDA needs per-pixel ranges, so "prebinned" pairs with the sweep
      raycast only.
    ops: dense-grid op provider (parallel/gridops.py).  The default DENSE
      runs single-device; ZShardOps runs the identical stage code with the
      grid Z-sharded inside shard_map (built by
      parallel/grid_step.make_grid_sharded_step — do not pass it here
      directly).
    raycast_every: apply the freespace update every N steps with
      its_diff = N (the reference's raycast thread naturally skips scans
      under load and compensates identically, ref :1540-1548).
    mask: optional uint8/bool [H*W] FOV mask (1 = usable).  Gates the exact
      raycast like the reference (skip when masked AND no return,
      ref :1449-1450); with ``raycast_gate`` (default) the sweep honors the
      same per-pixel mask/intensity gates through the angular gate factor
      (ops/raycast.py gate_faces).
    """
    if frontend_mode not in ("raw", "prebinned"):
        raise ValueError(f"unknown frontend_mode {frontend_mode!r}")
    if frontend_mode == "prebinned" and raycast_mode == "exact":
        raise NotImplementedError(
            "the exact DDA needs per-pixel ranges; prebinned ingest pairs "
            "with the sweep raycast (make_step_fn docstring)"
        )
    if cfg.dynamic_radii and (
        cfg.sepclusters_exact_census or cfg.compat_hascloseto_bounds
    ):
        # exact census derives the coarse leaf SIZE (an array-shape factor)
        # from max_bg_distance, and the hasCloseTo compat box is a parity
        # instrument — both are inherently static-radius modes.  The
        # grid-sharded step composes fine (ZShardOps halos at the bound).
        raise NotImplementedError(
            "dynamic_radii (traced stencil radii) is supported in the "
            "default sepclusters mode only, dense or grid-sharded "
            "(config.py VoFODConfig.dynamic_radii)"
        )
    # SPMD lockstep (2D streams×grid mesh only): the raycast and sepclusters
    # stage conds hold grid-axis collectives, and their predicates are
    # PER-STREAM — do_ray via in_limits(sensor_pos) (a stream whose sensor
    # leaves the oparea diverges from the other groups on a normal flight)
    # and run_sep via the per-stream step counter (diverges after a
    # per-stream reset or a checkpoint assembled from different streams).
    # Route the cond through ctrl_any (all groups enter whenever ANY group
    # must) and mask the stage result by the LOCAL predicate — the same
    # collective sequence on every group, bit-identical per-stream results
    # (gridops control-flow reduction notes; tests/test_fleet_grid.py
    # test_diverging_do_ray_lockstep).
    lockstep = bool(getattr(ops, "lockstep_axes", ()))
    grid = GridSpec.from_config(cfg)
    lut_dirs = jnp.asarray(lut.directions)
    lut_offs = jnp.asarray(lut.offsets)
    mask_dev = (
        jnp.asarray(mask).reshape(-1) > 0
        if mask is not None
        else jnp.ones((cfg.sensor.n_points,), jnp.bool_)
    )
    gate_spec = (
        make_angular_gate(lut)
        if (raycast_gate and raycast_mode == "sweep")
        else None
    )

    def cnc_stage(state: VoFODState, scan: ScanInput, dyn: DynParams):
        """Stages 1-5: frontend, split+point update, classify, detections
        (the reference's detection thread == routine CNC)."""
        pose = scan.pose
        sensor_pos = pose[:3, 3]

        # 1. frontend
        if frontend_mode == "prebinned":
            fe = run_frontend_prebinned(cfg, grid, scan, ops=ops)
        else:
            fe = run_frontend(
                cfg, grid, lut_dirs, lut_offs, scan.ranges_mm, pose, ops=ops
            )

        # 2-3. split + point update
        bg = split_and_update(
            cfg, dyn, state.grid, fe.counts, state.bg_sufficient, ops=ops
        )

        # 4. classification (+ frontier demotions)
        cls = classify(
            cfg,
            dyn,
            grid,
            bg.grid,
            bg.far,
            bg.labels,
            bg.cc_converged,
            sensor_pos,
            bg.bg_sufficient,
            state.sure_bg_sufficient,
            ops=ops,
        )

        # 5. detections
        dets, det_counter = extract_detections(
            cfg, dyn, grid, cls.grid, cls.labels, bg.far, cls, sensor_pos,
            state.det_counter, ops=ops,
        )
        return fe, bg, cls, dets, det_counter

    def ray_stage(
        scan: ScanInput, dyn: DynParams, step_idx, vals, occupied, blockers
    ):
        """Stage 6: freespace raycast + flag-guarded ray EMA update
        (the reference's raycast thread == routine RAYCASTING)."""
        if raycast_mode == "off":
            return vals
        pose = scan.pose
        sensor_pos = pose[:3, 3]
        rot = pose[:3, :3]
        do_ray = (
            (~dyn.raycast_pause)
            & grid.in_limits(sensor_pos[None, :])[0]
            & (jnp.mod(step_idx, raycast_every) == raycast_every - 1
               if raycast_every > 1 else jnp.bool_(True))
        )

        def with_ray(vals):
            if raycast_mode == "exact":
                r = scan.ranges_mm.astype(jnp.float32) * RANGE_TO_METERS
                # hostile-float contract (tests/test_hostile_inputs.py): NaN/
                # negative ranges are no-returns, +inf a return past any
                # operation area (mirrors io/binner.py's host sanitizer).
                # Without this a NaN range on an in-mask pixel makes
                # `lengths` NaN (r == 0 is False for NaN) and the DDA
                # emission weights would scatter NaN into the ray grid.
                # Elementwise, fuses into the conversion above for free.
                r = jnp.where(
                    jnp.isnan(r) | (r < 0.0), 0.0, jnp.minimum(r, 4.0e6)
                )
                dirs_w = se3_rotate(pose, lut_dirs)
                starts = se3_apply(pose, lut_offs)
                max_d = dyn.raycast_max_distance
                lengths = jnp.where(
                    r == 0.0, max_d, jnp.minimum(r - cfg.voxel_size, max_d)
                )
                rvalid = (
                    # ref gate is `intensity < min -> skip` (:1449), so NaN
                    # intensity PASSES (NaN < x is false) — keep the negated
                    # form for bit parity, not `>=`
                    ~(scan.intensity < dyn.raycast_min_intensity)
                    & (mask_dev | (r > 0))  # ref :1449-1450
                    & grid.in_limits(starts)
                )
                raylen = ops.raycast_dda(
                    grid, starts, dirs_w, lengths, rvalid,
                    cfg.raycast_max_distance_bound,
                )
            else:
                faces = None
                if gate_spec is not None:
                    if frontend_mode == "prebinned":
                        # the host binner evaluated the per-pixel gate
                        # (ref :1449-1450) — see io/binner.py
                        active = scan.active > 0
                    else:
                        r = (
                            scan.ranges_mm.astype(jnp.float32)
                            * RANGE_TO_METERS
                        )
                        active = ~(
                            scan.intensity < dyn.raycast_min_intensity
                        ) & (mask_dev | (r > 0))  # ref :1449-1450 (NaN passes)
                    faces = gate_faces(
                        gate_spec,
                        active.reshape(
                            cfg.sensor.vertical_rays,
                            cfg.sensor.horizontal_rays,
                        ),
                        rot,
                    )
                raylen = ops.raycast_sweep(
                    grid,
                    blockers,
                    sensor_pos,
                    rot,
                    max_distance=dyn.raycast_max_distance,
                    vertical_fov=cfg.sensor.vertical_fov,
                    v_rays=cfg.sensor.vertical_rays,
                    h_rays=cfg.sensor.horizontal_rays,
                    gate=faces,
                    # static window around the sensor: the sweep cost is
                    # volume-proportional and everything beyond the bound is
                    # masked anyway (raycast.py raycast_sweep docstring)
                    max_distance_bound=cfg.raycast_max_distance_bound,
                )
            updated = ray_update(
                cfg, dyn, vals, raylen, occupied,
                jnp.float32(raycast_every), ops=ops,
            )
            if lockstep:
                # discard on streams whose local predicate was false (their
                # group entered only to keep the collectives in lockstep)
                updated = jnp.where(do_ray, updated, vals)
            return updated

        pred = ops.ctrl_any(do_ray) if lockstep else do_ray
        return jax.lax.cond(pred, with_ray, lambda v: v, vals)

    def sep_stage(dyn: DynParams, step_idx, vals, safe, sure_bg_prev):
        """Stage 7: separated-background maintenance
        (the reference's bgclusters thread == routine SEPBGCLUSTERS)."""
        run_sep = (
            (jnp.mod(step_idx, cfg.sepclusters_every) == 0)
            & ~dyn.sepclusters_pause
        )

        def with_sep(args):
            vals, safe = args
            out = run_sepclusters(
                cfg, dyn, vals, safe, jnp.float32(cfg.sepclusters_every),
                ops=ops, prev_sure=sure_bg_prev,
            )
            res = (out.grid, out.safe, out.sure_bg_sufficient, out.converged)
            if lockstep:
                # discard on streams whose local counter didn't fire (their
                # group entered only to keep the collectives in lockstep)
                res = jax.tree.map(
                    lambda a, b: jnp.where(run_sep, a, b),
                    res,
                    without_sep(args),
                )
            return res

        def without_sep(args):
            vals, safe = args
            return vals, safe, sure_bg_prev, jnp.bool_(True)

        pred = ops.ctrl_any(run_sep) if lockstep else run_sep
        return jax.lax.cond(pred, with_sep, without_sep, (vals, safe))

    def assemble(state, bg, cls, dets, det_counter, vals, safe, sure_bg,
                 sep_conv):
        new_state = VoFODState(
            grid=vals,
            safe=safe,
            det_counter=det_counter,
            step=state.step + 1,
            sure_bg_sufficient=sure_bg,
            bg_sufficient=bg.bg_sufficient,
        )
        diag = StepDiagnostics(
            n_bg_voxels=bg.n_bg_voxels,
            bg_sufficient=bg.bg_sufficient,
            sure_bg_sufficient=sure_bg,
            n_occupied=ops.gsum(bg.occupied).astype(jnp.int32),
            n_far=cls.n_far,
            far_overflow=cls.far_overflow,
            cc_converged=bg.cc_converged & cls.labels_converged,
            cc_iters=bg.cc_iters,
            sep_converged=sep_conv,
            n_detections=dets.valid.sum().astype(jnp.int32),
        )
        return new_state, StepOutput(detections=dets, diag=diag)

    def step(
        state: VoFODState, scan: ScanInput, dyn: DynParams
    ) -> tuple[VoFODState, StepOutput]:
        fe, bg, cls, dets, det_counter = cnc_stage(state, scan, dyn)
        vals = ray_stage(
            scan, dyn, state.step, cls.grid, bg.occupied, fe.blockers
        )
        vals, safe, sure_bg, sep_conv = sep_stage(
            dyn, state.step, vals, state.safe, state.sure_bg_sufficient
        )
        return assemble(
            state, bg, cls, dets, det_counter, vals, safe, sure_bg, sep_conv
        )

    if _return_stages:
        return cnc_stage, ray_stage, sep_stage, assemble
    if not jit:
        return step
    donate_argnums = (0,) if donate else ()
    return jax.jit(step, donate_argnums=donate_argnums)


class StagedStep:
    """The same pipeline as three separately-jitted dispatches (CNC /
    RAYCASTING / SEPBGCLUSTERS), blocking between stages — for attributing
    REAL per-routine device times to the ProfilingInfo stream (the reference
    publishes per-thread START/END events, vofod_nodelet.cpp:2178-2203).

    Composes to exactly the fused step's result (tested bit-for-bit); costs
    two extra dispatch boundaries, so it is the profiling mode, not the
    production path.  ``last_timings`` holds {"cnc", "raycasting",
    "sepbgclusters"} wall durations (seconds) of the latest call.
    """

    def __init__(self, cfg: VoFODConfig, lut: XyzLut, **kw):
        cnc, ray, sep, assemble = _make_step_fn(
            cfg, lut, donate=False, jit=False, _return_stages=True, **kw
        )
        self._cnc = jax.jit(cnc)
        self._ray = jax.jit(ray)
        self._sep = jax.jit(sep)
        self._assemble = assemble
        self.last_timings: dict[str, float] = {}

    def __call__(
        self,
        state: VoFODState,
        scan: ScanInput,
        dyn: DynParams,
        stage_ctx: Callable | None = None,
    ) -> tuple[VoFODState, StepOutput]:
        """Run the three stages, blocking after each.

        ``stage_ctx(name)`` (names "cnc" / "raycasting" / "sepbgclusters")
        may return a context manager entered around each stage — the
        runtime's profiling stream brackets the dispatches with routine
        START/END events this way (runtime/node.py), so event stamps AND
        ``last_timings`` come from the same single drive of the pipeline.
        """
        import contextlib
        import time

        ctx = stage_ctx or (lambda name: contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx("cnc"):
            fe, bg, cls, dets, det_counter = jax.block_until_ready(
                self._cnc(state, scan, dyn)
            )
        t1 = time.perf_counter()
        with ctx("raycasting"):
            vals = jax.block_until_ready(
                self._ray(scan, dyn, state.step, cls.grid, bg.occupied,
                          fe.blockers)
            )
        t2 = time.perf_counter()
        with ctx("sepbgclusters"):
            vals, safe, sure_bg, sep_conv = jax.block_until_ready(
                self._sep(dyn, state.step, vals, state.safe,
                          state.sure_bg_sufficient)
            )
        t3 = time.perf_counter()
        self.last_timings = {
            "cnc": t1 - t0, "raycasting": t2 - t1, "sepbgclusters": t3 - t2
        }
        return self._assemble(
            state, bg, cls, dets, det_counter, vals, safe, sure_bg, sep_conv
        )
