"""Configuration system: static geometry config + live-tunable dynamic params.

Mirrors the reference's two config tiers (ref: src/vofod_nodelet.cpp:165-238
static params via mrs_lib::ParamLoader; config/dynamic_reconfigure/
DetectionParams.cfg live-tunable params read every scan):

* :class:`VoFODConfig` — frozen, hashable static configuration.  Anything that
  affects array *shapes* or compiled control flow lives here; changing it
  recompiles the step function (the analogue of restarting the nodelet).
* :class:`DynParams` — a JAX pytree of scalars traced into the jitted step, so
  scores/thresholds can change *per step* without recompilation (the
  analogue of dynamic_reconfigure).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Mapping

import jax.numpy as jnp
import numpy as np


def _deg2rad(x: float) -> float:
    return float(x) * math.pi / 180.0


@dataclass(frozen=True)
class SensorConfig:
    """Static sensor geometry (ref: config/sensors/os0-128.yaml,
    vofod_nodelet.cpp:422-444 ``initialize_sensor_rosparam``)."""

    vertical_rays: int = 128
    horizontal_rays: int = 1024
    vertical_fov: float = _deg2rad(90.0)  # radians (OS0-128)
    simulation: bool = True
    check_consistency: bool = False
    # Beam geometry for the calibrated (non-simulation) LUT variant
    # (ref: vofod_nodelet.cpp:358-371 initialize_sensor_lut).  When None, the
    # ideal spherical model is used (ref: :374-420).
    beam_azimuth_angles_deg: tuple[float, ...] | None = None
    beam_altitude_angles_deg: tuple[float, ...] | None = None
    lidar_origin_to_beam_origin_mm: float = 0.0

    @property
    def n_points(self) -> int:
        return self.vertical_rays * self.horizontal_rays


@dataclass(frozen=True)
class Box:
    """Axis-aligned box given by center offset + size (ref: exclude_box /
    operation_area in config/detection_params.yaml and apriori_maps/sim.yaml)."""

    offset: tuple[float, float, float] = (0.0, 0.0, 0.0)
    size: tuple[float, float, float] = (1.0, 1.0, 1.0)

    @property
    def lo(self) -> tuple[float, float, float]:
        return tuple(o - s / 2.0 for o, s in zip(self.offset, self.size))

    @property
    def hi(self) -> tuple[float, float, float]:
        return tuple(o + s / 2.0 for o, s in zip(self.offset, self.size))


@dataclass(frozen=True)
class VoFODConfig:
    """Static configuration; hashable so it can close over the jitted step.

    Defaults reproduce the reference simulation setup
    (config/detection_params.yaml + config/apriori_maps/sim.yaml).
    Note: like the reference (vofod_nodelet.cpp:212), the operation-area z
    offset in the YAML is the *bottom* of the box; ``from_dicts`` applies the
    ``+ size_z/2`` correction so ``oparea.offset`` here is the true center.
    """

    sensor: SensorConfig = field(default_factory=SensorConfig)

    voxel_size: float = 0.5
    # operation area with *center* offset (z already corrected)
    oparea: Box = field(
        default_factory=lambda: Box((40.0, 20.0, -1.25 + 12.5), (120.0, 100.0, 25.0))
    )
    # own-airframe exclusion box in the sensor frame; z offset is the *bottom*
    # in YAML, corrected to center here (ref: vofod_nodelet.cpp:204)
    exclude_box: Box = field(
        default_factory=lambda: Box((0.09, 0.0, -0.75 + 0.8), (2.5, 2.5, 1.6))
    )

    # apriori-map placement (ref vofod_nodelet.cpp:213-226): the cloud is
    # translated by tf + sim_correction FIRST, then rotated by yaw about Z
    # (Eigen right-multiplication: apriori_map_tf = R * T(translation), so
    # p' = R @ (p + t)); the operation area itself also shifts by
    # sim_correction (:219-222).  `from_dicts` applies the oparea shift;
    # runtime.node.VoFOD.load_apriori_map applies the cloud transform.
    apriori_tf_yaw_deg: float = 0.0
    apriori_tf: tuple[float, float, float] = (0.0, 0.0, 0.0)
    apriori_sim_correction: tuple[float, float, float] = (0.0, 0.0, 0.0)

    # host-side log throttling (ref NODELET_*_THROTTLE period,
    # config/detection_params.yaml:1); consumed by NodeOptions, carried here
    # so every entry point reads it from the one YAML parse
    throttle_period: float = 1.0

    ground_points_max_distance: float = 1.5
    background_sufficient_points_ratio: float = 0.15
    # geometry-affecting: shapes the sepclusters adjacency/demotion stencils
    sepclusters_max_bg_distance: float = 0.8
    # live tuning of the two stencil radii above (the reference exposes both
    # via dynamic_reconfigure, DetectionParams.cfg:16-44).  With
    # dynamic_radii=True the stencils compile once at the *_bound radii and
    # the DynParams fields of the same names gate the taps by a traced r²
    # compare — both params then change between steps with NO recompilation.
    # Cost: the traced pools run the naive tap set (~3x the clustering
    # stage, ops/morphology._ball_pool_traced), so the static path stays the
    # default.  Bounds <= 0 default to the static values above.  Composes
    # with the grid-sharded step (halos at the static bound); NOT with
    # sepclusters_exact_census (the coarse leaf size is shape-static) or
    # compat_hascloseto_bounds (a static parity instrument).
    dynamic_radii: bool = False
    ground_points_max_distance_bound: float = 0.0
    sepclusters_max_bg_distance_bound: float = 0.0

    # --- static capacities of the fixed-shape pipeline ---------------------
    # max far (non-background) clusters tracked per scan; slots fill in
    # ascending component-label order, so keep generous headroom — sparse
    # distant ground legitimately forms several large ring clusters that
    # occupy slots before failing the size gate (per-slot math is cheap)
    max_clusters: int = 32
    # max far voxels compacted for per-cluster statistics; beyond this the
    # scan's classification is skipped (cold-start scans only)
    max_far_voxels: int = 2048
    # max flood-fill query points per scan (member voxels of *gated* far
    # clusters only — small by the max_size gate); overflow clusters are
    # conservatively classified unknown
    max_queries: int = 256
    # fast-path capacities of the tiered explore: each scan's batched BFS
    # runs at the smallest listed capacity that fits its query count,
    # falling back to max_queries (identical results — queries fill in
    # ascending order; the BFS cost scales with the [n, S, S, S] arrays).
    # An int means a single fast tier; an empty tuple (or <= 0) disables
    # tiering entirely.
    explore_fast_queries: tuple[int, ...] | int = (8, 32, 64)
    # side of the cubic submap used for the bounded exploreToGround BFS;
    # must cover 2*max_explore_voxel_dist+1
    explore_submap: int = 32
    # side of the cubic submap used for the detection confidence score
    # (AABB + 2 voxel inflation; ref: vofod_nodelet.cpp:851-867)
    confidence_submap: int = 16
    # fixed label-propagation sweep count for clustering: components up to
    # ~cc_sweeps * ground_points_max_distance across resolve exactly (see
    # ops/components.py rationale); also the while_loop cap for the other
    # reachability loops
    cc_sweeps: int = 8
    max_cc_iters: int = 64

    # static upper bound on raycast/max_distance (sizes the exact-DDA step
    # loop; the traced dyn.raycast_max_distance must stay below it)
    raycast_max_distance_bound: float = 20.0

    # --- scheduling ---------------------------------------------------------
    # run the separated-background-cluster maintenance every N steps
    # (ref period 0.1 s at a 10 Hz scan rate == every scan;
    # config/detection_params.yaml:3)
    sepclusters_every: int = 1
    # exact per-cluster sure-voxel census (ref vofod_nodelet.cpp:1174-1206):
    # coarse counted binning + component labeling to convergence + per-
    # component census — bit-parity mode.  The default (False) uses the
    # local-ball-density seeding (pipeline/sepclusters.py docstring), which is
    # much cheaper and equivalent for dense real background structure.
    sepclusters_exact_census: bool = False

    # sequential exploreToGround with live demotion (ref vofod_nodelet.cpp
    # :1692-1718 + voxel_map.cpp:402-488): the reference explores cluster
    # members one at a time in extraction order and demotes a FAILED
    # member's explored frontier immediately, visible to every later query
    # in the same scan (and demotions persist even when a later member
    # connects).  The default (False) evaluates all queries independently in
    # one batched BFS and demotes only fully-floating clusters — far faster,
    # equivalent except when a failed member's demotions flip a
    # later query's verdict (tests/test_sequential_demotion.py constructs
    # that divergence; DESIGN.md §9).  True runs a lax.scan over queries in
    # the reference's (cluster, member) order — the bit-parity instrument.
    sequential_explore: bool = False

    # --- compat flags for reference quirks (SURVEY.md §7 hard-part e) -------
    # reference counts "sure" voxels over positions in the sorted index vector
    # instead of remapped point indices (voxel_grid_counted.cpp:185-187),
    # permuting per-cell counts; spec-correct is the default.  True routes
    # ops/binning.voxel_grid_counted(compat_indexing=True) and the quirked
    # census inside pipeline/sepclusters.run_sepclusters_exact
    compat_counted_indexing: bool = False
    # reference's rangefinder validity check uses && where || was intended
    # (vofod_nodelet.cpp:585); spec-correct behavior is the default
    compat_rangefinder_validity: bool = False
    # reference hasCloseTo searches [idx-ceil(r), idx+ceil(r)) — EXCLUSIVE
    # upper bound, dropping the +ceil(r) layer per axis at exactly-integer
    # radii (voxel_map.cpp:383-388); spec-correct symmetric ball is default
    compat_hascloseto_bounds: bool = False

    # ------------------------------------------------------------------------
    @property
    def grid_shape(self) -> tuple[int, int, int]:
        """(nz, ny, nx) — X is the fastest-varying (minor) dimension.

        Sizing matches the reference VoxelMap::resize
        (src/voxel_map.cpp:11-19): ``ceil(dim / voxel) + 1`` per axis.
        """
        sx, sy, sz = self.oparea.size
        nx = int(math.ceil(sx / self.voxel_size)) + 1
        ny = int(math.ceil(sy / self.voxel_size)) + 1
        nz = int(math.ceil(sz / self.voxel_size)) + 1
        return (nz, ny, nx)

    @property
    def grid_origin(self) -> tuple[float, float, float]:
        """World coords of the low corner of voxel (0,0,0) (ref voxel_map.cpp:15)."""
        return self.oparea.lo

    @property
    def n_voxels(self) -> int:
        nz, ny, nx = self.grid_shape
        return nz * ny * nx

    @property
    def background_min_sufficient_pts(self) -> float:
        """ref: vofod_nodelet.cpp:228-230."""
        sx, sy, _ = self.oparea.size
        n_xy = (sx / self.voxel_size) * (sy / self.voxel_size)
        return n_xy * self.background_sufficient_points_ratio

    # hashability: dataclass(frozen=True) with tuples is hashable already.

    @staticmethod
    def from_dicts(
        detection: Mapping[str, Any],
        sensor: Mapping[str, Any] | None = None,
        apriori: Mapping[str, Any] | None = None,
        scan_rate_hz: float = 10.0,
        **overrides: Any,
    ) -> "VoFODConfig":
        """Build a config from parsed YAML dicts shaped like the reference's
        config/detection_params.yaml, config/sensors/*.yaml and
        config/apriori_maps/*.yaml.

        ``scan_rate_hz`` converts the reference's wall-clock
        ``separate_cluster_removal_period`` (a 0.1 s timer thread,
        ref vofod_nodelet.cpp:1280-1294 + config/detection_params.yaml:3)
        into this framework's deterministic every-N-steps schedule:
        ``sepclusters_every = max(1, round(period * scan_rate_hz))``.  The
        default 10 Hz is the reference's sensor cadence (SURVEY §6); an
        explicit ``sepclusters_every`` key or override wins.
        """
        kw: dict[str, Any] = {}
        d = detection
        if "voxel_map" in d:
            kw["voxel_size"] = float(d["voxel_map"].get("voxel_size", 0.5))
        for key in (
            "ground_points_max_distance",
            "background_sufficient_points_ratio",
            "throttle_period",
        ):
            if key in d:
                kw[key] = float(d[key])
        if "sepclusters" in d and "max_bg_distance" in d["sepclusters"]:
            kw["sepclusters_max_bg_distance"] = float(d["sepclusters"]["max_bg_distance"])
        if "exclude_box" in d:
            eb = d["exclude_box"]
            off = (
                float(eb["offset"]["x"]),
                float(eb["offset"]["y"]),
                # ref: vofod_nodelet.cpp:204 — z offset corrected to center
                float(eb["offset"]["z"]) + float(eb["size"]["z"]) / 2.0,
            )
            size = (float(eb["size"]["x"]), float(eb["size"]["y"]), float(eb["size"]["z"]))
            kw["exclude_box"] = Box(off, size)
        # apriori_map/tf + sim_correction (ref vofod_nodelet.cpp:213-226):
        # tf/yaw+xyz place the cloud; sim_correction additionally shifts BOTH
        # the cloud and the operation area itself (:219-222)
        corr = (0.0, 0.0, 0.0)
        if apriori and "apriori_map" in apriori:
            am = apriori["apriori_map"] or {}
            tf = am.get("tf", {}) or {}
            kw["apriori_tf_yaw_deg"] = float(tf.get("yaw", 0.0))
            kw["apriori_tf"] = (
                float(tf.get("x", 0.0)),
                float(tf.get("y", 0.0)),
                float(tf.get("z", 0.0)),
            )
            sc = am.get("sim_correction", {}) or {}
            corr = (
                float(sc.get("x", 0.0)),
                float(sc.get("y", 0.0)),
                float(sc.get("z", 0.0)),
            )
            kw["apriori_sim_correction"] = corr
        if apriori and "operation_area" in apriori:
            oa = apriori["operation_area"]
            off = (
                float(oa["offset"]["x"]) + corr[0],
                float(oa["offset"]["y"]) + corr[1],
                # ref: vofod_nodelet.cpp:212 — z offset is the bottom in YAML
                float(oa["offset"]["z"]) + float(oa["size"]["z"]) / 2.0 + corr[2],
            )
            size = (float(oa["size"]["x"]), float(oa["size"]["y"]), float(oa["size"]["z"]))
            kw["oparea"] = Box(off, size)
        elif corr != (0.0, 0.0, 0.0):
            # nonzero sim_correction shifts the (default) operation area too
            base = VoFODConfig.__dataclass_fields__["oparea"].default_factory()
            kw["oparea"] = Box(
                tuple(o + c for o, c in zip(base.offset, corr)), base.size
            )
        if sensor and "sensor" in sensor:
            s = sensor["sensor"]
            fov = s.get("vertical_fov_angle", 90.0)
            kw["sensor"] = SensorConfig(
                vertical_rays=int(s.get("vertical_rays", 128)),
                horizontal_rays=int(s.get("horizontal_rays", 1024)),
                vertical_fov=_deg2rad(float(fov)),
            )
        if "separate_cluster_removal_period" in d:
            period = float(d["separate_cluster_removal_period"])
            kw["sepclusters_every"] = max(1, int(round(period * scan_rate_hz)))
        if "sepclusters_every" in d:
            kw["sepclusters_every"] = int(d["sepclusters_every"])
        kw.update(overrides)
        return VoFODConfig(**kw)


# =============================================================================
# Dynamic (traced) parameters — the dynamic_reconfigure analogue
# =============================================================================


@dataclass
class DynParams:
    """Live-tunable parameters, traced into the jitted step as scalars.

    Field names mirror config/dynamic_reconfigure/DetectionParams.cfg:16-44 and
    config/detection_params.yaml.  All fields are floats/bools packed into a
    pytree; changing a value between steps does NOT trigger recompilation.
    """

    # voxel_map scores (detection_params.yaml "voxel_map/scores")
    score_init: float = -740.0
    score_point: float = 0.0
    score_unknown: float = -740.0
    score_ray: float = -1000.0
    # voxel_map thresholds
    thr_apriori: float = 0.0
    thr_sure_obstacles: float = -0.1
    thr_new_obstacles: float = -300.0
    thr_frontiers: float = -750.0
    # classification gates
    cls_min_points: float = 2.0
    cls_max_size: float = 3.0
    cls_max_distance: float = 50.0
    cls_max_explore_distance: float = 3.0
    # raycast
    raycast_pause: bool = False
    raycast_new_update_rule: bool = True
    raycast_max_distance: float = 20.0
    raycast_weight_coefficient: float = 0.003
    raycast_min_intensity: float = 0.0
    # separated background clusters
    sepclusters_pause: bool = False
    sepclusters_min_sure_points: float = 24.0
    # output
    output_position_sigma: float = 0.1
    # live-tunable stencil radii — TRACED ONLY when cfg.dynamic_radii is on
    # (otherwise the static VoFODConfig fields of the same names apply and
    # VoFOD.update_params() rejects changes to these two; the traced pools
    # compile at the cfg *_bound radii and gate taps by r², so changing
    # either between steps does not recompile)
    ground_points_max_distance: float = 1.5
    sepclusters_max_bg_distance: float = 0.8

    def as_arrays(self) -> "DynParams":
        """Cast every field to a 0-d float32 jnp array (bools to bool_)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            is_bool = isinstance(v, (bool, np.bool_)) or (
                hasattr(v, "dtype") and v.dtype == np.bool_
            )
            dtype = jnp.bool_ if is_bool else jnp.float32
            out[f.name] = jnp.asarray(v, dtype=dtype)
        return DynParams(**out)

    @staticmethod
    def from_yaml_dict(
        d: Mapping[str, Any], base: "DynParams | None" = None
    ) -> "DynParams":
        """Extract dynamic params from a detection_params.yaml-shaped dict.

        Keys absent from the dict keep ``base``'s values (default: the
        dataclass defaults) — a partial file overrides only what it names,
        like the reference's per-param dynamic_reconfigure updates."""
        p = base if base is not None else DynParams()
        vm = d.get("voxel_map", {})
        sc = vm.get("scores", {})
        th = vm.get("thresholds", {})
        cl = d.get("classification", {})
        rc = d.get("raycast", {})
        sp = d.get("sepclusters", {})
        out = d.get("output", {})
        mapping = [
            ("score_init", sc, "init"),
            ("score_point", sc, "point"),
            ("score_unknown", sc, "unknown"),
            ("score_ray", sc, "ray"),
            ("thr_apriori", th, "apriori_map"),
            ("thr_sure_obstacles", th, "sure_obstacles"),
            ("thr_new_obstacles", th, "new_obstacles"),
            ("thr_frontiers", th, "frontiers"),
            ("cls_min_points", cl, "min_points"),
            ("cls_max_size", cl, "max_size"),
            ("cls_max_distance", cl, "max_distance"),
            ("cls_max_explore_distance", cl, "max_explore_distance"),
            ("raycast_pause", rc, "pause"),
            ("raycast_new_update_rule", rc, "new_update_rule"),
            ("raycast_max_distance", rc, "max_distance"),
            ("raycast_weight_coefficient", rc, "weight_coefficient"),
            ("raycast_min_intensity", rc, "min_intensity"),
            ("sepclusters_pause", sp, "pause"),
            ("sepclusters_min_sure_points", sp, "min_sure_points"),
            ("output_position_sigma", out, "position_sigma"),
            ("ground_points_max_distance", d, "ground_points_max_distance"),
            ("sepclusters_max_bg_distance", sp, "max_bg_distance"),
        ]
        kw = {}
        for name, src, key in mapping:
            if key in src:
                v = src[key]
                kw[name] = bool(v) if isinstance(v, bool) else float(v)
        return dataclasses.replace(p, **kw)


# register DynParams as a pytree so it traces through jit
import jax.tree_util as jtu  # noqa: E402

_DYN_FIELDS = tuple(f.name for f in dataclasses.fields(DynParams))


def _dyn_flatten(p: DynParams):
    return tuple(getattr(p, n) for n in _DYN_FIELDS), None


def _dyn_unflatten(_, children):
    return DynParams(**dict(zip(_DYN_FIELDS, children)))


jtu.register_pytree_node(DynParams, _dyn_flatten, _dyn_unflatten)


def read_reference_yaml(path: str | None):
    """Parse a reference-format YAML file (the subset of io/yaml_lite.py,
    including the ``!degrees`` tag used by config/sensors/*.yaml).  Returns
    None when path is None."""
    if path is None:
        return None
    from vofod_tpu.io.yaml_lite import load_file

    return load_file(path)


def load_config(
    detection_yaml: str | None = None,
    sensor_yaml: str | None = None,
    apriori_yaml: str | None = None,
    scan_rate_hz: float = 10.0,
    **overrides: Any,
) -> tuple[VoFODConfig, DynParams]:
    """Load (static config, dynamic params) from reference-format YAML files.

    Any file may be omitted, in which case reference-simulation defaults are
    used.  This replaces the reference's mrs_lib::ParamLoader +
    DynamicReconfigureMgr pair (vofod_nodelet.cpp:155-238).
    """
    det = read_reference_yaml(detection_yaml) or {}
    sen = read_reference_yaml(sensor_yaml)
    apr = read_reference_yaml(apriori_yaml)
    cfg = VoFODConfig.from_dicts(det, sen, apr, scan_rate_hz=scan_rate_hz, **overrides)
    dyn = DynParams.from_yaml_dict(det)
    return cfg, dyn
