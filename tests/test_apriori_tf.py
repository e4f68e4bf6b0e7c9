"""Apriori-map placement: ``apriori_map/tf`` + ``sim_correction``.

The reference composes the apriori-cloud transform as Eigen
``tf.rotate(R_yaw); tf.translate(t + sim_correction)`` — both
right-multiplications, so the map transform is ``M = R * T`` and
``p' = R_yaw @ (p + t + sim_correction)`` (vofod_nodelet.cpp:213-226,
applied at :319-344 via pcl::transformPointCloud).  The operation area
itself also shifts by ``sim_correction`` (:219-222).  Pinned here:

* ``VoFODConfig.from_dicts`` parses ``apriori_map/tf/{x,y,z,yaw}`` and
  ``apriori_map/sim_correction`` and shifts the operation-area offset
  (including the z-bottom-to-center convention of :212);
* ``VoFOD.load_apriori_map`` / ``FleetVoFOD.load_apriori_map`` stamp the
  transformed cloud — voxel-for-voxel equal to an independent NumPy
  evaluation of the reference formula;
* a whole-pipeline parity variant: detections over a TRANSFORMED apriori
  map (stamped through the node's cfg-driven path) agree scan-for-scan
  with the oracle whose map is stamped by the independent formula.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from vofod_tpu.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu.pipeline.state import ScanInput
from vofod_tpu.pipeline.step import make_step_fn
from vofod_tpu.runtime.node import NodeOptions, VoFOD
from vofod_tpu.sensor import make_lut


def ref_transform(pts, yaw_deg, t, corr):
    """The reference formula, written independently of the implementation:
    Eigen ``rotate`` then ``translate`` right-multiply (M = R * T), so
    ``p' = R_yaw @ (p + t + corr)`` (vofod_nodelet.cpp:224-225)."""
    th = math.radians(yaw_deg)
    c, s = math.cos(th), math.sin(th)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float64)
    return (np.asarray(pts, np.float64) + np.asarray(t) + np.asarray(corr)) @ R.T


def inv_transform(world_pts, yaw_deg, t, corr):
    """Source-frame points whose ref_transform lands on ``world_pts``."""
    th = math.radians(yaw_deg)
    c, s = math.cos(th), math.sin(th)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float64)
    return np.asarray(world_pts, np.float64) @ R - np.asarray(t) - np.asarray(corr)


def stamp_oracle(cfg, pts):
    """Voxel mask the reference would stamp +inf: transform by the config's
    tf (independent formula), floor-bin, bounds-filter (:339-341)."""
    w = ref_transform(
        pts, cfg.apriori_tf_yaw_deg, cfg.apriori_tf, cfg.apriori_sim_correction
    ).astype(np.float32)
    origin = np.asarray(cfg.grid_origin, np.float32)
    idx = np.floor((w - origin) / np.float32(cfg.voxel_size)).astype(np.int64)
    nz, ny, nx = cfg.grid_shape
    ok = np.all((idx >= 0) & (idx < [nx, ny, nz]), axis=-1)
    idx = idx[ok]
    mask = np.zeros((nz, ny, nx), bool)
    mask[idx[:, 2], idx[:, 1], idx[:, 0]] = True
    return mask


TF = dict(
    apriori_tf_yaw_deg=40.0,
    apriori_tf=(1.5, -2.0, 0.25),
    apriori_sim_correction=(0.5, 0.75, -0.25),
)


def small_cfg(**kw):
    d = dict(
        sensor=SensorConfig(
            vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0)
        ),
        oparea=Box((0.0, 0.0, 5.75), (16.0, 16.0, 11.5)),
        background_sufficient_points_ratio=0.05,
        max_clusters=8,
        max_far_voxels=512,
        max_queries=64,
        explore_submap=16,
        confidence_submap=8,
    )
    d.update(kw)
    return VoFODConfig(**d)


class TestConfigParsing:
    def test_tf_and_sim_correction_parsed(self):
        apriori = {
            "apriori_map": {
                "tf": {"x": 1.5, "y": -2.0, "z": 0.25, "yaw": 30.0},
                "sim_correction": {"x": 0.5, "y": 0.75, "z": -0.25},
            },
            "operation_area": {
                "offset": {"x": 10.0, "y": 20.0, "z": 5.0},
                "size": {"x": 16.0, "y": 16.0, "z": 8.0},
            },
        }
        cfg = VoFODConfig.from_dicts({}, None, apriori)
        assert cfg.apriori_tf_yaw_deg == 30.0
        assert cfg.apriori_tf == (1.5, -2.0, 0.25)
        assert cfg.apriori_sim_correction == (0.5, 0.75, -0.25)
        # ref: z offset is the bottom, +size/2 to center (:212), then the
        # whole offset shifts by sim_correction (:219-222)
        np.testing.assert_allclose(
            cfg.oparea.offset, (10.5, 20.75, 5.0 + 4.0 - 0.25)
        )
        assert cfg.oparea.size == (16.0, 16.0, 8.0)

    def test_absent_fields_default_identity(self):
        cfg = VoFODConfig.from_dicts({}, None, {"apriori_map": {}})
        assert cfg.apriori_tf_yaw_deg == 0.0
        assert cfg.apriori_tf == (0.0, 0.0, 0.0)
        assert cfg.apriori_sim_correction == (0.0, 0.0, 0.0)

    def test_sim_correction_shifts_default_oparea(self):
        # no operation_area in the YAML: sim_correction still shifts the
        # default box exactly like the reference shifts its loaded offsets
        base = VoFODConfig()
        cfg = VoFODConfig.from_dicts(
            {}, None,
            {"apriori_map": {"sim_correction": {"x": 2.0, "y": -1.0, "z": 0.5}}},
        )
        np.testing.assert_allclose(
            cfg.oparea.offset,
            np.asarray(base.oparea.offset) + [2.0, -1.0, 0.5],
        )
        assert cfg.oparea.size == base.oparea.size


class TestStampTransform:
    def test_node_stamp_matches_reference_formula(self):
        cfg = small_cfg(**TF)
        rng = np.random.default_rng(3)
        # desired world points inside the grid, inverted into the source frame
        lo = np.asarray(cfg.oparea.lo) + 0.3
        hi = np.asarray(cfg.oparea.hi) - 0.3
        world = rng.uniform(lo, hi, size=(400, 3))
        cloud = inv_transform(
            world, cfg.apriori_tf_yaw_deg, cfg.apriori_tf,
            cfg.apriori_sim_correction,
        ).astype(np.float32)

        node = VoFOD(cfg, DynParams(), NodeOptions(raycast_mode="exact"))
        n = node.load_apriori_map(cloud)  # cfg-driven tf defaults
        expected = stamp_oracle(cfg, cloud)
        assert n == 400  # every world point was drawn inside the grid
        got = np.isinf(np.asarray(node.state.grid))
        np.testing.assert_array_equal(got, expected)

    def test_explicit_args_override_config(self):
        cfg = small_cfg(**TF)
        node = VoFOD(cfg, DynParams(), NodeOptions(raycast_mode="exact"))
        # explicit identity overrides the config tf
        pts = np.array([[4.0, 4.0, 3.0], [6.0, 2.0, 4.0]], np.float32)
        node.load_apriori_map(pts, yaw_deg=0.0, translation=(0.0, 0.0, 0.0))
        idcfg = small_cfg()  # identity-tf config for the oracle
        expected = stamp_oracle(idcfg, pts)
        np.testing.assert_array_equal(
            np.isinf(np.asarray(node.state.grid)), expected
        )

    @pytest.mark.slow  # 8-device shard_map compile
    def test_fleet_stamp_matches_reference_formula(self):
        from vofod_tpu.runtime.fleet import FleetVoFOD

        cfg = small_cfg(**TF)
        rng = np.random.default_rng(5)
        lo = np.asarray(cfg.oparea.lo) + 0.3
        hi = np.asarray(cfg.oparea.hi) - 0.3
        world = rng.uniform(lo, hi, size=(200, 3))
        cloud = inv_transform(
            world, cfg.apriori_tf_yaw_deg, cfg.apriori_tf,
            cfg.apriori_sim_correction,
        ).astype(np.float32)
        fleet = FleetVoFOD(cfg, DynParams(), n_streams=8)
        fleet.load_apriori_map(cloud, stream=3)
        expected = stamp_oracle(cfg, cloud)
        grids = np.asarray(fleet.state.grid)
        np.testing.assert_array_equal(np.isinf(grids[3]), expected)
        assert not np.isinf(np.delete(grids, 3, axis=0)).any()


@pytest.mark.slow  # whole-pipeline oracle replay + exact-mode step compile
class TestTransformedAprioriParity:
    """Detections over a transformed apriori map: the node's cfg-driven
    stamp path vs the oracle stamped by the independent reference formula,
    then scan-for-scan exact-mode detection parity."""

    N_WARM, N_TGT = 10, 12

    @pytest.fixture(scope="class")
    def setup(self):
        cfg = small_cfg(
            sepclusters_exact_census=True, compat_hascloseto_bounds=True,
            max_clusters=16, max_far_voxels=1024, max_queries=128,
            explore_submap=32, confidence_submap=16, sepclusters_every=3,
            **TF,
        )
        lut = make_lut(cfg.sensor)
        # apriori map = every voxel center of grid row z=1 (the ground band
        # the scans also see), expressed in the SOURCE frame
        nz, ny, nx = cfg.grid_shape
        origin = np.asarray(cfg.grid_origin, np.float64)
        xs, ys = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
        centers = np.stack(
            [
                origin[0] + (xs.ravel() + 0.5) * cfg.voxel_size,
                origin[1] + (ys.ravel() + 0.5) * cfg.voxel_size,
                np.full(xs.size, origin[2] + 1.5 * cfg.voxel_size),
            ],
            axis=-1,
        )
        cloud = inv_transform(
            centers, cfg.apriori_tf_yaw_deg, cfg.apriori_tf,
            cfg.apriori_sim_correction,
        ).astype(np.float32)

        scans = []
        for i in range(self.N_WARM + self.N_TGT):
            th = 0.15 * i
            pose = hover_pose(
                (1.5 * math.cos(th), 1.5 * math.sin(th), 7.0), yaw=0.1 * i
            )
            scene = Scene(ground_z=0.5)
            if i >= self.N_WARM:
                t = i - self.N_WARM
                scene.add_sphere(
                    center=(4.0 - 0.08 * t, 0.3 * math.sin(0.4 * t), 9.0),
                    radius=0.7,
                )
            ranges = render_scan(scene, lut, pose)
            scans.append((ranges, np.ones(ranges.size, np.float32), pose))
        return cfg, lut, cloud, scans

    @pytest.fixture(scope="class")
    def runs(self, setup):
        from tests.ref_pipeline import RefPipeline

        cfg, lut, cloud, scans = setup
        dyn = DynParams(raycast_weight_coefficient=0.5)

        ref = RefPipeline(cfg, dyn, lut)
        ref.vmap[stamp_oracle(cfg, cloud)] = np.inf

        node = VoFOD(cfg, dyn, NodeOptions(raycast_mode="exact"))
        node.load_apriori_map(cloud)
        # both sides start from the identical stamped map
        np.testing.assert_array_equal(
            np.isinf(np.asarray(node.state.grid)), np.isinf(ref.vmap)
        )
        step = make_step_fn(cfg, lut, raycast_mode="exact", donate=False)
        state, dyn_arr = node.state, dyn.as_arrays()
        oracle_out, step_out = [], []
        for ranges, inten, pose in scans:
            oracle_out.append(ref.step(ranges, inten, pose))
            state, out = step(
                state,
                ScanInput(
                    ranges_mm=jnp.asarray(ranges.astype(np.float32)),
                    intensity=jnp.asarray(inten),
                    pose=jnp.asarray(pose),
                ),
                dyn_arr,
            )
            step_out.append(out)
        return oracle_out, step_out

    def test_detections_match(self, setup, runs):
        cfg = setup[0]
        oracle_out, step_out = runs
        n_det_scans = 0
        for i, ((odets, _), out) in enumerate(zip(oracle_out, step_out)):
            tdets = [
                dict(
                    position=np.asarray(out.detections.position[k]),
                    n_points=int(out.detections.n_points[k]),
                    id=int(out.detections.id[k]),
                )
                for k in range(cfg.max_clusters)
                if bool(out.detections.valid[k])
            ]
            assert len(tdets) == len(odets), f"scan {i}"
            n_det_scans += bool(tdets)
            osort = sorted(odets, key=lambda d: tuple(d["position"]))
            tsort = sorted(tdets, key=lambda d: tuple(d["position"]))
            for od, td in zip(osort, tsort):
                np.testing.assert_allclose(
                    td["position"], od["position"], atol=1e-3,
                    err_msg=f"scan {i}",
                )
                assert td["n_points"] == od["n_points"], f"scan {i}"
                assert td["id"] == od["id"], f"scan {i}"
        assert n_det_scans >= 5  # the target was actually tracked
