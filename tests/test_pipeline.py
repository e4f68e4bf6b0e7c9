"""End-to-end: synthetic scene -> scans -> detections on the hovering target.

The analogue of the reference's Gazebo two-UAV acceptance check
(tmux/simulation/session.yml; "you should see... the red sphere is the
detection", README.md:54-58): a ground plane, an apriori map patch to
bootstrap the background (like config/apriori_maps/sim.yaml), and a floating
sphere that must be detected once the freespace raycast has cleared the air
around it.
"""

import dataclasses

import numpy as np
import pytest

from vofod_tpu.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu.runtime.node import NodeOptions, VoFOD


def small_config(**kw):
    return VoFODConfig(
        sensor=SensorConfig(
            vertical_rays=32, horizontal_rays=256, vertical_fov=np.deg2rad(90.0)
        ),
        oparea=Box((0.0, 0.0, 4.0), (40.0, 40.0, 20.0)),
        background_sufficient_points_ratio=0.05,
        max_clusters=8,
        max_queries=128,
        **kw,
    )


@pytest.fixture(scope="module")
def detector_run():
    cfg = small_config()
    node = VoFOD(cfg, DynParams(), NodeOptions(raycast_mode="sweep"))

    # apriori ground patch (config/apriori_maps analogue)
    xs = np.arange(-6.0, 6.0, 0.4)
    gx, gy = np.meshgrid(xs, xs)
    patch = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)
    n_stamped = node.load_apriori_map(patch)
    assert n_stamped > 400

    # Phase 1: warm up the confidence map on the empty scene — the raycast
    # must clear the air below the frontiers threshold before a floating
    # object can be recognized (same physics as the reference: detection
    # requires a warmed-up map; a target parked in unswept air keeps its own
    # shadow in the unknown band and reads as "connected").
    empty = Scene(ground_z=0.0)
    pose = hover_pose((0.0, 0.0, 3.0))
    ranges_empty = render_scan(empty, node.lut, pose)

    # Phase 2: the target flies into the cleared region.
    scene = Scene(ground_z=0.0)
    scene.add_sphere(center=(8.0, 0.0, 5.0), radius=0.5)
    ranges_tgt = render_scan(scene, node.lut, pose)

    msgs = []
    for i in range(25):
        msgs.append(node.process_scan(ranges_empty, None, pose, stamp=i * 0.1))
    for i in range(25, 30):
        msgs.append(node.process_scan(ranges_tgt, None, pose, stamp=i * 0.1))
    return node, msgs


class TestEndToEnd:
    def test_background_becomes_sufficient(self, detector_run):
        node, _ = detector_run
        d = node.last_diag
        assert bool(d.bg_sufficient)
        assert bool(d.sure_bg_sufficient)
        assert int(d.n_bg_voxels) > 500

    def test_sphere_detected(self, detector_run):
        node, msgs = detector_run
        final = msgs[-1]
        assert len(final.detections) == 1
        det = final.detections[0]
        pos = np.array(det.position)
        assert np.linalg.norm(pos - np.array([8.0, 0.0, 5.0])) < 1.0
        assert det.n_points >= 2
        assert 0.0 < det.detection_probability <= 1.0
        assert det.confidence > 0.0

    def test_no_detection_before_clearing(self, detector_run):
        _, msgs = detector_run
        # first scans: air around the sphere not yet cleared below frontiers
        assert len(msgs[0].detections) == 0

    def test_detection_ids_monotonic(self, detector_run):
        _, msgs = detector_run
        ids = [d.id for m in msgs for d in m.detections]
        assert ids == sorted(ids)
        assert len(set(ids)) == len(ids)

    def test_ground_never_detected(self, detector_run):
        _, msgs = detector_run
        for m in msgs:
            for det in m.detections:
                assert det.position[2] > 1.0  # nothing near the ground plane

    def test_status_active(self, detector_run):
        node, _ = detector_run
        s = node.status()
        assert s.detection_active

    def test_snapshot_roundtrip(self, detector_run, tmp_path):
        node, _ = detector_run
        p = str(tmp_path / "state.npz")
        node.save_snapshot(p)
        before = np.asarray(node.state.grid).copy()
        node.reset()
        assert not np.allclose(np.asarray(node.state.grid), before)
        node.load_snapshot(p)
        np.testing.assert_array_equal(np.asarray(node.state.grid), before)


class TestRangefinderBootstrap:
    def test_rangefinder_seeds_background(self):
        """Without an apriori map, the rangefinder fusion must bootstrap the
        background (ref processMsg(Range), vofod_nodelet.cpp:579-613)."""
        cfg = small_config()
        node = VoFOD(cfg, DynParams(), NodeOptions(raycast_mode="off"))
        pose = hover_pose((0.0, 0.0, 3.0))
        v0 = np.asarray(node.state.grid).copy()
        ok = node.process_rangefinder(3.0, 0.2, 30.0, pose @ _down())
        assert ok
        v1 = np.asarray(node.state.grid)
        changed = np.nonzero(v1 != v0)
        assert len(changed[0]) == 1
        z, y, x = changed[0][0], changed[1][0], changed[2][0]
        # the voxel under the UAV moved toward the point score
        assert v1[z, y, x] == pytest.approx((-740.0 + 0.0) / 2.0)

    def test_invalid_range_rejected(self):
        node = VoFOD(small_config(), DynParams(), NodeOptions(raycast_mode="off"))
        pose = hover_pose((0.0, 0.0, 3.0))
        assert not node.process_rangefinder(0.1, 0.2, 30.0, pose @ _down())
        assert not node.process_rangefinder(40.0, 0.2, 30.0, pose @ _down())


def _down():
    """Rotate +x (range axis) to point down (rangefinder convention)."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32).T
    return T


class TestStagedStep:
    def test_staged_equals_fused_and_times_stages(self):
        """StagedStep (profiling mode) composes to exactly the fused step's
        result, and its ProfilingInfo routine events carry real durations."""
        from vofod_tpu.config import Box, SensorConfig, VoFODConfig
        from vofod_tpu.io.msgs import ProfilingInfo

        cfg = VoFODConfig(
            sensor=SensorConfig(
                vertical_rays=8, horizontal_rays=32,
                vertical_fov=np.deg2rad(90.0),
            ),
            oparea=Box((0.0, 0.0, 4.0), (8.0, 8.0, 8.0)),
            max_clusters=4,
            max_far_voxels=128,
            max_queries=32,
            explore_submap=8,
            confidence_submap=8,
        )
        dyn = DynParams()
        fused = VoFOD(cfg, dyn, NodeOptions(raycast_mode="sweep"))
        staged = VoFOD(
            cfg, dyn, NodeOptions(raycast_mode="sweep", profile_stages=True)
        )

        scene = Scene(ground_z=0.0)
        scene.add_sphere(center=(2.0, 1.0, 6.5), radius=0.4)
        pose = hover_pose((0.0, 0.0, 5.0))
        ranges = render_scan(scene, fused.lut, pose)
        for i in range(4):
            m_f = fused.process_scan(ranges, None, pose, stamp=i * 0.1)
            m_s = staged.process_scan(ranges, None, pose, stamp=i * 0.1)
            assert len(m_f.detections) == len(m_s.detections)
        np.testing.assert_array_equal(
            np.asarray(fused.state.grid), np.asarray(staged.state.grid)
        )
        assert int(fused.state.step) == int(staged.state.step)

        # the staged node emitted one START/END pair per routine per scan,
        # with nonzero durations for all three routines
        evs = staged.profiling.events
        for rid in (
            ProfilingInfo.ROUTINE_CNC,
            ProfilingInfo.ROUTINE_RAYCASTING,
            ProfilingInfo.ROUTINE_SEPBGCLUSTERS,
        ):
            starts = [e for e in evs
                      if e.routine_id == rid
                      and e.event_type == ProfilingInfo.EVENT_START]
            ends = [e for e in evs
                    if e.routine_id == rid
                    and e.event_type == ProfilingInfo.EVENT_END]
            assert len(starts) == len(ends) == 4
            durs = [b.stamp - a.stamp for a, b in zip(starts, ends)]
            assert all(d > 0 for d in durs)
