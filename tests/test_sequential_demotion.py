"""The sequential-demotion coupling, pinned by test (round-3 verdict missing
#3).

The reference explores a cluster's members ONE AT A TIME and demotes a failed
member's explored frontier immediately, visible to every later query in the
same scan (vofod_nodelet.cpp:1692-1718, voxel_map.cpp:402-488).  The
production step evaluates all queries independently in one batched BFS
(DESIGN.md §4).  This file:

1. constructs the adversarial scene where that difference flips a verdict —
   a failed first member whose demotions block a later member's only escape
   path — and asserts the production mode diverges from the oracle exactly
   as documented (the deviation is real, measured, and bounded to this
   coupling);
2. asserts the new ``cfg.sequential_explore`` parity instrument
   (pipeline/classify.py) reproduces the oracle bit-for-bit on that scene,
   demotions included;
3. replays the standard 52-scan parity scenario with sequential_explore on,
   asserting detection-level agreement still holds through the full
   pipeline.

Scene geometry (one z-layer; relative (x, y) cells carved as traversable
unknown in a solid wall of ray-carved voxels; manhattan budget m = 8, so a
query connects by popping a traversable cell at manhattan distance exactly
7 from its start — voxel_map.cpp:402-488 semantics):

      y=5  E .              A = member (0,0)   (explored first: smaller id)
      y=4  E C .            B = member (2,0)
      y=3  . C .            C/E = corridor to B's escape cell E=(0,5)
      y=2  . C C
      y=1  . . C            manh_A <= 5 everywhere  -> A FAILS, demotes all
      y=0  A . B            manh_B(E) = 7           -> B alone would connect

A's failed explore reaches every carved cell (max manh_A = 5 < 7, fully
walled) and demotes them all — including B's start and corridor — so the
oracle's B explores nothing and fails: cluster floating (mav).  The
independent batched explore lets B see the pre-demotion grid and connect:
cluster grounded (unknown).  One coupled demotion, one flipped verdict.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from tests.ref_pipeline import RefPipeline
from vofod_tpu.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu.geometry import GridSpec
from vofod_tpu.ops.components import SENTINEL
from vofod_tpu.pipeline.classify import CLS_MAV, CLS_UNKNOWN, classify
from vofod_tpu.sensor import make_lut

# relative carved cells (x, y): A, gap, B, then B's corridor to E
CARVED = [
    (0, 0), (1, 0), (2, 0),          # A, corridor, B
    (2, 1), (2, 2), (1, 2), (1, 3),  # winding corridor (avoids manh_A == 7
    (1, 4), (0, 4), (0, 5),          #   cells entirely; ends at E=(0,5))
]
A_REL, B_REL = (0, 0), (2, 0)
BASE = (5, 4, 8)  # (x, y, z) of the relative origin, safely interior


def scene_config():
    return VoFODConfig(
        sensor=SensorConfig(
            vertical_rays=8, horizontal_rays=32, vertical_fov=np.deg2rad(90.0)
        ),
        oparea=Box((0.0, 0.0, 4.0), (8.0, 8.0, 8.0)),
        max_clusters=4,
        max_far_voxels=64,
        max_queries=8,
        explore_submap=20,  # covers the 2*8+1 manhattan ball
        confidence_submap=8,
    )


def scene_dyn():
    # cls_max_explore_distance tuned so m = floor((obb 1.0 + 3.2)/0.5) = 8
    return DynParams(cls_max_explore_distance=3.2)


def build_scene(cfg, dyn):
    """(vals, far, labels, members, sensor_pos): solid ray-carved walls with
    the CARVED cells as traversable unknown; A and B are the far-cluster
    members (one cluster — their index distance 2 is within the clustering
    radius 3)."""
    nz, ny, nx = cfg.grid_shape
    vals = np.full((nz, ny, nx), np.float32(dyn.score_ray), np.float32)
    bx, by, bz = BASE
    for x, y in CARVED:
        vals[bz, by + y, bx + x] = np.float32(dyn.score_unknown)
    far = np.zeros((nz, ny, nx), bool)
    labels = np.full((nz, ny, nx), SENTINEL, np.int32)
    members = []
    for x, y in (A_REL, B_REL):
        far[bz, by + y, bx + x] = True
        members.append((bz * ny + (by + y)) * nx + (bx + x))
    label = min(members)
    for x, y in (A_REL, B_REL):
        labels[bz, by + y, bx + x] = label
    # sensor near the cluster (inside cls_max_distance)
    g = GridSpec.from_config(cfg)
    sensor_pos = np.asarray(
        g.idx_to_coord(
            jnp.int32(bx + 4), jnp.int32(by + 2), jnp.int32(bz + 2)
        ),
        np.float32,
    )
    return vals, far, labels, sorted(members), sensor_pos


def oracle_classify(cfg, dyn, vals, members, sensor_pos):
    """Drive the oracle's classify_cluster stage directly (sequential
    explore + live demotion, ref :1692-1718) on a hand-authored grid."""
    lut = make_lut(cfg.sensor)
    ref = RefPipeline(cfg, dyn, lut)
    ref.vmap = vals.copy()
    ref.bg_sufficient = True
    ref.sure_bg_sufficient = True
    dets, clusters = ref._classify_and_detect([members], [False], sensor_pos)
    return dets, clusters, ref.vmap


def step_classify(cfg, dyn, vals, far, labels, sensor_pos):
    g = GridSpec.from_config(cfg)
    out = classify(
        cfg,
        dyn.as_arrays(),
        g,
        jnp.asarray(vals),
        jnp.asarray(far),
        jnp.asarray(labels),
        jnp.bool_(True),
        jnp.asarray(sensor_pos),
        jnp.bool_(True),
        jnp.bool_(True),
    )
    k = int(np.argmax(np.asarray(out.cluster_valid)))
    assert bool(out.cluster_valid[k])
    return int(out.cluster_class[k]), np.asarray(out.grid)


class TestAdversarialScene:
    def test_oracle_couples_demotions(self):
        """Ground truth for the scene: the oracle (reference semantics) calls
        the cluster FLOATING because A's failed explore demoted B's escape
        path; without the coupling B would connect (verified by exploring B
        alone on the pristine grid)."""
        cfg, dyn = scene_config(), scene_dyn()
        vals, far, labels, members, sensor_pos = build_scene(cfg, dyn)
        _, clusters, vmap_after = oracle_classify(
            cfg, dyn, vals, members, sensor_pos
        )
        assert [c["cclass"] for c in clusters] == ["mav"]
        # every carved cell was demoted to thr_frontiers by A's failure
        bx, by, bz = BASE
        for x, y in CARVED:
            assert vmap_after[bz, by + y, bx + x] == np.float32(
                dyn.thr_frontiers
            ), (x, y)

        # B alone on the PRISTINE grid connects (escape at manh 7): the
        # scene isolates the coupling, not a geometry artifact
        from tests.oracles import explore_to_ground_np

        connected, _ = explore_to_ground_np(
            vals, (bx + B_REL[0], by + B_REL[1], bz),
            dyn.thr_frontiers, dyn.thr_new_obstacles, 8,
        )
        assert connected, "B must connect on the pristine grid"
        connected_a, _ = explore_to_ground_np(
            vals, (bx + A_REL[0], by + A_REL[1], bz),
            dyn.thr_frontiers, dyn.thr_new_obstacles, 8,
        )
        assert not connected_a, "A must fail on the pristine grid"

    def test_production_mode_diverges_as_documented(self):
        """The production (independent, batched) explore reaches the OPPOSITE
        verdict on this scene — the DESIGN.md §9 deviation, constructed and
        measured rather than asserted by argument."""
        cfg, dyn = scene_config(), scene_dyn()
        vals, far, labels, members, sensor_pos = build_scene(cfg, dyn)
        cls, grid_after = step_classify(cfg, dyn, vals, far, labels, sensor_pos)
        assert cls == CLS_UNKNOWN  # B connected independently -> grounded
        # and the non-floating cluster demotes nothing in production mode
        np.testing.assert_array_equal(grid_after, vals)

    def test_sequential_mode_matches_oracle_bit_for_bit(self):
        """cfg.sequential_explore reproduces the reference's coupled verdict
        AND the demoted grid exactly."""
        cfg = dataclasses.replace(scene_config(), sequential_explore=True)
        dyn = scene_dyn()
        vals, far, labels, members, sensor_pos = build_scene(cfg, dyn)
        _, clusters, vmap_oracle = oracle_classify(
            cfg, dyn, vals, members, sensor_pos
        )
        cls, grid_after = step_classify(cfg, dyn, vals, far, labels, sensor_pos)
        assert cls == CLS_MAV
        assert [c["cclass"] for c in clusters] == ["mav"]
        np.testing.assert_array_equal(grid_after, vmap_oracle)


class TestSequentialWholePipeline:
    """The parity instrument composes through the full step: the standard
    52-scan parity scenario in exact modes + sequential_explore agrees with
    the oracle at the detection level (same contract as
    test_pipeline_parity.TestExactModeParity)."""

    def test_detections_match(self):
        from tests.test_pipeline_parity import (
            make_scenario,
            parity_config,
            parity_dyn,
            run_step,
        )

        cfg = parity_config(
            sepclusters_exact_census=True,
            compat_hascloseto_bounds=True,
            sequential_explore=True,
        )
        lut, scans = make_scenario(cfg)
        ref = RefPipeline(cfg, parity_dyn(), lut)
        ref.vmap[1, :, :] = np.inf
        oracle_out = [ref.step(r, i, p) for r, i, p in scans]
        step_out, state = run_step(cfg, lut, scans, "exact")

        n_det = sum(1 for d, _ in oracle_out if d)
        assert n_det >= 10
        for i, ((odets, _), (tdets, _)) in enumerate(
            zip(oracle_out, step_out)
        ):
            assert len(tdets) == len(odets), f"scan {i}"
            osort = sorted(odets, key=lambda d: tuple(d["position"]))
            tsort = sorted(tdets, key=lambda d: tuple(d["position"]))
            for od, td in zip(osort, tsort):
                np.testing.assert_allclose(
                    td["position"], od["position"], atol=1e-3,
                    err_msg=f"scan {i}",
                )
                assert td["n_points"] == od["n_points"], f"scan {i}"
                assert td["id"] == od["id"], f"scan {i}"
                np.testing.assert_allclose(
                    td["confidence"], od["confidence"], rtol=2e-3,
                    err_msg=f"scan {i}",
                )

        # with the coupling reproduced, the demotion fringes disappear from
        # the grid divergence: what remains is f32-vs-f64 raycast chords
        g = np.asarray(state.grid)
        assert np.array_equal(np.isinf(g), np.isinf(ref.vmap))
        both_inf = np.isinf(g) & np.isinf(ref.vmap)
        with np.errstate(invalid="ignore"):
            diff = np.abs(np.where(both_inf, 0.0, g - ref.vmap))
        print(
            f"sequential-explore grid divergence: max {float(np.max(diff)):.3f}"
            f" mean {float(np.mean(diff)):.5f}"
        )
        # measured max 0.001 / mean 5e-5 (vs the independent-explore budget
        # of 15.0 / 0.05): the demotion fringes WERE the whole gap
        assert float(np.max(diff)) <= 0.1
        assert float(np.mean(diff)) <= 0.001
