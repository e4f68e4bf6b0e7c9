"""Whole-pipeline parity with the detection's confidence submap CLAMPED at
the grid border.

The reference's confidence submap is ``getSubmapCopy`` of the AABB inflated
by 2 voxels and CLAMPED to the grid (voxel_map.cpp:547-571; extractDetections
vofod_nodelet.cpp:851-867): a cluster near the operation area's top scores
its confidence over a SMALLER box than an interior cluster.  Every other
parity scenario keeps its targets deep interior, so the clamp branch
(fixed-window absolute-index masking in pipeline/detect.py + padded
dynamic_slice in gridops.submaps3) was previously untested at detection
level.

Construction notes (what bounds the geometry):

* a cluster cannot touch the hi-side grid shell through scan points at all —
  the operation-area crop keeps points <= oparea.hi while the shell row
  starts at ``lo + 0.5*ceil(2*size)`` >= oparea.hi (VoxelMap::resize rounds
  the grid UP, voxel_map.cpp:11-19) — and a shell-touching query would
  ground the cluster anyway (exploreToGround voxel_map.cpp:408-412; kernel
  coverage in tests/test_explore.py);
* the clamp regime is therefore hi_idx ∈ {nz-3, nz-2}: detectable, with the
  +2 inflation crossing nz-1.  We reuse the proven interior scenario and
  shrink the operation-area height so the target's top hit rows sit exactly
  there (measured: the sphere's visible rim bins into z rows ~17-18 of this
  lattice, so nz=20 clamps roughly half the detecting scans).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.ref_pipeline import RefPipeline
from tests.test_pipeline_parity import (
    make_scenario,
    parity_config,
    parity_dyn,
    run_step,
)
from vofod_tpu.config import Box
from vofod_tpu.parallel.grid_step import (
    make_grid_mesh,
    make_grid_sharded_step,
    shard_state,
)
from vofod_tpu.pipeline.state import ScanInput, init_state
from vofod_tpu.sensor import make_lut


@pytest.fixture(scope="module")
def border_runs():
    # z ∈ [0, 9.5] -> nz = 20 (ceil(9.5/0.5)+1): ground plane stays at row 1
    # like the main scenario; the target (center z 9.0, r 0.7, rim hits up
    # to ~9.4) tops out at row 18 = nz-2 -> the +2 inflation clamps
    cfg = parity_config(
        oparea=Box((0.0, 0.0, 4.75), (16.0, 16.0, 9.5)),
        sepclusters_exact_census=True,
        compat_hascloseto_bounds=True,
    )
    lut, scans = make_scenario(cfg)

    ref = RefPipeline(cfg, parity_dyn(), lut)
    ref.vmap[1, :, :] = np.inf  # apriori ground row (ref :339-341)
    oracle_out = [ref.step(r, inten, p) for r, inten, p in scans]

    step_out, step_state = run_step(cfg, lut, scans, raycast_mode="exact")
    return cfg, lut, scans, oracle_out, step_out, step_state


class TestBorderClusterParity:
    def test_clamp_actually_engages(self, border_runs):
        """Non-vacuity: the scenario must produce detections whose inflated
        AABB clamps at the grid's z-hi border (hi_idx + 2 > nz - 1)."""
        cfg, _, _, oracle_out, _, _ = border_runs
        nz = cfg.grid_shape[0]
        origin = np.array(cfg.grid_origin)
        det_scans = [d for d, _ in oracle_out if d]
        assert len(det_scans) >= 3, (
            f"only {len(det_scans)} detecting scans — scenario too marginal"
        )
        n_clamped = 0
        for dets in det_scans:
            for d in dets:
                hi_z = int(
                    np.floor((d["aabb_max"][2] - origin[2]) / cfg.voxel_size)
                )
                n_clamped += hi_z + 2 > nz - 1
        assert n_clamped >= 3, (
            f"only {n_clamped} clamped detections — scenario too marginal"
        )

    def test_detections_match(self, border_runs):
        _, _, _, oracle_out, step_out, _ = border_runs
        for i, ((odets, _), (tdets, _)) in enumerate(
            zip(oracle_out, step_out)
        ):
            assert len(tdets) == len(odets), (
                f"scan {i}: {len(tdets)} detections vs oracle {len(odets)}"
            )
            osort = sorted(odets, key=lambda d: tuple(d["position"]))
            tsort = sorted(tdets, key=lambda d: tuple(d["position"]))
            for od, td in zip(osort, tsort):
                np.testing.assert_allclose(
                    td["position"], od["position"], atol=1e-3,
                    err_msg=f"scan {i}: detection position",
                )
                assert td["n_points"] == od["n_points"], f"scan {i}"
                assert td["id"] == od["id"], f"scan {i}"
                # the clamped-submap uncertainty sum is exactly what this
                # scenario exists to pin
                np.testing.assert_allclose(
                    td["confidence"], od["confidence"], rtol=2e-3,
                    err_msg=f"scan {i}: confidence (clamped submap)",
                )
                np.testing.assert_allclose(
                    td["detection_probability"],
                    od["detection_probability"],
                    rtol=1e-4,
                )

    def test_sharded_step_matches_dense(self, border_runs):
        """The clamp branch composes with grid sharding: the same scenario
        through the Z-sharded exact step (4-way mesh, nz=20 -> shard height
        5) must agree with the dense run — detections per scan (ids/
        n_points equal, floats to the last-ulp fusion budget of
        test_grid_step) and the final grid bit-for-bit.  This drives
        ZShardOps.submaps3's padded dynamic_slice with a window crossing
        the GLOBAL z edge on the last shard, which no interior scenario
        reaches."""
        cfg, lut, scans, _, step_out, step_state = border_runs
        mesh = make_grid_mesh(4)
        dyn = parity_dyn()
        sh_step = make_grid_sharded_step(cfg, lut, mesh, raycast_mode="exact")
        state = init_state(cfg, dyn)
        state = state._replace(grid=state.grid.at[1, :, :].set(jnp.inf))
        state = shard_state(state, mesh)
        dyn = dyn.as_arrays()
        for i, (ranges, inten, pose) in enumerate(scans):
            scan = ScanInput(
                ranges_mm=jnp.asarray(ranges.astype(np.float32)),
                intensity=jnp.asarray(inten),
                pose=jnp.asarray(pose),
            )
            state, out = sh_step(state, scan, dyn)
            sdets = [
                dict(
                    id=int(out.detections.id[k]),
                    position=np.asarray(out.detections.position[k]),
                    n_points=int(out.detections.n_points[k]),
                    confidence=float(out.detections.confidence[k]),
                )
                for k in range(cfg.max_clusters)
                if bool(out.detections.valid[k])
            ]
            ddets, _ = step_out[i]
            assert len(sdets) == len(ddets), (
                f"scan {i}: sharded {len(sdets)} detections vs dense "
                f"{len(ddets)}"
            )
            ssort = sorted(sdets, key=lambda d: tuple(d["position"]))
            dsort = sorted(ddets, key=lambda d: tuple(d["position"]))
            for sd, dd in zip(ssort, dsort):
                assert sd["id"] == dd["id"], f"scan {i}"
                assert sd["n_points"] == dd["n_points"], f"scan {i}"
                np.testing.assert_allclose(
                    sd["position"], dd["position"], rtol=1e-5, atol=1e-7,
                    err_msg=f"scan {i}: sharded position",
                )
                # the clamped submap sum is the branch under test
                np.testing.assert_allclose(
                    sd["confidence"], dd["confidence"], rtol=1e-5,
                    err_msg=f"scan {i}: sharded clamped confidence",
                )
        np.testing.assert_array_equal(
            np.asarray(state.grid), np.asarray(step_state.grid),
            err_msg="final grid diverged between sharded and dense",
        )
