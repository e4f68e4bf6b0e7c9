"""Multi-object end-to-end parity: JAX exact modes vs the NumPy oracle.

Extends tests/test_pipeline_parity.py's single-target scenario with the
multi-cluster cases the reference handles in one scan (processMsg clusters
EVERY far component per scan, vofod_nodelet.cpp:932-963):

* TWO simultaneously-flying targets — exercises multi-slot labeling, distinct
  monotonic detection ids (ref :845) and per-cluster confidence submaps in
  the same step;
* an object RESTING ON a background structure — its cluster has background
  voxels within ground_points_max_distance, so findCloseFarClusters must
  file it as close (ref :703-750): it is EMA'd into the map as background
  and must never produce a detection in either implementation.

Scenario and config geometry match test_pipeline_parity (same compiled step
signature, so the in-process step cache dedupes the jit when the suite runs
both modules).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from tests.ref_pipeline import RefPipeline
from tests.test_pipeline_parity import parity_config, parity_dyn, run_step
from vofod_tpu.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu.sensor import make_lut

N_WARMUP = 20
N_TARGET = 32
REST_START = 6  # target phase scan when the resting sphere appears

A_R, B_R, C_R = 0.7, 0.8, 0.7


def target_positions(t: int):
    """Centers of the two flying targets (A, B) at target-phase scan t."""
    a = (4.0 - 0.05 * t, 0.3 * math.sin(0.4 * t), 9.0)
    b = (-3.5 + 0.04 * t, 2.5, 9.2 - 0.02 * t)
    return a, b


C_CENTER = (6.5, -5.5, 2.55)  # resting on the structure top (box top z=2.0)


def make_scenario(cfg):
    lut = make_lut(cfg.sensor)
    scans = []
    for i in range(N_WARMUP + N_TARGET):
        th = 0.15 * i
        pose = hover_pose(
            (1.5 * math.cos(th), 1.5 * math.sin(th), 7.0), yaw=0.1 * i
        )
        scene = Scene(ground_z=0.5)
        scene.add_box((5.5, -6.5, 0.0), (7.5, -4.5, 2.0))  # static structure
        if i >= N_WARMUP:
            t = i - N_WARMUP
            a, b = target_positions(t)
            scene.add_sphere(center=a, radius=A_R)
            scene.add_sphere(center=b, radius=B_R)
            if t >= REST_START:
                # bottom (z=1.85) overlaps the box top: contiguous with
                # background => close cluster, never classified
                scene.add_sphere(center=C_CENTER, radius=C_R)
        ranges = render_scan(scene, lut, pose)
        scans.append((ranges, np.ones(ranges.size, np.float32), pose))
    return lut, scans


@pytest.fixture(scope="module")
def scenario():
    cfg = parity_config()
    lut, scans = make_scenario(cfg)
    return cfg, lut, scans


@pytest.fixture(scope="module")
def oracle_run(scenario):
    cfg, lut, scans = scenario
    cfg_o = parity_config(
        sepclusters_exact_census=True, compat_hascloseto_bounds=True
    )
    ref = RefPipeline(cfg_o, parity_dyn(), lut)
    ref.vmap[1, :, :] = np.inf  # apriori ground plane (ref :339-341)
    out = [ref.step(r, inten, pose) for r, inten, pose in scans]
    return out, ref


@pytest.fixture(scope="module")
def step_run(scenario):
    cfg, lut, scans = scenario
    cfg_t = parity_config(
        sepclusters_exact_census=True, compat_hascloseto_bounds=True
    )
    return run_step(cfg_t, lut, scans, raycast_mode="exact")


def test_detections_match(oracle_run, step_run):
    oracle_out, _ = oracle_run
    step_out, _ = step_run
    for i, ((odets, _), (tdets, _)) in enumerate(zip(oracle_out, step_out)):
        assert len(tdets) == len(odets), (
            f"scan {i}: {len(tdets)} detections vs oracle {len(odets)}"
        )
        # ids are minted from the same monotonic counter in both, but the
        # WITHIN-scan assignment order is implementation-defined when two
        # detections first appear in one scan (the reference's order follows
        # PCL's extraction order, itself input-order-dependent; the JAX slots
        # order by label) — so ids must match as a per-scan set, while
        # per-detection fields pair by position.
        assert sorted(d["id"] for d in tdets) == sorted(
            d["id"] for d in odets
        ), f"scan {i}: id sets differ"
        osort = sorted(odets, key=lambda d: tuple(d["position"]))
        tsort = sorted(tdets, key=lambda d: tuple(d["position"]))
        for od, td in zip(osort, tsort):
            np.testing.assert_allclose(
                td["position"], od["position"], atol=1e-3,
                err_msg=f"scan {i}: detection position",
            )
            assert td["n_points"] == od["n_points"], f"scan {i}"
            np.testing.assert_allclose(
                td["confidence"], od["confidence"], rtol=2e-3,
                err_msg=f"scan {i}: confidence",
            )


def test_two_targets_detected_simultaneously(oracle_run, step_run):
    """Some scans must carry BOTH flying targets at once, in both
    implementations, with positions near the true sphere centers."""
    for out, name in ((oracle_run[0], "oracle"), (step_run[0], "step")):
        multi = 0
        for i, (dets, _) in enumerate(out):
            if len(dets) < 2:
                continue
            t = i - N_WARMUP
            a, b = target_positions(t)
            pos = np.array([d["position"] for d in dets])
            da = np.linalg.norm(pos - np.array(a), axis=1).min()
            db = np.linalg.norm(pos - np.array(b), axis=1).min()
            if da <= 1.5 and db <= 1.5:
                multi += 1
        assert multi >= 5, f"{name}: only {multi} dual-detection scans"


def test_distinct_monotonic_ids(step_run):
    """Per-scan ids are distinct; ids never decrease across the run and a
    fresh id is only ever minted one past the counter (ref :845)."""
    step_out, _ = step_run
    all_ids = []
    for dets, _ in step_out:
        ids = [d["id"] for d in dets]
        assert len(ids) == len(set(ids)), f"duplicate ids in one scan: {ids}"
        all_ids.extend(sorted(ids))
    assert all_ids, "no detections at all"
    # ids are minted from a monotonic counter: the k-th distinct id is k
    distinct = sorted(set(all_ids))
    assert distinct == list(range(len(distinct))), distinct


def test_resting_object_never_detected(oracle_run, step_run):
    """The sphere resting on the structure is a close cluster: no detection
    may ever appear near it in either implementation."""
    c = np.array(C_CENTER)
    for out, name in ((oracle_run[0], "oracle"), (step_run[0], "step")):
        for i, (dets, _) in enumerate(out):
            for d in dets:
                dist = float(np.linalg.norm(d["position"] - c))
                assert dist > 1.5, (
                    f"{name} scan {i}: detection {dist:.2f} m from the "
                    "resting (close-cluster) sphere"
                )


class TestSweepModeMulti:
    """Production configuration (plane-sweep raycast, local-density
    sepclusters, spec-correct defaults) on the multi-object scenario: both
    targets tracked within the documented sweep-mode error budget
    (DESIGN.md §9), and the close-cluster object still never detected."""

    @pytest.fixture(scope="class")
    def sweep_run(self, scenario):
        cfg, lut, scans = scenario
        return run_step(cfg, lut, scans, raycast_mode="sweep")

    def test_both_targets_tracked(self, sweep_run):
        multi = 0
        for i, (dets, _) in enumerate(sweep_run[0]):
            if len(dets) < 2:
                continue
            t = i - N_WARMUP
            a, b = target_positions(t)
            pos = np.array([d["position"] for d in dets])
            da = np.linalg.norm(pos - np.array(a), axis=1).min()
            db = np.linalg.norm(pos - np.array(b), axis=1).min()
            if da <= 1.5 and db <= 1.5:
                multi += 1
        assert multi >= 5, f"only {multi} dual-detection scans in sweep mode"

    def test_error_budget_vs_oracle(self, oracle_run, sweep_run):
        pos_errs = []
        matched = 0
        for (odets, _), (sdets, _) in zip(oracle_run[0], sweep_run[0]):
            if not odets or not sdets:
                continue
            matched += 1
            for od in odets:
                sd = min(
                    sdets,
                    key=lambda d: np.linalg.norm(d["position"] - od["position"]),
                )
                pos_errs.append(
                    float(np.linalg.norm(sd["position"] - od["position"]))
                )
        assert matched >= 8, f"only {matched} co-detected scans"
        assert max(pos_errs) <= 0.75, (
            f"sweep-vs-oracle multi-target pos err max {max(pos_errs):.3f} m"
        )

    def test_resting_object_never_detected(self, sweep_run):
        c = np.array(C_CENTER)
        for i, (dets, _) in enumerate(sweep_run[0]):
            for d in dets:
                dist = float(np.linalg.norm(d["position"] - c))
                assert dist > 1.5, (
                    f"sweep scan {i}: detection {dist:.2f} m from the "
                    "resting sphere"
                )
