"""Whole-pipeline parity with interleaved rangefinder fusion.

The reference fuses downward rangefinder hits into the voxel map from a
dedicated thread (vofod_nodelet.cpp:580-613, 1102-1117); under the
deterministic schedule both sides fuse one Range message between scans.
This drives the real ``VoFOD`` node (its jitted single-voxel update,
runtime/node.py:process_rangefinder) against the NumPy oracle's
``RefPipeline.rangefinder`` on the standard 52-scan parity scenario in
reference-exact modes, asserting:

* per-hit agreement of the fused/rejected verdict (validity gate,
  out-of-limits skip, +inf apriori-row stability);
* scan-for-scan detection-level agreement;
* final-grid agreement under the same bounds as the scan-only parity —
  the rangefinder half-EMA is bit-identical f32 math on both sides, so it
  must not widen the budget.
"""

import numpy as np
import pytest

from tests.ref_pipeline import RefPipeline
from tests.test_pipeline_parity import (
    N_WARMUP,
    make_scenario,
    parity_config,
    parity_dyn,
)
from vofod_tpu.runtime.node import NodeOptions, VoFOD


def _down():
    """Rotate sensor +x (the Range measurement axis) to world -z."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32).T
    return T


def rangefinder_plan(i, pose):
    """(rng, min_range, max_range, pose) fused after scan ``i``.

    Cycles through: a finite-row hit whose row varies with the scan (the
    voxel walks toward score_point), a hit onto the +inf apriori ground row
    (z = 0.5 m from z = 7 m: inf must stay inf), an invalid short range and
    a below-grid miss (both must be rejected on both sides).
    """
    k = i % 4
    if k == 0:
        return (3.0 + 0.1 * (i % 10), 0.2, 30.0, pose @ _down())
    if k == 1:
        return (6.5, 0.2, 30.0, pose @ _down())
    if k == 2:
        return (0.1, 0.2, 30.0, pose @ _down())  # rng <= min_range
    return (7.2, 0.2, 30.0, pose @ _down())  # z < grid floor


@pytest.fixture(scope="module")
def scenario():
    cfg = parity_config()
    lut, scans = make_scenario(cfg)
    return cfg, lut, scans


@pytest.fixture(scope="module")
def runs(scenario):
    _, lut, scans = scenario
    cfg = parity_config(
        sepclusters_exact_census=True, compat_hascloseto_bounds=True
    )
    ref = RefPipeline(cfg, parity_dyn(), lut)
    ref.vmap[1, :, :] = np.inf  # apriori ground plane (ref :339-341)

    node = VoFOD(cfg, parity_dyn(), NodeOptions(raycast_mode="exact"), lut=lut)
    node.state = node.state._replace(
        grid=node.state.grid.at[1, :, :].set(np.inf)
    )
    node._apriori_loaded = True

    oracle_out, step_out, verdicts = [], [], []
    for i, (ranges, inten, pose) in enumerate(scans):
        oracle_out.append(ref.step(ranges, inten, pose))
        msg = node.process_scan(ranges, inten, pose)
        step_out.append(msg.detections)
        rng, lo, hi, rf_pose = rangefinder_plan(i, pose)
        o_ok = ref.rangefinder(rng, lo, hi, rf_pose)
        t_ok = node.process_rangefinder(rng, lo, hi, rf_pose)
        verdicts.append((i, o_ok, t_ok))
    return oracle_out, step_out, verdicts, ref, node


def test_fusion_verdicts_match(runs):
    _, _, verdicts, _, _ = runs
    for i, o_ok, t_ok in verdicts:
        assert o_ok == t_ok, f"hit after scan {i}: oracle {o_ok} vs node {t_ok}"
    ks = {i % 4 for i, o_ok, _ in verdicts if o_ok}
    assert ks == {0, 1}, ks  # finite + inf-row fused; short + below-grid not


def test_detections_match(runs):
    oracle_out, step_out, _, _, _ = runs
    for i, ((odets, _), tdets) in enumerate(zip(oracle_out, step_out)):
        assert len(tdets) == len(odets), (
            f"scan {i}: {len(tdets)} detections vs oracle {len(odets)}"
        )
        osort = sorted(odets, key=lambda d: tuple(d["position"]))
        tsort = sorted(tdets, key=lambda d: tuple(d.position))
        for od, td in zip(osort, tsort):
            np.testing.assert_allclose(
                td.position, od["position"], atol=1e-3,
                err_msg=f"scan {i}: detection position",
            )
            assert td.n_points == od["n_points"], f"scan {i}"
            assert td.id == od["id"], f"scan {i}"
            np.testing.assert_allclose(
                td.confidence, od["confidence"], rtol=2e-3,
                err_msg=f"scan {i}: confidence",
            )


def test_scenario_detects(runs):
    oracle_out, _, _, _, _ = runs
    first = next((i for i, (d, _) in enumerate(oracle_out) if d), None)
    assert first is not None and first >= N_WARMUP
    assert sum(1 for d, _ in oracle_out if d) >= 10


def test_grid_divergence_bounded(runs):
    _, _, _, ref, node = runs
    g = np.asarray(node.state.grid)
    both_inf = np.isinf(g) & np.isinf(ref.vmap)
    assert np.array_equal(np.isinf(g), np.isinf(ref.vmap))
    with np.errstate(invalid="ignore"):
        diff = np.abs(np.where(both_inf, 0.0, g - ref.vmap))
    # same budget as the scan-only parity (tests/test_pipeline_parity.py):
    # the rangefinder updates themselves are bit-identical f32 on both sides
    assert float(np.max(diff)) <= 15.0, float(np.max(diff))
    assert float(np.mean(diff)) <= 0.05, float(np.mean(diff))


def test_rangefinder_hit_voxels_agree(runs, scenario):
    """At the exact voxels the finite-row hits landed in, the two grids agree
    far tighter than the global raycast budget: the half-EMA itself is
    bit-identical f32, so only the shared raycast history separates them."""
    _, _, _, ref, node = runs
    _, _, scans = scenario
    g = np.asarray(node.state.grid)
    hit = []
    for i, (ranges, inten, pose) in enumerate(scans):
        if i % 4 != 0:
            continue
        rng, lo_r, hi_r, rf_pose = rangefinder_plan(i, pose)
        pt = (np.asarray(rf_pose, np.float32)
              @ np.array([rng, 0, 0, 1], np.float32))[:3]
        idx = ref._coord_to_idx(pt[None, :])[0]
        hit.append((idx[2], idx[1], idx[0]))
    assert hit
    for z, y, x in hit:
        assert np.isfinite(g[z, y, x])
        assert abs(float(g[z, y, x]) - float(ref.vmap[z, y, x])) <= 1.0, (
            (z, y, x, float(g[z, y, x]), float(ref.vmap[z, y, x]))
        )
