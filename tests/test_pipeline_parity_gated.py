"""Gated-raycast parity: FOV mask + intensity gate + raycast_every schedule.

The per-pixel raycast gates of the reference (vofod_nodelet.cpp:1449-1450:
skip a pixel when ``intensity < raycast/min_intensity`` OR when it is masked
AND returned nothing) and the skipped-scan schedule compensation
(``its_diff``, ref :1540-1548) are covered at kernel level by
tests/test_raycast.py; this module proves them through the WHOLE pipeline:
the NumPy oracle and the JAX step in exact modes run a 52-scan scenario with

* a FOV mask zeroing one pixel block (airframe-style permanent occlusion),
* an intensity pattern putting one pixel block under the gate, and
* ``raycast_every=2`` (freespace applied every 2nd scan with its_diff=2),

and must agree detection-for-detection with a bounded grid divergence.  A
gate-engagement check first proves the gated pixel blocks actually change
the field (guarding against a scenario where the gates are dead weight).
"""

import numpy as np
import pytest

from tests.ref_pipeline import RefPipeline
from tests.test_pipeline_parity import (
    make_scenario,
    parity_config,
    run_step,
)
from vofod_tpu.config import DynParams
from vofod_tpu.pipeline.state import ScanInput, init_state
from vofod_tpu.pipeline.step import make_step_fn

import jax.numpy as jnp

RAYCAST_EVERY = 2
LOW_I = slice(0, 256)  # pixels under the intensity gate
MASKED = slice(512, 768)  # pixels masked out


def gated_dyn():
    return DynParams(
        raycast_weight_coefficient=0.5, raycast_min_intensity=0.5
    )


@pytest.fixture(scope="module")
def scenario():
    cfg = parity_config()
    lut, scans = make_scenario(cfg)
    # inject the intensity pattern: ones except the gated block
    gated = []
    for ranges, inten, pose in scans:
        inten = inten.copy()
        inten[LOW_I] = 0.2
        gated.append((ranges, inten, pose))
    mask = np.ones(scans[0][0].size, np.uint8)
    mask[MASKED] = 0
    return cfg, lut, gated, mask


@pytest.fixture(scope="module")
def oracle_run(scenario):
    cfg, lut, scans, mask = scenario
    cfg_o = parity_config(
        sepclusters_exact_census=True, compat_hascloseto_bounds=True
    )
    ref = RefPipeline(
        cfg_o, gated_dyn(), lut, mask=mask, raycast_every=RAYCAST_EVERY
    )
    ref.vmap[1, :, :] = np.inf
    out = [ref.step(r, i, p) for r, i, p in scans]
    return out, ref


@pytest.fixture(scope="module")
def step_run(scenario):
    cfg, lut, scans, mask = scenario
    cfg_t = parity_config(
        sepclusters_exact_census=True, compat_hascloseto_bounds=True
    )
    dyn = gated_dyn().as_arrays()
    step = make_step_fn(
        cfg_t, lut, raycast_mode="exact", donate=False, mask=mask,
        raycast_every=RAYCAST_EVERY,
    )
    state = init_state(cfg_t, gated_dyn())
    state = state._replace(grid=state.grid.at[1, :, :].set(jnp.inf))
    outs = []
    for ranges, inten, pose in scans:
        scan = ScanInput(
            ranges_mm=jnp.asarray(ranges.astype(np.float32)),
            intensity=jnp.asarray(inten),
            pose=jnp.asarray(pose),
        )
        state, out = step(state, scan, dyn)
        dets = [
            dict(
                position=np.asarray(out.detections.position[k]),
                n_points=int(out.detections.n_points[k]),
                id=int(out.detections.id[k]),
                confidence=float(out.detections.confidence[k]),
            )
            for k in range(cfg_t.max_clusters)
            if bool(out.detections.valid[k])
        ]
        outs.append((dets, out.diag))
    return outs, state


def test_gates_engage(scenario, oracle_run):
    """The gated pixel blocks must actually change the freespace field:
    an oracle run WITHOUT mask/intensity gating diverges from the gated one
    (some voxels cleared ungated stay uncleared gated)."""
    cfg, lut, scans, _ = scenario
    cfg_o = parity_config(
        sepclusters_exact_census=True, compat_hascloseto_bounds=True
    )
    plain = RefPipeline(
        cfg_o,
        DynParams(raycast_weight_coefficient=0.5),  # no intensity gate
        lut,
        mask=None,
        raycast_every=RAYCAST_EVERY,
    )
    plain.vmap[1, :, :] = np.inf
    for r, _, p in scans:
        plain.step(r, np.ones(r.size, np.float32), p)
    _, gated_ref = oracle_run
    with np.errstate(invalid="ignore"):
        diff = np.abs(
            np.where(
                np.isinf(plain.vmap) & np.isinf(gated_ref.vmap),
                0.0,
                plain.vmap - gated_ref.vmap,
            )
        )
    # gated pixels stop clearing rays: a real chunk of the grid must differ
    assert (diff > 1.0).sum() > 50, f"gates changed {(diff > 1.0).sum()} voxels"


def test_detections_match(oracle_run, step_run):
    oracle_out, _ = oracle_run
    step_out, _ = step_run
    n_det_scans = 0
    for i, ((odets, _), (tdets, _)) in enumerate(zip(oracle_out, step_out)):
        assert len(tdets) == len(odets), (
            f"scan {i}: {len(tdets)} detections vs oracle {len(odets)}"
        )
        n_det_scans += bool(odets)
        osort = sorted(odets, key=lambda d: tuple(d["position"]))
        tsort = sorted(tdets, key=lambda d: tuple(d["position"]))
        for od, td in zip(osort, tsort):
            np.testing.assert_allclose(
                td["position"], od["position"], atol=1e-3,
                err_msg=f"scan {i}: detection position",
            )
            assert td["n_points"] == od["n_points"], f"scan {i}"
            assert td["id"] == od["id"], f"scan {i}"
            np.testing.assert_allclose(
                td["confidence"], od["confidence"], rtol=2e-3,
                err_msg=f"scan {i}: confidence",
            )
    assert n_det_scans >= 10, "target not tracked under the gated schedule"


def test_grid_divergence_bounded(oracle_run, step_run):
    _, ref = oracle_run
    _, state = step_run
    g = np.asarray(state.grid)
    assert np.array_equal(np.isinf(g), np.isinf(ref.vmap))
    both_inf = np.isinf(g) & np.isinf(ref.vmap)
    with np.errstate(invalid="ignore"):
        diff = np.abs(np.where(both_inf, 0.0, g - ref.vmap))
    assert float(np.max(diff)) <= 15.0, float(np.max(diff))
    assert float(np.mean(diff)) <= 0.05, float(np.mean(diff))
