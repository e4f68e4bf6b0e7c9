"""chip_smoke.py off the card: it refuses the CPU, and its phase functions
run here at tiny sizes (the dry-run shapes of __graft_entry__.py)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from vofod_tpu.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu.sensor import make_lut

ROOT = Path(__file__).resolve().parent.parent


def _tiny():
    cfg = VoFODConfig(
        sensor=SensorConfig(
            vertical_rays=8, horizontal_rays=32, vertical_fov=np.deg2rad(90.0)
        ),
        oparea=Box((0.0, 0.0, 4.0), (8.0, 8.0, 8.0)),
        max_clusters=4,
        max_far_voxels=128,
        max_queries=32,
        explore_submap=8,
        confidence_submap=8,
    )
    lut = make_lut(cfg.sensor)
    scans, centers = [], []
    for k in range(6):
        a = 0.5 * k
        c = np.array([2.0 * np.cos(a), 2.0 * np.sin(a), 5.0])
        sc = Scene(ground_z=0.0)
        sc.add_sphere(center=c, radius=0.5)
        p = hover_pose((0.2 * np.cos(a), 0.0, 3.0), yaw=0.1 * k)
        scans.append((render_scan(sc, lut, p), p))
        centers.append(c)
    xs = np.arange(-4.0, 4.0, 0.4)
    gx, gy = np.meshgrid(xs, xs)
    apriori = np.stack(
        [gx.ravel(), gy.ravel(), np.full(gx.size, 0.1)], axis=1
    ).astype(np.float32)
    return cfg, DynParams(), lut, scans, centers, apriori


def _run(code, env_extra=None):
    env = {"PATH": os.environ.get("PATH", ""), "JAX_PLATFORMS": "cpu"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *code], cwd=ROOT, capture_output=True, text=True,
        timeout=180, env=env,
    )


def test_refuses_cpu():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stdout


def test_main_path_imports_without_optional_packages():
    code = (
        "import sys\n"
        "for m in ('yaml', 'orbax', 'orbax.checkpoint', 'cv2', 'PIL', 'lz4',"
        " 'lz4.frame'):\n"
        "    sys.modules[m] = None\n"
        "import vofod_tpu.config, vofod_tpu.runtime.node\n"
        "import vofod_tpu.runtime.fleet, vofod_tpu.tools.detect, chip_smoke\n"
        "from vofod_tpu.runtime.checkpoint import save_state\n"
        "try:\n"
        "    save_state('ckpt_dir', {})\n"
        "except ImportError as e:\n"
        "    assert 'orbax' in str(e) and '.npz' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('save_state without orbax did not raise')\n"
    )
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize(
    "text,want",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n",
         [("NVIDIA H100 80GB HBM3", "700.00 W")]),
        ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W",
         [("NVIDIA H100 80GB HBM3", "500.00 W"),
          ("NVIDIA H100 80GB HBM3", "700.00 W")]),
        ("", []),
    ],
)
def test_parse_nvidia_smi(text, want):
    assert chip_smoke.parse_nvidia_smi(text) == want


@pytest.mark.parametrize(
    "frontend_mode,raycast_mode", [("raw", "sweep"), ("prebinned", "sweep")]
)
def test_main_path_phase(frontend_mode, raycast_mode):
    cfg, dyn, _, scans, centers, apriori = _tiny()
    res = chip_smoke.run_main_path(
        cfg, dyn, scans, apriori, frontend_mode, raycast_mode, n_sync=3
    )
    assert len(res["dets"]) == len(scans)
    assert len(res["walls"]) == 2  # scans 1..2 synchronous, timed
    errs = chip_smoke.check_main_path(res, centers, min_hits=0, last=3)
    assert errs == [], errs


def test_fleet_phase_matches_single_nodes():
    from vofod_tpu.parallel.sharding import make_mesh

    cfg, dyn, _, scans, _, apriori = _tiny()
    r = chip_smoke.fleet_check(
        cfg, dyn, apriori, scans, n_streams=2, n_ticks=2, mesh=make_mesh(1)
    )
    assert r["dets_equal"] and r["devices"] == 1, r


def test_gate_phase_vs_float64():
    r = chip_smoke.gate_check(H=16, W=64, trials=1)
    assert r["ok"], r


def test_pca_phase_vs_float64():
    r = chip_smoke.pca_check(K=3, F=192)
    assert r["ok"], r


def test_comparison_helpers():
    a = [dict(id=1, position=np.zeros(3), n_points=4)]
    b = [dict(id=1, position=np.full(3, 5e-4), n_points=4)]
    assert chip_smoke.compare_dets(a, b) == (True, 5e-4)
    assert chip_smoke.compare_dets(a, [])[0] is False
    g = np.array([[0.0, np.inf], [1.0, -3.0]], np.float32)
    assert chip_smoke.grid_delta(g, g) == (True, 0.0, 0.0)
    h = g.copy()
    h[1, 0] = 17.0
    ok, mx, _ = chip_smoke.grid_delta(g, h)
    assert not ok and mx == 16.0
    h = g.copy()
    h[0, 1] = 0.0  # an apriori cell lost
    assert chip_smoke.grid_delta(g, h)[0] is False
