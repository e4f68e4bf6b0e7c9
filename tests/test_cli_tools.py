"""CLI entry points (detect.launch / create_mask.launch analogues)."""

import numpy as np

from vofod_tpu.io.pc_loader import save_cloud
from vofod_tpu.io.scan_source import Scene, hover_pose, render_scan, save_scans_npz
from vofod_tpu.sensor import make_lut_simulation


def _record(tmp_path, h=8, w=32, n=3, block_pixel=None):
    lut = make_lut_simulation(w, h, np.deg2rad(90.0))
    pose = hover_pose((0.0, 0.0, 3.0))
    r = render_scan(Scene(ground_z=0.0), lut, pose)
    if block_pixel is not None:
        r = r.copy()
        r[block_pixel] = 0
    p = str(tmp_path / "scans.npz")
    save_scans_npz(p, np.stack([r] * n), np.stack([pose] * n))
    return p


def test_detect_cli(tmp_path, capsys, monkeypatch):
    from vofod_tpu.tools.detect import main

    scans = _record(tmp_path)
    cloud = str(tmp_path / "world.pts")
    save_cloud(cloud, np.array([[1.0, 1.0, 0.2], [2.0, 1.0, 0.2]]))
    cfgy = str(tmp_path / "det.yaml")
    with open(cfgy, "w") as f:
        f.write(
            "voxel_map: {voxel_size: 0.5}\n"
            "background_sufficient_points_ratio: 0.05\n"
        )
    seny = str(tmp_path / "sen.yaml")
    with open(seny, "w") as f:
        f.write(
            "sensor: {vertical_fov_angle: 90.0, vertical_rays: 8, horizontal_rays: 32}\n"
        )
    mapy = str(tmp_path / "map.yaml")
    with open(mapy, "w") as f:
        f.write(
            "operation_area:\n"
            "  offset: {x: 0.0, y: 0.0, z: -1.0}\n"
            "  size: {x: 10.0, y: 10.0, z: 10.0}\n"
        )
    state = str(tmp_path / "state.npz")
    markers = str(tmp_path / "markers.npz")
    rc = main(
        [
            "--scans", scans, "--config", cfgy, "--sensor", seny,
            "--map", mapy, "--apriori-cloud", cloud, "--json",
            "--save-state", state, "--markers", markers, "--raycast", "off",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 3  # one JSON line per scan
    import json as _json

    for line in out:
        _json.loads(line)
    import os

    assert os.path.exists(state) and os.path.exists(markers)


def test_serve_fleet_cli(tmp_path, capsys):
    """Fleet serving entry point: 8 streams (one per virtual device) fed
    from a recording, two lockstep ticks, stats on stderr."""
    from vofod_tpu.tools.serve_fleet import main

    scans = _record(tmp_path, n=6)
    cfgy = str(tmp_path / "det.yaml")
    with open(cfgy, "w") as f:
        f.write(
            "voxel_map: {voxel_size: 0.5}\n"
            "background_sufficient_points_ratio: 0.05\n"
        )
    seny = str(tmp_path / "sen.yaml")
    with open(seny, "w") as f:
        f.write(
            "sensor: {vertical_fov_angle: 90.0, vertical_rays: 8, "
            "horizontal_rays: 32}\n"
        )
    mapy = str(tmp_path / "map.yaml")
    with open(mapy, "w") as f:
        f.write(
            "operation_area:\n"
            "  offset: {x: 0.0, y: 0.0, z: -1.0}\n"
            "  size: {x: 10.0, y: 10.0, z: 10.0}\n"
        )
    rc = main(
        [
            "--streams", "8", "--scans", scans, "--ticks", "2", "--loop",
            "--rate", "200", "--config", cfgy, "--sensor", seny,
            "--map", mapy, "--small-capacities", "--json",
        ]
    )
    assert rc == 0
    err = capsys.readouterr().err
    assert "2 ticks x 8 local streams" in err


def test_serve_fleet_multihost_requires_ticks(monkeypatch, capsys):
    """With >1 processes each tick is one global SPMD dispatch, so an
    unbounded run (--ticks 0) would deadlock the fleet the moment one
    host's sources drain first — the CLI must refuse up front (before the
    global mesh is committed)."""
    import pytest

    import vofod_tpu.tools.serve_fleet as sf

    monkeypatch.setattr("jax.process_count", lambda: 2)
    with pytest.raises(SystemExit) as ei:
        sf.main(["--sim", "--small-capacities"])
    assert ei.value.code == 2
    assert "--ticks is required" in capsys.readouterr().err


def test_create_mask_cli(tmp_path, capsys):
    from vofod_tpu.tools.create_mask import main

    scans = _record(tmp_path, block_pixel=5)
    out = str(tmp_path / "mask.npy")
    rc = main(["--scans", scans, "--out", out, "--rays", "8x32"])
    assert rc == 0
    m = np.load(out)
    assert m.shape == (8, 32)
    assert m.reshape(-1)[5] == 0


def test_serve_fleet_latency_summary(tmp_path, capsys):
    """--json gains per-tick latency records and a final percentile summary
    (the fleet-knee ergonomics: operators read the knee off the output)."""
    import json as _json

    from vofod_tpu.tools.serve_fleet import main

    scans = _record(tmp_path, n=6)
    seny = str(tmp_path / "sen.yaml")
    with open(seny, "w") as f:
        f.write(
            "sensor: {vertical_fov_angle: 90.0, vertical_rays: 8, "
            "horizontal_rays: 32}\n"
        )
    rc = main(
        [
            "--streams", "8", "--scans", scans, "--ticks", "3", "--loop",
            "--rate", "200", "--sensor", seny, "--small-capacities", "--json",
        ]
    )
    assert rc == 0
    out = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    recs = [_json.loads(l) for l in out]
    ticks = [r for r in recs if "latency_ms" in r and not r.get("summary")]
    assert len(ticks) == 3 and all(r["latency_ms"] > 0 for r in ticks)
    summary = [r for r in recs if r.get("summary")]
    assert len(summary) == 1
    s = summary[0]
    assert s["streams"] == 8 and s["ticks"] == 3
    assert s["latency_p50_ms"] <= s["latency_p95_ms"] <= s["latency_p99_ms"]


def test_serve_fleet_streams_auto(tmp_path, capsys, monkeypatch):
    """--streams auto takes the fleet's default knee; the policy itself is
    pure (test_pick_stream_knee_policy) — here the CLI wiring."""
    import vofod_tpu.runtime.fleet as fleet_mod
    from vofod_tpu.tools.serve_fleet import main

    monkeypatch.setattr(fleet_mod, "pick_stream_knee", lambda n_dev: n_dev)
    scans = _record(tmp_path, n=4)
    seny = str(tmp_path / "sen.yaml")
    with open(seny, "w") as f:
        f.write(
            "sensor: {vertical_fov_angle: 90.0, vertical_rays: 8, "
            "horizontal_rays: 32}\n"
        )
    rc = main(
        [
            "--streams", "auto", "--scans", scans, "--ticks", "2", "--loop",
            "--rate", "200", "--sensor", seny, "--small-capacities",
        ]
    )
    assert rc == 0
    err = capsys.readouterr().err
    assert "--streams auto: unmeasured default -> 8 streams" in err
    assert "2 ticks x 8 local streams" in err


def test_pick_stream_knee_policy():
    """The default knee: 32 streams per device, scaled by the device count
    (unmeasured until a cadence-validated knee replaces it)."""
    from vofod_tpu.runtime.fleet import pick_stream_knee

    assert pick_stream_knee(1) == 32
    assert pick_stream_knee(4) == 128
    assert pick_stream_knee() == 32
