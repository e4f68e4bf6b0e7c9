#!/usr/bin/env python
"""Smoke run of the VoFOD detector on NVIDIA GPUs.

  python chip_smoke.py               # one card: main path, parity, fleet
  python chip_smoke.py --four-cards  # the multi-device paths only (4 cards)

One card (default):

1. device — JAX must find a GPU (no CPU fallback); prints the card's
   ``device_kind`` and nvidia-smi's name and power limit;
2. main path at the flagship deployment (configs/detection_params.yaml,
   sensors/os0-128.yaml, apriori_maps/sim.yaml: 131,072 rays per scan over a
   241x201x51 voxel grid) through ``VoFOD.process_scan`` and
   ``process_scan_async``/``fetch_result`` in every supported
   ingest x raycast mode, then ``python -m vofod_tpu.tools.detect`` (run
   in this process) on a recording this script writes;
3. parity on the card — (a) the reference-exact small scenario against the
   NumPy oracle tests/ref_pipeline.py, (b) the full-width step against the
   same step on the host CPU backend, (c) the calibrated-table angular gate
   and (d) the PCA/OBB cluster stats against float64 NumPy;
4. a 4-stream fleet on one card against single-stream nodes;
5. informational timings (compile, device step, process_scan wall).

``--four-cards``: the stream-DP fleet over 4 cards, the Z-grid-sharded step
(both z-cone modes) and the 2x2 streams x grid composition, each against
its single-card reference.

Every phase runs even after an earlier one fails; the script exits non-zero
if any failed.  Only a fully passing run prints, as its last line,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Tolerances (each comparison prints its measured value beside the bound):

* detections vs detections: same count, ids and point counts, positions
  within 1e-3 m — the bound tests/test_pipeline_parity.py holds the step to
  against the oracle;
* grid vs grid across backends, device counts or GPU runs: max |delta| <= 15
  and mean |delta| <= 0.05 score units (scores span ~1000 units) — the same
  oracle-test bound.  Sweep-mode differences come from XLA fusing
  transcendentals and the intended bf16 gate einsums differently per
  backend; exact-mode differences from the DDA's float scatter-add, whose
  summation order GPU atomics do not fix;
* the grid-sharded exact step is held to bit-equality with the dense step
  whenever the dense exact step is itself bitwise reproducible on the card;
* angular gate: row coordinate within 2e-3 rows, face values within 3e-3
  (tests/test_raycast.py's bounds; TF32 rounding is ~0.1 row);
* PCA/OBB ~100 m from the origin: centers, half extents and diagonals
  within 1e-3 m (TF32 rounding of the mean alone is ~0.05 m there).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIGS = (
    "configs/detection_params.yaml",
    "configs/sensors/os0-128.yaml",
    "configs/apriori_maps/sim.yaml",
)
POS_ATOL = 1e-3  # m
GRID_MAX = 15.0  # score units
GRID_MEAN = 0.05
ROW_ATOL = 2e-3  # rows
FACE_ATOL = 3e-3
OBB_ATOL = 1e-3  # m


def _keep_host_backend() -> None:
    """Parity (b) compares the GPU with the host CPU backend in this
    process; if JAX_PLATFORMS names platforms, make sure cpu is one."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """``name, power.limit`` CSV rows -> [(name, power_limit)]."""
    rows = []
    for line in text.strip().splitlines():
        if line.strip():
            name, limit = line.rsplit(",", 1)
            rows.append((name.strip(), limit.strip()))
    return rows


def nvidia_smi() -> str:
    """The cards' name and power limit, read by a child that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def _repo_tests():
    """Bind ``tests`` to this repo's tests/ directory (the oracles live
    there); an installed top-level ``tests`` package would otherwise shadow
    the namespace package."""
    import types

    path = os.path.join(REPO, "tests")
    pkg = sys.modules.get("tests")
    if pkg is None or path not in list(getattr(pkg, "__path__", [])):
        pkg = types.ModuleType("tests")
        pkg.__path__ = [path]
        sys.modules["tests"] = pkg


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- helpers
def det_list(msg) -> list[dict]:
    """Detections message -> sortable plain records."""
    return sorted(
        (dict(id=d.id, position=np.asarray(d.position), n_points=d.n_points,
              confidence=d.confidence) for d in msg.detections),
        key=lambda d: tuple(d["position"]),
    )


def compare_dets(a: list[dict], b: list[dict]) -> tuple[bool, float]:
    """(same detection set, largest position difference in m)."""
    if len(a) != len(b):
        return False, float("inf")
    worst = 0.0
    same = True
    for x, y in zip(a, b):
        d = float(np.max(np.abs(x["position"] - y["position"])))
        worst = max(worst, d)
        same &= x["id"] == y["id"] and x["n_points"] == y["n_points"]
    return same and worst <= POS_ATOL, worst


def grid_delta(a: np.ndarray, b: np.ndarray) -> tuple[bool, float, float]:
    """(within the grid tolerance, max |delta|, mean |delta|); +-inf cells
    (apriori background) must match exactly."""
    a, b = np.asarray(a), np.asarray(b)
    if not np.array_equal(np.isinf(a), np.isinf(b)):
        return False, float("inf"), float("inf")
    fin = np.isfinite(a)
    diff = np.abs(np.where(fin, a, 0.0) - np.where(fin, b, 0.0))
    mx, mean = float(diff.max()), float(diff.mean())
    return mx <= GRID_MAX and mean <= GRID_MEAN, mx, mean


def target_hits(dets_per_scan, centers, radius=1.0) -> int:
    """Scans with a detection within ``radius`` m of the target center."""
    return sum(
        any(np.linalg.norm(d["position"] - c) <= radius for d in dets)
        for dets, c in zip(dets_per_scan, centers)
    )


def flagship():
    from vofod_tpu.config import load_config
    from vofod_tpu.io.scan_source import apriori_ground, make_scan_cycle
    from vofod_tpu.sensor import make_lut

    cfg, dyn = load_config(*(os.path.join(REPO, c) for c in CONFIGS))
    return cfg, dyn, make_lut(cfg.sensor), apriori_ground(), make_scan_cycle


# ------------------------------------------------------------- phase 2
def run_main_path(cfg, dyn, scans, apriori, frontend_mode, raycast_mode,
                  n_sync=None):
    """Drive ``VoFOD`` over ``scans``: the first ``n_sync`` through
    ``process_scan``, the rest through a one-deep
    ``process_scan_async``/``fetch_result`` pipeline.  Returns per-scan
    detections, the last diagnostics and host timings."""
    from vofod_tpu.runtime.node import NodeOptions, VoFOD

    node = VoFOD(cfg, dyn, NodeOptions(
        raycast_mode=raycast_mode, frontend_mode=frontend_mode))
    node.load_apriori_map(apriori)
    n_sync = len(scans) // 2 if n_sync is None else n_sync
    dets, walls = [], []
    t0 = time.perf_counter()
    dets.append(det_list(node.process_scan(scans[0][0], None, scans[0][1])))
    first_s = time.perf_counter() - t0
    for r, p in scans[1:n_sync]:
        t0 = time.perf_counter()
        dets.append(det_list(node.process_scan(r, None, p)))
        walls.append((time.perf_counter() - t0) * 1e3)
    pending = None
    for r, p in scans[max(n_sync, 1):]:
        h = node.process_scan_async(r, None, p)
        if pending is not None:
            dets.append(det_list(node.fetch_result(pending)))
        pending = h
    if pending is not None:
        dets.append(det_list(node.fetch_result(pending)))
    first_det = next((i for i, d in enumerate(dets) if d), None)
    return dict(dets=dets, diag=node.last_diag, first_s=first_s, walls=walls,
                first_detection_scan=first_det)


def check_main_path(res, centers, min_hits, last=10) -> list[str]:
    """Failures of a main-path run: unconverged, or target not detected."""
    errs = []
    if not bool(res["diag"].bg_sufficient):
        errs.append("background not sufficient (unconverged)")
    hits = target_hits(res["dets"][-last:], centers[-last:])
    res["target_hits"] = hits
    if hits < min_hits:
        errs.append(f"target detected in {hits}/{last} last scans "
                    f"(< {min_hits})")
    return errs


def run_detect_cli(config_paths, scans, apriori) -> list[dict]:
    """``python -m vofod_tpu.tools.detect`` on a recording of ``scans``, in
    this process (one JAX process per card).  Returns the JSON records."""
    from vofod_tpu.io.pc_loader import save_cloud
    from vofod_tpu.io.scan_source import save_scans_npz
    from vofod_tpu.tools.detect import main as detect_main

    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "scans.npz")
        cloud = os.path.join(tmp, "world.pts")
        save_scans_npz(rec, np.stack([r for r, _ in scans]),
                       np.stack([p for _, p in scans]))
        save_cloud(cloud, apriori)
        argv = ["--scans", rec, "--config", config_paths[0],
                "--sensor", config_paths[1], "--map", config_paths[2],
                "--apriori-cloud", cloud, "--json"]
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = detect_main(argv)
    if rc != 0:
        raise RuntimeError(f"tools.detect exited {rc}: {err.getvalue()}")
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.strip()]


# ------------------------------------------------------------- phase 3
def initial_state_host(cfg, dyn, apriori):
    """Fresh state with the apriori map stamped by the node, on the host."""
    import jax

    from vofod_tpu.runtime.node import VoFOD

    node = VoFOD(cfg, dyn)
    node.load_apriori_map(apriori)
    return jax.device_get(node.state)


def dets_from_out(d) -> list[dict]:
    """Host StepOutput.detections of one stream -> sortable records."""
    return sorted(
        (dict(id=int(d.id[k]), position=np.asarray(d.position[k]),
              n_points=int(d.n_points[k]), confidence=float(d.confidence[k]))
         for k in range(d.valid.shape[0]) if d.valid[k]),
        key=lambda x: tuple(x["position"]))


def run_step_on(device, cfg, lut, dyn, state_host, scans, raycast_mode):
    """The jitted step built and run on one ``device`` from a host state;
    returns (final state on the host, per-scan detections)."""
    import jax

    from vofod_tpu.pipeline.state import ScanInput
    from vofod_tpu.pipeline.step import _make_step_fn, make_step_fn

    # the node's all-ones FOV mask, so device 0 shares the node's compile
    mask = np.ones(cfg.sensor.n_points, np.uint8)
    if device == jax.devices()[0]:
        step = make_step_fn(cfg, lut, raycast_mode=raycast_mode, mask=mask)
    else:
        # uncached build: its constants must live on ``device`` too
        with jax.default_device(device):
            step = _make_step_fn(cfg, lut, raycast_mode=raycast_mode,
                                 mask=mask)
    state = jax.device_put(state_host, device)
    dyn_d = jax.device_put(dyn.as_arrays(), device)
    ones = jax.device_put(np.ones(cfg.sensor.n_points, np.float32), device)
    dets = []
    for r, p in scans:
        scan = ScanInput(
            ranges_mm=jax.device_put(r.astype(np.float32), device),
            intensity=ones, pose=jax.device_put(np.asarray(p), device))
        state, out = step(state, scan, dyn_d)
        dets.append(dets_from_out(jax.device_get(out.detections)))
    return jax.device_get(state), dets


def warm_state(cfg, lut, dyn, apriori, scans):
    """Host state after the apriori map and ``scans`` (sweep raycast) on
    device 0: a converged starting point, so comparisons see detections."""
    import jax

    s0 = initial_state_host(cfg, dyn, apriori)
    return run_step_on(jax.devices()[0], cfg, lut, dyn, s0, scans, "sweep")[0]


def parity_backends(cfg, lut, dyn, state0, scans, raycast_mode, gpu, cpu):
    """GPU step vs the same step on the host CPU backend (phase 3b)."""
    s_gpu, d_gpu = run_step_on(gpu, cfg, lut, dyn, state0, scans, raycast_mode)
    s_cpu, d_cpu = run_step_on(cpu, cfg, lut, dyn, state0, scans, raycast_mode)
    ok_g, mx, mean = grid_delta(s_gpu.grid, s_cpu.grid)
    cmp = [compare_dets(a, b) for a, b in zip(d_gpu, d_cpu)]
    res = dict(grid_ok=ok_g, grid_max=mx, grid_mean=mean,
               dets_equal=all(c[0] for c in cmp),
               pos_max=max(c[1] for c in cmp),
               n_dets=sum(len(d) for d in d_gpu))
    if raycast_mode == "exact":
        s2, _ = run_step_on(gpu, cfg, lut, dyn, state0, scans, raycast_mode)
        res["gpu_bitwise_repeatable"] = bool(
            np.array_equal(s_gpu.grid, s2.grid))
    return res


def parity_small_oracle() -> dict:
    """Phase 3a: reference-exact small scenario vs the NumPy oracle."""
    _repo_tests()
    from tests.ref_pipeline import RefPipeline
    from tests.test_pipeline_parity import (
        make_scenario,
        parity_config,
        parity_dyn,
        run_step,
    )

    cfg = parity_config(sepclusters_exact_census=True,
                        compat_hascloseto_bounds=True)
    lut, scans = make_scenario(cfg)
    ref = RefPipeline(cfg, parity_dyn(), lut)
    ref.vmap[1, :, :] = np.inf
    oracle = [ref.step(r, i, p)[0] for r, i, p in scans]
    dev, _ = run_step(cfg, lut, scans, raycast_mode="exact")
    bad, worst = [], 0.0
    for i, (od, (td, _)) in enumerate(zip(oracle, dev)):
        o = sorted(od, key=lambda d: tuple(d["position"]))
        t = sorted(td, key=lambda d: tuple(d["position"]))
        same, w = compare_dets(o, t)
        if len(o) == len(t):
            worst = max(worst, w)
        if not same:
            bad.append(i)
    return dict(scans=len(scans), mismatched_scans=bad, pos_max=worst,
                oracle_dets=sum(len(d) for d in oracle))


def gradient_lut(H, W):
    """OS0-style calibrated table: beams densest at the horizon, 90 deg."""
    from vofod_tpu.sensor import make_lut_ouster

    u = np.linspace(-1.0, 1.0, H)
    alt = -45.0 * np.sign(u) * np.abs(u) ** 1.3
    az = 3.0 * np.sin(np.linspace(0, 2 * np.pi, H))
    return make_lut_ouster(W, H, az, alt, 15.806)


def _random_rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def gate_check(H=128, W=1024, trials=3, seed=7) -> dict:
    """Phase 3c: calibrated-table angular gate vs a float64 inverse."""
    import jax
    import jax.numpy as jnp

    _repo_tests()
    from tests.oracles import gate_faces_np
    from vofod_tpu.ops.raycast import (
        _row_from_elevation,
        gate_faces,
        make_angular_gate,
    )

    lut = gradient_lut(H, W)
    gate = make_angular_gate(lut)
    if gate.el_rows is None:
        raise AssertionError("calibrated table took the linear row map")
    el_row = np.arcsin(np.clip(
        lut.directions.reshape(H, W, 3)[..., 2], -1, 1)).mean(axis=1)
    # row centers and midpoints of every segment, all H rows
    el = np.concatenate([el_row, (el_row[1:] + el_row[:-1]) / 2.0])
    sgn = 1.0 if el_row[-1] > el_row[0] else -1.0
    f, t = sgn * el_row, sgn * el
    seg = np.clip(np.searchsorted(f, t, side="right") - 1, 0, H - 2)
    want = seg + (t - f[seg]) / (f[seg + 1] - f[seg])
    row_fn = jax.jit(lambda e: _row_from_elevation(gate, e))
    got = np.asarray(row_fn(jnp.asarray(el, jnp.float32)))
    row_err = float(np.abs(got - want).max())

    rng = np.random.default_rng(seed)
    face_fn = jax.jit(lambda a, r: gate_faces(gate, a, r))
    face_err = 0.0
    for _ in range(trials):
        active = rng.random((H, W)) < rng.uniform(0.2, 0.9)
        R = _random_rotation(rng)
        g = np.asarray(face_fn(jnp.asarray(active), jnp.asarray(R, jnp.float32)))
        w = gate_faces_np(gate, lut, active, R)
        face_err = max(face_err, float(np.abs(g - w).max()))
    return dict(rows=H, row_err=row_err, face_err=face_err,
                ok=row_err <= ROW_ATOL and face_err <= FACE_ATOL)


def pca_oracle(pts: np.ndarray):
    """float64 PCA OBB of one cluster (same conventions as pca_obb)."""
    mean = pts.mean(axis=0)
    d = pts - mean
    cov = d.T @ d / len(pts) + 1e-6 * np.eye(3)
    _, vecs = np.linalg.eigh(cov)
    axes = np.flip(vecs, axis=1).T  # rows: major, middle, minor
    proj = d @ axes.T
    pmin, pmax = proj.min(axis=0), proj.max(axis=0)
    return (mean + axes.T @ ((pmin + pmax) / 2.0), (pmax - pmin) / 2.0,
            float(np.linalg.norm(pmax - pmin)))


def pca_check(K=8, F=2048, seed=3, voxel=0.5) -> dict:
    """Phase 3d: PCA/OBB stats of clusters ~100 m out vs float64 NumPy."""
    import jax
    import jax.numpy as jnp

    from vofod_tpu.pipeline.classify import pca_obb

    rng = np.random.default_rng(seed)
    centers = np.zeros((F, 3), np.float32)
    slot = np.zeros((F, K), bool)
    clusters, i = [], 0
    for k in range(K):
        n = int(rng.integers(30, F // K))
        c = np.array([100.0, 80.0, 20.0]) + rng.uniform(-5, 5, 3)
        R = _random_rotation(rng)
        p = (rng.normal(size=(n, 3)) * [2.0, 0.8, 0.3]) @ R.T + c
        p = np.floor(p / voxel) * voxel + voxel / 2.0  # voxel centers
        centers[i:i + n] = p
        slot[i:i + n, k] = True
        clusters.append(p.astype(np.float32).astype(np.float64))
        i += n
    oc, _, oe, osz = (np.asarray(x) for x in jax.jit(pca_obb)(
        jnp.asarray(centers), jnp.asarray(slot)))
    err = 0.0
    for k, p in enumerate(clusters):
        wc, we, wsz = pca_oracle(p)
        err = max(err, float(np.abs(oc[k] - wc).max()),
                  float(np.abs(oe[k] - we).max()), abs(float(osz[k]) - wsz))
    return dict(clusters=K, err=err, ok=err <= OBB_ATOL)


# ------------------------------------------------------------- phase 4
def fleet_check(cfg, dyn, apriori, scans, n_streams, n_ticks, mesh=None):
    """FleetVoFOD vs one single-stream node per stream; stream b sees scan
    (k + b) of the cycle at tick k."""
    from vofod_tpu.runtime.fleet import FleetVoFOD
    from vofod_tpu.runtime.node import VoFOD

    fleet = FleetVoFOD(cfg, dyn, n_streams=n_streams, mesh=mesh)
    fleet.load_apriori_map(apriori)
    nodes = [VoFOD(cfg, dyn) for _ in range(n_streams)]
    for nd in nodes:
        nd.load_apriori_map(apriori)
    n = len(scans)
    worst, same, n_dets = 0.0, True, 0
    for k in range(n_ticks):
        rs = np.stack([scans[(k + b) % n][0] for b in range(n_streams)])
        ps = np.stack([scans[(k + b) % n][1] for b in range(n_streams)])
        msgs = fleet.process_scans(rs, ps)
        for b in range(n_streams):
            want = det_list(nodes[b].process_scan(rs[b], None, ps[b]))
            ok, w = compare_dets(det_list(msgs[b]), want)
            same &= ok
            n_dets += len(want)
            if np.isfinite(w):
                worst = max(worst, w)
    devices = len(fleet.state.grid.sharding.device_set)
    return dict(streams=n_streams, ticks=n_ticks, dets_equal=bool(same),
                pos_max=worst, n_dets=n_dets, devices=devices)


# ------------------------------------------------------------- phase 5
def step_timing(cfg, lut, dyn, state0, scans, n=30, n_traced=5) -> dict:
    """Steady-state device step: p50 over ``n`` chained steps, each ended by
    block_until_ready; then a profiler trace of ``n_traced`` more steps for
    the device's busy share and kernel count."""
    import jax
    import jax.numpy as jnp

    from vofod_tpu.pipeline.state import ScanInput
    from vofod_tpu.pipeline.step import make_step_fn

    step = make_step_fn(cfg, lut, raycast_mode="sweep",
                        mask=np.ones(cfg.sensor.n_points, np.uint8))
    state = jax.device_put(state0)
    ones = jnp.ones(cfg.sensor.n_points, jnp.float32)
    dev = [ScanInput(ranges_mm=jnp.asarray(r.astype(np.float32)),
                     intensity=ones, pose=jnp.asarray(p)) for r, p in scans]
    d = dyn.as_arrays()
    for i in range(3):
        state, _ = step(state, dev[i % len(dev)], d)
    jax.block_until_ready(state)
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        state, _ = step(state, dev[i % len(dev)], d)
        jax.block_until_ready(state)
        times.append((time.perf_counter() - t0) * 1e3)
    res = dict(step_p50_ms=float(np.percentile(times, 50)),
               step_min_ms=float(np.min(times)), n=n)
    with tempfile.TemporaryDirectory() as tdir:
        with jax.profiler.trace(tdir):
            for i in range(n_traced):
                state, _ = step(state, dev[i % len(dev)], d)
            jax.block_until_ready(state)
        res.update(device_busy(tdir, n_traced))
    return res


def device_busy(trace_dir: str, n_steps: int) -> dict:
    """Device busy time (union of kernel intervals on the GPU planes'
    stream lines), its share of the device window, and kernels per step."""
    import glob

    from jax.profiler import ProfileData

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    spans, lines, n_d2h = [], {}, 0
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = len(evs)
            if "stream" in line.name.lower():
                spans += [(e.start_ns, e.end_ns) for e in evs]
                # device-to-host copies: loop predicates read by the host
                n_d2h += sum("d2h" in e.name.lower() for e in evs)
    if not spans:
        return dict(trace_lines=lines)
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    return dict(device_busy_ms_per_step=busy / 1e6 / n_steps,
                device_window_ms_per_step=window / 1e6 / n_steps,
                device_idle_share=1.0 - busy / window,
                kernels_per_step=len(spans) / n_steps,
                d2h_copies_per_step=n_d2h / n_steps, trace_lines=lines)


# ------------------------------------------------------ four-card phases
def dense_run(cfg, lut, dyn, state_host, scans, raycast_mode):
    """Dense single-card step from a host state; (grid, dets per scan)."""
    import jax

    s, dets = run_step_on(jax.devices()[0], cfg, lut, dyn, state_host, scans,
                          raycast_mode)
    return np.asarray(s.grid), dets


def grid_sharded_check(cfg, lut, dyn, state_host, scans, raycast_mode,
                       zcone_mode, n_grid) -> dict:
    """Z-sharded step over ``n_grid`` cards vs the dense single-card step."""
    import jax
    import jax.numpy as jnp

    from vofod_tpu.parallel.grid_step import (
        make_grid_mesh,
        make_grid_sharded_step,
        shard_state,
    )
    from vofod_tpu.pipeline.state import ScanInput

    mesh = make_grid_mesh(n_grid)
    step = make_grid_sharded_step(cfg, lut, mesh, zcone_mode=zcone_mode,
                                  raycast_mode=raycast_mode)
    state = shard_state(jax.tree.map(jnp.asarray, state_host), mesh)
    d = dyn.as_arrays()
    ones = jnp.ones(cfg.sensor.n_points, jnp.float32)
    dets = []
    for r, p in scans:
        scan = ScanInput(ranges_mm=jnp.asarray(r.astype(np.float32)),
                         intensity=ones, pose=jnp.asarray(p))
        state, out = step(state, scan, d)
        dets.append(dets_from_out(jax.device_get(out.detections)))
    devices = len(state.grid.sharding.device_set)
    g_sh = np.asarray(jax.device_get(state.grid))
    g_dn, d_dn = dense_run(cfg, lut, dyn, state_host, scans, raycast_mode)
    ok_g, mx, mean = grid_delta(g_sh, g_dn)
    cmp = [compare_dets(a, b) for a, b in zip(dets, d_dn)]
    res = dict(mode=raycast_mode, zcone=zcone_mode, devices=devices,
               bit_equal=bool(np.array_equal(g_sh, g_dn)), grid_ok=ok_g,
               grid_max=mx, grid_mean=mean,
               dets_equal=all(c[0] for c in cmp),
               pos_max=max((c[1] for c in cmp), default=0.0))
    if raycast_mode == "exact":
        g_dn2, _ = dense_run(cfg, lut, dyn, state_host, scans, raycast_mode)
        res["dense_bitwise_repeatable"] = bool(np.array_equal(g_dn, g_dn2))
    return res


def fleet_grid_check(cfg, lut, dyn, state_host, scans, n_data, n_grid,
                     n_streams) -> dict:
    """2D streams x grid step vs the dense single-card step per stream."""
    import jax
    import jax.numpy as jnp

    from vofod_tpu.parallel.grid_step import (
        init_fleet_grid_state,
        make_fleet_grid_mesh,
        make_fleet_grid_step,
    )
    from vofod_tpu.pipeline.state import ScanInput

    mesh = make_fleet_grid_mesh(n_data, n_grid)
    step = make_fleet_grid_step(cfg, lut, mesh)
    n = len(scans)
    B = n_streams
    # every stream starts from state_host, laid out like a fresh fleet state
    state = jax.tree.map(
        lambda fresh, h: jax.device_put(
            np.broadcast_to(np.asarray(h), fresh.shape), fresh.sharding),
        init_fleet_grid_state(cfg, dyn, B, mesh), state_host)
    d = dyn.as_arrays()
    n_ticks = min(4, n)
    per_stream = [[] for _ in range(B)]
    for k in range(n_ticks):
        rs = np.stack([scans[(k + b) % n][0] for b in range(B)])
        ps = np.stack([scans[(k + b) % n][1] for b in range(B)])
        sc = ScanInput(ranges_mm=jnp.asarray(rs.astype(np.float32)),
                       intensity=jnp.ones(rs.shape, jnp.float32),
                       pose=jnp.asarray(ps))
        state, out = step(state, sc, d)
        det = jax.device_get(out.detections)
        for b in range(B):
            per_stream[b].append(
                dets_from_out(jax.tree.map(lambda x: x[b], det)))
    devices = len(state.grid.sharding.device_set)
    grids = np.asarray(jax.device_get(state.grid))
    same, worst, gmax, gmean, gok = True, 0.0, 0.0, 0.0, True
    for b in range(B):
        sb = [scans[(k + b) % n] for k in range(n_ticks)]
        g_dn, d_dn = dense_run(cfg, lut, dyn, state_host, sb, "sweep")
        ok, mx, mean = grid_delta(grids[b], g_dn)
        gok &= ok
        gmax, gmean = max(gmax, mx), max(gmean, mean)
        for a, c in zip(per_stream[b], d_dn):
            s, w = compare_dets(a, c)
            same &= s
            worst = max(worst, w)
    return dict(mesh=f"{n_data}x{n_grid}", streams=B, devices=devices,
                grid_ok=bool(gok), grid_max=gmax, grid_mean=gmean,
                dets_equal=bool(same), pos_max=worst)


# ----------------------------------------------------------------- driver
class Phases:
    """Runs named phases, keeping going after a failure."""

    def __init__(self, card: str):
        self.card = card
        self.failed: list[str] = []

    def run(self, name, fn, *a, **kw):
        t0 = time.perf_counter()
        try:
            res = fn(*a, **kw)
        except Exception:  # a phase failure must not hide the later ones
            traceback.print_exc()
            log(f"FAIL {name}")
            self.failed.append(name)
            return None
        log(f"phase {name} [{self.card}] {time.perf_counter() - t0:.1f} s: "
            f"{_fmt(res)}")
        return res

    def require(self, name, cond, detail):
        if cond:
            log(f"ok {name}: {detail}")
        else:
            log(f"FAIL {name}: {detail}")
            self.failed.append(name)


def _fmt(res):
    if isinstance(res, dict):
        return json.dumps({k: v for k, v in res.items()
                           if k not in ("dets", "diag", "walls")},
                          default=lambda x: repr(x))
    return "done" if res is not None else "none"


def one_card(ph: Phases, gpu, cpu) -> None:
    import jax

    cfg, dyn, lut, apriori, make_scan_cycle = flagship()
    from vofod_tpu.io.scan_source import orbit_target_center

    log(f"flagship: sensor {cfg.sensor.vertical_rays}x"
        f"{cfg.sensor.horizontal_rays}, grid {cfg.grid_shape} "
        f"({cfg.n_voxels} voxels)")
    n_scans = 40
    scans = make_scan_cycle(lut, n_scans)
    centers = [orbit_target_center(k, n_scans) for k in range(n_scans)]

    # 3c/3d first: small programs that fail fast if the GPU compiler
    # refuses an op the step also uses
    r = ph.run("gate_vs_float64", gate_check)
    if r:
        ph.require("gate_tolerance", r["ok"],
                   f"row err {r['row_err']:.2e} (<= {ROW_ATOL}), face err "
                   f"{r['face_err']:.2e} (<= {FACE_ATOL})")
    r = ph.run("pca_obb_vs_float64", pca_check)
    if r:
        ph.require("pca_tolerance", r["ok"],
                   f"max err {r['err']:.2e} m (<= {OBB_ATOL})")
    r = ph.run("parity_small_vs_oracle", parity_small_oracle)
    if r:
        ph.require("oracle_detections", not r["mismatched_scans"],
                   f"mismatched scans {r['mismatched_scans']}, "
                   f"pos max {r['pos_max']:.2e} m")

    results = {}
    for fe, rc in (("raw", "sweep"), ("raw", "exact"), ("prebinned", "sweep")):
        name = f"main_{fe}_{rc}"
        res = ph.run(name, run_main_path, cfg, dyn, scans, apriori, fe, rc)
        if res is None:
            continue
        results[(fe, rc)] = res
        errs = check_main_path(res, centers, min_hits=5)
        ph.require(f"{name}_converged_and_detects", not errs,
                   f"bg_sufficient={bool(res['diag'].bg_sufficient)}, target "
                   f"hits {res['target_hits']}/10 last scans; {errs}")
        log(f"timing [{ph.card}] {name}: first scan (compile) "
            f"{res['first_s']:.2f} s, process_scan wall p50 "
            f"{np.percentile(res['walls'], 50):.2f} ms")
    try:
        run_main_path(cfg, dyn, scans[:1], apriori, "prebinned", "exact")
        ph.require("prebinned_exact_refused", False, "no error raised")
    except NotImplementedError as e:
        ph.require("prebinned_exact_refused", True, str(e)[:80])

    recs = ph.run("tools_detect_cli", run_detect_cli,
                  [os.path.join(REPO, c) for c in CONFIGS], scans, apriori)
    if recs is not None and ("raw", "sweep") in results:
        cli = [sorted((dict(id=d["id"], position=np.asarray(d["position"]),
                            n_points=d["n_points"]) for d in r["detections"]),
                      key=lambda x: tuple(x["position"])) for r in recs]
        node = results[("raw", "sweep")]["dets"]
        cmp = [compare_dets(a, b) for a, b in zip(cli, node)]
        ph.require("cli_matches_node", len(cli) == len(node)
                   and all(c[0] for c in cmp),
                   f"{len(cli)} records, target hits "
                   f"{target_hits(cli[-10:], centers[-10:])}/10")

    # from a converged state, so the compared scans carry detections
    warm = ph.run("warm_state", warm_state, cfg, lut, dyn, apriori, scans[:16])
    for rc in ("exact", "sweep"):
        if warm is None:
            break
        r = ph.run(f"parity_gpu_vs_cpu_{rc}", parity_backends, cfg, lut, dyn,
                   warm, scans[16:22], rc, gpu, cpu)
        if r:
            ph.require(f"parity_gpu_vs_cpu_{rc}_tolerance",
                       r["grid_ok"] and r["dets_equal"],
                       f"grid max {r['grid_max']:.3g} mean {r['grid_mean']:.3g}"
                       f", dets equal {r['dets_equal']} ({r['n_dets']}), "
                       f"pos max {r['pos_max']:.2e} m")

    r = ph.run("fleet_one_card", fleet_check, cfg, dyn, apriori, scans,
               n_streams=4, n_ticks=20)
    if r:
        ph.require("fleet_per_stream_equal", r["dets_equal"],
                   f"{r['n_dets']} dets, pos max {r['pos_max']:.2e} m")

    r = ph.run("step_timing", step_timing, cfg, lut, dyn, warm,
               scans[:12]) if warm is not None else None
    if r:
        log(f"timing [{ph.card}] device step (sweep, raw, chained): p50 "
            f"{r['step_p50_ms']:.3f} ms, min {r['step_min_ms']:.3f} ms; "
            f"traced: busy {r.get('device_busy_ms_per_step', 0):.3f} ms/step, "
            f"idle share {r.get('device_idle_share', float('nan')):.3f}, "
            f"{r.get('kernels_per_step', 0):.0f} kernels/step, "
            f"{r.get('d2h_copies_per_step', 0):.0f} device-to-host copies/step")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak device memory [{ph.card}]: "
        f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB")


def four_cards(ph: Phases) -> None:
    import dataclasses

    import jax

    from vofod_tpu.config import Box
    from vofod_tpu.parallel.sharding import make_mesh

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-cards needs 4 cards, found {len(jax.devices())}")
    cfg, dyn, lut, apriori, make_scan_cycle = flagship()
    scans = make_scan_cycle(lut, 24)
    # the flagship area with its height padded to a multiple of 4 planes
    # (25 -> 25.5 m, nz 51 -> 52) so Z splits evenly over 4 and 2 cards;
    # the extra plane sits above the sensor's reach and stays inert.  Every
    # four-card phase uses it, so they share the dense reference compiles.
    bottom = cfg.oparea.offset[2] - cfg.oparea.size[2] / 2.0
    extra = (-cfg.grid_shape[0]) % 4
    size = cfg.oparea.size[:2] + (cfg.oparea.size[2] + extra * cfg.voxel_size,)
    gcfg = dataclasses.replace(cfg, oparea=Box(
        cfg.oparea.offset[:2] + (bottom + size[2] / 2.0,), size))
    log(f"four-card area: grid {gcfg.grid_shape}")

    r = ph.run("fleet_8_streams_4_cards", fleet_check, gcfg, dyn, apriori,
               scans, n_streams=8, n_ticks=20, mesh=make_mesh(4))
    if r:
        ph.require("fleet_4card_sharded", r["devices"] == 4,
                   f"state on {r['devices']} devices")
        ph.require("fleet_4card_equal", r["dets_equal"],
                   f"{r['n_dets']} dets, pos max {r['pos_max']:.2e} m")

    state0 = ph.run("warm_state", warm_state, gcfg, lut, dyn, apriori,
                    scans[:16])
    if state0 is None:
        return
    gscans = scans[16:20]
    for rc, zc in (("exact", "pipelined"), ("sweep", "pipelined"),
                   ("sweep", "transpose")):
        name = f"grid_sharded_{rc}_{zc}"
        r = ph.run(name, grid_sharded_check, gcfg, lut, dyn, state0, gscans,
                   rc, zc, 4)
        if not r:
            continue
        if rc == "exact" and r["dense_bitwise_repeatable"]:
            ok, bound = r["bit_equal"], "bit-equal"
        else:
            ok, bound = r["grid_ok"], f"max <= {GRID_MAX}, mean <= {GRID_MEAN}"
        ph.require(f"{name}_vs_dense", ok and r["dets_equal"]
                   and r["devices"] == 4,
                   f"{bound}: bit_equal {r['bit_equal']}, grid max "
                   f"{r['grid_max']:.3g} mean {r['grid_mean']:.3g}, dets "
                   f"equal {r['dets_equal']}, pos max {r['pos_max']:.2e} m"
                   + (f", dense repeatable {r['dense_bitwise_repeatable']}"
                      if rc == "exact" else ""))

    r = ph.run("fleet_grid_2x2", fleet_grid_check, gcfg, lut, dyn, state0,
               scans[16:], 2, 2, 4)
    if r:
        ph.require("fleet_grid_2x2_vs_dense", r["grid_ok"] and r["dets_equal"]
                   and r["devices"] == 4,
                   f"grid max {r['grid_max']:.3g} mean {r['grid_mean']:.3g}, "
                   f"dets equal {r['dets_equal']}, pos max "
                   f"{r['pos_max']:.2e} m, devices {r['devices']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device phase (needs 4 cards)")
    args = ap.parse_args(argv)

    _keep_host_backend()
    import jax

    from vofod_tpu.runtime.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    hits = []
    jax.monitoring.register_event_listener(
        lambda event, **kw: hits.append(event)
        if event == "/jax/compilation_cache/cache_hits" else None)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"no GPU: JAX's first device is {devs[0].platform!r}")
        return 2
    smi = nvidia_smi()
    cards = parse_nvidia_smi(smi)
    card = f"{cards[0][0]}, {cards[0][1]}"
    log(f"device: {devs[0].device_kind} x{len(devs)}, jax {jax.__version__}")
    print(smi, flush=True)
    log(f"compile cache: {cache_dir}")
    gpu = devs[0]
    cpu = jax.devices("cpu")[0]

    subprocess.run(["make", "-C", os.path.join(REPO, "native")], check=True,
                   capture_output=True, timeout=300)

    ph = Phases(card)
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(ph)
    else:
        one_card(ph, gpu, cpu)
    log(f"timing [{card}] total {time.perf_counter() - t0:.1f} s; "
        f"persistent cache hits: {len(hits)}")
    if ph.failed:
        log(f"FAILED phases: {ph.failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
