#!/usr/bin/env python
"""Per-stage cost attribution by whole-workload ablation.

Each stage's cost is the DELTA between the full content-varying bench step
and the same workload with that stage knocked out:

* raycast  — raycast_mode="off"
* clustering sweeps — cc_sweeps=2 instead of 8 (delta/6 = per-sweep cost;
  sweeps are identical passes)
* explore BFS + K-slot classification — cls_max_size=0 closes the gate, so
  no cluster qualifies and the explore switch takes its empty branch (the
  per-cluster stats/OBB math still runs; only the BFS + demotion is cut)
* sepclusters — amortized (every 10th step), measured by sepclusters_pause

Prints one JSON line with per-stage ms, the full-step ms and the card it ran
on; exits non-zero without a GPU.  `python tools/bench_stages.py` (row:
vofod_nodelet.cpp routines CNC/RAYCASTING/SEPBGCLUSTERS; this is finer —
per-op attribution inside CNC).
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(cfg, lut, scans, dyn, n_iter=48, n_rounds=6, ray_mode="sweep"):
    import jax

    from vofod_tpu.pipeline.step import make_step_fn

    step_fn = make_step_fn(
        cfg, lut, raycast_mode=ray_mode, donate=True,
        frontend_mode="prebinned",
    )
    from bench import stamp_apriori
    from vofod_tpu.pipeline.state import init_state

    state = stamp_apriori(cfg, init_state(cfg))
    for i in range(24):
        state, out = step_fn(state, scans[i % len(scans)], dyn)
    jax.block_until_ready(state)
    best = float("inf")
    for _ in range(n_rounds):
        t0 = time.perf_counter()
        for i in range(n_iter):
            state, out = step_fn(state, scans[i % len(scans)], dyn)
        _ = float(jax.device_get(state.grid[0, 0, 0]))
        best = min(best, time.perf_counter() - t0)
    return best / n_iter * 1e3  # ms/step


def main():
    from bench import gpu_device_info
    from vofod_tpu.config import DynParams, VoFODConfig
    from vofod_tpu.io.binner import HostBinner
    from vofod_tpu.io.scan_source import make_scan_cycle
    from vofod_tpu.runtime.compile_cache import enable_compile_cache
    from vofod_tpu.sensor import make_lut

    enable_compile_cache()
    device = gpu_device_info()

    base = VoFODConfig(sepclusters_every=10)
    lut = make_lut(base.sensor)
    hb = HostBinner(base, lut)
    assert hb.native
    cycle = make_scan_cycle(lut, 12)
    scans = [hb.bin(r, p).to_device() for r, p in cycle]
    dyn = DynParams().as_arrays()

    out = {}
    full = measure(base, lut, scans, dyn)
    out["full_ms"] = round(full, 3)

    t = measure(base, lut, scans, dyn, ray_mode="off")
    out["raycast_ms"] = round(full - t, 3)

    cc2 = dataclasses.replace(base, cc_sweeps=2)
    t = measure(cc2, lut, scans, dyn)
    out["clustering_6sweeps_ms"] = round(full - t, 3)
    out["clustering_per_sweep_ms"] = round((full - t) / 6.0, 4)

    dyn_nogate = dataclasses.replace(
        DynParams(), cls_max_size=0.0
    ).as_arrays()
    t = measure(base, lut, scans, dyn_nogate)
    out["explore_bfs_ms"] = round(full - t, 3)

    dyn_nosep = dataclasses.replace(
        DynParams(), sepclusters_pause=True
    ).as_arrays()
    t = measure(base, lut, scans, dyn_nosep)
    out["sepclusters_amortized_ms"] = round(full - t, 3)

    out["device"] = device
    print(json.dumps(out))


if __name__ == "__main__":
    main()
