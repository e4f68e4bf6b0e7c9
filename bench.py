#!/usr/bin/env python
"""VoFOD benchmark: full scan->detections steps/sec on the flagship config.

Runs on one NVIDIA GPU and nowhere else: it exits non-zero when JAX finds no
GPU, and every result line names the card (``device_kind``, device count,
and nvidia-smi's name and power limit).

Workload (mirrors BASELINE.md): Ouster OS0-128 scans (128x1024 = 131,072 rays)
against the reference's simulation operation area (120x100x25 m at 0.5 m =>
241x201x51 ~= 2.47M voxel grid), full pipeline per scan: filtering, binning,
clustering, close/far split, EMA point update, classification with bounded
flood-fill, detection extraction, plane-sweep freespace raycast and
separated-background maintenance.

Two numbers matter (the device number alone is not a serving claim):

* ``os128_scans_per_sec_single_chip`` — device throughput: steps chained on
  pre-uploaded scans, host out of the loop.  The DEVICE program's capacity.
* ``sustained_stream_scans_per_sec`` — the end-to-end serving rate: >= 200
  content-varying scans through the real node's async pipeline with PER-SCAN
  host binning, upload and detection readback (the path the reference's
  per-scan delay log covers, vofod_nodelet.cpp:1094-1095), measured for BOTH
  ingest modes; ``ingest_mode_chosen`` is the faster one.

Plus the operational latency artifact: ``latency_p50/p95/p99_ms_at_10hz``
(scan-arrival -> detection-out at the reference's fixed 10 Hz sensor
cadence, single stream) and ``fleet{4,12}_latency_p{50,95,99}_ms``
(per-stream, N scans per tick through the batched fleet step).

The host binner is timed warm and in isolation (p50) AND concurrently inside
the sustained loop (the binner shares the host cores with the dispatch
loop — the concurrent number is the one that applies to serving).

Baseline: the reference's implied real-time requirement of 10 scans/s on the
onboard CPU (BASELINE.md); vs_baseline is the speedup over that.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...}.
"""

import json
import subprocess
import sys
import time

import numpy as np

from vofod_tpu.io.scan_source import apriori_ground, make_scan_cycle


def gpu_device_info() -> dict:
    """The card this run measures; exits non-zero without a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"bench.py measures a GPU; JAX found {devs[0].platform!r}"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "nvidia_smi": smi[0] if smi else "",
    }


def stamp_apriori(cfg, state):
    """Stamp the apriori ground plane into state.grid (works for the dense
    [nz, ny, nx] grid and the fleet's batched [B, nz, ny, nx] grid alike),
    keeping the grid's sharding."""
    import jax

    g = apriori_ground()
    ixs = np.floor(
        (g - np.array(cfg.grid_origin)) / cfg.voxel_size
    ).astype(int)
    nz, ny, nx = cfg.grid_shape
    ixs = ixs[np.all((ixs >= 0) & (ixs < [nx, ny, nz]), axis=1)]
    vals = np.array(jax.device_get(state.grid))
    vals[..., ixs[:, 2], ixs[:, 1], ixs[:, 0]] = np.inf
    return state._replace(grid=jax.device_put(vals, state.grid.sharding))


def measure_sustained(cfg, lut, scans, frontend_mode, n_total=200):
    """End-to-end sustained serving rate through the real node's async
    pipeline (the StreamRunner data path, runtime/stream.py): per-scan host
    bin (prebinned mode), upload, device step and detection readback all
    inside the timed loop.  Returns (scans_per_sec, period_p50_ms,
    concurrent_bin_p50_ms_or_None)."""
    from vofod_tpu.config import DynParams
    from vofod_tpu.runtime.node import NodeOptions, VoFOD

    node = VoFOD(
        cfg,
        DynParams(),
        NodeOptions(raycast_mode="sweep", frontend_mode=frontend_mode),
    )
    node.load_apriori_map(apriori_ground())

    bin_times = []
    if node._binner is not None:
        assert node._binner.native, "native binner required (cd native && make)"
        orig_bin = node._binner.bin

        def timed_bin(*a, **kw):
            t0 = time.perf_counter()
            out = orig_bin(*a, **kw)
            bin_times.append(time.perf_counter() - t0)
            return out

        node._binner.bin = timed_bin

    # warmup: compile + converge to the production steady state
    for k in range(16):
        r, p = scans[k % len(scans)]
        node.process_scan(r, None, p)
    assert node.last_diag is not None and bool(node.last_diag.bg_sufficient), (
        "sustained benchmark must run in the converged regime"
    )
    bin_times.clear()

    periods = []
    pending = None
    t_prev = None
    t0 = time.perf_counter()
    for i in range(n_total):
        r, p = scans[i % len(scans)]
        h = node.process_scan_async(r, None, p)
        if pending is not None:
            node.fetch_result(pending)
            now = time.perf_counter()
            if t_prev is not None:
                periods.append(now - t_prev)
            t_prev = now
        pending = h
    node.fetch_result(pending)
    total = time.perf_counter() - t0

    rate = n_total / total
    p50 = float(np.percentile(np.array(periods) * 1e3, 50))
    bin_p50 = (
        float(np.percentile(np.array(bin_times) * 1e3, 50))
        if bin_times
        else None
    )
    return rate, p50, bin_p50


def measure_latency_at_cadence(cfg, lut, scans, rate_hz=10.0, n_total=80,
                               rounds=3):
    """Scan-arrival -> detection-out latency at a FIXED sensor cadence — the
    reference's operational metric (it logs the per-scan delay at the 10 Hz
    sensor rate, vofod_nodelet.cpp:1094-1095).  Scans "arrive" on a 1/rate_hz
    grid; each is processed synchronously (host work + upload + device step +
    detection readback) and its latency is measured from the SCHEDULED
    arrival, so an overrunning scan honestly charges its lateness to the next
    (queueing, not resetting).  Raw ingest.  Best-of-rounds by p50.
    Returns (p50, p95, p99) ms."""
    from vofod_tpu.config import DynParams
    from vofod_tpu.runtime.node import NodeOptions, VoFOD

    node = VoFOD(
        cfg, DynParams(),
        NodeOptions(raycast_mode="sweep", frontend_mode="raw"),
    )
    node.load_apriori_map(apriori_ground())
    for k in range(16):  # compile + converge
        r, p = scans[k % len(scans)]
        node.process_scan(r, None, p)
    assert node.last_diag is not None and bool(node.last_diag.bg_sufficient), (
        "latency benchmark must run in the converged regime"
    )
    period = 1.0 / rate_hz
    best = None
    for _ in range(rounds):
        lats = []
        t0 = time.perf_counter() + 0.05
        for i in range(n_total):
            t_arr = t0 + i * period
            now = time.perf_counter()
            if now < t_arr:
                time.sleep(t_arr - now)
            r, p = scans[i % len(scans)]
            node.process_scan(r, None, p)  # returns host Detections
            lats.append(time.perf_counter() - t_arr)
        lats = np.array(lats) * 1e3
        if best is None or np.percentile(lats, 50) < np.percentile(best, 50):
            best = lats
    return tuple(float(np.percentile(best, q)) for q in (50, 95, 99))


def measure_fleet_latency_at_cadence(cfg, lut, scans, n_streams, rate_hz=10.0,
                                     n_ticks=80, rounds=3):
    """Per-stream scan-arrival -> detection-out latency for an N-stream fleet
    at the fixed sensor cadence: each tick, N scans arrive together, ride ONE
    stacked upload into the batched step and one fused readback (the
    serve_fleet path), so every stream's latency this tick is the tick
    latency.

    Returns (p50, p95, p99, tick_p50, tick_p95) ms per stream.  tick_p50 is
    the median PROCESSING time of a tick; when it exceeds the cadence period
    the fixed-rate loop falls behind and the latency percentiles measure
    cumulative queueing (seconds, growing with run length) rather than a
    steady state — the honest overload signature; bench main() reports
    ``fleet{N}_cadence_met`` so the artifact is self-describing.  tick_p95
    makes bursts visible: a run can meet the cadence at the median
    (tick_p50 < period) while slow ticks (tick_p95 >> period) build
    transient queues that inflate the latency p95/p99 into seconds — with
    both tick percentiles in the artifact that signature reads directly."""
    import jax
    import jax.numpy as jnp

    from vofod_tpu.config import DynParams
    from vofod_tpu.parallel.sharding import (
        init_batched_state,
        make_batched_step,
        make_mesh,
    )
    from vofod_tpu.pipeline.state import ScanInput

    mesh = make_mesh(1)
    dyn = DynParams().as_arrays()
    bstep = make_batched_step(cfg, lut, mesh, frontend_mode="raw")
    state = stamp_apriori(
        cfg, init_batched_state(cfg, DynParams(), n_streams, mesh)
    )
    ones = jnp.ones((n_streams, cfg.sensor.n_points), jnp.float32)

    def tick_scan(k):
        rs = np.stack(
            [
                scans[(k + i) % len(scans)][0].astype(np.float32)
                for i in range(n_streams)
            ]
        )
        ps = np.stack(
            [scans[(k + i) % len(scans)][1] for i in range(n_streams)]
        )
        return ScanInput(
            ranges_mm=jnp.asarray(rs), intensity=ones, pose=jnp.asarray(ps)
        )

    for k in range(16):  # compile + converge
        state, out = bstep(state, tick_scan(k), dyn)
    jax.block_until_ready(state)
    d = jax.device_get(out.diag)
    assert bool(np.all(d.bg_sufficient)), "fleet latency bench must be converged"

    period = 1.0 / rate_hz
    best = best_ticks = None
    for _ in range(rounds):
        lats, ticks = [], []
        t0 = time.perf_counter() + 0.05
        for k in range(n_ticks):
            t_arr = t0 + k * period
            now = time.perf_counter()
            if now < t_arr:
                time.sleep(t_arr - now)
            t_run = time.perf_counter()
            state, out = bstep(state, tick_scan(k), dyn)
            _ = jax.device_get(out.detections)  # fused per-tick readback
            done = time.perf_counter()
            lats.append(done - t_arr)
            ticks.append(done - t_run)
        lats = np.array(lats) * 1e3
        if best is None or np.percentile(lats, 50) < np.percentile(best, 50):
            best, best_ticks = lats, np.array(ticks) * 1e3
    return tuple(float(np.percentile(best, q)) for q in (50, 95, 99)) + (
        float(np.percentile(best_ticks, 50)),
        float(np.percentile(best_ticks, 95)),
    )


def measure_sustained_fleet(cfg, lut, scans, n_streams, n_ticks=60,
                            with_intensity=False):
    """Sustained MULTI-STREAM serving through one chip: per tick, N raw
    scans ride ONE stacked upload into the stream-DP batched step (the
    serve_fleet path, parallel/sharding.make_batched_step) and one fused
    detection readback, so the per-message host legs are shared by N
    streams.

    ``with_intensity=True`` ships a content-varying per-pixel intensity
    image with every tick instead of the cached all-ones buffer, so the
    ``raycast/min_intensity`` gate path (and its extra 524 KB/stream/tick
    upload) is measured, not substituted away.  Returns
    (aggregate scans/s, period p50 ms)."""
    import jax
    import jax.numpy as jnp

    from vofod_tpu.config import DynParams
    from vofod_tpu.parallel.sharding import (
        init_batched_state,
        make_batched_step,
        make_mesh,
    )
    from vofod_tpu.pipeline.state import ScanInput

    mesh = make_mesh(1)
    dyn = DynParams().as_arrays()
    bstep = make_batched_step(cfg, lut, mesh, frontend_mode="raw")
    state = stamp_apriori(cfg, init_batched_state(cfg, DynParams(), n_streams, mesh))
    ones = jnp.ones((n_streams, cfg.sensor.n_points), jnp.float32)
    intens = None
    if with_intensity:
        # content-varying intensity images with a real sub-threshold
        # population (uniform [0, 2) vs min_intensity=0.5: ~25% of pixels
        # gated per tick), so the gate actually gates.  Kept as HOST arrays
        # and converted inside tick_scan: the point of this mode is that the
        # extra 524 KB/stream/tick ride the timed transport — pre-staging
        # them device-resident would substitute the upload away and
        # overstate the measured rate.
        rng = np.random.default_rng(11)
        intens = [
            rng.uniform(0.0, 2.0, (n_streams, cfg.sensor.n_points))
            .astype(np.float32)
            for _ in range(len(scans))
        ]
        dyn = DynParams(raycast_min_intensity=0.5).as_arrays()

    def tick_scan(k):
        rs = np.stack(
            [
                scans[(k + i) % len(scans)][0].astype(np.float32)
                for i in range(n_streams)
            ]
        )
        ps = np.stack(
            [scans[(k + i) % len(scans)][1] for i in range(n_streams)]
        )
        return ScanInput(
            ranges_mm=jnp.asarray(rs),
            intensity=(
                jnp.asarray(intens[k % len(intens)]) if intens else ones
            ),
            pose=jnp.asarray(ps),
        )

    for k in range(16):  # compile + converge
        state, out = bstep(state, tick_scan(k), dyn)
    jax.block_until_ready(state)
    d = jax.device_get(out.diag)
    assert bool(np.all(d.bg_sufficient)), "fleet bench must be converged"

    # best of 3 rounds, like the device bench
    best_rate, best_p50 = 0.0, float("inf")
    for _ in range(3):
        periods = []
        pending = None
        t_prev = None
        t0 = time.perf_counter()
        for k in range(n_ticks):
            sc = tick_scan(k)
            new_state, out = bstep(state, sc, dyn)
            state = new_state
            if pending is not None:
                _ = jax.device_get(pending)  # fused detections readback
                now = time.perf_counter()
                if t_prev is not None:
                    periods.append(now - t_prev)
                t_prev = now
            pending = out.detections
        _ = jax.device_get(pending)
        total = time.perf_counter() - t0
        rate = n_ticks * n_streams / total
        if rate > best_rate:
            best_rate = rate
            best_p50 = float(np.percentile(np.array(periods) * 1e3, 50))
    return best_rate, best_p50


def main():
    import jax
    import jax.numpy as jnp

    from vofod_tpu.config import DynParams, VoFODConfig
    from vofod_tpu.io.binner import HostBinner
    from vofod_tpu.pipeline.state import ScanInput, init_state
    from vofod_tpu.pipeline.step import make_step_fn
    from vofod_tpu.runtime.compile_cache import enable_compile_cache
    from vofod_tpu.sensor import make_lut

    enable_compile_cache()
    device = gpu_device_info()
    print(f"# card: {device['nvidia_smi']}", file=sys.stderr)

    raw_mode = "--raw" in sys.argv  # legacy on-device-binning path
    n_streams = (
        int(sys.argv[sys.argv.index("--streams") + 1])
        if "--streams" in sys.argv
        else 0
    )  # >0: N independent streams on this chip via the stream-DP scan path
    skip_sustained = "--device-only" in sys.argv
    n_fleet = (
        int(sys.argv[sys.argv.index("--sustained-fleet") + 1])
        if "--sustained-fleet" in sys.argv
        else 0
    )  # >0: sustained N-stream serving (one upload/dispatch/readback per tick)

    if n_fleet:
        from vofod_tpu.config import VoFODConfig as _C

        with_intensity = "--fleet-intensity" in sys.argv
        cfg = _C(sepclusters_every=10)
        lut = make_lut(cfg.sensor)
        cycle = make_scan_cycle(lut, 24)
        rate, p50 = measure_sustained_fleet(
            cfg, lut, cycle, n_fleet, with_intensity=with_intensity
        )
        print(json.dumps({
            "metric": f"sustained_fleet{n_fleet}_scans_per_sec"
            + ("_intensity" if with_intensity else ""),
            "value": round(rate, 2),
            "unit": "scans/s",
            "vs_baseline": round(rate / 10.0, 2),
            "period_p50_ms": round(p50, 2),
            "intensity_gated": with_intensity,
            "device": device,
        }))
        return

    # sepclusters_every=10: the reference runs separated-background
    # maintenance on a FIXED 10 Hz thread regardless of scan rate
    # (vofod_nodelet.cpp:1280-1294, period detection_params.yaml:3), so at
    # 100+ scans/s the faithful schedule is every ~10th scan with
    # its_diff = 10 — the EMA compensation is identical by construction
    # (pipeline/step.py sep_stage).  Running it per scan would be ~10x MORE
    # maintenance than the reference performs per unit time.
    cfg = VoFODConfig(sepclusters_every=10)
    dyn = DynParams().as_arrays()
    lut = make_lut(cfg.sensor)
    step = make_step_fn(
        cfg, lut, raycast_mode="sweep", donate=True,
        frontend_mode="raw" if raw_mode else "prebinned",
    )

    n_scans = 12
    scan_cycle = make_scan_cycle(lut, n_scans)
    scans = list(scan_cycle)

    # production ingest: the host bins each scan (native/frontend.cpp) and
    # the packed count grid rides the upload.  Warm the binner first, then
    # p50-of-many: the cold first calls (page faults, cache fill) are not
    # the per-scan cost (round-3 bench published an unwarmed mean, 6x off)
    host_bin_p50 = None
    if raw_mode:
        scans = [
            ScanInput(
                ranges_mm=jnp.asarray(r.astype(np.float32)),
                intensity=jnp.ones(r.size, jnp.float32),
                pose=jnp.asarray(p),
            )
            for r, p in scans
        ]
    else:
        hb = HostBinner(cfg, lut)
        assert hb.native, "native binner required (cd native && make)"
        for r, p in scan_cycle:  # warm
            hb.bin(r, p)
        times = []
        for _ in range(4):
            for r, p in scan_cycle:
                t0 = time.perf_counter()
                b = hb.bin(r, p)
                times.append(time.perf_counter() - t0)
        host_bin_p50 = float(np.percentile(np.array(times) * 1e3, 50))
        scans = [hb.bin(r, p).to_device() for r, p in scan_cycle]

    state = init_state(cfg)
    state = stamp_apriori(cfg, state)

    if n_streams:
        # stream-DP serving measurement on ONE chip: shard_map over a
        # 1-device mesh, lax.scan over the N local streams — the multi-chip
        # serving path's per-chip program, measured for real (each stream
        # carries its own state; stream i sees scan (k + i) % cycle so no
        # two streams process identical content in a step)
        from vofod_tpu.parallel.sharding import make_batched_step, make_mesh

        mesh = make_mesh(1)
        bstep = make_batched_step(
            cfg, lut, mesh,
            frontend_mode="raw" if raw_mode else "prebinned",
        )
        bstate = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (n_streams,) + x.shape), state
        )
        bscans = [
            jax.tree.map(
                lambda *xs: jnp.stack(xs),
                *[scans[(k + i) % len(scans)] for i in range(n_streams)],
            )
            for k in range(len(scans))
        ]
        for i in range(24):
            bstate, out = bstep(bstate, bscans[i % len(bscans)], dyn)
        jax.block_until_ready(bstate)
        n_iter, n_rounds = 48, 8
        best = float("inf")
        for _ in range(n_rounds):
            t0 = time.perf_counter()
            for i in range(n_iter):
                bstate, out = bstep(bstate, bscans[i % len(bscans)], dyn)
            _ = float(jax.device_get(bstate.grid[0, 0, 0, 0]))
            best = min(best, time.perf_counter() - t0)
        total = n_iter * n_streams / best
        out = {
            "metric": f"os128_scans_per_sec_{n_streams}streams_single_chip",
            "value": round(total, 2),
            "unit": "scans/s",
            "vs_baseline": round(total / 10.0, 2),
            "per_stream": round(total / n_streams, 2),
            "device": device,
        }
        print(json.dumps(out))
        return

    # --- device throughput: steps chained on device-resident scans ----------
    for i in range(24):
        state, out = step(state, scans[i % n_scans], dyn)
    jax.block_until_ready(state)
    d = jax.device_get(out.diag)
    assert bool(d.bg_sufficient), "benchmark must run in the converged regime"

    # several rounds, best wins: the detector is steady-state periodic, so
    # the fastest round is its throughput without host interference
    n_iter, n_rounds = 48, 8
    best = float("inf")
    for _ in range(n_rounds):
        t0 = time.perf_counter()
        for i in range(n_iter):
            state, out = step(state, scans[i % n_scans], dyn)
        # force completion of the whole chain with a host readback
        _ = float(jax.device_get(state.grid[0, 0, 0]))
        best = min(best, time.perf_counter() - t0)
    device_rate = n_iter / best

    out = {
        "metric": "os128_scans_per_sec_single_chip",
        "value": round(device_rate, 2),
        "unit": "scans/s",
        "vs_baseline": round(device_rate / 10.0, 2),
        "device": device,
    }
    if host_bin_p50 is not None:
        out["host_bin_p50_ms"] = round(host_bin_p50, 3)

    # --- sustained end-to-end serving (both ingest modes) -------------------
    if not skip_sustained:
        # a 24-scene cycle so consecutive scans always differ in content AND
        # pose; ~8 passes over it in 200 scans, against an evolving state
        stream_cycle = make_scan_cycle(lut, 24)
        rates = {}
        for mode in ("prebinned", "raw"):
            rate, p50, bin_p50 = measure_sustained(
                cfg, lut, stream_cycle, mode, n_total=200
            )
            rates[mode] = rate
            out[f"sustained_scans_per_sec_{mode}"] = round(rate, 2)
            out[f"sustained_period_p50_ms_{mode}"] = round(p50, 2)
            if bin_p50 is not None:
                out["host_bin_concurrent_p50_ms"] = round(bin_p50, 3)
        chosen = max(rates, key=rates.get)
        out["ingest_mode_chosen"] = chosen
        out["sustained_stream_scans_per_sec"] = round(rates[chosen], 2)
        out["n_sustained"] = 200
        # fleet batching: N scans ride one stacked upload + one dispatch +
        # one fused readback per tick
        frate, fp50 = measure_sustained_fleet(cfg, lut, stream_cycle, 4)
        out["sustained_fleet4_scans_per_sec"] = round(frate, 2)
        out["sustained_fleet4_period_p50_ms"] = round(fp50, 2)

        # --- fixed-cadence latency: the reference's operational metric ------
        # (per-scan delay logged at the 10 Hz sensor cadence,
        # vofod_nodelet.cpp:1094-1095).  Scan-arrival -> detection-out
        # percentiles at 10 Hz, single stream raw ingest and the fleet at
        # N=4 and N=12.
        cadence_hz = 10.0
        p50l, p95l, p99l = measure_latency_at_cadence(
            cfg, lut, stream_cycle, rate_hz=cadence_hz
        )
        out["latency_p50_ms_at_10hz"] = round(p50l, 2)
        out["latency_p95_ms_at_10hz"] = round(p95l, 2)
        out["latency_p99_ms_at_10hz"] = round(p99l, 2)
        for nf in (4, 12):
            fp50l, fp95l, fp99l, ftick, ftick95 = (
                measure_fleet_latency_at_cadence(
                    cfg, lut, stream_cycle, nf, rate_hz=cadence_hz
                )
            )
            out[f"fleet{nf}_latency_p50_ms"] = round(fp50l, 2)
            out[f"fleet{nf}_latency_p95_ms"] = round(fp95l, 2)
            out[f"fleet{nf}_latency_p99_ms"] = round(fp99l, 2)
            out[f"fleet{nf}_tick_p50_ms"] = round(ftick, 2)
            # tick_p95 >> period with tick_p50 < period = congestion BURSTS:
            # transient queues drain, but they own the latency p95/p99
            out[f"fleet{nf}_tick_p95_ms"] = round(ftick95, 2)
            # tick > period means the cadence loop fell behind: the latency
            # percentiles then measure queueing growth, not steady state
            out[f"fleet{nf}_cadence_met"] = bool(ftick < 1e3 / cadence_hz)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
