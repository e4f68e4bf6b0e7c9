"""Fleet serving CLI — N sensor streams through one SPMD dispatch per tick.

The multi-chip production entry point (DESIGN.md §6 stream data
parallelism): one detector state per stream sharded over the device mesh,
per-stream producer threads feeding native SPSC rings (io/scan_queue.py —
the reference's subscriber-queue back-pressure, vofod_nodelet.cpp:1113-1122),
and a lockstep consumer that pops the freshest frame per stream each tick
and runs the batched step.  On a mesh spanning several hosts, start the SAME
command on every host with ``--coordinator/--num-processes/--process-id``;
each host feeds and reports only its local streams
(runtime/fleet.py runbook).

Multi-host lockstep: ``process_local_scans`` is ONE global SPMD dispatch, so
every host must issue the same number of calls — with ``--coordinator`` the
shared tick budget ``--ticks`` is required, ticks are paced at ``--rate``,
and a host whose rings have no fresh frame re-dispatches each stream's
freshest seen frame rather than skipping (host-local freshness or source
drain must never change the dispatch count, or the fleet deadlocks inside
the mesh collectives pairing mismatched ticks).

``--streams auto`` takes runtime/fleet.py ``pick_stream_knee``: a default
of 32 streams per device that has NOT been measured yet.  Every tick's
scan→detections latency is recorded; ``--json`` emits it per tick and a
final percentile summary (p50/p95/p99) either way — the operator reads off
whether the fleet meets the sensor cadence.

  # single host, one simulated stream per device:
  python -m vofod_tpu.tools.serve_fleet --ticks 50 --sim

  # recordings round-robined across 8 streams:
  python -m vofod_tpu.tools.serve_fleet --streams 8 --scans a.npz,b.npz

  # host 0 of a 4-host slice:
  python -m vofod_tpu.tools.serve_fleet --coordinator head:1234 \\
      --num-processes 4 --process-id 0 --scans ...
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--streams", default="0",
                    help="total stream count (default '0': one per device; "
                    "'auto': the unmeasured default of 32 per device, "
                    "runtime/fleet.py pick_stream_knee)")
    ap.add_argument("--scans", default="",
                    help="comma-separated NPZ recordings, round-robined "
                    "across streams (io.scan_source format)")
    ap.add_argument("--loop", action="store_true",
                    help="cycle recordings forever (rosbag play --loop)")
    ap.add_argument("--sim", action="store_true",
                    help="synthetic scene source (ground + orbiting sphere "
                    "per stream) instead of recordings")
    ap.add_argument("--ticks", type=int, default=0,
                    help="stop after N ticks (0 = run until sources drain "
                    "or Ctrl-C)")
    ap.add_argument("--rate", type=float, default=10.0,
                    help="producer frame rate per stream (Hz)")
    ap.add_argument("--config", default="", help="detection_params.yaml")
    ap.add_argument("--sensor", default="", help="sensors/*.yaml")
    ap.add_argument("--map", dest="map_yaml", default="",
                    help="apriori_maps/*.yaml")
    ap.add_argument("--grid-shards", type=int, default=1,
                    help="Z-shard every stream's grid over this many devices "
                    "(the 2D streams×grid mesh for operation "
                    "areas beyond one device's memory; nz must be "
                    "divisible by it)")
    ap.add_argument("--small-capacities", action="store_true")
    ap.add_argument("--json", action="store_true", help="JSON lines output")
    # multi-host (runtime/fleet.py runbook)
    ap.add_argument("--coordinator", default="",
                    help="head host:port for jax.distributed")
    ap.add_argument("--num-processes", type=int, default=0)
    ap.add_argument("--process-id", type=int, default=-1)
    args = ap.parse_args(argv)

    from vofod_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.coordinator:
        from vofod_tpu.runtime.fleet import initialize_multihost

        initialize_multihost(
            args.coordinator, args.num_processes, args.process_id
        )

    import numpy as np

    from vofod_tpu.config import DynParams, VoFODConfig, load_config
    from vofod_tpu.io.scan_queue import ScanQueue
    from vofod_tpu.io.scan_source import (
        Scene,
        hover_pose,
        load_scans_npz,
        render_scan,
    )
    from vofod_tpu.runtime.fleet import FleetVoFOD

    if args.config or args.sensor or args.map_yaml:
        cfg, dyn = load_config(
            args.config or None, args.sensor or None, args.map_yaml or None
        )
    else:
        cfg, dyn = VoFODConfig(), DynParams()
    if args.small_capacities:
        import dataclasses

        cfg = dataclasses.replace(
            cfg, max_clusters=8, max_far_voxels=512, max_queries=64,
            explore_submap=16, confidence_submap=8,
        )

    import jax

    multihost = jax.process_count() > 1
    if multihost and args.ticks <= 0:
        # checked BEFORE building the fleet: the error is host-local and
        # cheap here; after construction every host is already committed to
        # the global mesh
        ap.error(
            "--ticks is required with --coordinator: each tick is one "
            "global SPMD dispatch, so every host must run the same fixed "
            "number (see module docstring)"
        )

    if args.streams == "auto":
        from vofod_tpu.runtime.fleet import pick_stream_knee

        n_streams = pick_stream_knee(jax.device_count())
        print(
            f"# --streams auto: unmeasured default -> {n_streams} streams",
            file=sys.stderr,
        )
    else:
        n_streams = int(args.streams)

    fleet = FleetVoFOD(
        cfg, dyn, n_streams=n_streams or None,
        grid_shards=args.grid_shards,
    )
    local = fleet.local_streams
    n_pts = cfg.sensor.n_points

    # --- per-local-stream frame sources --------------------------------------
    def npz_frames(path):
        ranges, poses, _, inten = load_scans_npz(path)
        while True:
            for k, (r, p) in enumerate(zip(ranges, poses)):
                yield (
                    np.asarray(r, np.uint32).reshape(-1), p,
                    None if inten is None else inten[k],
                )
            if not args.loop:
                return

    def sim_frames(stream):
        sc = Scene(ground_z=0.0)
        pose = hover_pose((0.0, 0.0, 3.0))
        k = 0
        while True:
            sc.spheres = []
            ang = 0.15 * k + stream
            sc.add_sphere(
                center=(6.0 * np.cos(ang), 6.0 * np.sin(ang), 5.0), radius=0.5
            )
            r = render_scan(sc, fleet.lut, pose)
            yield np.asarray(r, np.uint32).reshape(-1), pose, None
            k += 1

    if args.sim or not args.scans:
        sources = [sim_frames(b) for b in local]
    else:
        paths = args.scans.split(",")
        sources = [npz_frames(paths[i % len(paths)]) for i in range(len(local))]

    queues = [ScanQueue(n_pts, capacity=4) for _ in local]
    done = threading.Event()
    drained = [False] * len(local)

    def producer(i, src, q):
        period = 1.0 / args.rate if args.rate > 0 else 0.0
        for ranges, pose, inten in src:
            if done.is_set():
                return
            q.push(ranges, pose, intensity=inten)
            if period:
                time.sleep(period)
        drained[i] = True

    threads = [
        threading.Thread(target=producer, args=(i, s, q), daemon=True)
        for i, (s, q) in enumerate(zip(sources, queues))
    ]
    for t in threads:
        t.start()

    # --- lockstep consumer: freshest frame per stream each tick --------------
    last = [None] * len(local)
    tick = 0
    t0 = time.time()
    period = 1.0 / args.rate if args.rate > 0 else 0.0
    next_t = time.time()
    lat_ms, period_ms = [], []  # per-tick dispatch latency / inter-tick period
    prev_tick_t = None
    try:
        while args.ticks == 0 or tick < args.ticks:
            fresh = False
            for i, q in enumerate(queues):
                frame = q.pop()
                while frame is not None:  # drain to freshest
                    last[i] = frame
                    fresh = True
                    frame = q.pop()
            if any(f is None for f in last):
                # warm-up: every local stream needs one frame before the
                # first dispatch (the dispatch itself is the cross-host
                # barrier, so a late host just delays the first collective)
                if all(drained):
                    break  # a source drained without ever producing
                time.sleep(0.001)
                continue
            if not multihost and not fresh:
                if all(drained):
                    break  # sources exhausted and rings empty
                time.sleep(0.001)
                continue
            if multihost and period:
                # pace the fixed tick budget at the producer rate; stale
                # rings re-dispatch last — the dispatch COUNT must be
                # host-invariant (module docstring)
                now = time.time()
                if now < next_t:
                    time.sleep(next_t - now)
                next_t = max(next_t + period, time.time())
            ranges = np.stack([f[0] for f in last])
            inten = np.stack([f[1] for f in last])
            poses = np.stack([f[2] for f in last])
            t_tick = time.perf_counter()
            out = fleet.process_local_scans(
                ranges, poses, stamp=time.time(), intensity=inten
            )
            # process_local_scans returns HOST messages, so this spans
            # stacked upload + batched step + fused readback — every
            # stream's scan->detections latency this tick
            lat_ms.append((time.perf_counter() - t_tick) * 1e3)
            if prev_tick_t is not None:
                period_ms.append((t_tick - prev_tick_t) * 1e3)
            prev_tick_t = t_tick
            tick += 1
            if args.json:
                print(json.dumps({
                    "tick": tick,
                    "latency_ms": round(lat_ms[-1], 2),
                    "period_ms": round(period_ms[-1], 2) if period_ms else None,
                }))
            for b, msg in sorted(out.items()):
                for d in msg.detections:
                    rec = {
                        "tick": tick, "stream": b, "id": d.id,
                        "position": list(d.position),
                        "confidence": d.confidence,
                        "detection_probability": d.detection_probability,
                    }
                    if args.json:
                        print(json.dumps(rec))
                    else:
                        print(
                            f"tick {tick:4d} stream {b}: id={d.id} pos="
                            f"({d.position[0]:.2f},{d.position[1]:.2f},"
                            f"{d.position[2]:.2f}) conf={d.confidence:.3f}"
                        )
    except KeyboardInterrupt:
        pass
    finally:
        done.set()
    dt = time.time() - t0
    rate = tick * len(local) / dt if dt > 0 else 0.0
    print(
        f"# {tick} ticks x {len(local)} local streams in {dt:.1f}s "
        f"({rate:.1f} scans/s aggregate)",
        file=sys.stderr,
    )
    if lat_ms:
        # per-stream latency percentiles: each tick is one batched dispatch,
        # so the tick latency IS every stream's latency that tick (skip the
        # compile tick — it would dominate every percentile)
        steady = lat_ms[1:] or lat_ms
        summary = {
            "summary": True,
            "ticks": tick,
            "streams": len(local),
            "latency_p50_ms": round(float(np.percentile(steady, 50)), 2),
            "latency_p95_ms": round(float(np.percentile(steady, 95)), 2),
            "latency_p99_ms": round(float(np.percentile(steady, 99)), 2),
        }
        if period_ms:
            summary["period_p50_ms"] = round(
                float(np.percentile(period_ms[1:] or period_ms, 50)), 2
            )
        line = json.dumps(summary)
        print(line if args.json else f"# {line}",
              file=sys.stdout if args.json else sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
