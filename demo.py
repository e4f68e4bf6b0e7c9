#!/usr/bin/env python
"""End-to-end demo: the reference's Gazebo two-UAV scenario.

Mirrors tmux/simulation/session.yml: one 'observer' UAV hovers with an
OS-128-class sensor while a 'target' UAV flies a circular trajectory through
its field of view; the detector should track it once the confidence map has
warmed up.  Prints per-scan detections and writes marker exports.

Usage: python demo.py [--scans 100] [--markers out_markers.npz]
       [--config configs/detection_params.yaml]
"""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=80)
    ap.add_argument("--markers", type=str, default="")
    ap.add_argument("--config", type=str, default="")
    ap.add_argument("--sensor", type=str, default="")
    ap.add_argument("--small", action="store_true", help="small grid (CPU-friendly)")
    ap.add_argument("--profile", default="", help="jax.profiler trace dir (the valgrind profile:=true analogue)")
    args = ap.parse_args()

    from vofod_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()

    from vofod_tpu.config import Box, DynParams, SensorConfig, VoFODConfig, load_config
    from vofod_tpu.io.scan_source import Scene, hover_pose, render_scan
    from vofod_tpu.runtime.node import NodeOptions, VoFOD
    from vofod_tpu.runtime.viz import (
        border_marker,
        cluster_obb_markers,
        save_markers_npz,
        voxel_markers,
    )

    if args.config:
        cfg, dyn = load_config(args.config, args.sensor or None)
    elif args.small:
        cfg = VoFODConfig(
            sensor=SensorConfig(vertical_rays=32, horizontal_rays=256),
            oparea=Box((0.0, 0.0, 4.0), (40.0, 40.0, 20.0)),
            background_sufficient_points_ratio=0.05,
        )
        dyn = DynParams()
    else:
        cfg, dyn = VoFODConfig(), DynParams()

    node = VoFOD(cfg, dyn, NodeOptions(raycast_mode="sweep"))

    # apriori map covering the whole operation-area ground — the reference
    # simulation loads a full static world cloud the same way
    # (config/apriori_maps/sim.yaml + tmux/simulation)
    cx, cy, _ = cfg.oparea.offset
    lo, hi = cfg.oparea.lo, cfg.oparea.hi
    gx, gy = np.meshgrid(
        np.arange(lo[0] + 0.25, hi[0], 0.5), np.arange(lo[1] + 0.25, hi[1], 0.5)
    )
    ground_z = cfg.oparea.lo[2] + 0.25
    patch = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, ground_z)], axis=1)
    print(f"apriori voxels stamped: {node.load_apriori_map(patch)}")

    observer = np.array([cx, cy, ground_z + 4.0])
    pose = hover_pose(observer)

    from vofod_tpu.runtime.profiling import trace

    t0 = time.time()
    n_det = 0
    profile_ctx = trace(args.profile or None)
    profile_ctx.__enter__()
    for i in range(args.scans):
        # target orbits the observer at 10 m radius, 4 m above ground
        ang = 0.08 * i
        target = observer + np.array(
            [10.0 * np.cos(ang), 10.0 * np.sin(ang), 2.0]
        )
        scene = Scene(ground_z=ground_z)
        scene.add_sphere(center=target, radius=0.4)
        ranges = render_scan(scene, node.lut, pose)
        msg = node.process_scan(ranges, None, pose, stamp=i * 0.1)
        if msg.detections:
            n_det += len(msg.detections)
            d = msg.detections[0]
            err = np.linalg.norm(np.array(d.position) - target)
            print(
                f"scan {i:3d}: id={d.id} pos=({d.position[0]:.2f},"
                f"{d.position[1]:.2f},{d.position[2]:.2f}) err={err:.2f} m"
                f" conf={d.confidence:.3f} pdet={d.detection_probability:.3f}"
            )
    profile_ctx.__exit__(None, None, None)
    dt = time.time() - t0
    diag = node.last_diag
    print(
        f"\n{args.scans} scans in {dt:.1f}s ({args.scans / dt:.1f} scans/s), "
        f"{n_det} detections; bg={int(diag.n_bg_voxels)} "
        f"active={bool(diag.bg_sufficient and diag.sure_bg_sufficient)}"
    )

    if args.markers:
        vals = np.asarray(node.state.grid)
        markers = [
            voxel_markers(
                vals,
                node.grid_spec,
                [
                    (float(dyn.thr_new_obstacles), (0, 0, 1, 0.6)),
                    (float(dyn.thr_sure_obstacles), (0, 1, 0, 0.8)),
                    (float(dyn.thr_apriori), (1, 0, 0, 1.0)),
                ],
            ),
            border_marker(node.grid_spec),
        ]
        save_markers_npz(args.markers, markers)
        print(f"markers written to {args.markers}")


if __name__ == "__main__":
    main()
