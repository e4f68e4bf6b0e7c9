"""Detector CLI — the detect.launch analogue.

Runs the detector over an NPZ scan recording (or the built-in simulator),
with reference-format YAML configs, optional apriori map (.pts/.txt),
optional FOV mask, and optional marker/state outputs.

  python -m vofod_tpu.tools.detect --scans recording.npz \
      --config configs/detection_params.yaml \
      --sensor configs/sensors/os0-128.yaml \
      --map configs/apriori_maps/sim.yaml \
      --apriori-cloud world.pts --mask mask.npy \
      --save-state map.npz --markers markers.npz
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--scans",
        help="NPZ recording (io.scan_source format), or a .bag (converted "
        "on the fly via tools.bag_to_npz — the `rosbag play` analogue)",
    )
    ap.add_argument(
        "--pointcloud-topic",
        default="/os_cloud_node/points",
        help="for --scans *.bag: the PointCloud2 topic to read",
    )
    ap.add_argument(
        "--metadata",
        default="",
        help="for --scans *.bag: Ouster metadata JSON (destagger shifts)",
    )
    ap.add_argument("--config", default="", help="detection_params.yaml")
    ap.add_argument("--sensor", default="", help="sensors/*.yaml")
    ap.add_argument("--map", dest="map_yaml", default="", help="apriori_maps/*.yaml")
    ap.add_argument("--apriori-cloud", default="", help=".pts/.txt static cloud")
    ap.add_argument("--mask", default="", help="FOV mask (.npy/.png)")
    ap.add_argument("--mask-mangle", action="store_true")
    ap.add_argument("--raycast", default="sweep", choices=["sweep", "exact", "off"])
    ap.add_argument(
        "--frontend",
        default="raw",
        choices=["raw", "prebinned", "auto"],
        help="prebinned = the host bins each scan (native/frontend.cpp; "
        "sweep raycast only); auto = time both ingests once at startup "
        "and pick the cheaper (io/binner.py probe_ingest_mode)",
    )
    ap.add_argument(
        "--small-capacities",
        action="store_true",
        help="shrink the compile-shaping static capacities (cluster/query/"
        "submap slots) for small sensors/grids — faster compile, CPU-sized",
    )
    ap.add_argument(
        "--save-state", default="",
        help="write the final map (*.npz = host NPZ; any other path = "
        "Orbax checkpoint dir, runtime/checkpoint.py)",
    )
    ap.add_argument(
        "--load-state", default="",
        help="resume from a map snapshot (NPZ or Orbax dir)",
    )
    ap.add_argument("--markers", default="", help="write final markers NPZ")
    ap.add_argument(
        "--viz-config", default="",
        help="visualization.yaml (reference format) for marker colors; "
        "defaults to the reference palette",
    )
    ap.add_argument("--json", action="store_true", help="JSON lines output")
    ap.add_argument(
        "--watch-params", default="",
        help="detection_params YAML polled before every scan; edits apply "
        "live without recompiling (the dynamic_reconfigure analogue, "
        "runtime/param_watch.py)",
    )
    args = ap.parse_args(argv)

    from vofod_tpu.config import DynParams, VoFODConfig, load_config
    from vofod_tpu.runtime.compile_cache import enable_compile_cache
    from vofod_tpu.runtime.node import NodeOptions, VoFOD

    enable_compile_cache()
    if args.config or args.sensor or args.map_yaml:
        # every file is optional in load_config — honor --sensor/--map even
        # without a detection_params.yaml
        cfg, dyn = load_config(
            args.config or None, args.sensor or None, args.map_yaml or None
        )
    else:
        cfg, dyn = VoFODConfig(), DynParams()
    if args.small_capacities:
        import dataclasses

        cfg = dataclasses.replace(
            cfg,
            max_clusters=8,
            max_far_voxels=512,
            max_queries=64,
            explore_submap=16,
            confidence_submap=8,
        )

    node = VoFOD(
        cfg,
        dyn,
        NodeOptions(
            raycast_mode=args.raycast,
            mask_path=args.mask,
            mask_mangle=args.mask_mangle,
            frontend_mode=args.frontend,
            throttle_period=cfg.throttle_period,
        ),
    )
    if args.load_state:
        node.load_snapshot(args.load_state)
    if args.apriori_cloud:
        from vofod_tpu.io.pc_loader import load_cloud

        n = node.load_apriori_map(load_cloud(args.apriori_cloud))
        print(f"# apriori voxels stamped: {n}", file=sys.stderr)

    if not args.scans:
        ap.error("--scans is required (record one with io.scan_source)")
    scans_path = args.scans
    tmp_npz = None  # bag-conversion scratch file, removed after replay
    if scans_path.endswith(".bag"):
        # the reference consumes recorded flights via `rosbag play`
        # (launch/detect.launch:8-10); here the bag converts in place and
        # replays through the same NPZ path
        import tempfile

        from vofod_tpu.tools.bag_to_npz import convert_bag

        tmp = tempfile.NamedTemporaryFile(suffix=".npz", delete=False)
        tmp.close()
        n = convert_bag(
            scans_path,
            tmp.name,
            pointcloud_topic=args.pointcloud_topic,
            metadata_json=args.metadata or None,
            do_destagger=bool(args.metadata),
        )
        print(f"# converted {n} scans from {scans_path}", file=sys.stderr)
        scans_path = tmp_npz = tmp.name
    before_scan = None
    if args.watch_params:
        from vofod_tpu.runtime.param_watch import ParamWatcher

        watcher = ParamWatcher(node, args.watch_params)
        watcher.poll()  # the watched file is authoritative from scan 0
        before_scan = lambda k: watcher.poll()
    try:
        msgs = node.replay(scans_path, before_scan=before_scan)
    finally:
        if tmp_npz is not None:
            import contextlib
            import os

            with contextlib.suppress(OSError):
                os.unlink(tmp_npz)
    for m in msgs:
        if args.json:
            print(
                json.dumps(
                    {
                        "stamp": m.header.stamp,
                        "detections": [
                            {
                                "id": d.id,
                                "position": d.position,
                                "confidence": d.confidence,
                                "n_points": d.n_points,
                                "detection_probability": d.detection_probability,
                            }
                            for d in m.detections
                        ],
                    }
                )
            )
        elif m.detections:
            for d in m.detections:
                print(
                    f"t={m.header.stamp:.2f} id={d.id} pos="
                    f"({d.position[0]:.2f},{d.position[1]:.2f},{d.position[2]:.2f})"
                    f" conf={d.confidence:.3f} pdet={d.detection_probability:.3f}"
                )

    d = node.last_diag
    print(
        f"# {len(msgs)} scans; bg={int(d.n_bg_voxels)} "
        f"active={bool(d.bg_sufficient and d.sure_bg_sufficient)}",
        file=sys.stderr,
    )
    if args.save_state:
        node.save_snapshot(args.save_state)
    if args.markers:
        import numpy as np

        from vofod_tpu.runtime.viz import (
            border_marker,
            frontier_markers,
            load_viz_config,
            save_markers_npz,
            voxel_markers,
        )

        viz = load_viz_config(args.viz_config or None)
        vals = np.asarray(node.state.grid)
        save_markers_npz(
            args.markers,
            [
                voxel_markers(vals, node.grid_spec, viz.vmap_thresholds(node.dyn)),
                frontier_markers(
                    vals,
                    node.grid_spec,
                    float(node.dyn.thr_frontiers),
                    float(node.dyn.thr_new_obstacles),
                    color=viz.vmap["frontiers"],
                ),
                border_marker(node.grid_spec),
            ],
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
