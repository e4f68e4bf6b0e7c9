"""Scan frontend: range image -> world points -> masks -> count grids.

Replaces the reference's filterAndTransform (vofod_nodelet.cpp:619-686):
CropBox compactions become boolean masks over the fixed H*W lattice (no
dynamic shapes), the SE(3) transform is one fused matmul, and the
VoxelGridWeighted downsample is the dense histogram of ops/binning.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from vofod_tpu.config import VoFODConfig
from vofod_tpu.geometry import GridSpec, box_mask, se3_apply
from vofod_tpu.ops.compaction import masked_compact
from vofod_tpu.parallel.gridops import DENSE
from vofod_tpu.sensor import RANGE_TO_METERS

Array = jnp.ndarray

# capacity for compacted own-airframe returns (a real airframe subtends a
# few thousand pixels at most)
_MAX_EXCLUDE_HITS = 4096


class FrontendOut(NamedTuple):
    counts: Array  # int32 (nz, ny, nx) — filtered weighted downsample
    blockers: Array  # bool (nz, ny, nx) — all returns (raycast opacity),
    #                  including own-airframe hits that truncate rays
    #                  (ref raycast uses raw ranges, vofod_nodelet.cpp:1455)
    n_valid_points: Array  # int32 — points surviving the filters
    n_exclude_hits: Array  # int32 — own-airframe returns (cap overflow check)


def run_frontend(
    cfg: VoFODConfig,
    grid: GridSpec,
    lut_dirs: Array,  # float32 [N, 3] (device-resident constant)
    lut_offs: Array,  # float32 [N, 3]
    ranges_mm: Array,  # [N]
    pose: Array,  # [4, 4]
    ops=DENSE,  # dense-grid op provider (parallel/gridops.py)
) -> FrontendOut:
    r = ranges_mm.astype(jnp.float32) * RANGE_TO_METERS
    has_return = r > 0
    pts_sensor = lut_dirs * r[:, None] + lut_offs

    # exclude-box: own airframe, sensor frame (ref :626-636; CropBox negative)
    in_exclude = box_mask(pts_sensor, cfg.exclude_box.lo, cfg.exclude_box.hi)

    pts_world = se3_apply(pose, pts_sensor)

    # operation-area crop, world frame (ref :644-655; CropBox positive)
    in_oparea = box_mask(pts_world, cfg.oparea.lo, cfg.oparea.hi)

    valid = has_return & ~in_exclude & in_oparea
    counts = ops.bin_points(grid, pts_world, valid)

    # raycast opacity: any return inside the grid (airframe hits included —
    # they truncate rays in the reference too, :1455).  Blockers differ from
    # the filtered counts only by the exclude-box (own airframe) hits, which
    # are few: compact them and scatter the short list instead of paying a
    # second full-scan scatter (~1 ms).  Overflow beyond the cap only
    # over-clears behind the airframe (flagged via n_exclude_hits).
    excl = has_return & in_oparea & in_exclude
    eids, evalid, etotal = masked_compact(excl, _MAX_EXCLUDE_HITS)
    epts = pts_world[eids]
    ix, iy, iz = grid.coord_to_idx(epts)
    fid = grid.flat_id(
        jnp.clip(ix, 0, grid.nx - 1),
        jnp.clip(iy, 0, grid.ny - 1),
        jnp.clip(iz, 0, grid.nz - 1),
    )
    excl_counts = ops.scatter_add(grid, fid, evalid.astype(jnp.int32))
    blockers = (counts > 0) | (excl_counts > 0)
    return FrontendOut(
        counts=counts,
        blockers=blockers,
        n_valid_points=valid.sum().astype(jnp.int32),
        n_exclude_hits=etotal,
    )


def run_frontend_prebinned(
    cfg: VoFODConfig,
    grid: GridSpec,
    scan,  # PrebinnedScan (pipeline/state.py)
    ops=DENSE,
) -> FrontendOut:
    """Device half of the prebinned ingest path (io/binner.py +
    native/frontend.cpp): the host already filtered, transformed and
    histogrammed the scan into a packed dense uint8 grid, so binning
    collapses to a pure elementwise unpack — the 131k-point histogram
    scatter disappears from the device entirely.

    Bit-equivalent to :func:`run_frontend`: the 6-bit count clamp matches
    the EMA's own clamp-at-63 (pipeline/background.py), and the blocker bit
    covers own-airframe hits without the raw path's compaction cap.  Works
    unchanged under the grid-sharded step — ``packed`` arrives as the local
    Z-shard and the unpack is elementwise."""
    counts = (scan.packed & 0x3F).astype(jnp.int32)
    return FrontendOut(
        counts=counts,
        blockers=scan.packed >= 0x80,
        n_valid_points=scan.stats[0],
        n_exclude_hits=scan.stats[1],
    )
