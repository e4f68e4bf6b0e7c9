"""Compute kernels for the VoFOD pipeline, in plain jax.numpy/lax.

Design rule (DESIGN.md §1): every hot-path op is formulated as dense
stencil/elementwise work over the full grid plus *small* (≤ a few hundred
element) compacted index lists, avoiding large random-access gathers and
scatters; the only full-size scatter kept is the 131k-point voxel binning
histogram.  The rule predates any GPU measurement; its costs are to be
re-measured on the GPU (ROADMAP.md §3.4).
"""

from vofod_tpu.ops.morphology import (
    ball_offsets,
    ball_pool_min,
    ball_pool_max,
    ball_pool_sum,
    dilate6,
    shift3,
)
from vofod_tpu.ops.compaction import masked_compact
from vofod_tpu.ops.binning import bin_points
from vofod_tpu.ops.components import propagate_reach, label_components

__all__ = [
    "ball_offsets",
    "ball_pool_min",
    "ball_pool_max",
    "ball_pool_sum",
    "dilate6",
    "shift3",
    "masked_compact",
    "bin_points",
    "propagate_reach",
    "label_components",
]
