"""vofod_tpu — volumetric flying-object detection framework in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of ctu-mrs/vofod
(LiDAR-based detection of flying objects via a probabilistic
occupancy-confidence voxel map; see /root/reference, README.md:3-5).

The reference is a mutable-object C++ ROS nodelet; this framework is a single
pure function ``step(state, scan, pose) -> (state, detections)`` jitted
end-to-end on one accelerator, with the voxel grids as donated
device-resident state.
"""

from vofod_tpu.config import VoFODConfig, DynParams, load_config
from vofod_tpu.geometry import GridSpec
from vofod_tpu.pipeline.state import VoFODState, init_state
from vofod_tpu.pipeline.step import make_step_fn
from vofod_tpu.runtime.node import VoFOD

__version__ = "0.1.0"

__all__ = [
    "VoFODConfig",
    "DynParams",
    "load_config",
    "GridSpec",
    "VoFODState",
    "init_state",
    "make_step_fn",
    "VoFOD",
]
