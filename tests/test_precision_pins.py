"""Every f32 matmul whose result is claimed exact or parity-checked runs at
``Precision.HIGHEST``.

At default precision a GPU may evaluate f32 matmuls in TF32 (~10 mantissa
bits).  The CPU backend never does, so CPU parity suites cannot see the
difference; this module pins the precision in the traced program instead,
one case per call site.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from vofod_tpu.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu.geometry import se3_apply, se3_rotate
from vofod_tpu.ops.raycast import _row_from_elevation, gate_faces, make_angular_gate
from vofod_tpu.pipeline.classify import pca_obb
from vofod_tpu.pipeline.state import ScanInput, init_state
from vofod_tpu.pipeline.step import make_step_fn
from vofod_tpu.sensor import make_lut, make_lut_ouster


def _sub_jaxprs(v):
    if hasattr(v, "eqns"):
        yield v
    elif hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
        yield v.jaxpr
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _sub_jaxprs(x)


def _dots(jaxpr):
    """All dot_general equations, nested control flow included."""
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            yield e
        for v in e.params.values():
            for sub in _sub_jaxprs(v):
                yield from _dots(sub)


def _f32_dots(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    return [
        e for e in _dots(jaxpr)
        if all(x.aval.dtype == jnp.float32 for x in e.invars)
    ]


def _is_highest(e):
    p = e.params["precision"]
    ps = p if isinstance(p, tuple) else (p,)
    return all(x == lax.Precision.HIGHEST for x in ps)


def _gradient_lut(H=32, W=64):
    u = np.linspace(-1.0, 1.0, H)
    alt = -45.0 * np.sign(u) * np.abs(u) ** 1.3  # non-uniform beam table
    return make_lut_ouster(W, H, np.zeros(H), alt, 15.806)


def _pose():
    c, s = np.cos(0.3), np.sin(0.3)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    T[:3, 3] = (100.0, -80.0, 5.0)
    return jnp.asarray(T)


def _case_se3_apply():
    return _f32_dots(se3_apply, _pose(), jnp.ones((7, 3), jnp.float32))


def _case_se3_rotate():
    return _f32_dots(se3_rotate, _pose(), jnp.ones((7, 3), jnp.float32))


def _case_classify_stats():
    centers = jnp.ones((16, 3), jnp.float32)
    slot = jnp.zeros((16, 4), bool).at[:, 0].set(True)
    return _f32_dots(pca_obb, centers, slot)


def _case_row_from_elevation():
    gate = make_angular_gate(_gradient_lut())
    assert gate.el_rows is not None  # the calibrated-table branch
    return _f32_dots(
        lambda el: _row_from_elevation(gate, el), jnp.zeros((9,), jnp.float32)
    )


def _case_gate_faces():
    lut = _gradient_lut()
    gate = make_angular_gate(lut)
    active = jnp.ones((lut.height, lut.width), bool)
    return _f32_dots(
        lambda a, r: gate_faces(gate, a, r), active, jnp.eye(3, dtype=jnp.float32)
    )


def _case_exact_dda_ray_setup():
    """The exact-mode step's ray starts/directions ([R, 3] x [3, 3]);
    every f32 contraction over 3 in the step (ray setup and PCA) is pinned."""
    cfg = VoFODConfig(
        sensor=SensorConfig(
            vertical_rays=4, horizontal_rays=8, vertical_fov=np.deg2rad(90.0)
        ),
        oparea=Box((0.0, 0.0, 2.0), (4.0, 4.0, 4.0)),
        max_clusters=2, max_far_voxels=16, max_queries=8,
        explore_fast_queries=(), explore_submap=8, confidence_submap=4,
    )
    lut = make_lut(cfg.sensor)
    dyn = DynParams()
    step = make_step_fn(cfg, lut, raycast_mode="exact", donate=False, jit=False)
    n = cfg.sensor.n_points
    scan = ScanInput(
        ranges_mm=jnp.zeros((n,), jnp.float32),
        intensity=jnp.ones((n,), jnp.float32),
        pose=_pose(),
    )
    dots = _f32_dots(step, init_state(cfg, dyn), scan, dyn.as_arrays())
    dots = [
        e for e in dots
        if [e.invars[0].aval.shape[d] for d in
            e.params["dimension_numbers"][0][0]] == [3]
    ]
    ray_setup = [e for e in dots if e.invars[0].aval.shape == (n, 3)]
    # the frontend's point transform, then the DDA's ray directions and starts
    assert len(ray_setup) == 3
    return dots


@pytest.mark.parametrize(
    "case",
    [
        _case_se3_apply,
        _case_se3_rotate,
        _case_classify_stats,
        _case_row_from_elevation,
        _case_gate_faces,
        _case_exact_dda_ray_setup,
    ],
    ids=lambda f: f.__name__[len("_case_"):],
)
def test_f32_matmuls_pinned_highest(case):
    dots = case()
    assert dots, "call site traced no f32 matmul"
    loose = [str(e) for e in dots if not _is_highest(e)]
    assert not loose, loose
