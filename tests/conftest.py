"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests exercise the same sharded code paths that run across several GPUs
(`python chip_smoke.py --four-cards` runs them on real cards).  The CPU is
forced through both the environment and jax.config before any backend is
instantiated, so every pytest-xdist worker stays off the GPU: one JAX
process per card is all a card can hold.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# entry points under test (tools.detect, serve_fleet) turn on the persistent
# compilation cache; tests neither read nor write one
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.default_backend() == "cpu", "tests must run on the virtual CPU mesh"


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


# --- test tiers --------------------------------------------------------------
# Every test gets exactly one of the markers quick/slow/soak (registered in
# pyproject.toml).  `pytest -m quick` is the CI-quick pass (kernel oracles +
# one parity scenario, <10 min on the 1-CPU box); `-m "not soak"` is the
# pre-commit pass; plain `pytest tests/` runs everything.  Modules are the
# tier unit because the cost is compile-dominated and shared per module.

SOAK_MODULES = {"test_soak"}
SLOW_MODULES = {
    # whole-pipeline oracle replays / randomized fuzz (minutes per scenario)
    "test_pipeline_parity",
    "test_pipeline_parity_border",
    "test_pipeline_parity_fuzz",
    "test_pipeline_parity_gated",
    "test_pipeline_parity_multi",
    "test_pipeline_parity_rangefinder",
    "test_sequential_demotion",
    "test_staged_step",
    # sharded whole-step compiles (8-device shard_map programs)
    "test_grid_step",
    "test_fleet",
    "test_fleet_grid",
    # many independent step compiles
    "test_scenarios",
    "test_dynamic_radii",
    "test_determinism",
    "test_stream",
    "test_profiling_markers",
    "test_regression",
    "test_checkpoint",
    "test_ros_node",
    "test_cli_tools",
    # 8-device shard_map compiles + whole-step comparisons (measured round 4:
    # these five were ~80% of a 37-min "quick" pass)
    "test_sharding",
    "test_pipeline",
    "test_classify_fuzz",
    "test_param_watch",
    "test_rosbag_ingest",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        # explicit in-file slow/soak markers win over the module rule
        if item.get_closest_marker("slow") or item.get_closest_marker("soak"):
            continue
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in SOAK_MODULES:
            item.add_marker(pytest.mark.soak)
        elif mod in SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.quick)


def pytest_configure(config):
    """Build the native library if missing (the .so is not committed)."""
    import pathlib
    import subprocess

    native = pathlib.Path(__file__).resolve().parent.parent / "native"
    if not (native / "libvofod_native.so").exists():
        try:
            subprocess.run(["make", "-C", str(native)], check=True, timeout=120)
        except Exception as e:  # tests using the lib will fall back / fail loudly
            print(f"[conftest] native build failed: {e}")
