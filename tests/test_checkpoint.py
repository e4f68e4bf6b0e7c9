"""Orbax checkpoint/resume (runtime/checkpoint.py).

The reference has no map persistence (SURVEY.md §5); the framework closes
that two ways — host NPZ for the single-chip node, and sharding-preserving
Orbax checkpoints for everything (single-chip AND the Z-sharded state on
the 8-device mesh, where shards must restore straight onto their devices
without a host gather)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from vofod_tpu.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu.pipeline.state import init_state
from vofod_tpu.runtime.checkpoint import (
    AsyncSaver,
    SnapshotManager,
    restore_state,
    save_state,
)


def tiny_cfg():
    return VoFODConfig(
        sensor=SensorConfig(
            vertical_rays=8, horizontal_rays=32, vertical_fov=np.deg2rad(90.0)
        ),
        oparea=Box((0.0, 0.0, 7.75), (16.0, 16.0, 15.5)),  # nz=32: 8-shardable
        max_clusters=4,
        max_far_voxels=128,
        max_queries=32,
        explore_submap=8,
        confidence_submap=8,
    )


def scribble(state, seed=0):
    """Distinct recognizable content in every leaf."""
    rng = np.random.default_rng(seed)
    return state._replace(
        grid=jnp.asarray(rng.normal(size=state.grid.shape).astype(np.float32)),
        safe=jnp.asarray(rng.random(state.safe.shape) > 0.5),
        det_counter=jnp.int32(7),
        step=jnp.int32(42),
        sure_bg_sufficient=jnp.bool_(True),
        bg_sufficient=jnp.bool_(True),
    )


def assert_state_equal(a, b):
    for name in a._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, name)),
            np.asarray(getattr(b, name)),
            err_msg=name,
        )


class TestSaveRestore:
    def test_roundtrip_bitexact(self, tmp_path):
        cfg = tiny_cfg()
        state = scribble(init_state(cfg))
        p = str(tmp_path / "ckpt")
        save_state(p, state)
        got = restore_state(p, init_state(cfg))
        assert_state_equal(got, state)

    def test_overwrite(self, tmp_path):
        cfg = tiny_cfg()
        p = str(tmp_path / "ckpt")
        save_state(p, scribble(init_state(cfg), seed=1))
        second = scribble(init_state(cfg), seed=2)
        save_state(p, second)  # overwrite=True default
        assert_state_equal(restore_state(p, init_state(cfg)), second)

    def test_sharded_roundtrip_preserves_sharding(self, tmp_path):
        """Z-sharded state over the 8-device mesh: restore lands every leaf
        on the placement of the restore target (no host-gathered grid)."""
        from vofod_tpu.parallel.grid_step import make_grid_mesh, shard_state

        assert len(jax.devices()) == 8
        mesh = make_grid_mesh(8)
        cfg = tiny_cfg()
        state = shard_state(scribble(init_state(cfg)), mesh)
        assert len(state.grid.sharding.device_set) == 8
        p = str(tmp_path / "sharded_ckpt")
        save_state(p, state)

        like = shard_state(init_state(cfg), mesh)
        got = restore_state(p, like)
        assert_state_equal(got, state)
        assert got.grid.sharding == NamedSharding(mesh, P("grid", None, None))
        assert len(got.grid.sharding.device_set) == 8

    def test_cross_placement_restore(self, tmp_path):
        """A checkpoint saved unsharded restores onto the mesh, and vice
        versa — resume is placement-agnostic (scale up/down between runs)."""
        from vofod_tpu.parallel.grid_step import make_grid_mesh, shard_state

        mesh = make_grid_mesh(8)
        cfg = tiny_cfg()
        dense = scribble(init_state(cfg))
        p = str(tmp_path / "dense_ckpt")
        save_state(p, dense)
        onto_mesh = restore_state(p, shard_state(init_state(cfg), mesh))
        assert_state_equal(onto_mesh, dense)
        assert len(onto_mesh.grid.sharding.device_set) == 8

        p2 = str(tmp_path / "sharded_ckpt")
        save_state(p2, onto_mesh)
        back = restore_state(p2, init_state(cfg))
        assert_state_equal(back, dense)

    def test_fleet_grid_2d_roundtrip(self, tmp_path):
        """The 2D streams×grid fleet state (batch over "data", grid Z over
        "grid") checkpoints and restores with both sharding axes intact —
        resume works for the multi-host fleet shape too."""
        from vofod_tpu.parallel.grid_step import (
            _fleet_state_specs,
            init_fleet_grid_state,
            make_fleet_grid_mesh,
        )

        mesh = make_fleet_grid_mesh(2, 4)
        cfg = tiny_cfg()
        B = 2
        state = init_fleet_grid_state(cfg, DynParams(), B, mesh)
        rng = np.random.default_rng(3)
        content = rng.normal(size=state.grid.shape).astype(np.float32)
        state = state._replace(
            grid=jax.device_put(
                jnp.asarray(content), state.grid.sharding
            ),
            step=jnp.full((B,), 9, jnp.int32),
        )
        p = str(tmp_path / "fleet2d_ckpt")
        save_state(p, state)
        like = init_fleet_grid_state(cfg, DynParams(), B, mesh)
        got = restore_state(p, like)
        assert_state_equal(got, state)
        specs = _fleet_state_specs("data", "grid")
        assert got.grid.sharding == NamedSharding(mesh, specs.grid)
        assert got.step.sharding == NamedSharding(mesh, specs.step)
        assert len(got.grid.sharding.device_set) == 8


class TestAsyncSaver:
    def test_async_save_then_restore(self, tmp_path):
        cfg = tiny_cfg()
        state = scribble(init_state(cfg))
        p = str(tmp_path / "async_ckpt")
        with AsyncSaver() as saver:
            saver.save(p, state)
            saver.wait()
            got = restore_state(p, init_state(cfg))
        assert_state_equal(got, state)


class TestSnapshotManager:
    def test_rolling_keep_last_k(self, tmp_path):
        cfg = tiny_cfg()
        states = {k: scribble(init_state(cfg), seed=k) for k in (1, 2, 3)}
        with SnapshotManager(str(tmp_path / "mgr"), max_to_keep=2) as mgr:
            for k, s in states.items():
                mgr.save(k, s)
            mgr._mgr.wait_until_finished()
            assert mgr.latest_step() == 3
            got = mgr.restore(init_state(cfg))  # latest by default
            assert_state_equal(got, states[3])
            got2 = mgr.restore(init_state(cfg), step=2)
            assert_state_equal(got2, states[2])
            # step 1 was pruned (max_to_keep=2)
            with pytest.raises(Exception):
                mgr.restore(init_state(cfg), step=1)

    def test_empty_directory_raises(self, tmp_path):
        with SnapshotManager(str(tmp_path / "empty")) as mgr:
            with pytest.raises(FileNotFoundError):
                mgr.restore(init_state(tiny_cfg()))


class TestNodeIntegration:
    def test_node_orbax_snapshot(self, tmp_path):
        """VoFOD.save_snapshot: non-.npz paths go through Orbax; resume
        restores the scan counter too."""
        from vofod_tpu.runtime.node import VoFOD

        cfg = tiny_cfg()
        node = VoFOD(cfg, DynParams())
        node.state = scribble(node.state)
        p = str(tmp_path / "node_ckpt")
        node.save_snapshot(p)

        fresh = VoFOD(cfg, DynParams())
        fresh.load_snapshot(p)
        assert_state_equal(fresh.state, node.state)
        assert fresh._host_step == 42
