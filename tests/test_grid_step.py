"""Grid-sharded full step (parallel/grid_step.py) vs the unsharded step.

The Z-sharded step must be a drop-in for oversized operation areas, so these
tests assert BIT-FOR-BIT equality of the state grids on the virtual 8-device
CPU mesh — the halo/merge/pipeline constructions feed every grid element the
same operands in the same order as the dense ops.  Detection FLOAT outputs
(confidence etc.) are compared to the last ulp instead: the sharded and
unsharded programs fuse the small per-cluster reductions differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from vofod_tpu.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu.ops.compaction import masked_compact
from vofod_tpu.ops.raycast import raycast_sweep
from vofod_tpu.parallel.grid_step import (
    make_grid_mesh,
    make_grid_sharded_step,
    shard_state,
)
from vofod_tpu.parallel.gridops import ZShardOps
from vofod_tpu.pipeline.state import ScanInput, init_state
from vofod_tpu.pipeline.step import make_step_fn
from vofod_tpu.sensor import make_lut


def sharded_config(**kw):
    """Tiny flagship-shaped config with nz = 32 (divisible by 8 shards):
    oparea z size 15.5 -> ceil(15.5/0.5)+1 = 32 planes, shard height 4."""
    d = dict(
        sensor=SensorConfig(
            vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0)
        ),
        oparea=Box((0.0, 0.0, 7.75), (16.0, 16.0, 15.5)),
        background_sufficient_points_ratio=0.05,
        max_clusters=8,
        max_far_voxels=512,
        max_queries=64,
        explore_submap=16,  # halo 8 > shard height 4: exercises multi-hop
        confidence_submap=8,
    )
    d.update(kw)
    return VoFODConfig(**d)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return make_grid_mesh(8)


class TestShardedPrimitives:
    # transpose mode: ny=33 doesn't divide 8 shards, so the pinned-pad-row
    # path is exercised; bound=5.0 adds the windowed crop on top
    @pytest.mark.parametrize(
        "zcone_mode,bound",
        [("pipelined", None), ("transpose", None), ("transpose", 5.0)],
    )
    def test_sweep_zsharded_matches(self, rng, mesh, zcone_mode, bound):
        cfg = sharded_config()
        from vofod_tpu.geometry import GridSpec

        grid = GridSpec.from_config(cfg)
        blockers = jnp.asarray(rng.random(grid.shape) < 0.03)
        origin = jnp.asarray([1.0, -2.0, 9.0], jnp.float32)
        rot = jnp.eye(3, dtype=jnp.float32)
        kw = dict(
            max_distance=jnp.float32(bound if bound is not None else 20.0),
            vertical_fov=cfg.sensor.vertical_fov,
            v_rays=cfg.sensor.vertical_rays,
            h_rays=cfg.sensor.horizontal_rays,
            max_distance_bound=bound,
        )
        want = raycast_sweep(grid, blockers, origin, rot, **kw)

        ops = ZShardOps("grid", 8, zcone_mode=zcone_mode)

        def body(b):
            return ops.raycast_sweep(grid, b, origin, rot, **kw)

        got = shard_map(
            body,
            mesh=mesh,
            in_specs=(P("grid", None, None),),
            out_specs=P("grid", None, None),
            check_vma=False,
        )(blockers)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_bad_zcone_mode_raises(self):
        with pytest.raises(ValueError, match="zcone_mode"):
            ZShardOps("grid", 8, zcone_mode="bogus")

    def test_compact_merge_matches(self, rng, mesh):
        mask = jnp.asarray(rng.random((32, 12, 12)) < 0.05)
        want = masked_compact(mask, 64)
        ops = ZShardOps("grid", 8)
        got = shard_map(
            lambda m: ops.compact(m, 64),
            mesh=mesh,
            in_specs=(P("grid", None, None),),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )(mask)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))

    @pytest.mark.parametrize("r", [1, 2, 5, 8])
    def test_halo_fold_min_cross_shard(self, mesh, r):
        """Min-writes stamped into halo copies must fold back onto the owner
        from BOTH directions, for every hop count and for overlapping
        head/tail ranges (r >= shard_height/2 — the regime where the round-2
        ``.set()`` fold silently dropped the next-shard contribution).

        Every shard stamps value 50-i over its whole halo-extended view, so
        the oracle at global row z is min(orig, 50 - max{i : shard i sees z})
        — the winning stamp always comes from the next-side direction."""
        nz, ny, nx = 32, 4, 4
        n = 8
        nzl = nz // n
        g = (
            jnp.arange(nz * ny * nx, dtype=jnp.float32).reshape(nz, ny, nx)
            + 100.0
        )
        ops = ZShardOps("grid", n)

        def body(local):
            ext = ops.halo_exchange(local, r, jnp.float32(jnp.inf))
            idx = jax.lax.axis_index("grid")
            ext = jnp.minimum(ext, 50.0 - idx.astype(jnp.float32))
            return ops.halo_fold_min(ext, r)

        got = shard_map(
            body,
            mesh=mesh,
            in_specs=(P("grid", None, None),),
            out_specs=P("grid", None, None),
            check_vma=False,
        )(g)

        want = np.asarray(g).copy()
        for i in range(n):
            z0 = i * nzl
            lo, hi = max(0, z0 - r), min(nz, z0 + nzl + r)
            want[lo:hi] = np.minimum(want[lo:hi], 50.0 - i)
        np.testing.assert_array_equal(np.asarray(got), want)

    def test_demote_spans_shard_boundaries(self, rng, mesh):
        """ZShardOps.demote vs DenseOps.demote when the demotion submap
        (S=16, halo 8 > shard height 4) covers rows owned by shards up to
        two hops away on BOTH sides of the query's owner — the fold path the
        round-2 full-step test never reached (its reached-set degenerated to
        the query voxel)."""
        from vofod_tpu.parallel.gridops import DENSE

        nz, ny, nx = 32, 16, 16
        S, pad = 16, 8
        vals = jnp.asarray(
            rng.uniform(0.5, 1.5, (nz, ny, nx)).astype(np.float32)
        )
        # three queries: two demoting with z-spans crossing 4-5 shards,
        # one non-demoting (its patch must be a no-op)
        q = np.array([[8, 7, 20], [7, 9, 6], [8, 8, 27]], np.int32)  # x,y,z
        corners = jnp.asarray(
            np.stack([q[:, 2] - pad, q[:, 1] - pad, q[:, 0] - pad], 1)
        )
        reached = jnp.asarray(rng.random((3, S, S, S)) < 0.3)
        demote = jnp.asarray([True, True, False])
        thr = jnp.float32(0.25)

        want = DENSE.demote(vals, reached, corners, demote, thr)

        ops = ZShardOps("grid", 8)
        got = shard_map(
            lambda v: ops.demote(v, reached, corners, demote, thr),
            mesh=mesh,
            in_specs=(P("grid", None, None),),
            out_specs=P("grid", None, None),
            check_vma=False,
        )(vals)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        # sanity: the demotions really did land outside the owners' shards
        diff_rows = np.unique(
            np.nonzero(np.asarray(got) != np.asarray(vals))[0] // 4
        )
        assert len(diff_rows) >= 4

    def test_compact_overflow_prefix(self, rng, mesh):
        """When total > capacity the merged list must equal the global first-
        capacity ids (each shard's contribution to any global prefix is a
        prefix of its own list)."""
        mask = jnp.asarray(rng.random((32, 12, 12)) < 0.4)
        want = masked_compact(mask, 32)
        ops = ZShardOps("grid", 8)
        got = shard_map(
            lambda m: ops.compact(m, 32),
            mesh=mesh,
            in_specs=(P("grid", None, None),),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )(mask)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


class TestGridShardedStep:
    def _scan(self, cfg, lut, scene, pose):
        ranges = render_scan(scene, lut, pose)
        return ScanInput(
            ranges_mm=jnp.asarray(ranges.astype(np.float32)),
            intensity=jnp.ones(ranges.size, jnp.float32),
            pose=jnp.asarray(pose),
        )

    def test_bitexact_vs_unsharded(self, mesh):
        """Full pipeline sequence (background build-up, then a floating
        target) — sharded and unsharded steps must agree bit-for-bit on
        state, detections and diagnostics at every step."""
        cfg = sharded_config()
        # fast raycast clearing (live-tunable param) so the floating check
        # resolves within a short sequence
        dyn = DynParams(raycast_weight_coefficient=0.5)
        lut = make_lut(cfg.sensor)
        pose = hover_pose((0.0, 0.0, 6.0))

        ground = Scene(ground_z=0.5)
        target = Scene(ground_z=0.5)
        target.add_sphere(center=(4.0, 0.0, 9.0), radius=0.7)
        scans = [self._scan(cfg, lut, ground, pose)] * 4 + [
            self._scan(cfg, lut, target, pose)
        ] * 3

        ref_step = make_step_fn(cfg, lut, donate=False)
        ref_state = init_state(cfg, dyn)
        # apriori ground plane (the detector bootstraps from an apriori map
        # exactly like the reference, node.load_apriori_map)
        ref_state = ref_state._replace(
            grid=ref_state.grid.at[1, :, :].set(0.0)
        )

        sh_step = make_grid_sharded_step(cfg, lut, mesh)
        sh_state = shard_state(ref_state, mesh)

        for i, scan in enumerate(scans):
            ref_state, ref_out = ref_step(ref_state, scan, dyn.as_arrays())
            sh_state, sh_out = sh_step(sh_state, scan, dyn.as_arrays())
            for name, a, b in [
                ("grid", ref_state.grid, sh_state.grid),
                ("safe", ref_state.safe, sh_state.safe),
            ]:
                np.testing.assert_array_equal(
                    np.asarray(b), np.asarray(a),
                    err_msg=f"step {i}: state.{name} diverged",
                )
            for name in ref_out.detections._fields:
                a = np.asarray(getattr(sh_out.detections, name))
                b = np.asarray(getattr(ref_out.detections, name))
                if a.dtype.kind == "f":
                    # sharded/unsharded programs fuse differently; float
                    # outputs may differ in the last ulp
                    np.testing.assert_allclose(
                        a, b, rtol=1e-5, atol=1e-7,
                        err_msg=f"step {i}: detections.{name} diverged",
                    )
                else:
                    np.testing.assert_array_equal(
                        a, b, err_msg=f"step {i}: detections.{name} diverged"
                    )
            for name in ref_out.diag._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(sh_out.diag, name)),
                    np.asarray(getattr(ref_out.diag, name)),
                    err_msg=f"step {i}: diag.{name} diverged",
                )
        # the run must actually exercise detection: the target is found
        assert int(jnp.sum(ref_out.detections.valid)) >= 1
        # and the state really is sharded over all 8 devices
        assert len(sh_state.grid.sharding.device_set) == 8

    def test_prebinned_bitexact_vs_unsharded(self, mesh):
        """The prebinned ingest path under the grid-sharded step: the packed
        host-binned grid shards along Z; results must match the unsharded
        prebinned step bit-for-bit."""
        from jax.sharding import NamedSharding

        from vofod_tpu.io.binner import HostBinner

        cfg = sharded_config()
        dyn = DynParams(raycast_weight_coefficient=0.5)
        lut = make_lut(cfg.sensor)
        hb = HostBinner(cfg, lut)
        pose = hover_pose((0.0, 0.0, 6.0))
        ground = Scene(ground_z=0.5)
        target = Scene(ground_z=0.5)
        target.add_sphere(center=(4.0, 0.0, 9.0), radius=0.7)
        scenes = [ground] * 3 + [target] * 2

        ref_step = make_step_fn(
            cfg, lut, donate=False, frontend_mode="prebinned"
        )
        ref_state = init_state(cfg, dyn)
        ref_state = ref_state._replace(grid=ref_state.grid.at[1].set(0.0))
        sh_step = make_grid_sharded_step(
            cfg, lut, mesh, frontend_mode="prebinned"
        )
        sh_state = shard_state(ref_state, mesh)
        pspec = NamedSharding(mesh, P("grid", None, None))

        for i, scene in enumerate(scenes):
            b = hb.bin(render_scan(scene, lut, pose), pose)
            scan = b.to_device()
            sh_scan = scan._replace(
                packed=jax.device_put(scan.packed, pspec)
            )
            ref_state, ref_out = ref_step(ref_state, scan, dyn.as_arrays())
            sh_state, sh_out = sh_step(sh_state, sh_scan, dyn.as_arrays())
            np.testing.assert_array_equal(
                np.asarray(sh_state.grid), np.asarray(ref_state.grid),
                err_msg=f"scan {i}: grid diverged",
            )
            for name in ref_out.detections._fields:
                a = np.asarray(getattr(sh_out.detections, name))
                b2 = np.asarray(getattr(ref_out.detections, name))
                if a.dtype.kind == "f":
                    # sharded/unsharded programs fuse differently; float
                    # outputs may differ in the last ulp
                    np.testing.assert_allclose(
                        a, b2, rtol=1e-5, atol=1e-7,
                        err_msg=f"scan {i}: detections.{name}",
                    )
                else:
                    np.testing.assert_array_equal(
                        a, b2, err_msg=f"scan {i}: detections.{name}"
                    )
        assert int(jnp.sum(ref_out.detections.valid)) >= 1

    def test_indivisible_nz_raises(self, mesh):
        cfg = sharded_config(oparea=Box((0.0, 0.0, 7.5), (16.0, 16.0, 15.0)))
        lut = make_lut(cfg.sensor)
        with pytest.raises(ValueError, match="divisible"):
            make_grid_sharded_step(cfg, lut, mesh)

    def test_exact_modes_bitexact_vs_unsharded(self, mesh):
        """Both reference-exact modes under grid sharding (round-2 verdict
        item 7): exact DDA raycast (replicated walk, ownership-filtered
        scatter) and exact-census sepclusters (halo'd coarse labeling +
        psum'd census) must match the unsharded exact step bit-for-bit, so
        parity studies can run beyond one device's memory."""
        cfg = sharded_config(sepclusters_exact_census=True)
        dyn = DynParams(raycast_weight_coefficient=0.5)
        lut = make_lut(cfg.sensor)
        pose = hover_pose((0.0, 0.0, 6.0))
        ground = Scene(ground_z=0.5)
        target = Scene(ground_z=0.5)
        target.add_sphere(center=(4.0, 0.0, 9.0), radius=0.7)
        scans = [self._scan(cfg, lut, ground, pose)] * 4 + [
            self._scan(cfg, lut, target, pose)
        ] * 2

        ref_step = make_step_fn(
            cfg, lut, donate=False, raycast_mode="exact"
        )
        ref_state = init_state(cfg, dyn)
        ref_state = ref_state._replace(grid=ref_state.grid.at[1].set(0.0))
        sh_step = make_grid_sharded_step(
            cfg, lut, mesh, raycast_mode="exact"
        )
        sh_state = shard_state(ref_state, mesh)

        for i, scan in enumerate(scans):
            ref_state, ref_out = ref_step(ref_state, scan, dyn.as_arrays())
            sh_state, sh_out = sh_step(sh_state, scan, dyn.as_arrays())
            np.testing.assert_array_equal(
                np.asarray(sh_state.grid), np.asarray(ref_state.grid),
                err_msg=f"step {i}: grid diverged",
            )
            np.testing.assert_array_equal(
                np.asarray(sh_state.safe), np.asarray(ref_state.safe),
                err_msg=f"step {i}: safe diverged",
            )
            for name in ref_out.detections._fields:
                a = np.asarray(getattr(sh_out.detections, name))
                b = np.asarray(getattr(ref_out.detections, name))
                if a.dtype.kind == "f":
                    np.testing.assert_allclose(
                        a, b, rtol=1e-5, atol=1e-7,
                        err_msg=f"step {i}: detections.{name}",
                    )
                else:
                    np.testing.assert_array_equal(
                        a, b, err_msg=f"step {i}: detections.{name}"
                    )
        assert int(jnp.sum(ref_out.detections.valid)) >= 1

    def test_sequential_explore_bitexact_vs_unsharded(self, mesh):
        """cfg.sequential_explore (the round-4 demotion-coupling parity
        instrument, pipeline/classify.py) composes with grid sharding: the
        lax.scan of single-query BFS dispatches runs inside shard_map — the
        per-query psum'd connected verdict and the halo-folded per-failure
        demotions are replicated, so every shard branches in lockstep — and
        must match the dense sequential step bit-for-bit through a sequence
        with real explore failures and demotions (a floating target)."""
        cfg = sharded_config(sequential_explore=True)
        dyn = DynParams(raycast_weight_coefficient=0.5)
        lut = make_lut(cfg.sensor)
        pose = hover_pose((0.0, 0.0, 6.0))
        ground = Scene(ground_z=0.5)
        target = Scene(ground_z=0.5)
        target.add_sphere(center=(4.0, 0.0, 9.0), radius=0.7)
        scans = [self._scan(cfg, lut, ground, pose)] * 4 + [
            self._scan(cfg, lut, target, pose)
        ] * 3

        ref_step = make_step_fn(cfg, lut, donate=False)
        ref_state = init_state(cfg, dyn)
        ref_state = ref_state._replace(grid=ref_state.grid.at[1].set(0.0))
        sh_step = make_grid_sharded_step(cfg, lut, mesh)
        sh_state = shard_state(ref_state, mesh)

        n_det = 0
        for i, scan in enumerate(scans):
            ref_state, ref_out = ref_step(ref_state, scan, dyn.as_arrays())
            sh_state, sh_out = sh_step(sh_state, scan, dyn.as_arrays())
            np.testing.assert_array_equal(
                np.asarray(sh_state.grid), np.asarray(ref_state.grid),
                err_msg=f"step {i}: grid diverged (demotions?)",
            )
            np.testing.assert_array_equal(
                np.asarray(sh_out.detections.valid),
                np.asarray(ref_out.detections.valid),
                err_msg=f"step {i}: detections diverged",
            )
            n_det += int(jnp.sum(ref_out.detections.valid))
        assert n_det >= 1  # the target was classified (explore really ran)

    def test_dynamic_radii_bitexact_vs_dense(self, mesh):
        """cfg.dynamic_radii composes with the grid-sharded step: the traced
        pools halo at the STATIC bound and gate taps by the traced r², so
        changing both stencil radii between steps (a) matches the dense
        dynamic-radii step bit-for-bit on the state grids and (b) reuses the
        one compiled sharded executable (no retrace)."""
        import dataclasses

        cfg = sharded_config(
            dynamic_radii=True,
            ground_points_max_distance_bound=2.0,
            sepclusters_max_bg_distance_bound=2.0,
        )
        lut = make_lut(cfg.sensor)
        pose = hover_pose((0.0, 0.0, 6.0))
        ground = Scene(ground_z=0.5)
        target = Scene(ground_z=0.5)
        target.add_sphere(center=(4.0, 0.0, 9.0), radius=0.7)
        scans = [self._scan(cfg, lut, ground, pose)] * 3 + [
            self._scan(cfg, lut, target, pose)
        ] * 3
        radii = [(1.5, 0.8), (1.5, 0.8), (1.0, 1.4), (2.0, 1.9),
                 (1.5, 0.8), (1.0, 1.9)]

        base = DynParams(raycast_weight_coefficient=0.5)
        ref_step = make_step_fn(cfg, lut, donate=False)
        ref_state = init_state(cfg, base)
        ref_state = ref_state._replace(grid=ref_state.grid.at[1].set(0.0))
        sh_step = make_grid_sharded_step(cfg, lut, mesh)
        sh_state = shard_state(ref_state, mesh)

        for i, (scan, (g, s)) in enumerate(zip(scans, radii)):
            dyn = dataclasses.replace(
                base,
                ground_points_max_distance=g,
                sepclusters_max_bg_distance=s,
            )
            ref_state, ref_out = ref_step(ref_state, scan, dyn.as_arrays())
            sh_state, sh_out = sh_step(sh_state, scan, dyn.as_arrays())
            np.testing.assert_array_equal(
                np.asarray(sh_state.grid), np.asarray(ref_state.grid),
                err_msg=f"step {i} (radii {g}, {s}): grid diverged",
            )
            np.testing.assert_array_equal(
                np.asarray(sh_state.safe), np.asarray(ref_state.safe),
                err_msg=f"step {i} (radii {g}, {s}): safe diverged",
            )
            assert int(sh_out.diag.n_far) == int(ref_out.diag.n_far), i
        assert sh_step._cache_size() == 1
        assert int(jnp.sum(ref_out.detections.valid)) >= 1

    @pytest.mark.parametrize("lsz", [1, 2])
    def test_quirk_census_sharded_matches(self, rng, mesh, lsz):
        """The counted-indexing quirk census composes with Z-sharding:
        global export ranks from gathered block sums + psum-merged rank
        table must reproduce the unsharded quirk bit-for-bit."""
        from vofod_tpu.pipeline.sepclusters import (
            _quirk_sure_counts,
            _quirk_sure_counts_sharded,
        )

        bg = jnp.asarray(rng.random((32, 9, 11)) < 0.3)
        sure = jnp.asarray(rng.random((32, 9, 11)) < 0.5) & bg
        want = _quirk_sure_counts(bg, sure, lsz)
        got = shard_map(
            lambda b, s: _quirk_sure_counts_sharded(b, s, lsz, "grid", 8),
            mesh=mesh,
            in_specs=(P("grid", None, None), P("grid", None, None)),
            out_specs=P("grid", None, None),
            check_vma=False,
        )(bg, sure)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
