"""Raycast tests: exact DDA vs oracle; sweep vs DDA on synthetic scenes."""

import jax.numpy as jnp
import numpy as np
import pytest

from vofod_tpu.geometry import GridSpec
from vofod_tpu.ops.raycast import (
    gate_faces,
    make_angular_gate,
    raycast_dda,
    raycast_sweep,
)
from vofod_tpu.sensor import make_lut_simulation

from oracles import dda_raylen_np, gate_faces_np


class TestDDA:
    def test_matches_oracle_random_rays(self, rng):
        grid = GridSpec(origin=(-2.0, -2.0, -2.0), shape=(10, 12, 14), voxel_size=0.5)
        R = 64
        starts = rng.uniform(-1.0, 1.0, size=(R, 3)).astype(np.float32)
        dirs = rng.normal(size=(R, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        lengths = rng.uniform(0.1, 6.0, size=R).astype(np.float32)
        valid = rng.random(R) < 0.9

        got = np.asarray(
            raycast_dda(
                grid,
                jnp.asarray(starts),
                jnp.asarray(dirs),
                jnp.asarray(lengths),
                jnp.asarray(valid),
                max_length=6.0,
            )
        )
        want = dda_raylen_np(
            grid.shape, grid.origin, 0.5, starts, dirs, lengths, valid
        )
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_ray_length_conservation(self, rng):
        """Sum of chord lengths equals min(ray length, distance to exit)."""
        grid = GridSpec(origin=(0.0, 0.0, 0.0), shape=(16, 16, 16), voxel_size=0.5)
        starts = np.tile(np.array([[4.0, 4.0, 4.0]], np.float32), (32, 1))
        dirs = rng.normal(size=(32, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        lengths = np.full(32, 2.0, np.float32)  # stays inside the 8m box
        got = np.asarray(
            raycast_dda(
                grid,
                jnp.asarray(starts),
                jnp.asarray(dirs),
                jnp.asarray(lengths),
                jnp.ones(32, bool),
                max_length=2.0,
            )
        )
        np.testing.assert_allclose(got.sum(), 32 * 2.0, rtol=1e-4)


class TestSweep:
    def _setup(self):
        # small world, sensor in the middle
        grid = GridSpec(origin=(-8.0, -8.0, -4.0), shape=(16, 32, 32), voxel_size=0.5)
        lut = make_lut_simulation(256, 32, np.deg2rad(90.0))
        origin = np.array([0.0, 0.0, 0.0], np.float32)
        return grid, lut, origin

    def test_transmittance_blocked_behind_wall(self):
        grid, lut, origin = self._setup()
        opaque = np.zeros(grid.shape, bool)
        # wall at x = 2.0 .. 2.5 (ix = 20), spanning all y/z
        opaque[:, :, 20] = True
        raylen = np.asarray(
            raycast_sweep(
                grid,
                jnp.asarray(opaque),
                jnp.asarray(origin),
                jnp.eye(3),
                max_distance=jnp.float32(20.0),
                vertical_fov=np.deg2rad(90.0),
                v_rays=32,
                h_rays=256,
            )
        )
        # free voxel in front of the wall along +x: swept
        assert raylen[8, 16, 18] > 0
        # voxel behind the wall: shadowed
        assert raylen[8, 16, 23] == pytest.approx(0.0, abs=1e-5)
        # other directions unaffected
        assert raylen[8, 16, 8] > 0

    def test_sweep_tracks_dda_off_center_with_blockers(self):
        """Off-center sensor + a blocking box: shadow and totals agree."""
        grid, lut, _ = self._setup()
        origin = np.array([-3.5, 2.5, 1.0], np.float32)
        opaque = np.zeros(grid.shape, bool)
        opaque[4:10, 24:28, 20:24] = True  # box north-east of the sensor
        kw = dict(max_distance=jnp.float32(20.0),
                  vertical_fov=np.deg2rad(90.0), v_rays=32, h_rays=256)
        raylen = np.asarray(raycast_sweep(
            grid, jnp.asarray(opaque), jnp.asarray(origin), jnp.eye(3), **kw))
        # deep-shadow voxel behind the box center (sensor at idx ~(10,21,9)):
        # strongly attenuated vs a lit voxel at similar range (the sweep's
        # bilinear diffusion leaves soft ~1-voxel penumbra edges by design)
        lit = raylen[7, 22, 17]
        shadow = raylen[5, 27, 28]
        assert lit > 0
        assert shadow < 0.05 * lit
        # a rotated sensor frame changes only the density term, not the
        # transmittance topology
        R = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
        raylen_rot = np.asarray(raycast_sweep(
            grid, jnp.asarray(opaque), jnp.asarray(origin), jnp.asarray(R), **kw))
        assert raylen_rot[5, 27, 28] < 0.05 * raylen_rot[7, 22, 17]

    def test_masked_sector_not_cleared(self):
        """A permanently-occluded azimuth sector (FOV mask, no returns) must
        not clear freespace in sweep mode — the reference skips masked
        no-return pixels entirely (vofod_nodelet.cpp:1449-1450).  Exact DDA
        already honors this; before the angular gate the sweep diverged."""
        grid, lut, origin = self._setup()
        H, W = 32, 256
        gate = make_angular_gate(lut)

        # mask out azimuth 45°..90° (sim LUT: az = col * 2π/(W-1))
        yaw_step = 2 * np.pi / (W - 1)
        cols = np.arange(W)
        masked_cols = (cols * yaw_step >= np.deg2rad(45.0)) & (
            cols * yaw_step <= np.deg2rad(90.0)
        )
        mask = np.ones((H, W), bool)
        mask[:, masked_cols] = False

        # scan with no returns anywhere: active = mask | (range > 0) = mask
        active = jnp.asarray(mask)
        faces = gate_faces(gate, active, jnp.eye(3))
        opaque = jnp.zeros(grid.shape, bool)
        kw = dict(max_distance=jnp.float32(20.0),
                  vertical_fov=np.deg2rad(90.0), v_rays=H, h_rays=W)
        gated = np.asarray(raycast_sweep(
            grid, opaque, jnp.asarray(origin), jnp.eye(3), gate=faces, **kw))
        ungated = np.asarray(raycast_sweep(
            grid, opaque, jnp.asarray(origin), jnp.eye(3), **kw))

        # exact DDA with the reference gate: masked no-return rays skipped
        valid = mask.reshape(-1)
        starts = np.tile(origin[None, :], (valid.size, 1)).astype(np.float32)
        lengths = np.full(valid.size, 20.0, np.float32)
        exact = np.asarray(raycast_dda(
            grid, jnp.asarray(starts), jnp.asarray(lut.directions),
            jnp.asarray(lengths), jnp.asarray(valid), max_length=20.0))

        # voxel ~5 m out at az 67.5° (deep inside the masked sector), z level
        # of the sensor: exact mode casts nothing; the gated sweep must agree
        sector = (8, 25, 19)
        assert exact[sector] == 0.0
        assert ungated[sector] > 0.1  # the old behavior: wrongly cleared
        assert gated[sector] < 0.02 * ungated[sector]
        # an unmasked direction (az 180°) is unaffected by the gate
        open_v = (8, 16, 6)
        assert exact[open_v] > 0
        assert gated[open_v] == pytest.approx(ungated[open_v], rel=0.15)

    def test_intensity_gated_sector(self):
        """Pixels below raycast/min_intensity never cast (ref :1449) — the
        active image folds them into the same angular gate."""
        grid, lut, origin = self._setup()
        H, W = 32, 256
        gate = make_angular_gate(lut)
        yaw_step = 2 * np.pi / (W - 1)
        cols = np.arange(W)
        low_int = (cols * yaw_step >= np.deg2rad(225.0)) & (
            cols * yaw_step <= np.deg2rad(315.0)
        )
        intensity = np.where(low_int[None, :], 0.1, 5.0).astype(np.float32)
        min_intensity = 1.0
        active = jnp.asarray(
            np.broadcast_to(intensity >= min_intensity, (H, W))
        )
        faces = gate_faces(gate, active, jnp.eye(3))
        opaque = jnp.zeros(grid.shape, bool)
        kw = dict(max_distance=jnp.float32(20.0),
                  vertical_fov=np.deg2rad(90.0), v_rays=H, h_rays=W)
        gated = np.asarray(raycast_sweep(
            grid, opaque, jnp.asarray(origin), jnp.eye(3), gate=faces, **kw))
        ungated = np.asarray(raycast_sweep(
            grid, opaque, jnp.asarray(origin), jnp.eye(3), **kw))
        # az 270° = -y direction, ~5 m out -> idx y = (-5+8)/0.5 = 6
        assert gated[8, 6, 16] < 0.02 * ungated[8, 6, 16]
        # az 0° untouched
        assert gated[8, 16, 26] == pytest.approx(ungated[8, 16, 26], rel=0.15)

    def test_gate_all_active_matches_ungated(self):
        """With every pixel active the gate reduces to the (more accurate)
        FOV window: inside the FOV the field is unchanged."""
        grid, lut, origin = self._setup()
        gate = make_angular_gate(lut)
        faces = gate_faces(gate, jnp.ones((32, 256), bool), jnp.eye(3))
        opaque = np.zeros(grid.shape, bool)
        opaque[4:10, 24:28, 20:24] = True
        kw = dict(max_distance=jnp.float32(20.0),
                  vertical_fov=np.deg2rad(90.0), v_rays=32, h_rays=256)
        gated = np.asarray(raycast_sweep(
            grid, jnp.asarray(opaque), jnp.asarray(origin), jnp.eye(3),
            gate=faces, **kw))
        ungated = np.asarray(raycast_sweep(
            grid, jnp.asarray(opaque), jnp.asarray(origin), jnp.eye(3), **kw))
        # compare at mid-elevation voxels well inside the FOV
        sel = np.s_[7:10, 4:28, 4:28]
        np.testing.assert_allclose(gated[sel], ungated[sel], rtol=0.1,
                                   atol=1e-4)

    def test_sweep_tracks_dda_in_open_space(self):
        """In an empty scene the sweep field should match the DDA field to
        ~tens of percent (ray-count quantization) wherever ray coverage is
        dense (several rays per voxel)."""
        grid, lut, origin = self._setup()
        opaque = np.zeros(grid.shape, bool)
        raylen_sweep = np.asarray(
            raycast_sweep(
                grid,
                jnp.asarray(opaque),
                jnp.asarray(origin),
                jnp.eye(3),
                max_distance=jnp.float32(20.0),
                vertical_fov=np.deg2rad(90.0),
                v_rays=32,
                h_rays=256,
            )
        )
        dirs = lut.directions
        starts = np.tile(origin[None, :], (dirs.shape[0], 1))
        lengths = np.full(dirs.shape[0], 20.0, np.float32)
        raylen_dda = np.asarray(
            raycast_dda(
                grid,
                jnp.asarray(starts),
                jnp.asarray(dirs),
                jnp.asarray(lengths),
                jnp.ones(dirs.shape[0], bool),
                max_length=20.0,
            )
        )
        # compare on voxels 2-5 m from the sensor, away from cone boundaries
        zz, yy, xx = np.meshgrid(
            np.arange(16), np.arange(32), np.arange(32), indexing="ij"
        )
        cx = (xx + 0.5) * 0.5 - 8.0
        cy = (yy + 0.5) * 0.5 - 8.0
        cz = (zz + 0.5) * 0.5 - 4.0
        d = np.sqrt(cx**2 + cy**2 + cz**2)
        sel = (d > 2.0) & (d < 5.0) & (np.abs(cz) < d * 0.5)
        a, b = raylen_sweep[sel], raylen_dda[sel]
        # aggregate agreement: total swept length within 25%
        assert a.sum() == pytest.approx(b.sum(), rel=0.25)
        # pointwise: most voxels within a factor of 2
        ratio = (a + 1e-3) / (b + 1e-3)
        assert np.mean((ratio > 0.5) & (ratio < 2.0)) > 0.85


@pytest.mark.slow  # two full-frame sweep compiles, ~65 s each (round-4 tiering)
class TestSweepWindow:
    """Static max-distance window around the sensor (raycast_sweep
    max_distance_bound): in-range output must match the full-frame sweep and
    everything outside the window must be zero."""

    def _setup(self, rng, sensor):
        grid = GridSpec(origin=(0.0, 0.0, 0.0), shape=(20, 160, 160),
                        voxel_size=0.5)
        blockers = jnp.asarray(rng.random(grid.shape) < 0.03)
        origin = jnp.asarray(sensor, jnp.float32)
        rot = jnp.eye(3, dtype=jnp.float32)
        kw = dict(max_distance=jnp.float32(10.0),
                  vertical_fov=np.deg2rad(90.0), v_rays=16, h_rays=64)
        return grid, blockers, origin, rot, kw

    @pytest.mark.parametrize("sensor", [(40.0, 40.0, 5.0), (2.0, 78.0, 5.0)])
    def test_windowed_matches_full(self, rng, sensor):
        grid, blockers, origin, rot, kw = self._setup(rng, sensor)
        full = np.asarray(raycast_sweep(grid, blockers, origin, rot, **kw))
        win = np.asarray(
            raycast_sweep(grid, blockers, origin, rot,
                          max_distance_bound=10.0, **kw)
        )
        # identical inside range (window margin covers the tap support; any
        # residual difference is the smoothing tail of blockers outside the
        # window — must be far below the EMA's sensitivity)
        np.testing.assert_allclose(win, full, atol=1e-4)
        # in-range values are present (the window did not clip real signal)
        assert (win > 0).sum() == (full > 0).sum()

    def test_outside_window_zero(self, rng):
        grid, blockers, origin, rot, kw = self._setup(rng, (40.0, 40.0, 5.0))
        win = np.asarray(
            raycast_sweep(grid, blockers, origin, rot,
                          max_distance_bound=10.0, **kw)
        )
        # beyond bound + margin from the sensor, strictly zero
        xs = (np.arange(160) + 0.5) * 0.5 - 40.0
        far_cols = np.abs(xs) > 10.0 + 8 * 0.5 + 0.5
        assert np.all(win[:, :, far_cols] == 0.0)


class TestAngularGateCalibratedLut:
    """The angular gate on CALIBRATED non-uniform beam-altitude tables.

    The row↔elevation map is linear only for sim/uniform LUTs; gradient- or
    gamma-spaced tables (real OS-series options) deviate from the linear fit
    by MULTIPLE pooled bins, so make_angular_gate stores the per-row
    elevation table and gate_faces inverts it exactly.  Pinned here against
    an independent per-texel NumPy oracle across random masks and rotations
    (ref LUT semantics: vofod_nodelet.cpp:358-371)."""

    H, W = 64, 512

    @staticmethod
    def _gradient_lut(H, W):
        from vofod_tpu.sensor import make_lut_ouster

        u = np.linspace(-1.0, 1.0, H)
        # OS0-style gradient: beams densest at the horizon, 90° total FOV
        alt = -45.0 * np.sign(u) * np.abs(u) ** 1.3
        az = 3.0 * np.sin(np.linspace(0, 2 * np.pi, H))  # staggered columns
        return make_lut_ouster(W, H, az, alt, 15.806)

    def test_linear_fit_fails_table_is_stored(self):
        """The motivating measurement: the linear row fit misplaces gradient
        beams by >1 pooled bin, so make_angular_gate must store the table."""
        lut = self._gradient_lut(self.H, self.W)
        gate = make_angular_gate(lut)
        assert gate.el_rows is not None
        el_row = np.arcsin(np.clip(
            lut.directions.reshape(self.H, self.W, 3)[..., 2], -1, 1
        )).mean(axis=1)
        row_lin = (el_row - gate.el_b) / gate.el_a
        err = np.abs(row_lin - np.arange(self.H)).max()
        assert err > gate.pool_v  # the old map was >1 pooled bin off

    def test_sim_lut_keeps_linear_path(self):
        """Uniform tables stay on the (bit-identical) linear map."""
        gate = make_angular_gate(make_lut_simulation(256, 32, np.deg2rad(90)))
        assert gate.el_rows is None
        from vofod_tpu.sensor import make_lut_ouster

        uni = make_lut_ouster(
            512, 64, np.zeros(64), np.linspace(45.0, -45.0, 64), 15.806
        )
        assert make_angular_gate(uni).el_rows is None

    def test_gate_matches_oracle_random_masks_rotations(self):
        """gate_faces == the independent per-texel oracle on a gradient LUT,
        across random active images and sensor rotations."""
        from scipy.spatial.transform import Rotation

        lut = self._gradient_lut(self.H, self.W)
        gate = make_angular_gate(lut)
        rng = np.random.default_rng(7)
        for trial in range(4):
            active = rng.random((self.H, self.W)) < rng.uniform(0.2, 0.9)
            R = Rotation.random(random_state=int(rng.integers(1 << 30))).as_matrix()
            got = np.asarray(
                gate_faces(gate, jnp.asarray(active), jnp.asarray(R, jnp.float32))
            )
            want = gate_faces_np(gate, lut, active, R)
            np.testing.assert_allclose(got, want, atol=3e-3, err_msg=f"trial {trial}")

    def test_row_centers_exact(self):
        """Each beam's own elevation maps back to its own row index (the
        inverse is exact at every row center, not just within a bound)."""
        lut = self._gradient_lut(self.H, self.W)
        gate = make_angular_gate(lut)
        from vofod_tpu.ops.raycast import _row_from_elevation

        el_row = np.arcsin(np.clip(
            lut.directions.reshape(self.H, self.W, 3)[..., 2], -1, 1
        )).mean(axis=1)
        row_f = np.asarray(
            _row_from_elevation(gate, jnp.asarray(el_row, jnp.float32))
        )
        np.testing.assert_allclose(row_f, np.arange(self.H), atol=2e-3)

    def test_gradient_lut_traces_in_sweep_step(self):
        """The exact row-table inverse (rank + one-hot matmul) must trace
        under jit inside the production sweep step, not just eagerly."""
        import jax.numpy as jnp

        from vofod_tpu.config import Box, DynParams, SensorConfig, VoFODConfig
        from vofod_tpu.runtime.node import NodeOptions, VoFOD

        H, W = 16, 64
        u = np.linspace(-1.0, 1.0, H)
        from vofod_tpu.sensor import make_lut_ouster

        lut = make_lut_ouster(
            W, H, np.zeros(H), -45.0 * np.sign(u) * np.abs(u) ** 1.3, 15.806
        )
        cfg = VoFODConfig(
            sensor=SensorConfig(
                vertical_rays=H, horizontal_rays=W,
                vertical_fov=np.deg2rad(90.0),
            ),
            oparea=Box((0.0, 0.0, 5.75), (16.0, 16.0, 11.5)),
            max_clusters=4, max_far_voxels=256, max_queries=32,
            explore_submap=16, confidence_submap=8,
        )
        node = VoFOD(cfg, DynParams(), NodeOptions(raycast_mode="sweep"),
                     lut=lut)
        from vofod_tpu.ops.raycast import make_angular_gate

        assert make_angular_gate(lut).el_rows is not None  # table path live
        rng = np.random.default_rng(2)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = (0.0, 0.0, 6.0)
        for k in range(3):
            r = rng.integers(0, 15000, H * W).astype(np.uint32)
            node.process_scan(r, None, pose, stamp=0.1 * k)
        assert np.isfinite(np.asarray(node.state.grid)).all() or np.isinf(
            np.asarray(node.state.grid)
        ).any()  # stepped without trace errors; grid is defined
