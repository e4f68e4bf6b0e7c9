"""Host-side binning (io/binner.py + native/frontend.cpp) and the prebinned
step path (pipeline/frontend.run_frontend_prebinned).

Three layers:
* native C++ binner vs the NumPy fallback: identical packed grids (the
  fallback is the behavioral oracle);
* host binner vs the device-side run_frontend: identical counts/blocker
  grids (the host bins with the same f32 math — native built with
  -ffp-contract=off so rounding matches XLA);
* prebinned step vs raw step over a scan sequence: identical detections and
  state (the production-serving ingest path is a drop-in).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from vofod_tpu.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu.geometry import GridSpec
from vofod_tpu.io.binner import HostBinner
from vofod_tpu.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu.pipeline.frontend import run_frontend, run_frontend_prebinned
from vofod_tpu.pipeline.state import ScanInput, init_state
from vofod_tpu.pipeline.step import make_step_fn
from vofod_tpu.sensor import make_lut


def small_cfg(**kw):
    d = dict(
        sensor=SensorConfig(
            vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0)
        ),
        oparea=Box((0.0, 0.0, 5.75), (16.0, 16.0, 11.5)),
        background_sufficient_points_ratio=0.05,
        max_clusters=8,
        max_far_voxels=512,
        max_queries=64,
        explore_submap=16,
        confidence_submap=8,
    )
    d.update(kw)
    return VoFODConfig(**d)


def scene_scans(cfg, n=6):
    lut = make_lut(cfg.sensor)
    out = []
    for i in range(n):
        th = 0.3 * i
        pose = hover_pose(
            (1.0 * np.cos(th), 1.0 * np.sin(th), 7.0), yaw=0.12 * i
        )
        scene = Scene(ground_z=0.5)
        scene.add_box((4.5, -5.5, 0.0), (6.5, -3.5, 2.0))
        scene.add_sphere(center=(4.0, 0.4 * np.sin(th), 9.0), radius=0.7)
        out.append((render_scan(scene, lut, pose), pose))
    return lut, out


def as_device(b):
    return b.to_device()


class TestHostBinner:
    def test_native_available(self):
        cfg = small_cfg()
        hb = HostBinner(cfg, make_lut(cfg.sensor))
        assert hb.native, "native binner must be built (cd native && make)"

    def test_native_matches_numpy(self):
        cfg = small_cfg()
        lut, scans = scene_scans(cfg)
        nat = HostBinner(cfg, lut, use_native=True)
        ref = HostBinner(cfg, lut, use_native=False)
        assert nat.native and not ref.native
        for ranges, pose in scans:
            a = nat.bin(ranges, pose)
            b = ref.bin(ranges, pose)
            assert a.n_valid_points == b.n_valid_points
            assert a.n_exclude_hits == b.n_exclude_hits
            np.testing.assert_array_equal(a.packed, b.packed)
            np.testing.assert_array_equal(a.active, b.active)

    @pytest.mark.parametrize("use_native", [True, False])
    def test_matches_device_frontend(self, use_native):
        cfg = small_cfg()
        lut, scans = scene_scans(cfg)
        grid = GridSpec.from_config(cfg)
        hb = HostBinner(cfg, lut, use_native=use_native)
        dirs, offs = jnp.asarray(lut.directions), jnp.asarray(lut.offsets)
        for ranges, pose in scans:
            b = hb.bin(ranges, pose)
            fe_pre = run_frontend_prebinned(cfg, grid, as_device(b))
            fe_raw = run_frontend(
                cfg, grid, dirs, offs,
                jnp.asarray(ranges.astype(np.float32)), jnp.asarray(pose),
            )
            np.testing.assert_array_equal(
                np.asarray(fe_pre.counts),
                np.minimum(np.asarray(fe_raw.counts), 63),  # 6-bit clamp
            )
            np.testing.assert_array_equal(
                np.asarray(fe_pre.blockers), np.asarray(fe_raw.blockers)
            )
            assert int(fe_pre.n_valid_points) == int(fe_raw.n_valid_points)

    def test_count_saturates_at_63(self):
        """Counts clamp to 6 bits — bit-equivalent through the EMA, which
        clamps at 63 itself (pipeline/background.py)."""
        cfg = small_cfg()
        lut, scans = scene_scans(cfg, n=1)
        hb = HostBinner(cfg, lut)
        b = hb.bin(*scans[0])
        counts = b.packed & 0x3F
        assert counts.max() <= 63
        assert (b.packed[counts > 0] >= 0x80).all()  # counted => blocker

    def test_intensity_gate_in_active(self):
        cfg = small_cfg()
        lut, scans = scene_scans(cfg, n=1)
        hb = HostBinner(cfg, lut)
        ranges, pose = scans[0]
        inten = np.ones(ranges.size, np.float32)
        inten[::2] = 0.0
        b = hb.bin(ranges, pose, intensity=inten, min_intensity=0.5)
        assert not b.active[::2].any()

    @pytest.mark.parametrize("use_native", [False, True])
    def test_missing_intensity_matches_raw_step_gate(self, use_native):
        """No intensity channel: the raw step substitutes intensity=ones
        (runtime/node.py), so min_intensity > 1 disables every raycast pixel.
        The host binner must gate identically, not all-pass."""
        cfg = small_cfg()
        lut, scans = scene_scans(cfg, n=1)
        hb = HostBinner(cfg, lut, use_native=use_native)
        if use_native and not hb.native:
            pytest.skip("native binner not built")
        ranges, pose = scans[0]
        assert hb.bin(ranges, pose, min_intensity=2.0).active.sum() == 0
        assert hb.bin(ranges, pose, min_intensity=1.0).active.all()


@pytest.mark.slow  # compiles BOTH full step variants, ~2 min (round-4 tiering)
class TestPrebinnedStep:
    def test_matches_raw_step(self):
        """Full sequence: the prebinned path must be a drop-in for the raw
        path — identical detections, diagnostics and final state."""
        cfg = small_cfg()
        lut, scans = scene_scans(cfg, n=8)
        dyn = DynParams(raycast_weight_coefficient=0.5).as_arrays()
        hb = HostBinner(cfg, lut)

        raw = make_step_fn(cfg, lut, donate=False)
        pre = make_step_fn(cfg, lut, donate=False, frontend_mode="prebinned")

        s_raw = init_state(cfg, DynParams())
        s_raw = s_raw._replace(grid=s_raw.grid.at[1, :, :].set(jnp.inf))
        s_pre = s_raw

        for i, (ranges, pose) in enumerate(scans):
            scan = ScanInput(
                ranges_mm=jnp.asarray(ranges.astype(np.float32)),
                intensity=jnp.ones(ranges.size, jnp.float32),
                pose=jnp.asarray(pose),
            )
            s_raw, o_raw = raw(s_raw, scan, dyn)
            s_pre, o_pre = pre(s_pre, as_device(hb.bin(ranges, pose)), dyn)
            np.testing.assert_array_equal(
                np.asarray(s_pre.grid), np.asarray(s_raw.grid),
                err_msg=f"scan {i}: grid",
            )
            for name in o_raw.detections._fields:
                a = np.asarray(getattr(o_pre.detections, name))
                b = np.asarray(getattr(o_raw.detections, name))
                if a.dtype.kind == "f":
                    # the two programs fuse differently in XLA; float
                    # outputs may differ in the last ulp
                    np.testing.assert_allclose(
                        a, b, rtol=1e-5, atol=1e-7,
                        err_msg=f"scan {i}: detections.{name}",
                    )
                else:
                    np.testing.assert_array_equal(
                        a, b, err_msg=f"scan {i}: detections.{name}"
                    )
            assert int(o_pre.diag.n_occupied) == int(o_raw.diag.n_occupied)
            assert int(o_pre.diag.n_bg_voxels) == int(o_raw.diag.n_bg_voxels)
        # the sequence must actually detect the floating sphere
        assert int(jnp.sum(o_raw.detections.valid)) >= 1

    def test_exact_mode_rejected(self):
        cfg = small_cfg()
        lut = make_lut(cfg.sensor)
        with pytest.raises(NotImplementedError, match="prebinned"):
            make_step_fn(
                cfg, lut, raycast_mode="exact", frontend_mode="prebinned"
            )


class TestIngestProbe:
    """frontend_mode="auto": a startup probe measures both ingests on this
    deployment (io/binner.py probe_ingest_mode) and picks the cheaper."""

    def test_choose_ingest_rule(self):
        from vofod_tpu.io.binner import choose_ingest

        # slow uploads: the 4.7x larger packed grid dominates -> raw
        assert choose_ingest(31.0, 95.0, 1.1, 1.5, 0.1) == "raw"
        # fast uploads: prebinned saves more device time than the host
        # bin costs -> prebinned
        assert choose_ingest(0.05, 0.15, 1.1, 1.5, 0.1) == "prebinned"
        # bin cost exceeding the device saving flips it back
        assert choose_ingest(0.05, 0.15, 2.0, 1.5, 0.1) == "raw"
        # a cheap device histogram leaves nothing to save
        assert choose_ingest(0.05, 0.15, 1.1, 0.2, 0.1) == "raw"

    def test_probe_runs_and_reports(self):
        from vofod_tpu.io.binner import probe_ingest_mode
        from vofod_tpu.sensor import make_lut

        cfg = small_cfg()
        lut = make_lut(cfg.sensor)
        mode, d = probe_ingest_mode(cfg, lut)
        assert mode in ("raw", "prebinned")
        for k in ("t_raw_upload_ms", "t_prebinned_upload_ms",
                  "t_host_bin_ms", "t_raw_device_ms",
                  "t_prebinned_device_ms", "raw_bytes", "prebinned_bytes"):
            assert d[k] > 0, k
        assert d["raw_bytes"] == cfg.sensor.n_points * 4

    def test_node_auto_mode_resolves(self):
        from vofod_tpu.config import DynParams
        from vofod_tpu.runtime.node import NodeOptions, VoFOD

        node = VoFOD(
            small_cfg(), DynParams(),
            NodeOptions(frontend_mode="auto", raycast_mode="sweep"),
        )
        assert node.options.frontend_mode in ("raw", "prebinned")
        assert node.ingest_probe["t_host_bin_ms"] > 0
        # the picked mode actually constructed the matching ingest path
        assert (node._binner is not None) == (
            node.options.frontend_mode == "prebinned"
        )
