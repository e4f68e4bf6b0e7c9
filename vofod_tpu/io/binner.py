"""Host-side scan binning: the prebinned ingest path's CPU half.

Bins each organized scan on the host (native C++ kernel, native/frontend.cpp)
into a packed dense uint8 count grid — low 6 bits = filtered point count
clamped to 63 (bit-equivalent through the EMA: pipeline/background.py clamps
at 63 anyway), bit 7 = any-return blocker flag — so the device-side frontend
collapses to a pure elementwise unpack (pipeline/frontend.py
run_frontend_prebinned).  This removes the 131k-point histogram scatter from
the device step entirely: the one op XLA cannot reshape (serialized
~8 ns/update, DESIGN.md §1, measured ~1.5 ms of the ~4.9 ms step).

The reference performs the same filter+transform+downsample work on the CPU
(vofod_nodelet.cpp:619-686 filterAndTransform + voxel_grid_weighted.cpp);
here it becomes part of data loading and overlaps the device step in the
stream runner.

A NumPy fallback implements identical semantics when the native library is
not built (and serves as its oracle in tests/test_binner.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from vofod_tpu.config import VoFODConfig
from vofod_tpu.io.pc_loader import _native_lib
from vofod_tpu.sensor import XyzLut


def _binner_lib():
    lib = _native_lib()
    if lib is None or not hasattr(lib, "vofod_binner_create"):
        return None
    if getattr(lib, "_binner_sigs", False):
        return lib
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.vofod_binner_create.restype = ctypes.c_void_p
    lib.vofod_binner_create.argtypes = [
        f32p, f32p, ctypes.c_longlong, u8p,
        f32p, f32p, f32p, f32p, f32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
    ]
    lib.vofod_binner_destroy.restype = None
    lib.vofod_binner_destroy.argtypes = [ctypes.c_void_p]
    lib.vofod_binner_bin_dense.restype = None
    lib.vofod_binner_bin_dense.argtypes = [
        ctypes.c_void_p, u32p, f32p, f32p, ctypes.c_float,
        u8p, u8p, i32p,
    ]
    lib._binner_sigs = True
    return lib


@dataclass
class BinnedScan:
    """One host-binned scan (numpy; see pipeline/state.PrebinnedScan for the
    device-side pytree)."""

    packed: np.ndarray  # uint8 (nz, ny, nx): count & 0x3f | blocker << 7
    active: np.ndarray  # uint8 [N] per-pixel raycast gate mask
    pose: np.ndarray  # float32 [4, 4]
    n_valid_points: int
    n_exclude_hits: int

    def to_device(self):
        """The device-side ``pipeline.state.PrebinnedScan`` pytree (stats
        packed as one int32 pair — single upload).  For a grid-sharded step,
        ``_replace(packed=jax.device_put(scan.packed, <P(axis,None,None)>))``
        afterwards."""
        import jax.numpy as jnp

        from vofod_tpu.pipeline.state import PrebinnedScan

        return PrebinnedScan(
            packed=jnp.asarray(self.packed),
            active=jnp.asarray(self.active),
            pose=jnp.asarray(self.pose),
            stats=jnp.asarray(
                np.array([self.n_valid_points, self.n_exclude_hits], np.int32)
            ),
        )


class HostBinner:
    """Per-sensor host binner bound to a (config, LUT, mask) triple."""

    def __init__(
        self,
        cfg: VoFODConfig,
        lut: XyzLut,
        mask: np.ndarray | None = None,
        use_native: bool = True,
    ):
        self.cfg = cfg
        self.dirs = np.ascontiguousarray(lut.directions, np.float32)
        self.offs = np.ascontiguousarray(lut.offsets, np.float32)
        self.n = self.dirs.shape[0]
        self.mask = (
            np.ones(self.n, np.uint8)
            if mask is None
            else np.ascontiguousarray(np.asarray(mask).reshape(-1) > 0, np.uint8)
        )
        nz, ny, nx = cfg.grid_shape
        self.shape = (nz, ny, nx)
        self.n_voxels = nz * ny * nx
        self._ctx = None
        self._lib = _binner_lib() if use_native else None
        if self._lib is not None:
            f32 = lambda a: np.asarray(a, np.float32)
            self._excl_lo = f32(cfg.exclude_box.lo)
            self._excl_hi = f32(cfg.exclude_box.hi)
            self._op_lo = f32(cfg.oparea.lo)
            self._op_hi = f32(cfg.oparea.hi)
            self._origin = f32(cfg.grid_origin)
            p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
            self._ctx = self._lib.vofod_binner_create(
                p(self.dirs, ctypes.c_float), p(self.offs, ctypes.c_float),
                self.n, p(self.mask, ctypes.c_uint8),
                p(self._excl_lo, ctypes.c_float), p(self._excl_hi, ctypes.c_float),
                p(self._op_lo, ctypes.c_float), p(self._op_hi, ctypes.c_float),
                p(self._origin, ctypes.c_float), nx, ny, nz,
                ctypes.c_float(cfg.voxel_size),
            )

    @property
    def native(self) -> bool:
        return self._ctx is not None

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.vofod_binner_destroy(self._ctx)
            self._ctx = None

    def bin(
        self,
        ranges_mm: np.ndarray,
        pose: np.ndarray,
        intensity: np.ndarray | None = None,
        min_intensity: float = 0.0,
    ) -> BinnedScan:
        r_in = np.asarray(ranges_mm).reshape(-1)
        if np.issubdtype(r_in.dtype, np.floating):
            # Hostile-float contract (tests/test_hostile_inputs.py): the raw
            # frontend consumes float ranges directly, where NaN and negative
            # values fail its `r > 0` no-return test and +inf is a return
            # that misses the operation area but still opens the raycast
            # gate (ref skip rule vofod_nodelet.cpp:1449-1450 keys on
            # range != 0).  The float->uint32 cast below is undefined for
            # non-finite values, so map them to the same semantics first:
            # NaN/negative -> 0 (no return), +inf -> 4e9 mm (a 4000 km
            # return — nonzero, guaranteed outside any operation area).
            r_in = r_in.astype(np.float64)  # holds 4e9 exactly at any input width
            r_in[np.isnan(r_in) | (r_in < 0)] = 0.0
            np.minimum(r_in, 4.0e9, out=r_in)
        ranges_mm = np.ascontiguousarray(r_in, np.uint32)
        pose = np.asarray(pose, np.float32)
        if intensity is None:
            # the raw step substitutes intensity=ones when the source has no
            # intensity channel (runtime/node.py), so the raycast gate is
            # `1.0 >= min_intensity` — substitute the same here rather than
            # all-pass, or the two frontends diverge when min_intensity > 1
            if not hasattr(self, "_ones"):
                self._ones = np.ones(self.n, np.float32)
            intensity = self._ones
        if self._ctx is not None:
            return self._bin_native(ranges_mm, pose, intensity, min_intensity)
        return self._bin_np(ranges_mm, pose, intensity, min_intensity)

    # -- native path ----------------------------------------------------------
    def _bin_native(self, ranges_mm, pose, intensity, min_intensity):
        packed = np.empty(self.n_voxels, np.uint8)
        active = np.empty(self.n, np.uint8)
        stats = np.empty(2, np.int32)
        inten = (
            None
            if intensity is None
            else np.ascontiguousarray(np.asarray(intensity).reshape(-1), np.float32)
        )
        p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        self._lib.vofod_binner_bin_dense(
            self._ctx,
            p(ranges_mm, ctypes.c_uint32),
            p(inten, ctypes.c_float) if inten is not None else None,
            p(np.ascontiguousarray(pose), ctypes.c_float),
            ctypes.c_float(min_intensity),
            p(packed, ctypes.c_uint8), p(active, ctypes.c_uint8),
            p(stats, ctypes.c_int32),
        )
        return BinnedScan(
            packed=packed.reshape(self.shape), active=active, pose=pose,
            n_valid_points=int(stats[0]), n_exclude_hits=int(stats[1]),
        )

    # -- NumPy fallback / oracle ----------------------------------------------
    def _bin_np(self, ranges_mm, pose, intensity, min_intensity):
        cfg = self.cfg
        r = ranges_mm.astype(np.float32) * np.float32(0.001)
        has_return = r > 0
        pts_s = self.dirs * r[:, None] + self.offs
        lo = np.asarray(cfg.exclude_box.lo, np.float32)
        hi = np.asarray(cfg.exclude_box.hi, np.float32)
        excl = np.all((pts_s >= lo) & (pts_s <= hi), axis=-1)
        R, t = pose[:3, :3], pose[:3, 3]
        pw = pts_s @ R.T + t
        olo = np.asarray(cfg.oparea.lo, np.float32)
        ohi = np.asarray(cfg.oparea.hi, np.float32)
        inop = np.all((pw >= olo) & (pw <= ohi), axis=-1)
        nz, ny, nx = self.shape
        origin = np.asarray(cfg.grid_origin, np.float32)
        idx = np.floor(
            (pw - origin) * np.float32(1.0 / cfg.voxel_size)
        ).astype(np.int64)
        inb = np.all((idx >= 0) & (idx < [nx, ny, nz]), axis=-1)
        fid_all = (idx[:, 2] * ny + idx[:, 1]) * nx + idx[:, 0]

        blocker = has_return & inop & inb
        valid = blocker & ~excl
        counts = np.zeros(self.n_voxels, np.int64)
        np.add.at(counts, fid_all[valid], 1)
        bmask = np.zeros(self.n_voxels, bool)
        bmask[fid_all[blocker]] = True
        packed = (
            np.minimum(counts, 63).astype(np.uint8)
            | (bmask.astype(np.uint8) << 7)
        )
        if intensity is None:  # same ones substitution as bin() (raw-step parity)
            act_i = np.full(self.n, not (np.float32(1.0) < np.float32(min_intensity)))
        else:
            # ref rule is `intensity < min -> skip` (:1449): NaN passes
            act_i = ~(np.asarray(intensity).reshape(-1) < min_intensity)
        active = (act_i & ((self.mask > 0) | has_return)).astype(np.uint8)
        return BinnedScan(
            packed=packed.reshape(self.shape), active=active, pose=pose,
            n_valid_points=int(valid.sum()),
            n_exclude_hits=int((blocker & excl).sum()),
        )


# -----------------------------------------------------------------------------
# Ingest-mode startup probe
# -----------------------------------------------------------------------------

def choose_ingest(
    t_raw_up_ms: float, t_pre_up_ms: float, t_bin_ms: float,
    t_raw_device_ms: float, t_pre_device_ms: float,
) -> str:
    """The pure decision rule behind ``frontend_mode="auto"``.

    Per-scan cost of each ingest on THIS deployment:
      raw       = raw upload (0.52 MB)   + device frontend with histogram
      prebinned = packed upload (2.47 MB) + host bin + device unpack
    Pick the cheaper; every term is measured by :func:`probe_ingest_mode`.
    """
    raw_cost = t_raw_up_ms + t_raw_device_ms
    pre_cost = t_pre_up_ms + t_bin_ms + t_pre_device_ms
    return "raw" if raw_cost <= pre_cost else "prebinned"


def probe_ingest_mode(
    cfg, lut, mask: np.ndarray | None = None, rounds: int = 3
) -> tuple[str, dict]:
    """Measure this deployment once and pick the ingest default.

    Times (best-of-``rounds``, content-varying): one raw-scan-sized
    upload+readback, one packed-grid-sized upload+readback, one warm host
    bin, and each ingest's device frontend (the raw histogram scatter vs the
    prebinned unpack).  Returns ``(mode, details)`` where details carries
    every measured number for the startup log.
    """
    import time

    import jax
    import jax.numpy as jnp

    n_pts = int(np.prod([lut.height, lut.width]))
    hb = HostBinner(cfg, lut, mask=mask)
    rng = np.random.default_rng(0)
    pose = np.eye(4, dtype=np.float32)
    ranges = rng.integers(0, 20000, n_pts, dtype=np.uint32)
    from vofod_tpu.geometry import GridSpec
    from vofod_tpu.pipeline.frontend import (
        run_frontend,
        run_frontend_prebinned,
    )

    grid = GridSpec.from_config(cfg)
    dirs, offs = jnp.asarray(lut.directions), jnp.asarray(lut.offsets)
    fe_raw = jax.jit(
        lambda r, p: run_frontend(cfg, grid, dirs, offs, r, p).counts
    )
    fe_pre = jax.jit(lambda sc: run_frontend_prebinned(cfg, grid, sc).counts)

    b = hb.bin(ranges, pose)  # warm (native ctx, caches)
    # warm the alloc path and compile both device frontends
    jax.block_until_ready((
        fe_raw(jnp.asarray(ranges.astype(np.float32)), jnp.asarray(b.pose)),
        fe_pre(b.to_device()),
    ))

    t_bin = t_raw = t_pre = t_raw_dev = t_pre_dev = float("inf")
    for k in range(rounds):
        r = rng.integers(0, 20000, n_pts, dtype=np.uint32)
        t0 = time.perf_counter()
        b = hb.bin(r, pose)
        t_bin = min(t_bin, (time.perf_counter() - t0) * 1e3)

        # each side pays its FULL per-scan transfer set.  raw ships ranges
        # + pose (intensity rides a cached device buffer, runtime/node.py);
        # prebinned ships every BinnedScan.to_device transfer — packed grid
        # + per-pixel active mask (131 KB) + pose + the int32 stats pair.
        raw = r.astype(np.float32)
        t0 = time.perf_counter()
        float(jnp.sum(jnp.asarray(raw)) + jnp.sum(jnp.asarray(b.pose)))
        t_raw = min(t_raw, (time.perf_counter() - t0) * 1e3)

        stats = np.array([b.n_valid_points, b.n_exclude_hits], np.int32)
        t0 = time.perf_counter()
        float(
            jnp.sum(jnp.asarray(b.packed).astype(jnp.int32))
            + jnp.sum(jnp.asarray(b.active).astype(jnp.int32))
            + jnp.sum(jnp.asarray(b.pose))
            + jnp.sum(jnp.asarray(stats))
        )
        t_pre = min(t_pre, (time.perf_counter() - t0) * 1e3)

        raw_dev, pose_dev = jnp.asarray(raw), jnp.asarray(b.pose)
        pre_dev = b.to_device()
        jax.block_until_ready((raw_dev, pose_dev, pre_dev))
        t0 = time.perf_counter()
        jax.block_until_ready(fe_raw(raw_dev, pose_dev))
        t_raw_dev = min(t_raw_dev, (time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        jax.block_until_ready(fe_pre(pre_dev))
        t_pre_dev = min(t_pre_dev, (time.perf_counter() - t0) * 1e3)

    mode = choose_ingest(t_raw, t_pre, t_bin, t_raw_dev, t_pre_dev)
    return mode, {
        "t_raw_upload_ms": round(t_raw, 2),
        "t_prebinned_upload_ms": round(t_pre, 2),
        "t_host_bin_ms": round(t_bin, 2),
        "t_raw_device_ms": round(t_raw_dev, 3),
        "t_prebinned_device_ms": round(t_pre_dev, 3),
        "raw_bytes": n_pts * 4,
        "prebinned_bytes": int(np.prod(hb.shape)),
    }
