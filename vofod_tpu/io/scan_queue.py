"""Streaming scan queue backed by the native SPSC ring buffer.

The reference's data path is the nodelet subscriber queue drained by
pointcloud_loop worker threads (vofod_nodelet.cpp:1113-1122); here a native
lock-free ring decouples a producer thread (sensor driver / bag reader) from
the device feeder, with drop counting when the consumer falls behind (the same
back-pressure semantics as a depth-limited ROS subscriber).  Falls back to a
pure-Python deque when the native library is absent.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import numpy as np

from vofod_tpu.io.pc_loader import _native_lib


class ScanQueue:
    """Fixed-capacity queue of (ranges_mm u32 [N], intensity f32 [N],
    pose f32 [16]) frames.

    The intensity/signal channel rides every frame so the reference's
    ``raycast/min_intensity`` per-pixel gate (vofod_nodelet.cpp:1449) works
    through the live serving path too, not only in bag replay; producers
    without an intensity channel push ``None`` (stored as all-ones, which the
    gate treats as always-pass, matching VoFOD.process_scan(intensity=None)).
    """

    def __init__(self, n_points: int, capacity: int = 8):
        self.n_points = n_points
        self.capacity = capacity
        self._frame_dtype = np.dtype(
            [
                ("ranges", np.uint32, (n_points,)),
                ("intensity", np.float32, (n_points,)),
                ("pose", np.float32, (16,)),
            ]
        )
        lib = _native_lib()
        self._lib = None
        if lib is not None and hasattr(lib, "vofod_queue_create"):
            lib.vofod_queue_create.restype = ctypes.c_void_p
            lib.vofod_queue_create.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
            lib.vofod_queue_destroy.argtypes = [ctypes.c_void_p]
            lib.vofod_queue_push.restype = ctypes.c_int
            lib.vofod_queue_push.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.vofod_queue_pop.restype = ctypes.c_int
            lib.vofod_queue_pop.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.vofod_queue_size.restype = ctypes.c_longlong
            lib.vofod_queue_size.argtypes = [ctypes.c_void_p]
            lib.vofod_queue_dropped.restype = ctypes.c_longlong
            lib.vofod_queue_dropped.argtypes = [ctypes.c_void_p]
            self._lib = lib
            self._q = lib.vofod_queue_create(
                self._frame_dtype.itemsize, capacity
            )
        else:
            self._dq: collections.deque = collections.deque(maxlen=capacity)
            self._dropped = 0
            self._lock = threading.Lock()

    def push(
        self, ranges_mm: np.ndarray, pose: np.ndarray,
        intensity: np.ndarray | None = None,
    ) -> bool:
        frame = np.zeros((), self._frame_dtype)
        frame["ranges"] = np.asarray(ranges_mm, np.uint32).reshape(-1)
        frame["intensity"] = (
            1.0 if intensity is None
            else np.asarray(intensity, np.float32).reshape(-1)
        )
        frame["pose"] = np.asarray(pose, np.float32).reshape(-1)
        if self._lib is not None:
            buf = frame.tobytes()
            arr = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
            return bool(self._lib.vofod_queue_push(self._q, arr))
        with self._lock:
            if len(self._dq) >= self.capacity:
                self._dropped += 1
                return False
            self._dq.append(frame.copy())
            return True

    def pop(self):
        """Returns (ranges u32 [N], intensity f32 [N], pose f32 [4,4]) or
        None when empty."""
        if self._lib is not None:
            buf = (ctypes.c_uint8 * self._frame_dtype.itemsize)()
            if not self._lib.vofod_queue_pop(self._q, buf):
                return None
            f = np.frombuffer(bytes(buf), self._frame_dtype)[0]
        else:
            with self._lock:
                if not self._dq:
                    return None
                f = self._dq.popleft()
        return (
            f["ranges"].copy(),
            f["intensity"].copy(),
            f["pose"].reshape(4, 4).copy(),
        )

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.vofod_queue_size(self._q))
        return len(self._dq)

    @property
    def dropped(self) -> int:
        if self._lib is not None:
            return int(self._lib.vofod_queue_dropped(self._q))
        return self._dropped

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self._lib.vofod_queue_destroy(self._q)
