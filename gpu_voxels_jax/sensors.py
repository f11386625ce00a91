"""Sensor abstractions: depth-camera model + data sources.

Equivalents of octree/Sensor.{h,cu}, octree/SensorModel.h and the optional
helpers/Kinect grabber. Real device drivers are out of scope here;
`SyntheticDepthSource` and `ReplayDepthSource` implement the same callback
contract the Kinect grabber fills (a host buffer of the latest frame).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .constants import SENSOR_MODEL_FREE, SENSOR_MODEL_OCCUPIED
from .geometry import transforms
from .ops.raycast import depth_image_to_point_cloud


@dataclass
class SensorModel:
    """Probabilistic update magnitudes (octree/SensorModel.h:41-131)."""

    initial_probability: int = SENSOR_MODEL_OCCUPIED
    update_probability: int = SENSOR_MODEL_FREE


@dataclass
class Sensor:
    """Sensor pose + intrinsics + invalid-measure handling (Sensor.h:40-110)."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    orientation_rpy: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    data_width: int = 640
    data_height: int = 480
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    invalid_value: float = 0.0
    model: SensorModel = field(default_factory=SensorModel)

    def pose(self) -> np.ndarray:
        return transforms.from_rpy(self.orientation_rpy, self.position, xp=np)

    def process_depth_image(self, depth):
        """Depth image -> world-frame points (kernel_preprocess*DepthImage +
        pose transform). NaN rows mark invalid measurements."""
        import jax.numpy as jnp

        pts = depth_image_to_point_cloud(
            depth, self.fx, self.fy, self.cx, self.cy, self.invalid_value
        )
        return transforms.transform_points(jnp.asarray(self.pose()), pts)


class DepthSource:
    """Kinect-grabber contract: poll the latest frame (helpers/Kinect.h)."""

    def get_frame(self) -> Optional[np.ndarray]:
        raise NotImplementedError


class SyntheticDepthSource(DepthSource):
    """Procedural frames (moving wall + noise) for demos and tests."""

    def __init__(self, sensor: Sensor, seed: int = 0):
        self.sensor = sensor
        self.rng = np.random.default_rng(seed)
        self.t = 0

    def get_frame(self) -> np.ndarray:
        h, w = self.sensor.data_height, self.sensor.data_width
        depth = np.full((h, w), 4.0 + np.sin(self.t / 5.0), np.float32)
        depth += self.rng.normal(0, 0.01, (h, w)).astype(np.float32)
        self.t += 1
        return depth


class ReplayDepthSource(DepthSource):
    """Replays recorded frames (an .npy stack) in a loop."""

    def __init__(self, frames: np.ndarray):
        self.frames = np.asarray(frames, np.float32)
        self.i = 0

    def get_frame(self) -> np.ndarray:
        f = self.frames[self.i % len(self.frames)]
        self.i += 1
        return f


class StreamingDepthSource(DepthSource):
    """Frames delivered at real sensor cadence (helpers/Kinect.h:36-70).

    The Kinect grabber's contract is a callback filling a host buffer at the
    camera's frame rate while the consumer polls the latest frame; frames the
    consumer misses are dropped (latest wins). This source reproduces that
    timing behavior from a recorded stack / generator: `get_frame()` returns
    a frame only when one is DUE under the `hz` cadence (None otherwise — a
    poll, never a wait), and a consumer slower than the cadence skips the
    frames it missed instead of replaying a backlog.

    `frames` may be a numpy stack, a list of per-frame arrays (host or
    device-resident — pre-staged device frames keep a measurement about the
    pipeline, not the upload), or a zero-arg callable
    producing the next frame. `wait_for_frame()` blocks until the next frame
    is due — the Provider.wait_for_new_data pairing.
    """

    def __init__(self, frames, hz: float = 30.0, loop: bool = True):
        self.hz = float(hz)
        self.period = 1.0 / self.hz
        self.loop = loop
        self._fn = frames if callable(frames) else None
        self._frames = None if callable(frames) else list(frames)
        self._start: Optional[float] = None
        self._delivered = -1  # index of the last frame handed out

    def _frame_at(self, i: int):
        if self._fn is not None:
            return self._fn()
        n = len(self._frames)
        if not self.loop and i >= n:
            return None
        return self._frames[i % n]

    def _due_index(self) -> int:
        import time

        if self._start is None:
            self._start = time.monotonic()
            return 0
        return int((time.monotonic() - self._start) / self.period)

    def get_frame(self):
        """Latest due frame, or None when the consumer polls early/exhausted."""
        i = self._due_index()
        if i <= self._delivered:
            return None
        self._delivered = i  # frames (_delivered, i) were missed: dropped
        return self._frame_at(i)

    def wait_for_frame(self, timeout_s: float = 1.0):
        """Block until the next frame is due (at most timeout_s).

        Sleeps to ~2 ms BEFORE the due time and polls the remainder:
        time.sleep overshoots by single-digit milliseconds under load, which
        at a 30-60 Hz cadence silently costs 10-20% of the frame budget."""
        import time

        deadline = time.monotonic() + timeout_s
        while True:
            f = self.get_frame()
            if f is not None:
                return f
            now = time.monotonic()
            if now >= deadline:
                return None
            if self._start is None:
                continue
            next_due = self._start + (self._delivered + 1) * self.period
            gap = min(next_due, deadline) - now
            time.sleep(max(gap - 0.002, 0.0) if gap > 0.002 else 0.0)


class SocketDepthSource(DepthSource):
    """Live frames over a TCP socket: a background thread reads
    length-prefixed float32 frames into a latest-wins buffer — the exact
    Kinect callback shape (helpers/Kinect.h:36-70) for remote cameras.

    Wire format per frame: uint32 height, uint32 width, then h*w float32
    (little-endian). Use `send_frame(sock, depth)` on the producer side.
    """

    HEADER = 8

    def __init__(self, host: str, port: int, connect_timeout_s: float = 5.0):
        import socket
        import threading

        self._sock = socket.create_connection((host, port), timeout=connect_timeout_s)
        self._sock.settimeout(None)
        self._latest: Optional[np.ndarray] = None
        self._seq = 0
        self._taken = 0
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    @staticmethod
    def send_frame(sock, depth: np.ndarray) -> None:
        depth = np.ascontiguousarray(depth, np.float32)
        h, w = depth.shape
        sock.sendall(np.asarray([h, w], "<u4").tobytes() + depth.tobytes())

    def _recv_exact(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _reader(self) -> None:
        try:
            while not self._closed:
                hdr = self._recv_exact(self.HEADER)
                if hdr is None:
                    break
                h, w = np.frombuffer(hdr, "<u4")
                body = self._recv_exact(int(h) * int(w) * 4)
                if body is None:
                    break
                frame = np.frombuffer(body, "<f4").reshape(int(h), int(w)).copy()
                with self._lock:
                    self._latest = frame
                    self._seq += 1
        except OSError:
            pass
        finally:
            self._closed = True

    def get_frame(self) -> Optional[np.ndarray]:
        with self._lock:
            if self._seq == self._taken:
                return None  # nothing new since the last poll
            self._taken = self._seq
            return self._latest

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(2)
        except OSError:
            pass
        self._sock.close()
