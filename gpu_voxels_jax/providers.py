"""Provider abstraction (reference: octree/test/Provider.h:46-107).

The reference's benchmark/live apps drive maps through a common contract:
init / visualize / collide / waitForNewData / newSensorData / setCollideWith,
with NTreeProvider / VoxelMapProvider / OctomapProvider implementations.
Here one generic implementation wraps any map kind; sensor data arrives from
a DepthSource (sensors module) instead of a live Kinect.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .sensors import DepthSource, Sensor
from .vis.provider import VisProvider

# map class -> whether its collide_with accepts coll_threshold (see
# Provider._collide_kwargs)
_CLASS_TAKES_THRESHOLD: dict = {}


class Provider:
    """init/visualize/collide/waitForNewData/newSensorData contract."""

    def __init__(self, name: str, carve_pool: int = 1, live_vis: bool = False,
                 vis_max_cubes=None):
        """carve_pool=1 fuses depth frames with the exact per-pixel carve
        (reference semantics); carve_pool=8 carves against the 8x8
        min-pooled depth image (conservative: never frees a voxel the exact
        carve keeps). live_vis=True publishes through the
        AsyncVisPublisher (latest-wins worker thread) so visualize() costs
        the sense loop O(1) — the reference's cheap IPC-handle publish."""
        self.name = name
        self.map = None
        self.carve_pool = int(carve_pool)
        self.collide_with_provider: Optional["Provider"] = None
        self.coll_threshold = 1.0
        if live_vis:
            from .vis.provider import AsyncVisPublisher

            self._vis_async = AsyncVisPublisher(name, max_cubes=vis_max_cubes)
            self._vis = self._vis_async.provider
        else:
            self._vis_async = None
            self._vis = VisProvider(name, max_cubes=vis_max_cubes)
        self._last_data_time = 0.0

    def init(self, initial_map) -> None:
        self.map = initial_map

    def set_collide_with(self, other: "Provider", coll_threshold: float = 1.0) -> None:
        self.collide_with_provider = other
        self.coll_threshold = float(coll_threshold)

    def _collide_kwargs(self) -> dict:
        """Pass coll_threshold only to maps whose collide_with takes it: the
        dense-map signature is (other, coll_threshold, offset) but octree
        tiers take (other, min_level, offset) and lists (other, offset) —
        a positional threshold would silently bind to the wrong parameter.
        The signature inspection is cached per map class (collide_async runs
        per frame in live loops; reflection there is waste)."""
        cls = type(self.map)
        takes = _CLASS_TAKES_THRESHOLD.get(cls)
        if takes is None:
            import inspect

            try:
                params = inspect.signature(cls.collide_with).parameters
                takes = "coll_threshold" in params
            except (TypeError, ValueError):
                takes = False
            _CLASS_TAKES_THRESHOLD[cls] = takes
        return {"coll_threshold": self.coll_threshold} if takes else {}

    def collide(self) -> int:
        if self.collide_with_provider is None or self.collide_with_provider.map is None:
            return 0
        return int(self.map.collide_with(self.collide_with_provider.map,
                                         **self._collide_kwargs()))

    def collide_async(self):
        """The collision count as a DEVICE scalar (no host sync): live loops
        fetch counts in batches or one frame late, so the fetch overlaps the
        next frame's compute instead of serializing it."""
        if self.collide_with_provider is None or self.collide_with_provider.map is None:
            return None
        return self.map.collide_with(self.collide_with_provider.map,
                                     **self._collide_kwargs())

    def new_sensor_data(self, depth: np.ndarray, sensor: Sensor, robot_map=None) -> None:
        """Fuse one depth frame. With robot_map, measurements landing in the
        robot's voxels are cut out (insertSensorData's cut_real_robot)."""
        if robot_map is not None:
            self.map = self.map.insert_depth_image(
                depth, sensor, carve_pool=self.carve_pool, robot_map=robot_map
            )
        elif hasattr(self.map, "insert_depth_image"):
            self.map = self.map.insert_depth_image(depth, sensor, carve_pool=self.carve_pool)
        else:
            pts = np.asarray(sensor.process_depth_image(depth))
            pts = pts[np.isfinite(pts).all(axis=1)]
            self.map = self.map.insert_point_cloud(pts)
        self._last_data_time = time.monotonic()

    def wait_for_new_data(self, source: DepthSource, sensor: Sensor, timeout_s: float = 1.0) -> bool:
        """Blocks until the source delivers a frame (Provider.h waitForNewData):
        cadenced sources (StreamingDepthSource) sleep until the next frame is
        due; plain sources are polled up to the timeout."""
        if hasattr(source, "wait_for_frame"):
            frame = source.wait_for_frame(timeout_s)
        else:
            frame = source.get_frame()
            if frame is None:
                deadline = time.monotonic() + timeout_s
                while frame is None and time.monotonic() < deadline:
                    time.sleep(0.001)
                    frame = source.get_frame()
        if frame is None:
            return False
        self.new_sensor_data(frame, sensor)
        return True

    def visualize(self, force_repaint: bool = True) -> bool:
        if self._vis_async is not None:
            self._vis_async.publish(self.map)
            return True
        return self._vis.visualize(self.map, force_repaint)

    def finish_visualization(self, timeout_s: float = 60.0) -> int:
        """Drain the async publisher; returns snapshots actually painted."""
        if self._vis_async is None:
            return 0
        self._vis_async.flush(timeout_s)
        return self._vis_async.frames_painted
