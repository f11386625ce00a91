"""VisProvider: per-map visualization publisher (vis_interface equivalent).

The CUDA reference publishes device pointers over CUDA IPC + boost shm to a
separate viewer process (VisProvider.h:49-73). The equivalent here is an
async host-readback publisher: visualize() snapshots the map into a
directory (PLY + HTML) only when the content changed, so a file-watching
viewer (or a browser on the HTML) plays the reference viewer's role.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from . import export
from .serve import POLL_S


class VisProvider:
    def __init__(self, name: str, out_dir: Optional[str] = None,
                 max_cubes: Optional[int] = None):
        self.name = name
        self.out_dir = Path(out_dir or os.environ.get("GPU_VOXELS_VIS_DIR", "/tmp/gpu_voxels_jax_vis"))
        self._last_fingerprint = None
        # dense-map viewer budget: bounds BOTH the device->host fetch (the
        # compaction capacity) and the written cube count; None = exact full
        # extraction. Live sense loops set a budget so each publish fetch is
        # O(budget) regardless of scene size.
        self.max_cubes = max_cubes

    # multi-level extraction budget: truncates (coarsest-first) past this
    # many cubes — a 32768^3 paged world stays interactive
    MAX_CUBES = 1_000_000

    def visualize(self, m, force_repaint: bool = True, threshold: float = 0.5) -> bool:
        """Publish the map snapshot; skips unchanged content unless forced.

        Hierarchical / paged maps publish MULTI-LEVEL cubes (one per uniform
        octree node, the reference's VisNTree extractCubes path,
        NTree.hpp:2637) so octree-scale worlds render with O(allocated)
        cubes; distance maps additionally publish a distance-gradient slice
        layer (the reference viewer's DistanceVoxel coloring).

        Extraction runs FIRST (device-compacted — the readback is
        O(extracted), see ops/compact.py) and the change-detection
        fingerprint hashes the extracted arrays: no path here ever fetches a
        full map buffer (an earlier design fingerprinted the raw grid, which
        cost a 16.7 MB readback per publish at 256^3 — ~30 s on the relay)."""
        import numpy as np

        self.out_dir.mkdir(parents=True, exist_ok=True)
        # extract once, feed all three writers
        from ..maps.hierarchical import _PyramidQueries
        from ..maps.paged import PagedHierarchicalMap
        from ..parallel.paged_world import ShardedPagedWorld
        from .extract import extract_cubes, extract_multilevel_cubes
        from .serve import publish_cubes

        if isinstance(m, (PagedHierarchicalMap, _PyramidQueries, ShardedPagedWorld)):
            corners, sizes, types = extract_multilevel_cubes(
                m, max_cubes=self.MAX_CUBES
            )
            side = float(m.side_length)
            centers = (corners.astype(np.float64) + sizes[:, None] / 2.0) * side
            cubes = (centers, types, sizes.astype(np.float64) * side)
        else:
            cubes = extract_cubes(m, threshold, max_cubes=self.max_cubes)
        fp = hash(
            (threshold,)
            + tuple(np.asarray(part).tobytes() for part in cubes if part is not None)
        )
        if not force_repaint and fp == self._last_fingerprint:
            return False
        self._last_fingerprint = fp
        export.write_ply(self.out_dir / f"{self.name}.ply", m, threshold, cubes=cubes)
        export.write_html(
            self.out_dir / f"{self.name}.html", {self.name: m}, threshold,
            cubes={self.name: cubes},
        )
        # feed the live viewer process (vis/serve.py) as well
        publish_cubes(self.out_dir, self.name, m, threshold, cubes=cubes)
        from ..maps.distance_map import DistanceVoxelMap

        if isinstance(m, DistanceVoxelMap):
            from .serve import publish_distance_layer

            publish_distance_layer(self.out_dir, f"{self.name}.distance", m)
        return True


class AsyncVisPublisher:
    """Producer-cheap visualization for live loops.

    The reference's visualizeMap costs the producer almost nothing — an IPC
    handle + a changed flag in shared memory — while the viewer PROCESS pulls
    at its own rate (VisProvider.h:49-73, Visualizer.cu). The analogue here:
    `publish(map)` drops an immutable map snapshot into a one-slot latest-wins
    mailbox (O(1): JAX arrays are immutable device references, no copy, no
    readback) and a worker thread runs the full VisProvider extraction +
    readback + file writes. A 30 Hz sense loop publishes every frame; the
    viewer sees the freshest state, exactly like the CUDA viewer.

    Paints start at most every MIN_INTERVAL_S, half the live viewer's poll
    period (vis/serve.POLL_S), so every poll finds a snapshot at most half a
    period old. A paint the viewer never reads is wasted host work, and that
    work holds Python's GIL against the producer loop.
    """

    MIN_INTERVAL_S = POLL_S / 2

    def __init__(self, name: str, out_dir: Optional[str] = None,
                 max_cubes: Optional[int] = None):
        import threading

        self.provider = VisProvider(name, out_dir, max_cubes=max_cubes)
        self._next_paint = 0.0  # monotonic time the next paint may start
        self._slot = None
        self._cond = threading.Condition()
        self._stop = False
        self._published = 0  # frames handed to publish()
        self._busy = False  # worker currently inside a paint
        self._painted = 0  # snapshots actually written by the worker
        self._error: Optional[BaseException] = None
        self._error_reported = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def publish(self, m) -> None:
        """Hand the latest map snapshot to the worker (never blocks on IO).

        If the worker died on an exception, the first publish() after the
        failure warns eagerly (a live loop would otherwise fill the mailbox
        forever with visualization silently dead); the exception itself is
        still re-raised by flush()/stop()."""
        with self._cond:
            if self._error is not None and not self._error_reported:
                self._error_reported = True
                import warnings

                warnings.warn(
                    f"AsyncVisPublisher({self.provider.name!r}) worker died: "
                    f"{self._error!r}; visualization is stopped "
                    f"(flush()/stop() re-raises)",
                    RuntimeWarning,
                    stacklevel=2,
                )
            self._slot = m
            self._published += 1
            self._cond.notify()

    def _worker(self) -> None:
        import time

        while True:
            with self._cond:
                self._busy = False
                self._cond.notify_all()
                while self._slot is None and not self._stop:
                    self._cond.wait()
                if self._stop and self._slot is None:
                    return
                self._busy = True
                # throttle, still latest-wins: whatever is newest when the
                # paint is due gets painted
                while not self._stop and time.monotonic() < self._next_paint:
                    self._cond.wait(self._next_paint - time.monotonic())
                m, self._slot = self._slot, None
                self._next_paint = time.monotonic() + self.MIN_INTERVAL_S
            try:
                self.provider.visualize(m, force_repaint=False)
                with self._cond:
                    self._painted += 1
                    self._cond.notify_all()
            except BaseException as exc:  # surfaced by flush()/stop()
                with self._cond:
                    self._error = exc
                    self._busy = False
                    self._cond.notify_all()
                return

    @property
    def frames_painted(self) -> int:
        with self._cond:
            return self._painted

    def flush(self, timeout_s: float = 30.0) -> bool:
        """Wait until the worker has drained the mailbox (or error/timeout)."""
        import time

        deadline = time.monotonic() + timeout_s
        with self._cond:
            # drained = mailbox empty AND the worker is not mid-paint (file
            # writes of the last snapshot must be complete when flush returns)
            while (self._slot is not None or self._busy) and self._error is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
            if self._error is not None:
                raise self._error
        return True

    def stop(self, timeout_s: float = 30.0) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout_s)
        if self._error is not None:
            raise self._error
