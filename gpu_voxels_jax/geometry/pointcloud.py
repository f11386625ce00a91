"""Device-resident point clouds.

Equivalents of helpers/PointCloud.{h,cu} and helpers/MetaPointCloud.{h,cu}.

`PointCloud` is a thin pytree around a float32[N,3] device array.

`MetaPointCloud` keeps the reference's design of ONE accumulated device
allocation for all sub-clouds (MetaPointCloud.h:221-240) because it is also
the right accelerator layout: a single [total, 3] array plus a per-point int32
sub-cloud id. Per-link transforms become one gather of 4x4 matrices by
sub-cloud id followed by a single fused einsum — the whole robot moves in one
XLA op instead of one kernel launch per link (MetaPointCloud.cu:624).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import transforms


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PointCloud:
    """A single point cloud on device (helpers/PointCloud.h:41-158)."""

    points: jnp.ndarray  # float32[N, 3]

    @staticmethod
    def from_numpy(points) -> "PointCloud":
        return PointCloud(jnp.asarray(np.asarray(points, dtype=np.float32).reshape(-1, 3)))

    @property
    def size(self) -> int:
        return self.points.shape[0]

    def transformed(self, matrix) -> "PointCloud":
        """PointCloud::transform (PointCloud.cu): rigid transform."""
        return PointCloud(transforms.transform_points(matrix, self.points))

    def scaled(self, factors) -> "PointCloud":
        f = jnp.asarray(factors, dtype=jnp.float32)
        return PointCloud(self.points * f)

    def add(self, other: "PointCloud") -> "PointCloud":
        return PointCloud(jnp.concatenate([self.points, other.points], axis=0))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MetaPointCloud:
    """Named collection of sub-clouds in one device allocation.

    Equivalent of helpers/MetaPointCloud.{h,cu}. Static metadata (names,
    offsets) lives on host; point data is a single device array.
    """

    points: jnp.ndarray  # float32[total, 3]
    cloud_ids: jnp.ndarray  # int32[total] sub-cloud index per point
    offsets: Tuple[int, ...] = field(metadata=dict(static=True))  # len = num_clouds+1
    names: Tuple[str, ...] = field(metadata=dict(static=True))

    @staticmethod
    def from_clouds(clouds, names=None) -> "MetaPointCloud":
        arrs = [np.asarray(c, dtype=np.float32).reshape(-1, 3) for c in clouds]
        if names is None:
            names = tuple(f"cloud_{i}" for i in range(len(arrs)))
        sizes = [a.shape[0] for a in arrs]
        offsets = tuple(np.concatenate([[0], np.cumsum(sizes)]).tolist())
        total = offsets[-1]
        pts = np.concatenate(arrs, axis=0) if arrs else np.zeros((0, 3), np.float32)
        ids = np.repeat(np.arange(len(arrs), dtype=np.int32), sizes)
        assert pts.shape[0] == total
        return MetaPointCloud(jnp.asarray(pts), jnp.asarray(ids), offsets, tuple(names))

    @property
    def num_clouds(self) -> int:
        return len(self.offsets) - 1

    @property
    def accumulated_size(self) -> int:
        return self.points.shape[0]

    def cloud_size(self, i: int) -> int:
        return self.offsets[i + 1] - self.offsets[i]

    def cloud_index(self, name: str) -> int:
        return self.names.index(name)

    def get_cloud(self, i: int) -> jnp.ndarray:
        return self.points[self.offsets[i] : self.offsets[i + 1]]

    def transformed(self, matrix) -> "MetaPointCloud":
        """Whole-cloud rigid transform (MetaPointCloud::transform)."""
        return replace(self, points=transforms.transform_points(matrix, self.points))

    def transformed_sub_cloud(self, cloud_id: int, matrix) -> "MetaPointCloud":
        """transformSubCloud (MetaPointCloud.cu:624): one sub-cloud only."""
        lo, hi = self.offsets[cloud_id], self.offsets[cloud_id + 1]
        seg = transforms.transform_points(matrix, self.points[lo:hi])
        return replace(self, points=self.points.at[lo:hi].set(seg))

    def transformed_per_cloud(self, matrices) -> "MetaPointCloud":
        """Transform every sub-cloud by its own 4x4 in ONE fused op.

        matrices: float32[num_clouds, 4, 4]. This is the fused
        replacement for the reference's per-link transformSubCloud loop
        (KinematicChain.cu:93-126): gather matrices by point id, then a
        single einsum + add over all points of all links.
        """
        matrices = jnp.asarray(matrices, dtype=jnp.float32)
        rot = matrices[self.cloud_ids, :3, :3]  # [total,3,3]
        t = matrices[self.cloud_ids, :3, 3]  # [total,3]
        pts = jnp.einsum("nij,nj->ni", rot, self.points, precision=jax.lax.Precision.HIGHEST) + t
        return replace(self, points=pts)

    def updated_cloud(self, cloud_id: int, points) -> "MetaPointCloud":
        """updatePointCloud for an existing sub-cloud of the SAME size.

        Size changes reallocate (host-side), mirroring the reference's
        resize path.
        """
        pts = jnp.asarray(points, dtype=jnp.float32).reshape(-1, 3)
        lo, hi = self.offsets[cloud_id], self.offsets[cloud_id + 1]
        if pts.shape[0] == hi - lo:
            return replace(self, points=self.points.at[lo:hi].set(pts))
        clouds = [np.asarray(self.get_cloud(i)) for i in range(self.num_clouds)]
        clouds[cloud_id] = np.asarray(pts)
        return MetaPointCloud.from_clouds(clouds, self.names)

    def as_dict(self) -> Dict[str, jnp.ndarray]:
        return {n: self.get_cloud(i) for i, n in enumerate(self.names)}
