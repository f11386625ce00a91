"""Multi-chip paged octree demo: a virtual world z-slab-decomposed over every
available device (`parallel.ShardedPagedWorld`), driven through the same
sense -> insert -> probe -> collide -> save flow as the single-device octree
examples.

The reference is single-GPU; this is the framework's grid-scaling capability
(SURVEY §2.4) applied to the sparse NTree-scale tier: each device owns one
slab's page directory, tile pool and allocator, so map memory and insert work
distribute while every count stays exactly the single-device map's
(GvlNTree.hpp:150-330 semantics per slab).

Run on N chips to hold a world N times deeper at the same per-chip memory.
"""
import tempfile
from pathlib import Path

import jax
import numpy as np

from gpu_voxels_jax.maps.paged import PagedHierarchicalMap
from gpu_voxels_jax.maps.voxellist import VoxelList
from gpu_voxels_jax.parallel import ShardedPagedWorld
from gpu_voxels_jax.sensors import Sensor


def main():
    devices = jax.devices()
    dims = (128, 128, 256 * len(devices))  # deeper world per extra chip
    world = ShardedPagedWorld(dims, 0.05, probabilistic=True, devices=devices)

    # a depth camera in the first slab looking down +z: its rays cross every
    # slab, carving free space and fusing hits in whichever slab owns them
    cam = Sensor(
        position=np.array([3.2, 3.2, 0.4], np.float32),
        data_width=64, data_height=64, fx=64.0, fy=64.0, cx=32.0, cy=32.0,
    )
    rng = np.random.default_rng(7)
    depth = rng.uniform(6.0, 0.05 * dims[2] * 0.9, (64, 64)).astype(np.float32)
    world.insert_depth_image(depth, cam, max_steps=dims[2])
    world.assert_distributed()

    # probe a column along the optical axis: near cells free, far unknown
    zs = np.arange(16, dims[2], 32, np.int32)
    col = np.stack([np.full_like(zs, 64), np.full_like(zs, 64), zs], axis=-1)
    occupied, unknown, free = world.probe(col)

    # collide against a static obstacle list spanning several slabs
    obstacles = (rng.uniform(0.2, 0.8, (500, 3)) * np.asarray(dims) * 0.05).astype(
        np.float32
    )
    lst = VoxelList.create(dims, 0.05, "bit", 2048, "linear").insert_point_cloud(
        obstacles
    )
    n_coll, n_unknown = world.collide_with_counting_unknown(lst)

    # persistence: the file is the single-device paged format; reload stays
    # distributed on the same devices
    with tempfile.TemporaryDirectory() as td:
        p = Path(td) / "world.bin"
        world.write_to_disk(p)
        world = world.read_from_disk(p)
    world.assert_distributed()

    return {
        "devices": len(devices),
        "dims": dims,
        "tiles": world.n_tiles(),
        "memory_mb": world.memory_usage() / 2**20,
        "free_cells": int(np.asarray(free).sum()),
        "unknown_cells": int(np.asarray(unknown).sum()),
        "collisions": int(n_coll),
        "unknown_hits": int(n_unknown),
    }


if __name__ == "__main__":
    out = main()
    for k, v in out.items():
        print(f"{k}: {v}")
