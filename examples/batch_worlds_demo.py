"""Batched-world planning: vmap as the data-parallel axis.

Plans are usually validated against MANY hypothetical worlds (sampled
obstacle predictions, belief particles). Maps are pytrees, so a stack of W
environments batches through one vmapped program — the multi-chip version
shards the same axis over the mesh ('world' in parallel/sharded).
"""
import numpy as np

from gpu_voxels_jax.constants import float_to_probability
from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap
from gpu_voxels_jax.ops.insert import linear_index, map_to_voxels

DIMS = (64, 64, 64)
W = 16  # worlds


def main():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)

    # W sampled worlds: a wall whose opening position is uncertain
    envs = []
    for w in range(W):
        gap = rng.uniform(8, 56)
        ys = np.arange(0.5, 64, 1.0, dtype=np.float32)
        zs = np.arange(0.5, 64, 1.0, dtype=np.float32)
        yy, zz = np.meshgrid(ys, zs, indexing="ij")
        keep = np.abs(yy - gap) > 4.0  # 8-voxel gap
        wall = np.stack([np.full(keep.sum(), 32.5, np.float32), yy[keep], zz[keep]], axis=1)
        envs.append(np.asarray(ProbVoxelMap.create(DIMS).insert_point_cloud(wall).data))
    env_stack = jnp.asarray(np.stack(envs))  # [W, N]

    # candidate straight-line path through the wall at a chosen y
    t = float_to_probability(0.5)

    def path_blocked(env_data, y):
        pts = jnp.stack(
            [jnp.linspace(2.0, 62.0, 61), jnp.full(61, y), jnp.full(61, 32.5)], axis=1
        )
        coords = map_to_voxels(pts, 1.0)
        idx = linear_index(coords, DIMS)
        return jnp.any(env_data[idx].astype(jnp.int32) >= t)

    # all worlds x all candidate crossings in ONE program
    candidates = jnp.arange(4.5, 60.0, 1.0)
    blocked = jax.jit(jax.vmap(jax.vmap(path_blocked, in_axes=(None, 0)), in_axes=(0, None)))(
        env_stack, candidates
    )  # [W, C]
    feasible_per_candidate = np.asarray((~blocked).sum(axis=0))
    best = int(np.argmax(feasible_per_candidate))
    print(f"{W} worlds x {len(candidates)} candidate crossings in one vmapped program")
    print(
        f"best crossing y={float(candidates[best]):.1f} is clear in "
        f"{feasible_per_candidate[best]}/{W} worlds"
    )
    assert feasible_per_candidate[best] >= 1
    return int(feasible_per_candidate[best])


if __name__ == "__main__":
    main()
