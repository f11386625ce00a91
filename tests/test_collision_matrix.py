"""The full type x type collision matrix against one set-arithmetic oracle.

The reference expresses its collision matrix as 14 mixin interfaces
(helpers/CollisionInterfaces.h:37-430) inherited selectively per map class:
dense maps collide with dense maps only (BitVoxelMap.h:37-38,
ProbVoxelMap.h:36-37), lists add dense maps + same-id lists (+ octrees via
the GvlNTree-implemented mixin, BitVoxelList.h:110-114), and GvlNTree
collides with everything (GvlNTree.h:36-44). This test drives every ordered
pair through the facade on randomized scenes:

  * every SUPPORTED direction must return exactly |occupied(A) n occupied(B)|
    (the set-arithmetic oracle on floor-voxelized coords);
  * every UNSUPPORTED direction must raise TypeError — never a silent wrong
    count (a raw-id compare between linear and morton lists would quietly
    report 0; here the cross-mode pair is actually supported by re-encoding
    coords, which the reference's type system cannot even express).
"""
import numpy as np
import pytest

from gpu_voxels_jax.api import GpuVoxels, MapType

DIMS = 48

TYPES = [
    ("prob", MapType.MT_PROBAB_VOXELMAP),
    ("bit", MapType.MT_BITVECTOR_VOXELMAP),
    ("bitlist", MapType.MT_BITVECTOR_VOXELLIST),
    ("mortonlist", MapType.MT_BITVECTOR_MORTON_VOXELLIST),
    ("problist", MapType.MT_PROBAB_VOXELLIST),
    ("countlist", MapType.MT_COUNTING_VOXELLIST),
    ("hierbit", MapType.MT_BITVECTOR_OCTREE),
    ("hierprob", MapType.MT_PROBAB_OCTREE),
]
DENSE = {"prob", "bit"}
LISTS = {"bitlist", "mortonlist", "problist", "countlist"}
HIER = {"hierbit", "hierprob"}


def _supported(a: str, b: str) -> bool:
    if a in DENSE:
        return b in DENSE  # BitVoxelMap.h:37-38 / ProbVoxelMap.h:36-37
    return True  # lists and hierarchies collide with every tier here


@pytest.mark.parametrize("seed", [3, 11])
def test_collision_matrix_vs_set_oracle(seed):
    rng = np.random.default_rng(seed)
    pts_a = rng.uniform(2.0, DIMS - 2.0, (400, 3)).astype(np.float32)
    pts_b = rng.uniform(2.0, DIMS - 2.0, (400, 3)).astype(np.float32)
    # guarantee overlap: share a slab of points
    pts_b[:80] = pts_a[:80]

    def vox_set(pts):
        v = np.floor(pts).astype(np.int64)
        return {tuple(r) for r in v}

    want = len(vox_set(pts_a) & vox_set(pts_b))
    assert want >= 80 - 5  # sanity: the shared slab mostly survives dedup

    GpuVoxels._instance = None
    g = GpuVoxels.get_instance()
    g.initialize(DIMS, DIMS, DIMS, 1.0)
    amaps, bmaps = {}, {}
    for n, t in TYPES:
        g.add_map(t, "A_" + n, capacity=2048)
        g.insert_point_cloud_into_map(pts_a, "A_" + n)
        amaps[n] = g.get_map("A_" + n)
        g.add_map(t, "B_" + n, capacity=2048)
        g.insert_point_cloud_into_map(pts_b, "B_" + n)
        bmaps[n] = g.get_map("B_" + n)

    for an, _ in TYPES:
        for bn, _ in TYPES:
            if _supported(an, bn):
                r = amaps[an].collide_with(bmaps[bn])
                got = int(r[0] if isinstance(r, tuple) else r)
                assert got == want, f"{an} x {bn}: {got} != {want}"
            else:
                with pytest.raises(TypeError):
                    amaps[an].collide_with(bmaps[bn])
