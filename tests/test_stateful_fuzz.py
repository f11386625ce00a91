"""Stateful randomized differential: a random op sequence over bit maps vs a
host set-model oracle.

Single-op differentials can miss interaction bugs (state dropped across
derivations, summaries drifting out of sync after unusual op orders). This
fuzz drives a random interleaving of insert / clear_bit / merge / shift ops
over two BitVectorVoxelMaps and, after every op, checks

  * the maintained occupancy summary is exactly !noneButEmpty(data)
    (BitVector.h:184-198 — bit 0 = eBVM_FREE never counts), and
  * collide_with both ways equals the oracle's |occupied(A) n occupied(B)|.

The oracle models each map as {linear voxel: set of meanings} with the
reference's exact semantics: insert = setBit (BitVoxel.hpp:60-79), merge =
bitwise OR, clearBitVoxelMeaning = clear one bit everywhere."""
import numpy as np
import jax.numpy as jnp
import pytest

from gpu_voxels_jax import bitops
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap

DIM = 16
MEANINGS = (0, 10, 11, 200)  # incl. eBVM_FREE (bit 0, masked by noneButEmpty)


class Oracle:
    def __init__(self):
        self.vox = {}  # linear idx -> set of meanings

    def insert(self, coords, meaning):
        for c in coords:
            if np.all((c >= 0) & (c < DIM)):
                idx = int(c[2]) * DIM * DIM + int(c[1]) * DIM + int(c[0])
                self.vox.setdefault(idx, set()).add(int(meaning))

    def clear_bit(self, meaning):
        for s in self.vox.values():
            s.discard(int(meaning))

    def merge(self, other):
        for idx, s in other.vox.items():
            self.vox.setdefault(idx, set()).update(s)

    def occupied(self):
        return {i for i, s in self.vox.items() if s - {0}}


def check(m, oracle, tag):
    want = bitops.occupied(m.data).astype(jnp.uint8)
    np.testing.assert_array_equal(np.asarray(m.occ), np.asarray(want), err_msg=tag)
    got_occ = set(np.flatnonzero(np.asarray(want)))
    assert got_occ == oracle.occupied(), tag


@pytest.mark.parametrize("seed", [1, 6])
def test_voxellist_stateful_fuzz_vs_set_model(seed):
    """Same idea for the list tier: random insert/merge/subtract interleavings
    (append + make_unique, TemplateVoxelList.hpp:142-209; subtract :610-643)
    checked against an id-set model every step — count, exact id set, and
    collide_with both ways (binary_search membership, payload-independent)."""
    from gpu_voxels_jax.maps.voxellist import bit_vector_voxel_list

    rng = np.random.default_rng(seed)
    # capacity 4096 == DIM^3: dedup can never overflow, so grow=False keeps
    # every op a fixed-shape compiled program without drop semantics
    lists = [bit_vector_voxel_list((DIM,) * 3, capacity=4096) for _ in range(2)]
    models = [set(), set()]

    def lin(c):
        return int(c[2]) * DIM * DIM + int(c[1]) * DIM + int(c[0])

    for step in range(24):
        which = int(rng.integers(0, 2))
        op = rng.choice(["insert", "insert", "merge", "subtract"])
        tag = f"seed={seed} step={step} {op} on {which}"
        if op == "insert":
            pts = rng.uniform(0.0, DIM, (64, 3)).astype(np.float32)
            meaning = int(rng.choice(MEANINGS[1:]))  # list entries: real bits
            lists[which] = lists[which].insert_point_cloud(pts, meaning, grow=False)
            models[which] |= {lin(c) for c in np.floor(pts).astype(np.int64)}
        elif op == "merge":
            # re-pin the capacity (merge grows it like the reference's thrust
            # append): content never exceeds DIM^3 == 4096, so nothing drops
            # and every op stays one already-compiled fixed-shape program
            lists[which] = lists[which].merge(lists[1 - which]).with_capacity(4096)
            models[which] |= models[1 - which]
        else:
            lists[which] = lists[which].subtract(lists[1 - which]).with_capacity(4096)
            models[which] -= models[1 - which]

        lst = lists[which]
        n = int(lst.count)
        assert n == len(models[which]), tag
        assert set(np.asarray(lst.ids[:n]).tolist()) == models[which], tag
        overlap = len(models[0] & models[1])
        assert int(lists[0].collide_with(lists[1])) == overlap, tag
        assert int(lists[1].collide_with(lists[0])) == overlap, tag


@pytest.mark.parametrize("seed", [0, 4])
def test_bitmap_stateful_fuzz_vs_set_model(seed):
    rng = np.random.default_rng(seed)
    maps = [BitVectorVoxelMap.create((DIM,) * 3), BitVectorVoxelMap.create((DIM,) * 3)]
    oracles = [Oracle(), Oracle()]

    for step in range(30):
        which = int(rng.integers(0, 2))
        op = rng.choice(["insert", "insert", "insert", "clear_bit", "merge"])
        tag = f"seed={seed} step={step} {op} on {which}"
        if op == "insert":
            # fixed shape (64 points) so the compiled program is reused
            pts = rng.uniform(-1.0, DIM + 1.0, (64, 3)).astype(np.float32)
            meaning = int(rng.choice(MEANINGS))
            maps[which] = maps[which].insert_point_cloud(pts, meaning)
            oracles[which].insert(np.floor(pts).astype(np.int64), meaning)
        elif op == "clear_bit":
            meaning = int(rng.choice(MEANINGS))
            maps[which] = maps[which].clear_bit(meaning)
            oracles[which].clear_bit(meaning)
        else:
            maps[which] = maps[which].merge(maps[1 - which])
            oracles[which].merge(oracles[1 - which])

        check(maps[which], oracles[which], tag)
        want_overlap = len(oracles[0].occupied() & oracles[1].occupied())
        assert int(maps[0].collide_with(maps[1])) == want_overlap, tag
        assert int(maps[1].collide_with(maps[0])) == want_overlap, tag
