"""Stateful randomized fuzz of the dense hierarchy (status pyramid) tier.

Random interleavings of probabilistic point inserts — occupied (+127), free
(-127), and explicit-unknown meanings (-128, ProbabilisticVoxel::insert for
non-free/occupied meanings, ProbabilisticVoxel.hpp:77-92) — over a
HierarchicalProbMap, checked after every op against a host cell-model:

  * tri-state probes (occupied iff v != -128 && v >= THRESHOLD_OCCUPANCY,
    EnvNodesProbCommon.h:30-45; unknown iff v == -128),
  * collide_with_counting_unknown against a fixed voxel-list query
    (GvlNTree.h:120-129 semantics: occupied hits + unknown-cell hits), and
  * periodically, check_tree() re-deriving the full pyramid (NTree.h:267-271).
"""
import numpy as np
import pytest

from gpu_voxels_jax.constants import (
    MAX_PROBABILITY,
    MIN_PROBABILITY,
    UNKNOWN_PROBABILITY,
    BitVoxelMeaning,
)
from gpu_voxels_jax.maps.hierarchical import HierarchicalProbMap
from gpu_voxels_jax.maps.voxellist import bit_vector_voxel_list

DIM = 64
THRESHOLD_OCCUPANCY = 10  # DataTypes.h:78

MEANING_VALUE = {
    BitVoxelMeaning.eBVM_OCCUPIED: MAX_PROBABILITY,
    BitVoxelMeaning.eBVM_FREE: MIN_PROBABILITY,
    BitVoxelMeaning.eBVM_SWEPT_VOLUME_START: UNKNOWN_PROBABILITY,
}


@pytest.mark.parametrize("seed", [3, 12])
def test_hier_prob_fuzz_vs_cell_model(seed):
    rng = np.random.default_rng(seed)
    m = HierarchicalProbMap.create((DIM,) * 3)
    vals = {}  # linear (unpadded) idx -> int8; absent = UNKNOWN

    probes = rng.integers(0, DIM, (128, 3)).astype(np.int32)
    query = bit_vector_voxel_list((DIM,) * 3).insert_point_cloud(
        (probes.astype(np.float32) + 0.5), 50
    )
    q_cells = {(int(c[0]), int(c[1]), int(c[2])) for c in probes}

    def lin(c):
        return (int(c[2]) * DIM + int(c[1])) * DIM + int(c[0])

    for step in range(12):
        meaning = rng.choice(list(MEANING_VALUE))
        pts = rng.uniform(0.0, DIM, (64, 3)).astype(np.float32)
        m = m.insert_point_cloud(pts, meaning)
        for c in np.floor(pts).astype(np.int64):
            if np.all((c >= 0) & (c < DIM)):
                vals[lin(c)] = MEANING_VALUE[meaning]
        tag = f"seed={seed} step={step} meaning={int(meaning)}"

        occ, unk, free = (np.asarray(x) for x in m.probe(probes))
        for i, c in enumerate(probes):
            v = vals.get(lin(c), UNKNOWN_PROBABILITY)
            want_occ = v != UNKNOWN_PROBABILITY and v >= THRESHOLD_OCCUPANCY
            want_unk = v == UNKNOWN_PROBABILITY
            assert bool(occ[i]) == want_occ, f"{tag} at {c.tolist()}"
            assert bool(unk[i]) == want_unk, f"{tag} at {c.tolist()}"
            assert bool(free[i]) == (not want_occ and not want_unk), tag

        # counting-unknown against the fixed list: per DISTINCT query cell
        hits, unknowns = m.collide_with_counting_unknown(query)
        want_hits = sum(
            1 for c in q_cells
            if (v := vals.get(lin(c), UNKNOWN_PROBABILITY)) != UNKNOWN_PROBABILITY
            and v >= THRESHOLD_OCCUPANCY
        )
        want_unknown = sum(
            1 for c in q_cells if vals.get(lin(c), UNKNOWN_PROBABILITY) == UNKNOWN_PROBABILITY
        )
        assert int(hits) == want_hits, tag
        assert int(unknowns) == want_unknown, tag
        if step % 4 == 3:
            assert m.check_tree(), tag
