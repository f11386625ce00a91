"""Stateful randomized fuzz of the paged octree tier vs a host cell-model.

The paged tier is the repo's only host-stateful map (pool growth on insert,
maintained block summaries + page pyramid); this fuzz drives random
interleavings of occupied/free point inserts and sensor free-space inserts
over BOTH instantiations (deterministic hard-status, probabilistic log-odds
— Octree.cu:71-72) and checks after every op:

  * tri-state probes at random coords match the model exactly
    (occupied/unknown/free — unallocated space stays implicit UNKNOWN),
  * collide_with_coords counts match the model,
  * the probabilistic tier's raw log-odds read back exactly, and
  * periodically, check_tree() (NTree.h:267-271) re-derives every summary
    level from the pool and agrees with the maintained ones.

Ray PLACEMENT for the free-space inserts reuses the module's own
_free_ray_cells (its stepping semantics have dedicated exact tests against
the reference's visiting rule); what this fuzz targets is the state machine
built on top: tile allocation, hard-set ordering (hits override carves),
saturating log-odds accumulation, and summary coherence across random op
interleavings.
"""
import numpy as np
import pytest

from gpu_voxels_jax.constants import (
    MAX_PROBABILITY,
    MIN_PROBABILITY,
    SENSOR_MODEL_FREE,
    SENSOR_MODEL_OCCUPIED,
    UNKNOWN_PROBABILITY,
    BitVoxelMeaning,
)
from gpu_voxels_jax.maps import paged as paged_mod
from gpu_voxels_jax.maps.paged import PagedHierarchicalMap

DIM = 128
THRESHOLD_OCCUPANCY = 10  # DataTypes.h:78


def _ray_cells(pts, origin):
    """The module's own ray placement, fetched to host (live cells only)."""
    import jax.numpy as jnp

    padded = paged_mod._pad_points_pow2(jnp.asarray(pts, np.float32))
    coords, live = paged_mod._free_ray_cells(
        padded, jnp.asarray(origin, np.float32), 1.0, (DIM,) * 3, 64
    )
    c = np.asarray(coords).reshape(-1, 3)
    return c[np.asarray(live).reshape(-1)]


def _lin(c):
    return (int(c[2]) * DIM + int(c[1])) * DIM + int(c[0])


def _inside(c):
    return np.all((c >= 0) & (c < DIM))


@pytest.mark.parametrize("seed", [2, 9])
def test_paged_det_fuzz_vs_cell_model(seed):
    rng = np.random.default_rng(seed)
    m = PagedHierarchicalMap((DIM,) * 3, 1.0)
    model = {}  # linear idx -> "occ" | "free"; absent = unknown
    origin = np.array([64.5, 64.5, 64.5], np.float32)

    probes = rng.integers(0, DIM, (128, 3)).astype(np.int32)

    for step in range(14):
        op = rng.choice(["occ", "free", "sensor"])
        tag = f"seed={seed} step={step} {op}"
        if op in ("occ", "free"):
            pts = rng.uniform(0.0, DIM, (64, 3)).astype(np.float32)
            meaning = (
                BitVoxelMeaning.eBVM_OCCUPIED if op == "occ" else BitVoxelMeaning.eBVM_FREE
            )
            m.insert_point_cloud(pts, meaning)
            for c in np.floor(pts).astype(np.int64):
                if _inside(c):
                    model[_lin(c)] = "occ" if op == "occ" else "free"
        else:
            pts = rng.uniform(8.0, DIM - 8.0, (16, 3)).astype(np.float32)
            m.insert_point_cloud_with_free_space(pts, origin, max_steps=64)
            for c in _ray_cells(pts, origin):  # carve first...
                model[_lin(c)] = "free"
            for c in np.floor(pts).astype(np.int64):  # ...hits override
                if _inside(c):
                    model[_lin(c)] = "occ"

        occ, unk, free = (np.asarray(x) for x in m.probe(probes))
        for i, c in enumerate(probes):
            want = model.get(_lin(c))
            got = "occ" if occ[i] else ("free" if free[i] else "unk")
            assert got == (want or "unk"), f"{tag} at {c.tolist()}: {got} != {want}"
        want_hits = sum(1 for c in probes if model.get(_lin(c)) == "occ")
        assert int(m.collide_with_coords(probes)) == want_hits, tag
        if step % 4 == 3:
            assert m.check_tree(), tag


@pytest.mark.parametrize("seed", [7])
def test_paged_prob_fuzz_vs_cell_model(seed):
    rng = np.random.default_rng(seed)
    m = PagedHierarchicalMap((DIM,) * 3, 1.0, probabilistic=True)
    vals = {}  # linear idx -> int8 log-odds; absent = UNKNOWN (-128)
    origin = np.array([64.5, 64.5, 64.5], np.float32)
    probes = rng.integers(0, DIM, (128, 3)).astype(np.int32)

    for step in range(12):
        op = rng.choice(["occ", "free", "sensor", "sensor"])
        tag = f"seed={seed} step={step} {op}"
        if op in ("occ", "free"):
            # ProbabilisticVoxel::insert is a hard SET (hpp:77-92)
            pts = rng.uniform(0.0, DIM, (64, 3)).astype(np.float32)
            meaning = (
                BitVoxelMeaning.eBVM_OCCUPIED if op == "occ" else BitVoxelMeaning.eBVM_FREE
            )
            m.insert_point_cloud(pts, meaning)
            v = MAX_PROBABILITY if op == "occ" else MIN_PROBABILITY
            for c in np.floor(pts).astype(np.int64):
                if _inside(c):
                    vals[_lin(c)] = v
        else:
            # one accumulated delta then ONE saturating clamp per op
            pts = rng.uniform(8.0, DIM - 8.0, (16, 3)).astype(np.float32)
            m.insert_point_cloud_with_free_space(pts, origin, max_steps=64)
            delta = {}
            for c in _ray_cells(pts, origin):
                delta[_lin(c)] = delta.get(_lin(c), 0) + SENSOR_MODEL_FREE
            for c in np.floor(pts).astype(np.int64):
                if _inside(c):
                    delta[_lin(c)] = delta.get(_lin(c), 0) + SENSOR_MODEL_OCCUPIED
            for idx, d in delta.items():
                old = vals.get(idx, UNKNOWN_PROBABILITY)
                vals[idx] = max(min(old + d, MAX_PROBABILITY), MIN_PROBABILITY)

        got_v = np.asarray(m.probe_occupancy(probes))
        for i, c in enumerate(probes):
            want_v = vals.get(_lin(c), UNKNOWN_PROBABILITY)
            assert int(got_v[i]) == want_v, f"{tag} at {c.tolist()}"
        occ, unk, _ = (np.asarray(x) for x in m.probe(probes))
        for i, c in enumerate(probes):
            v = vals.get(_lin(c), UNKNOWN_PROBABILITY)
            assert bool(occ[i]) == (v != UNKNOWN_PROBABILITY and v >= THRESHOLD_OCCUPANCY), tag
            assert bool(unk[i]) == (v == UNKNOWN_PROBABILITY), tag
        if step % 4 == 3:
            assert m.check_tree(), tag
