"""Multi-robot swept-volume fitter (gpu_voxels_jax.robot.fitter).

Reference: examples/swept_fitter/Fitter.cpp:71-116 (ordering recursion) —
the per-slot start-delay windows are this framework's time-in-bits
extension (BitVector.h:361-402 shift + SVCollider-style margin windows).
"""
import numpy as np
import pytest

from gpu_voxels_jax.constants import BitVoxelMeaning
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap
from gpu_voxels_jax.robot.fitter import (
    MAX_SV_SHIFT,
    deconflict_slot,
    fit_orderings,
    fit_schedule,
)

SV = int(BitVoxelMeaning.eBVM_SWEPT_VOLUME_START)
DIMS = (32, 32, 32)


def box_cloud(lo, hi):
    """Centers of all voxels in [lo, hi) per axis (side 1.0)."""
    ax = [np.arange(lo[i], hi[i], dtype=np.float32) + 0.5 for i in range(3)]
    g = np.stack(np.meshgrid(*ax, indexing="ij"), axis=-1).reshape(-1, 3)
    return g


def swept_map(home_lo, shared_steps):
    """A toy swept volume: a private home box at steps 0..4 plus the SHARED
    box (10..13)^3 visited during ``shared_steps``."""
    m = BitVectorVoxelMap.create(DIMS, 1.0)
    home = box_cloud(home_lo, tuple(c + 3 for c in home_lo))
    for s in range(5):
        m = m.insert_point_cloud(home, SV + s)
    shared = box_cloud((10, 10, 10), (13, 13, 13))
    for s in shared_steps:
        m = m.insert_point_cloud(shared, SV + s)
    return m


@pytest.fixture(scope="module")
def slot_mates():
    # all three visit the shared box at steps 10..12; homes are disjoint
    a = swept_map((1, 1, 1), range(10, 13))
    b = swept_map((20, 1, 1), range(10, 13))
    c = swept_map((1, 20, 1), range(10, 13))
    return a, b, c


def test_deconflict_slot_greedy_minimal_delays(slot_mates):
    """Three robots visiting the same cells at steps 10-12, margin=1:
    pairwise conflicts clear exactly when the relative offset exceeds
    (step span - 1) + margin = 3, so greedy delays must be [0, 4, 8]."""
    a, b, c = slot_mates
    assert int(a.collide_with_bitcheck(b, margin=1)) > 0
    delays = deconflict_slot([a, b, c], margin=1)
    assert delays == [0, 4, 8]

    # brute-force verification: at the returned delays every pair is clean,
    # and one step less on any later robot re-conflicts (greedy minimality)
    def conflicts(mi, mj, rel, margin=1):
        if rel < 0:
            mi, mj, rel = mj, mi, -rel
        sj = mj if rel == 0 else mj.shift_left_swept_volume_ids(rel)
        return int(mi.collide_with_bitcheck(sj, margin=margin))

    maps = [a, b, c]
    for i in range(3):
        for j in range(i):
            assert conflicts(maps[j], maps[i], delays[i] - delays[j]) == 0
    assert conflicts(a, b, delays[1] - 1) > 0
    assert conflicts(b, c, delays[2] - delays[1] - 1) > 0


def test_deconflict_slot_zero_for_compatible(slot_mates):
    """Spatially disjoint slot-mates keep every delay at 0."""
    a, b, _ = slot_mates
    home_only_a = swept_map((1, 1, 1), ())
    home_only_b = swept_map((20, 1, 1), ())
    assert int(home_only_a.collide_with(home_only_b)) == 0
    assert deconflict_slot([home_only_a, home_only_b], margin=2) == [0, 0]
    # margin=0 vs real conflicts still needs a shift
    d = deconflict_slot([a, b], margin=0)
    assert d == [0, 3]


def test_deconflict_slot_infeasible_returns_none():
    """Shared cells visited across the WHOLE shiftable range cannot be
    separated within the 56-bit cap."""
    a = swept_map((1, 1, 1), range(0, 60))
    b = swept_map((20, 1, 1), range(0, 60))
    assert deconflict_slot([a, b], margin=0, stride=8) is None
    with pytest.raises(ValueError):
        deconflict_slot([a, b], max_shift=MAX_SV_SHIFT + 1)


def test_fit_schedule_windows_rescue_boolean_rejects(slot_mates):
    """One trajectory per robot, all sharing workspace: the reference's
    boolean fitter finds NO ordering; windows_in_search finds the schedule
    with the greedy per-slot delays."""
    a, b, c = slot_mates
    robots = [("A", [("tA", a)]), ("B", [("tB", b)]), ("C", [("tC", c)])]
    assert fit_orderings(robots) == []
    plain = fit_schedule(robots, margin=1)
    assert plain == []  # no boolean ordering to annotate
    rescued = fit_schedule(robots, margin=1, windows_in_search=True)
    assert len(rescued) == 1
    sol, slot_delays = rescued[0]
    assert sol == [[0], [0], [0]]
    assert slot_delays == [[0, 4, 8]]


def test_fit_schedule_annotates_boolean_orderings(slot_mates):
    """Two robots x two trajectories (shared-reach + home-only): the two
    boolean orderings pair shared with home; every slot deconflicts at
    delay 0, and fit_schedule returns the first fully-deconflicted one."""
    a, b, _ = slot_mates
    ha = swept_map((1, 1, 1), ())
    hb = swept_map((20, 1, 1), ())
    robots = [("A", [("center", a), ("home", ha)]),
              ("B", [("center", b), ("home", hb)])]
    assert len(fit_orderings(robots)) == 2
    res = fit_schedule(robots, margin=1)
    assert len(res) == 1
    _, slot_delays = res[0]
    assert slot_delays == [[0, 0], [0, 0]]
