"""Probability, Morton and constants semantics tests."""
import numpy as np
import jax.numpy as jnp

from gpu_voxels_jax import morton, probability
from gpu_voxels_jax.constants import (
    MAX_PROBABILITY,
    MIN_PROBABILITY,
    UNKNOWN_PROBABILITY,
    BitVoxelMeaning,
    float_to_probability,
    meaning_to_probability,
)


def test_float_to_probability():
    # DefaultCollider.hpp:94-98: val*(127-(-127)) + (-127), truncated
    assert float_to_probability(0.0) == -127
    assert float_to_probability(1.0) == 127
    assert float_to_probability(0.5) == 0
    assert float_to_probability(0.1) == int(0.1 * 254.0 - 127.0)


def test_meaning_to_probability():
    assert meaning_to_probability(BitVoxelMeaning.eBVM_FREE) == MIN_PROBABILITY
    assert meaning_to_probability(BitVoxelMeaning.eBVM_OCCUPIED) == MAX_PROBABILITY
    assert meaning_to_probability(BitVoxelMeaning.eBVM_COLLISION) == MAX_PROBABILITY
    assert meaning_to_probability(BitVoxelMeaning.eBVM_UNKNOWN) == UNKNOWN_PROBABILITY
    assert meaning_to_probability(77) == UNKNOWN_PROBABILITY


def test_update_occupancy_saturates():
    occ = jnp.asarray([-128, -127, 0, 100, 127], dtype=jnp.int8)
    up = probability.update_occupancy(occ, 72)
    np.testing.assert_array_equal(np.asarray(up), [-56, -55, 72, 127, 127])
    down = probability.update_occupancy(occ, -10)
    np.testing.assert_array_equal(np.asarray(down), [-127, -127, -10, 90, 117])


def test_morton_roundtrip_30():
    rng = np.random.default_rng(1)
    xyz = rng.integers(0, 1024, size=(3, 1000)).astype(np.uint32)
    code = morton.morton_code30(*[jnp.asarray(c) for c in xyz])
    x, y, z = morton.inv_morton_code30(code)
    np.testing.assert_array_equal(np.asarray(x), xyz[0])
    np.testing.assert_array_equal(np.asarray(y), xyz[1])
    np.testing.assert_array_equal(np.asarray(z), xyz[2])


def test_morton_known_values():
    # interleave: x bit0 -> bit0, y bit0 -> bit1, z bit0 -> bit2
    assert int(morton.morton_code30(jnp.uint32(1), jnp.uint32(0), jnp.uint32(0))) == 1
    assert int(morton.morton_code30(jnp.uint32(0), jnp.uint32(1), jnp.uint32(0))) == 2
    assert int(morton.morton_code30(jnp.uint32(0), jnp.uint32(0), jnp.uint32(1))) == 4
    assert int(morton.morton_code30(jnp.uint32(3), jnp.uint32(3), jnp.uint32(3))) == 63


def test_morton_roundtrip_60():
    rng = np.random.default_rng(2)
    xyz = rng.integers(0, 2**20, size=(3, 500)).astype(np.uint32)
    hi, lo = morton.morton_code60(*[jnp.asarray(c) for c in xyz])
    x, y, z = morton.inv_morton_code60(hi, lo)
    np.testing.assert_array_equal(np.asarray(x), xyz[0])
    np.testing.assert_array_equal(np.asarray(y), xyz[1])
    np.testing.assert_array_equal(np.asarray(z), xyz[2])


def test_morton_is_z_order_sorted_within_octant():
    # codes of (0..1)^3 cube enumerate 0..7
    codes = []
    for z in range(2):
        for y in range(2):
            for x in range(2):
                codes.append(int(morton.morton_code30(jnp.uint32(x), jnp.uint32(y), jnp.uint32(z))))
    assert sorted(codes) == list(range(8))
