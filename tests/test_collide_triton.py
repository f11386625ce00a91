"""The one-pass Triton margin-window types collide (ops/collide_triton), run
in the Pallas interpreter against the plain XLA formulation."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpu_voxels_jax import backend
from gpu_voxels_jax.ops import collide, collide_triton

N = 4 * collide_triton.BLOCK


def _planes(seed, density=0.05):
    r = np.random.default_rng(seed)
    w = r.integers(0, 2**32, (8, N), dtype=np.uint64).astype(np.uint32)
    return jnp.asarray(w * (r.random(N) < density))


def _same(got, want):
    assert int(got[0]) == int(want[0])
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))


@pytest.mark.parametrize("margin", [0, 1, 8, 24])
def test_kernel_matches_xla(margin):
    a, b = _planes(1), _planes(2)
    got = collide.collide_with_types_bit_bit(a, b, margin, interpret=True)
    _same(got, collide._types_xla(a, b, margin))


def test_count_only_matches_xla():
    a, b = _planes(3, 0.3), _planes(4, 0.3)
    cnt, meanings, same_a = collide_triton.collide_types(a, b, 5, mark=False, interpret=True)
    ref = collide._types_xla(a, b, 5)
    assert int(cnt) == int(ref[0]) and same_a is a
    np.testing.assert_array_equal(np.asarray(meanings), np.asarray(ref[1]))


def test_sharded_maps_stay_sharded():
    """On 4 devices the call partitions into per-device kernels: no gather,
    outputs laid out like the inputs, results equal the single-device ones."""
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("z",))
    a, b = _planes(5), _planes(6)
    put = lambda x: jax.device_put(x, NamedSharding(mesh, P(None, "z")))  # noqa: E731
    fn = jax.jit(lambda x, y: collide.collide_with_types_bit_bit(x, y, 8, interpret=True))
    got = fn(put(a), put(b))
    _same(got, collide._types_xla(a, b, 8))
    assert {s.data.shape for s in got[2].addressable_shards} == {(8, N // 4)}
    assert "all-gather" not in fn.lower(put(a), put(b)).compile().as_text()


@pytest.mark.parametrize(
    "n,margin,sv_offset,ok",
    [(N, 0, 0, True), (N, 24, 0, True), (N, 25, 0, False), (N, 2, 3, False), (N + 8, 2, 0, False)],
)
def test_supported(n, margin, sv_offset, ok):
    assert collide_triton.supported(n, margin, sv_offset) is ok


def test_kernel_lowers_for_cuda(monkeypatch):
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    a, b = _planes(7), _planes(8)
    text = (
        jax.jit(lambda x, y: collide.collide_with_types_bit_bit(x, y, 8))
        .trace(a, b).lower(lowering_platforms=("cuda",)).as_text()
    )
    assert text.count("xla.gpu.triton") == 1
