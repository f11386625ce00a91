"""collideWithTypes / bitcheck with a +-margin window in one Triton pass.

The GPU kernel behind `ops/collide.collide_with_types_bit_bit` and
`BitVectorVoxelMap.collide_with_bitcheck` for sv_offset == 0 and margin <= 24
(kernelCollideVoxelMapsBitvector with SVCollider, BitVoxelMap.hpp:85-135;
window semantics bitMarginCollisionCheck, BitVector.h:415-471, as in
bitops.bit_margin_collision_check_packed). XLA evaluates the 2*margin+1
shifted copies of the window in several passes over the planes; this kernel
reads both maps once and writes the marked map once.

One block covers BLOCK consecutive voxels as STEPS chunks of CHUNK lanes. Per
chunk it loads the 8 planes of both maps, builds the window by shift doubling
(same-sign zero-fill shifts compose exactly), and accumulates per lane the
hit count and the OR of the colliding bits. Blocks share nothing: each
writes its CHUNK-lane partials, and XLA finishes the sum and the OR. The
partials are laid along the voxel axis (one lane per STEPS voxels), so a map
sharded over its voxel axis (parallel/shard_value.py) partitions the call
into per-device kernels, declared through custom_partitioning.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton
from jax.experimental.custom_partitioning import custom_partitioning
from jax.sharding import NamedSharding, PartitionSpec as P

from .. import bitops

U32 = jnp.uint32
CHUNK = 256  # lanes per step
STEPS = 8  # steps per block
BLOCK = CHUNK * STEPS  # voxels per block
_NUM_WARPS = 8
MAX_MARGIN = 24  # beyond it the reference's 64-bit buffer drops matches


def supported(n_voxels: int, margin: int, sv_offset: int) -> bool:
    """Whether the kernel covers this call (otherwise XLA's packed paths)."""
    return sv_offset == 0 and 0 <= margin <= MAX_MARGIN and n_voxels % BLOCK == 0


def _shift(v, k):
    """bitops.shift_bits on a list of 8 word arrays (bit b <- bit b + k)."""
    if k == 0:
        return v
    z = jnp.zeros_like(v[0])
    n = len(v)
    q, r = divmod(abs(k), 32)
    out = []
    for p in range(n):
        if k > 0:
            lo = v[p + q] if p + q < n else z
            hi = v[p + q + 1] if p + q + 1 < n else z
            out.append(lo if r == 0 else (lo >> U32(r)) | (hi << U32(32 - r)))
        else:
            hi = v[p - q] if p - q >= 0 else z
            lo = v[p - q - 1] if p - q - 1 >= 0 else z
            out.append(hi if r == 0 else (hi << U32(r)) | (lo >> U32(32 - r)))
    return out


def _window(v, margin):
    """OR of _shift(v, s) over s in [-margin, margin], by doubling."""

    def side(sign):
        r, covered = v, 1  # r = OR of shifts 0 .. covered-1
        while covered < margin + 1:
            step = min(covered, margin + 1 - covered)
            r = [x | y for x, y in zip(r, _shift(r, sign * step))]
            covered += step
        return r

    return [x | y for x, y in zip(side(1), side(-1))]


def _kernel(a_ref, b_ref, cnt_ref, or_ref, *new_ref, margin):
    base = pl.program_id(0) * BLOCK

    def body(step, carry):
        cnt, acc = carry[0], carry[1:]
        sl = pl.ds(base + step * CHUNK, CHUNK)
        a = [pltriton.load(a_ref.at[p, sl]) for p in range(8)]
        b = [pltriton.load(b_ref.at[p, sl]) for p in range(8)]
        b[0] = b[0] & U32(0xFFFFFFF0)  # the non-SV nibble never collides
        col = [x & w for x, w in zip(a, _window(b, margin))]
        hit = functools.reduce(jnp.bitwise_or, col) != U32(0)
        if new_ref:
            pltriton.store(new_ref[0].at[0, sl], jnp.where(hit, a[0] | U32(1 << 2), a[0]))
            for p in range(1, 8):
                pltriton.store(new_ref[0].at[p, sl], a[p])
        return (cnt + hit.astype(jnp.int32), *(x | y for x, y in zip(acc, col)))

    init = (jnp.zeros((CHUNK,), jnp.int32),) + tuple(
        jnp.zeros((CHUNK,), U32) for _ in range(8)
    )
    out = lax.fori_loop(0, STEPS, body, init)
    cnt_ref[...] = out[0]
    for p in range(8):
        or_ref[p, :] = out[1 + p]


def _pass(a, b, margin: int, mark: bool, interpret: bool):
    """(count partials int32[n/STEPS], OR partials uint32[8, n/STEPS]
    [, marked planes uint32[8, n]]) for one device's planes."""
    n = a.shape[1]
    nblk = n // BLOCK
    anyspec = pl.BlockSpec(memory_space=pl.ANY)
    out_shape = [
        jax.ShapeDtypeStruct((nblk * CHUNK,), jnp.int32),
        jax.ShapeDtypeStruct((8, nblk * CHUNK), U32),
    ]
    out_specs = [
        pl.BlockSpec((CHUNK,), lambda i: (i,)),
        pl.BlockSpec((8, CHUNK), lambda i: (0, i)),
    ]
    if mark:
        out_shape.append(jax.ShapeDtypeStruct((8, n), U32))
        out_specs.append(anyspec)
    return tuple(pl.pallas_call(
        functools.partial(_kernel, margin=margin),
        grid=(nblk,),
        in_specs=[anyspec, anyspec],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="collide_types",
    )(a, b))


@functools.partial(custom_partitioning, static_argnums=(2, 3, 4))
def _partitioned_pass(a, b, margin, mark, interpret):
    return _pass(a, b, margin, mark, interpret)


def _voxel_axis_shardings(mesh, a_shape, mark):
    """(arg shardings, result shardings): both maps and every output are
    sharded like the first map's voxel axis — replicated if it is not, or
    if a device's slice would not be a whole number of blocks."""
    spec = a_shape.sharding.spec
    ax = spec[1] if len(spec) > 1 else None
    if ax is not None:
        k = 1
        for name in (ax if isinstance(ax, tuple) else (ax,)):
            k *= mesh.shape[name]
        if a_shape.shape[1] % (k * BLOCK):
            ax = None
    planes = NamedSharding(mesh, P(None, ax))
    res = [NamedSharding(mesh, P(ax)), planes] + ([planes] if mark else [])
    return (planes, planes), tuple(res)


def _infer(margin, mark, interpret, mesh, arg_shapes, result_shape):
    return _voxel_axis_shardings(mesh, arg_shapes[0], mark)[1]


def _partition(margin, mark, interpret, mesh, arg_shapes, result_shape):
    args, res = _voxel_axis_shardings(mesh, arg_shapes[0], mark)

    def lower(a, b):
        return _pass(a, b, margin, mark, interpret)

    return mesh, lower, res, args


def _rule(margin, mark, interpret, mesh, value_types, result_types):
    outs = "m, p m" + (", p (m s)" if mark else "")
    return f"p (m s), p (m s) -> {outs}", {"s": STEPS}


_partitioned_pass.def_partition(
    partition=_partition,
    infer_sharding_from_operands=_infer,
    sharding_rule=_rule,
)


def collide_types(a_planes, b_planes, margin: int, mark: bool = True, interpret: bool = False):
    """(count uint32, meanings uint32[8], marked planes or a_planes) of the
    margin-window types collide; see `supported` for the covered calls."""
    outs = _partitioned_pass(a_planes, b_planes, int(margin), bool(mark), bool(interpret))
    count = jnp.sum(outs[0], dtype=jnp.uint32)
    meanings = bitops.or_reduce_words_spmd(outs[1])
    return count, meanings, outs[2] if mark else a_planes
