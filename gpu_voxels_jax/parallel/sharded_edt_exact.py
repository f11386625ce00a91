"""Multi-chip EXACT envelope EDT: z-slab sharded parallel_banding.

`parallel/sharded_edt.py` shards the approximate JFA-multires path; this
module shards the flagship exact EDT (`ops/edt_envelope.parallel_banding`,
the parallelBanding3D replacement, DistanceVoxelMap.hpp:251-345) with
bit-identical results:

  * phase 1 (Z flood): each slab runs the local up/down nearest-site scans,
    then ONE all_gather of the per-slab boundary summaries ([nz, dy, dx]
    "last/first marked z") lets every chip inject the exact cross-slab
    carry — the halo exchange SURVEY §7.11 prescribes, done as a single
    collective instead of nz-step neighbor passes.
  * bound grids: the 1/c-resolution coarse site masks are built locally per
    slab and all_gather'd (volume/c^2 and volume/c^3 — a 512^3 grid ships
    ~8 MB per chip); every chip then computes the tiny coarse EDTs
    redundantly (replicated compute beats a second collective).
  * phases 2/3 (Y/X envelopes): per-z-slice independent, so the min-plus
    sweeps (the Triton kernel on the GPU) run on local slabs with their
    slice of the bound grid — zero communication.

Selection and tie-break rules are identical to the single-device pipeline
(`dd <= du` prefers the lower-z site, f32 distance math), so the sharded
output is asserted bit-identical in `__graft_entry__.check_multichip`.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import PBA_UNINITIALISED_COORD, PBA_UNINITIALISED_PACKED
from ..ops.edt_envelope import (
    MISS,
    _block_any,
    _bound_from_d2,
    _coarse_bound_x,
    _max_x_blocks,
    _nearest_scan,
    envelope_pass,
)

Dims = Tuple[int, int, int]
I32 = jnp.int32
U32 = jnp.uint32
F32 = jnp.float32
_BIG = jnp.int32(2**30)


def _nearest_scan_halo(flag: jnp.ndarray, z0, axis: str):
    """Slab-local version of edt_envelope._nearest_scan along global Z.

    flag bool[dzl, dy, dx] is this slab's site mask; z0 the slab's first
    global z row. Returns (d2 int32, nearest global z index) identical to
    the single-device scan over the full column: local scans produce the
    within-slab carries, an all_gather of the slab boundary rows supplies
    the exact carry entering from every other slab.
    """
    dzl = flag.shape[0]
    gidx = jax.lax.broadcasted_iota(I32, flag.shape, 0) + z0
    marked = jnp.where(flag, gidx, _BIG)

    def fwd(carry, row):
        best = jnp.where(row < _BIG, row, carry)
        return best, best

    init = jnp.full(flag.shape[1:], _BIG)
    last_down, down_local = jax.lax.scan(fwd, init, marked)
    first_up, up_local = jax.lax.scan(fwd, init, marked[::-1])
    up_local = up_local[::-1]

    # cross-slab carries: latest marked z below this slab, earliest above
    all_last = jax.lax.all_gather(last_down, axis)  # [nz, dy, dx]
    all_first = jax.lax.all_gather(first_up, axis)
    s = jax.lax.axis_index(axis)
    slabs = jax.lax.broadcasted_iota(I32, all_last.shape, 0)
    below = jnp.where(
        (slabs < s) & (all_last < _BIG), all_last, I32(-1)
    )
    carry_down = jnp.max(below, axis=0)  # -1 = no site below
    above = jnp.where(slabs > s, all_first, _BIG)
    carry_up = jnp.min(above, axis=0)  # _BIG = no site above

    down = jnp.where(
        down_local < _BIG,
        down_local,
        jnp.where(carry_down >= 0, carry_down, _BIG),
    )
    up = jnp.minimum(up_local, carry_up)
    dd = jnp.where(down < _BIG, (gidx - down) ** 2, MISS)
    du = jnp.where(up < _BIG, (up - gidx) ** 2, MISS)
    take_down = dd <= du
    near = jnp.where(take_down, down, up)
    d2 = jnp.minimum(jnp.minimum(dd, du), MISS).astype(I32)
    return d2, near


def build_sharded_parallel_banding(
    mesh: Mesh, dims: Dims, bound_c: int = 8, interpret: bool = False
):
    """Jitted z-slab-sharded exact EDT: fn(packed_flat uint32[N] sharded over
    'z') -> packed_flat uint32[N] sharded over 'z', bit-identical to
    `ops.edt_envelope.parallel_banding(packed_flat, dims)`. interpret=True
    runs the envelope kernel in the Pallas interpreter (tests).

    Constraints: dz must divide the mesh 'z' axis and each slab's z extent
    must be a multiple of bound_c (the coarse-block alignment).
    """
    dx, dy, dz = dims
    nz = mesh.shape["z"]
    if dz % nz:
        raise ValueError(f"dimz {dz} must divide the z mesh ({nz})")
    dzl = dz // nz
    if dzl % bound_c:
        raise ValueError(
            f"slab z extent {dzl} must be a multiple of bound_c {bound_c}"
        )
    czl = dzl // bound_c
    ep = functools.partial(envelope_pass, bound_c=bound_c, interpret=interpret)

    def _shard_fn(packed_local):
        s = jax.lax.axis_index("z")
        z0 = s * dzl
        grid = packed_local.reshape(dzl, dy, dx).astype(U32)
        ox = grid & U32(0x3FF)
        oy = (grid >> U32(10)) & U32(0x3FF)
        oz = grid >> U32(20)
        pz = jax.lax.broadcasted_iota(I32, (dzl, dy, dx), 0) + z0
        py = jax.lax.broadcasted_iota(I32, (dzl, dy, dx), 1)
        px = jax.lax.broadcasted_iota(I32, (dzl, dy, dx), 2)
        is_site = (
            (ox.astype(I32) == px) & (oy.astype(I32) == py) & (oz.astype(I32) == pz)
        ) & (ox != U32(PBA_UNINITIALISED_COORD))

        # phase 1: Z flood with halo carry
        g1, near_z = _nearest_scan_halo(is_site, z0, "z")
        near_z_c = jnp.clip(near_z, 0, PBA_UNINITIALISED_COORD).astype(U32)
        pay1 = px.astype(U32) | (py.astype(U32) << U32(10)) | (near_z_c << U32(20))

        # Y-pass bound: semi-coarse site mask gathered to the full z extent,
        # coarse EDT computed redundantly on every chip (tiny)
        semi_local = _block_any(is_site, axes=(0, 1), c=bound_c)  # [czl, cy, dx]
        semi = jax.lax.all_gather(semi_local, "z").reshape(
            nz * czl, *semi_local.shape[1:]
        )
        d1s, _ = _nearest_scan(semi, semi.shape[0])
        d2s, _ = ep(d1s, jnp.zeros(semi.shape, U32))
        boundY_full = _bound_from_d2(_max_x_blocks(d2s, bound_c), 2, bound_c)
        boundY = jax.lax.dynamic_slice_in_dim(boundY_full, s * czl, czl, axis=0)

        # phase 2: envelope along Y on the local slab
        d2t, pay2t = ep(g1, pay1, boundY)
        d2t = jnp.transpose(d2t, (0, 2, 1))
        pay2t = jnp.transpose(pay2t, (0, 2, 1))

        # X-pass bound: full coarse 3D EDT, gathered + replicated compute
        cmask_local = _block_any(is_site, axes=(0, 1, 2), c=bound_c)
        cmask = jax.lax.all_gather(cmask_local, "z").reshape(
            nz * czl, *cmask_local.shape[1:]
        )
        boundX_full = _coarse_bound_x(cmask, bound_c, ep)  # [cz, cx, cy]
        boundX = jax.lax.dynamic_slice_in_dim(boundX_full, s * czl, czl, axis=0)

        # phase 3: envelope along X (transposed layout) on the local slab
        d3t, pay3t = ep(d2t, pay2t, boundX)
        outt = jnp.where(
            d3t >= MISS, jnp.uint32(PBA_UNINITIALISED_PACKED), pay3t
        )
        return jnp.transpose(outt, (0, 2, 1)).reshape(-1)

    fn = jax.shard_map(
        _shard_fn, mesh=mesh, in_specs=P("z"), out_specs=P("z"),
        check_vma=False,
    )
    return jax.jit(fn)
