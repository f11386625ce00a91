#!/usr/bin/env python3
"""Time each translated kernel's plain XLA version and the kept Triton
kernels on one GPU at the shapes of the reference's configurations, beside a
device-to-device copy of the same bytes; the types collide also end to end
through the public API.

    python tools/kernel_verdicts.py [--out FILE.jsonl]

Every time is the median of 7 calls after one warm-up call, each ended by
block_until_ready. The "copy floor" is an elementwise read + write of the
same arrays, timed in the same process. Prints one line per measurement and,
with --out, writes the same records as JSON lines.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def median_time(fn, *args, reps: int = 7) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def copy_floor(*arrays) -> float:
    """Seconds to read and write `arrays` once (XLA cannot elide the xor
    with a traced zero)."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda k, *xs: tuple(x ^ k.astype(x.dtype) for x in xs))
    return median_time(f, jnp.zeros((), jnp.int32), *arrays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the records here as JSON lines")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's backend is {jax.default_backend()!r}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from gpu_voxels_jax import backend, bitops
    from gpu_voxels_jax.ops import collide, collide_triton, edt, edt_envelope, raycast
    from gpu_voxels_jax.utils.jitcache import enable_persistent_cache

    enable_persistent_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()[0].strip()
    records = []

    def rec(kernel, variant, seconds, floor_s, nbytes, **extra):
        r = dict(kernel=kernel, variant=variant, ms=seconds * 1e3,
                 copy_floor_ms=floor_s * 1e3, bytes=int(nbytes), card=card, **extra)
        records.append(r)
        print(f"{kernel:28s} {variant:34s} {r['ms']:10.3f} ms  copy floor "
              f"{r['copy_floor_ms']:8.3f} ms  ({seconds / floor_s:5.2f}x)", flush=True)

    key = jax.random.PRNGKey(args.seed)
    k = iter(jax.random.split(key, 16))

    # 1. counting collides (library path: ops/collide)
    n5 = 512 ** 3
    a, b = (jax.random.randint(next(k), (n5,), -128, 128, jnp.int8) for _ in range(2))
    fl = copy_floor(a, b)
    rec("count_prob_prob", "xla 512^3", median_time(
        jax.jit(lambda x, y: collide.count_prob_prob(x, y, 100, 100)), a, b), fl, 2 * n5)
    rec("count_and_mark_prob", "xla 512^3", median_time(
        jax.jit(lambda x, y: collide.count_and_mark_prob(x, y, 100, 100)), a, b), fl, 2 * n5)
    del a, b
    n2 = 256 ** 3

    def planes(kk, density):
        k1, k2 = jax.random.split(kk)
        w = jax.random.bits(k1, (8, n2), jnp.uint32)
        return jnp.where(jax.random.uniform(k2, (n2,)) < density, w, jnp.uint32(0))

    pa, pb = planes(next(k), 0.3), planes(next(k), 0.3)
    fl = copy_floor(pa, pb)
    rec("count_bit_bit", "xla 256^3", median_time(
        jax.jit(collide.count_bit_bit), pa, pb), fl, pa.nbytes + pb.nbytes)

    # 2. collideWithTypes, margin 0 and 8: plain XLA vs the Triton kernel
    for m in (0, 8):
        for variant, fn in (("xla", collide._types_xla),
                            ("triton kernel", collide.collide_with_types_bit_bit)):
            rec("collide_types_bit_bit", f"{variant} 256^3 margin {m}", median_time(
                jax.jit(lambda x, y, m=m, fn=fn: fn(x, y, m)), pa, pb), fl,
                pa.nbytes + pb.nbytes)
        rec("collide_bitcheck", f"xla 256^3 margin {m} count only", median_time(
            jax.jit(lambda x, y, m=m: jnp.sum(
                bitops.bit_margin_collision_check_packed(x, y, m)[0], dtype=jnp.uint32)), pa, pb),
            fl, pa.nbytes + pb.nbytes)
        rec("collide_bitcheck", f"triton kernel 256^3 margin {m} count only", median_time(
            jax.jit(lambda x, y, m=m: collide_triton.collide_types(x, y, m, mark=False)[0]),
            pa, pb), fl, pa.nbytes + pb.nbytes)
    del pa, pb

    # end to end through the public API: two 64-step UR10 swept volumes
    # (chip_smoke phase 4), built and collided, kernel vs forced XLA
    import chip_smoke

    build = chip_smoke.ur10_swept_pair(chip_smoke.FULL, args.seed)
    sa, sb = build()
    fl = copy_floor(sa.data, sb.data)

    def phase4():
        a, b = build()
        return [a.collide_with_types(b, sv_window=m) for m in (0, 8)]

    for variant, platform in (("triton kernel", None), ("xla", "cpu")):
        jax.clear_caches()
        saved = backend.platform
        if platform:
            backend.platform = lambda: platform  # the reference path, on the GPU
        try:
            for m in (0, 8):
                rec("collide_with_types (public)", f"{variant} UR10 SV 256^3 margin {m}",
                    median_time(lambda m=m: sa.collide_with_types(sb, sv_window=m)), fl,
                    sa.data.nbytes * 2)
                rec("collide_with_bitcheck (public)", f"{variant} UR10 SV 256^3 margin {m}",
                    median_time(lambda m=m: sa.collide_with_bitcheck(sb, margin=m)), fl,
                    sa.data.nbytes * 2)
            rec("chip_smoke phase 4 step", f"{variant} (2 SV builds + 2 types collides)",
                median_time(phase4, reps=5), fl, sa.data.nbytes * 2)
        finally:
            backend.platform = saved
    jax.clear_caches()

    # 3./4. projective carve, 640x480 -> 256^3, exact and pooled
    rng = np.random.default_rng(args.seed)
    depth = np.full((480, 640), 4.0, np.float32)
    depth[100:300, 200:450] = 2.5
    depth += rng.normal(0, 0.003, depth.shape).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [2.56, 2.56, 0.1]
    dj, pj = jnp.asarray(depth), jnp.asarray(pose)
    grid = jnp.full((n2,), jnp.int8(-128))
    fl = copy_floor(grid)
    for pool in (1, 8):
        carve = jax.jit(lambda d, p, pool=pool: raycast.projective_free_space(
            d, p, 525.0, 525.0, 319.5, 239.5, 0.02, (256, 256, 256), pool=pool))
        rec("projective_free_space", f"xla 640x480->256^3 pool {pool}",
            median_time(carve, dj, pj), fl, n2)
        fuse = jax.jit(lambda g, d, p, pool=pool: raycast.insert_depth_image(
            g, d, p, 525.0, 525.0, 319.5, 239.5, 0.02, (256, 256, 256), carve_pool=pool))
        rec("insert_depth_image", f"xla 640x480->256^3 pool {pool}",
            median_time(fuse, grid, dj, pj), fl, 2 * n2)

    # 5. exact EDT at 512^3 with 20k obstacles
    dims = (512, 512, 512)
    mask = jnp.zeros((n5,), bool).at[jax.random.randint(next(k), (20_000,), 0, n5)].set(True)
    packed = jax.jit(lambda m: edt.init_from_obstacle_mask(m, dims))(mask)
    fl = copy_floor(packed)
    kern = jax.jit(lambda p: edt_envelope.parallel_banding(p, dims))
    ref = jax.jit(lambda p: edt_envelope.parallel_banding_reference(p, dims))
    jfa = jax.jit(lambda p: edt.jump_flood_multires(p, dims))
    out_k, out_r = np.asarray(kern(packed)), np.asarray(ref(packed))
    same = int((out_k != out_r).sum())
    rec("parallel_banding", "triton kernel (pipeline)", median_time(kern, packed), fl,
        packed.nbytes, differing_vs_reference=same)
    rec("parallel_banding", "xla full-scan reference (pipeline)",
        median_time(ref, packed, reps=5), fl, packed.nbytes)
    d_j = np.asarray(edt.squared_distance_grid(jfa(packed), dims))
    d_k = np.asarray(edt.squared_distance_grid(jnp.asarray(out_k), dims))
    rec("jump_flood_multires", "xla (approximate JFA)", median_time(jfa, packed), fl,
        packed.nbytes, differing_distances_vs_exact=int((d_j != d_k).sum()))

    # one Y pass at real size: tile shapes of the kernel beside the XLA pass
    g = jax.random.randint(next(k), dims, 0, 1 << 20, jnp.int32)
    g = jnp.where(jax.random.uniform(next(k), dims) < 0.02, g, jnp.int32(edt_envelope.MISS))
    p = jax.random.bits(next(k), dims, jnp.uint32) >> 2
    fl = copy_floor(g, p)
    rec("envelope_pass", "xla full scan", median_time(
        jax.jit(edt_envelope._envelope_xla), g, p, reps=3),
        fl, 2 * g.nbytes)
    rec("envelope_pass", f"triton full rings tile {edt_envelope.TILE_Y}x{edt_envelope.TX}",
        median_time(jax.jit(edt_envelope.envelope_pass), g, p, reps=3), fl, 2 * g.nbytes)

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("".join(json.dumps(r) + "\n" for r in records))
        print(f"wrote {out}")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
