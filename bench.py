"""Headline benchmark: voxel collision checks/sec + insert->collide cycle Hz.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", <all five
BASELINE config numbers>, "device", "regressions"} where the value is
voxel-pair collision checks/sec on a 512^3 prob x prob sweep (the reference's
kernelCollideVoxelMapsDebug workload) and vs_baseline is measured against the
1e9 checks/s target from BASELINE.md. Details go to stderr. It runs only on
a GPU and fails without one.

"regressions" lists broken exact contracts (the linkage scene's 8000-voxel
count). The scored JSON line is emitted as soon as the headline + cycle + all
five BASELINE configs are measured (secondary diagnostics follow on stderr
only); a SIGTERM/SIGINT handler and a 30-minute watchdog timer flush a
partial line if a phase hangs, and a crash after the headline still emits
whatever was measured. The END of the run prints the full dict to stderr and
writes it to BENCH_SELF.json. The persistent XLA compilation cache
(utils/jitcache) makes repeat runs compile-free.

Measurement method: each measurement runs K sweeps inside ONE jitted
lax.fori_loop whose per-iteration parameters change (so XLA cannot hoist the
sweep); each call ends with block_until_ready, the median of 5 calls after a
warm-up is taken, and the 1-iteration program's time is subtracted:
t_sweep = (t(K) - t(1)) / (K - 1).
"""
import json
import signal
import sys
import threading
import time
from pathlib import Path

import numpy as np

# the one JSON line under construction; flushed exactly once
_REPORT = {
    "metric": "voxel collision checks/sec (512^3 prob x prob)",
    "value": 0.0,
    "unit": "checks/s",
    "vs_baseline": 0.0,
}
# exact numeric contracts: a measured value that differs is a regression
_CONTRACTS = {"b1_linkage_count": 8000}
_EMITTED = False
_EMIT_LOCK = threading.Lock()


def _emit_report():
    global _EMITTED
    with _EMIT_LOCK:
        if _EMITTED:
            return
        _EMITTED = True
    _REPORT["regressions"] = _check_regressions(_REPORT)
    for r in _REPORT["regressions"]:
        print(f"WARN regression: {r}", file=sys.stderr)
    print(json.dumps(_REPORT), flush=True)


def _finalize_report():
    """End-of-run: re-check regressions over the COMPLETE report, surface
    WARNs on stderr, mirror the full dict to stderr + BENCH_SELF.json.

    The scored stdout line is emitted as soon as the headline + cycle + five
    BASELINE configs are measured (driver timeouts must never lose it — that
    is how round 4's record died when emission sat at the very end), with a
    watchdog timer + signal handler flushing a partial line if any phase
    hangs first. Only the post-emission stderr diagnostics are excluded from
    the scored line; they reach the record via the stderr tail and this side
    file."""
    _REPORT["regressions"] = _check_regressions(_REPORT)
    for r in _REPORT["regressions"]:
        print(f"WARN regression: {r}", file=sys.stderr)
    print("full report: " + json.dumps(_REPORT), file=sys.stderr, flush=True)
    try:
        (Path(__file__).resolve().parent / "BENCH_SELF.json").write_text(
            json.dumps(_REPORT, indent=1) + "\n"
        )
    except OSError as exc:
        print(f"BENCH_SELF.json not written: {exc!r}", file=sys.stderr)


def _on_signal(signum, frame):
    print(f"bench interrupted by signal {signum}; flushing partial report", file=sys.stderr)
    _emit_report()
    raise SystemExit(1)


def _check_regressions(report):
    """Broken exact contracts (_CONTRACTS) in a report; unmeasured keys
    (a partial run) are not a verdict."""
    out = []
    for key, expect in _CONTRACTS.items():
        got = report.get(key)
        if got is None or got == 0:
            continue
        if got != expect:
            out.append(f"{key}: {got} != exact contract {expect}")
    return out


def _timed_loop(build_fn, iters, *args):
    """build_fn(k) -> jitted callable(*args) running k serially-dependent
    sweeps; returns seconds per sweep (see the module docstring)."""
    import statistics

    import jax

    fn_k = build_fn(iters)
    fn_1 = build_fn(1)
    jax.block_until_ready(fn_k(*args))  # compile + warm up
    jax.block_until_ready(fn_1(*args))

    def run(f):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*args))
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    return max(run(fn_k) - run(fn_1), 1e-9) / (iters - 1)


def _device_record():
    """platform, device kind and nvidia-smi's name + power limit."""
    import subprocess

    import jax

    d = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()[0].strip()
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def main():
    import jax
    import jax.numpy as jnp

    from gpu_voxels_jax.utils.jitcache import enable_persistent_cache

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's backend is {jax.default_backend()!r}")
    _REPORT["device"] = _device_record()
    cache = enable_persistent_cache()
    print(f"persistent compilation cache: {cache}", file=sys.stderr)

    from gpu_voxels_jax.geometry import generation
    from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap
    from gpu_voxels_jax.ops import collide as xla_collide

    dims = (512, 512, 512)
    n = dims[0] * dims[1] * dims[2]
    side = 1.0

    rng = np.random.default_rng(0)
    # large random inputs are generated on the device
    k0 = jax.random.PRNGKey(0)
    a, b = jax.jit(
        lambda k: tuple(
            jax.random.randint(kk, (n,), -128, 128, jnp.int8)
            for kk in jax.random.split(k)
        )
    )(k0)

    def build_xla(k):
        @jax.jit
        def run(x, y):
            def body(i, acc):
                # threshold depends on the carried count: serial dependency,
                # so XLA cannot hoist or batch the sweeps
                t1 = (acc % jnp.uint32(3)).astype(jnp.int32) - 120
                return acc + xla_collide.count_prob_prob(x, y, t1, 0)

            return jax.lax.fori_loop(0, k, body, jnp.uint32(0))

        return run

    iters = 201
    t_xla = _timed_loop(build_xla, iters, a, b)
    checks_per_sec = n / t_xla
    print(
        f"collide 512^3: {t_xla*1e3:.3f} ms/sweep -> {checks_per_sec:.3e} checks/s "
        f"(eff BW {2*n/t_xla/1e9:.0f} GB/s)",
        file=sys.stderr,
    )
    _REPORT["value"] = checks_per_sec
    _REPORT["vs_baseline"] = checks_per_sec / 1e9
    global _HEADLINE_DONE
    _HEADLINE_DONE = True

    # full cycle: insert two Kinect-sized clouds (307k points) + collide, 512^3
    pts_env = jnp.asarray(
        generation.create_equidistant_points_in_box(307200, (511, 511, 511), side)
    )

    def build_cycle(k):
        @jax.jit
        def run(pts):
            def body(i, acc):
                # cloud shift depends on the carried count: serial dependency
                off = (acc % jnp.uint32(7)).astype(jnp.float32)
                m1 = ProbVoxelMap.create(dims, side).insert_point_cloud(pts + off)
                m2 = ProbVoxelMap.create(dims, side).insert_point_cloud(pts + off + 1.0)
                return acc + m1.collide_with(m2, 0.5)

            return jax.lax.fori_loop(0, k, body, jnp.uint32(0))

        return run

    t_cycle = _timed_loop(build_cycle, 101, pts_env)
    print(
        f"full insert->collide cycle 512^3: {t_cycle*1e3:.2f} ms = {1.0/t_cycle:.1f} Hz",
        file=sys.stderr,
    )
    _REPORT["cycle_hz_512"] = 1.0 / t_cycle

    from gpu_voxels_jax.ops import edt

    # 256-bit map collide at 256^3 (sparse random planes, device-generated)
    nb = 256 ** 3

    def _rand_planes(k):
        k1, k2 = jax.random.split(k)
        return jax.random.bits(k1, (8, nb), jnp.uint32) & jax.random.bits(
            k2, (8, nb), jnp.uint32
        ) & jnp.uint32(3)

    pa, pb = jax.jit(
        lambda k: tuple(_rand_planes(kk) for kk in jax.random.split(k))
    )(jax.random.PRNGKey(1))


    # --- the five BASELINE.md configs, one stderr line each ----------------
    # config #1: gvl_linkage_test — exact 8000-count contract + call latency
    import time as _time

    from gpu_voxels_jax.api import GpuVoxels
    from gpu_voxels_jax.constants import BitVoxelMeaning, MapType

    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(128, 128, 128, 0.01)
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "bA")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "bB")
    # the exact gvl_linkage_test boxes (overlap 0.4-0.6 -> 20^3 = 8000)
    gvl.insert_box_into_map((0.4, 0.4, 0.4), (0.8, 0.8, 0.8), "bA", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    gvl.insert_box_into_map((0.2, 0.2, 0.2), (0.6, 0.6, 0.6), "bB", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    c1 = int(gvl.get_map("bA").collide_with(gvl.get_map("bB"), 0.1))
    t0 = _time.perf_counter()
    c1 = int(gvl.get_map("bA").collide_with(gvl.get_map("bB"), 0.1))
    t_link = _time.perf_counter() - t0
    print(
        f"BASELINE #1 linkage scene: count={c1} (expect 8000) in {t_link*1e3:.1f} ms/call",
        file=sys.stderr,
    )
    _REPORT["b1_linkage_count"] = c1
    _REPORT["b1_linkage_ms"] = t_link * 1e3

    # config #2: Kinect 640x480 -> 256^3 sensor fusion with the EXACT
    # per-pixel carve (reference insertSensorData semantics, default path)
    from gpu_voxels_jax.ops import raycast as rc_ops

    dims_s = (256, 256, 256)
    ns = dims_s[0] * dims_s[1] * dims_s[2]
    h_img, w_img = 480, 640
    depth = np.full((h_img, w_img), 4.0, np.float32)
    depth[100:300, 200:450] = 2.5
    depth[350:460, 50:250] = 1.8
    depth += rng.normal(0, 0.003, (h_img, w_img)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [2.56, 2.56, 0.1]
    depth_j = jnp.asarray(depth)
    pose_j = jnp.asarray(pose)
    fresh = jnp.full((ns,), jnp.int8(-128))

    def build_fusion(k):
        @jax.jit
        def run(d, fresh_map):
            def body(i, acc):
                out = rc_ops.insert_depth_image(
                    fresh_map, d + i.astype(jnp.float32) * 1e-6, pose_j,
                    525.0, 525.0, 320.0, 240.0, 0.02, dims_s,
                )
                return acc + out[ns // 2].astype(jnp.int32)

            return jax.lax.fori_loop(0, k, body, jnp.int32(0))

        return run

    t_fuse = _timed_loop(build_fusion, 8, depth_j, fresh)
    print(
        f"BASELINE #2 sensor fusion 640x480 -> 256^3 (EXACT carve, default): "
        f"{t_fuse*1e3:.2f} ms = {1.0/t_fuse:.1f} Hz (target >=30)",
        file=sys.stderr,
    )
    _REPORT["b2_sensor_fusion_hz"] = 1.0 / t_fuse

    # config #3: UR10 swept-volume trajectory (64 steps, per-step SV bits)
    from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap
    from gpu_voxels_jax.robot.presets import ur_robot
    from gpu_voxels_jax.robot.swept_volume import insert_swept_volume_batched

    chain = ur_robot("ur10", spacing=0.02)
    base = jnp.asarray([2.56, 2.56, 0.5], jnp.float32)

    class _Placed:
        def transformed_clouds_for(self, cfg):
            from dataclasses import replace as _replace

            full = jnp.concatenate([cfg, jnp.zeros((1,), jnp.float32)])
            c = chain.transformed_clouds_for(full)
            return _replace(c, points=c.points + base)

    cfgs = np.linspace(
        [0.3, -0.5, 0.5, 0, 0, 0], [-1.2, -0.2, 1.0, 0.4, 0.3, 0], 64
    ).astype(np.float32)

    def build_sv(k):
        @jax.jit
        def run(cs, env_planes):
            # env map passed as an argument: closing over it would embed
            # 536 MB of constants in the program
            def body(i, acc):
                m = insert_swept_volume_batched(
                    BitVectorVoxelMap.create(dims_s, 0.02), _Placed(),
                    cs + (acc % jnp.uint32(5)).astype(jnp.float32) * 1e-4,
                )
                return acc + xla_collide.count_bit_bit(m.data, env_planes)

            return jax.lax.fori_loop(0, k, body, jnp.uint32(0))

        return run

    t_sv = _timed_loop(build_sv, 4, jnp.asarray(cfgs), pa)
    print(
        f"BASELINE #3 UR10 64-step swept volume + env collide at 256^3: "
        f"{t_sv*1e3:.1f} ms/trajectory",
        file=sys.stderr,
    )
    _REPORT["b3_swept_volume_ms"] = t_sv * 1e3

    # config #4: PBA exact EDT at 512^3 (Triton envelope sweeps)
    from gpu_voxels_jax.ops import edt_envelope

    ne5 = 512 ** 3
    packed5 = jax.jit(
        lambda k: edt.init_from_obstacle_mask(
            jnp.zeros((ne5,), bool)
            .at[jax.random.randint(k, (20000,), 0, ne5)]
            .set(True),
            (512, 512, 512),
        )
    )(jax.random.PRNGKey(4))

    def build_pba(k):
        @jax.jit
        def run(p):
            def body(i, acc):
                pp = p.at[0].set(p[0] ^ (acc & jnp.uint32(1)))
                out = edt_envelope.parallel_banding(pp, (512, 512, 512))
                return acc + out[ne5 // 2]

            return jax.lax.fori_loop(0, k, body, jnp.uint32(0))

        return run

    t_pba = _timed_loop(build_pba, 3, packed5)
    print(
        f"BASELINE #4 exact PBA EDT 512^3 (20k obstacles): {t_pba*1e3:.1f} ms",
        file=sys.stderr,
    )
    _REPORT["b4_pba_edt_ms"] = t_pba * 1e3

    # config #5: motion-validity batch against a 1024^3 hierarchical env
    from dataclasses import replace as _dc_replace

    from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud
    from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap
    from gpu_voxels_jax.planning.validity import HierarchicalValidityChecker

    env_pts = rng.uniform(0, 1024, (200000, 3)).astype(np.float32)
    env_h = HierarchicalBitMap.create((1024, 1024, 1024)).insert_point_cloud(env_pts)
    robot_cloud = MetaPointCloud.from_clouds(
        [rng.uniform(-2, 2, (400, 3)).astype(np.float32)], names=("body",)
    )

    class _Translated:
        def transformed_clouds_for(self, cfg):
            return _dc_replace(robot_cloud, points=robot_cloud.points + cfg)

    checker = HierarchicalValidityChecker(env_h, _Translated())
    states = rng.uniform(100.0, 900.0, (315, 3)).astype(np.float32)
    checker.batch_colliding_voxels(states)  # compile
    t0 = _time.perf_counter()
    cv = checker.batch_colliding_voxels(states)
    t_val = _time.perf_counter() - t0
    print(
        f"BASELINE #5 motion validity at 1024^3: {len(states)} poses in "
        f"{t_val*1e3:.1f} ms = {len(states)/t_val:.0f} checks/s "
        f"(colliding={int((cv > 0).sum())})",
        file=sys.stderr,
    )
    _REPORT["b5_validity_checks_per_s"] = len(states) / t_val

    # emit the scored stdout line NOW (headline + cycle + all five BASELINE
    # configs measured): every remaining phase only adds stderr diagnostics +
    # the end-of-run side file. A watchdog timer (below, __main__) emits a
    # partial line if anything above hangs past the deadline.
    _emit_report()

    # --- secondary workloads (stderr diagnostics, best-effort) -------------
    from gpu_voxels_jax import bitops
    from gpu_voxels_jax.ops import edt

    def build_bit(count_fn):
        def build(k):
            @jax.jit
            def run(x, y):
                def body(i, carry):
                    # 4-byte in-place bumps defeat loop hoisting/CSE with no
                    # buffer copy (loop-state aliasing keeps the update in
                    # place). An optimization_barrier form would copy the
                    # whole 536 MB carried map every iteration.
                    acc, a, b = carry
                    a = a.at[0, 0].add(1)
                    b = b.at[0, 0].add(1)
                    return (acc + count_fn(a, b), a, b)

                acc, _, _ = jax.lax.fori_loop(0, k, body, (jnp.uint32(0), x, y))
                return acc

            return run

        return build

    t_bit = _timed_loop(build_bit(xla_collide.count_bit_bit), 41, pa, pb)
    print(
        f"bitvector collide 256^3: {t_bit*1e3:.3f} ms/sweep = {nb/t_bit:.3e} checks/s",
        file=sys.stderr,
    )
    _REPORT["bit_fold_ms_256"] = t_bit * 1e3

    # maintained occupancy-summary collide: BitVectorVoxelMap keeps a
    # uint8[N] !noneButEmpty summary coherent through every mutation, so the
    # plain collideWith count reads 2 bytes/voxel-pair instead of folding 64
    # (the raw-plane fold above is the occ=None fallback / worst case)
    occ_a, occ_b = jax.jit(
        lambda k: tuple(
            (jax.random.uniform(kk, (nb,)) < 0.3).astype(jnp.uint8)
            for kk in jax.random.split(k)
        )
    )(jax.random.PRNGKey(2))

    def build_occ(k):
        @jax.jit
        def run(x, y):
            def body(i, carry):
                acc, a, b = carry
                a = a.at[0].add(1)
                b = b.at[0].add(1)
                return (acc + xla_collide.count_occ_occ(a, b), a, b)

            acc, _, _ = jax.lax.fori_loop(0, k, body, (jnp.uint32(0), x, y))
            return acc

        return run

    # 2001 iterations: a sweep this short must dominate the launch and fetch
    # in the t(K) - t(1) subtraction
    t_occ = _timed_loop(build_occ, 2001, occ_a, occ_b)
    print(
        f"bitvector collide 256^3 via maintained occupancy summary: "
        f"{t_occ*1e3:.3f} ms/sweep = {nb/t_occ:.3e} checks/s "
        f"({t_bit/t_occ:.0f}x the plane fold)",
        file=sys.stderr,
    )
    _REPORT["occ_summary_ms_256"] = t_occ * 1e3

    # EDT (jump flood) at 256^3 with 10k obstacles
    dims_e = (256, 256, 256)
    ne = 256 ** 3
    packed = jax.jit(
        lambda k: edt.init_from_obstacle_mask(
            jnp.zeros((ne,), bool)
            .at[jax.random.randint(k, (10000,), 0, ne)]
            .set(True),
            dims_e,
        )
    )(jax.random.PRNGKey(3))

    def build_edt(k):
        @jax.jit
        def run(p):
            def body(i, acc):
                pp = p.at[0].set(p[0] ^ (acc & jnp.uint32(1)))
                out = edt.jump_flood_multires(pp, dims_e)
                return acc + out[ne // 2]

            return jax.lax.fori_loop(0, k, body, jnp.uint32(0))

        return run

    t_edt = _timed_loop(build_edt, 4, packed)
    print(f"EDT multires jump-flood 256^3 (10k obstacles): {t_edt*1e3:.1f} ms", file=sys.stderr)
    _REPORT["edt_jfa_ms_256"] = t_edt * 1e3

    # the jumpFlood3D API route, driven through the PUBLIC
    # DistanceVoxelMap.jump_flood() (inline-jit traces into the loop) so this
    # covers the actual routing condition, not just the kernel it picks
    from dataclasses import replace as _dc_replace

    from gpu_voxels_jax.maps.distance_map import DistanceVoxelMap as _DVM

    # 1-element placeholder data: replace() swaps in the real grid inside the
    # loop, and a full proto would close a 64 MB constant into the jit
    _dvm_proto = _DVM(jnp.zeros((1,), jnp.uint32), dims_e, 1.0)

    def build_edt_api(k):
        @jax.jit
        def run(p):
            def body(i, acc):
                pp = p.at[0].set(p[0] ^ (acc & jnp.uint32(1)))
                out = _dc_replace(_dvm_proto, data=pp).jump_flood().data
                return acc + out[ne // 2]

            return jax.lax.fori_loop(0, k, body, jnp.uint32(0))

        return run

    t_edt_api = _timed_loop(build_edt_api, 6, packed)
    print(
        f"EDT jump_flood() API route 256^3 (10k obstacles): "
        f"{t_edt_api*1e3:.1f} ms",
        file=sys.stderr,
    )
    _REPORT["edt_api_ms_256"] = t_edt_api * 1e3

    # insert throughput: 307k points into 512^3
    def build_insert(k):
        @jax.jit
        def run(pts):
            def body(i, acc):
                off = (acc % jnp.uint32(7)).astype(jnp.float32)
                m = ProbVoxelMap.create(dims, side).insert_point_cloud(pts + off)
                return acc + m.data[0].astype(jnp.uint32)

            return jax.lax.fori_loop(0, k, body, jnp.uint32(0))

        return run

    t_ins = _timed_loop(build_insert, 51, pts_env)
    print(
        f"insert 307k points into fresh 512^3: {t_ins*1e3:.3f} ms = "
        f"{pts_env.shape[0]/t_ins:.3e} points/s",
        file=sys.stderr,
    )
    _REPORT["insert_points_per_s_512"] = float(pts_env.shape[0]) / t_ins

_HEADLINE_DONE = False

if __name__ == "__main__":
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    # watchdog: if any phase hangs (pathological compile), the
    # scored line still reaches stdout with whatever was measured by then
    _watchdog = threading.Timer(1800.0, _emit_report)
    _watchdog.daemon = True  # never holds the process open after completion
    _watchdog.start()
    try:
        main()
    except Exception as exc:
        if not _HEADLINE_DONE:
            raise  # headline failed: a real benchmark failure
        print(f"post-headline phase aborted: {exc!r}", file=sys.stderr)
    _emit_report()  # no-op when the early emission already fired
    _finalize_report()
