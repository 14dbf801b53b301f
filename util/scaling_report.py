"""Multi-chip scaling-efficiency report (BASELINE north star: >= 90%
frames/s efficiency on a 2-host pod slice).

Runs the dp-sharded level-8 analysis on meshes of 1..N devices and
reports frames/s plus efficiency vs linear scaling. On GPUs this
measures sharded throughput across cards; on a CPU host it exercises the
same sharded program on the virtual device mesh (set
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu).

usage: python util/scaling_report.py [frames_per_device] [block_size]
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    import os

    import jax

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from flake_tpu import params as P
    from flake_tpu.ops.frame import FrameConfig
    from flake_tpu.parallel.mesh import make_mesh, make_sharded_analyzer

    fpd = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    ndev = len(jax.devices())
    cfg = FrameConfig.from_params(P.set_defaults(8), channels=2, bps=16,
                                  block_size=B)
    rng = np.random.default_rng(0)

    sizes = []
    d = 1
    while d <= ndev:
        sizes.append(d)
        d *= 2
    base_fps = None
    print(f"devices  frames/s   x-realtime   efficiency")
    for nd in sizes:
        mesh = make_mesh(nd)
        run = make_sharded_analyzer(cfg, mesh)
        F = fpd * nd
        samples = rng.integers(-30000, 30000, (F, B, 2)).astype(np.int32)
        hdr = np.full((F,), 48, np.int32)
        out = run(samples, hdr)
        jax.block_until_ready(out)
        best = None
        iters = 5
        for _ in range(3):
            t0 = time.perf_counter()
            acc = None
            for _ in range(iters):
                o = run(samples, hdr)
                s = jnp.sum(o["frame_bytes"])
                acc = s if acc is None else acc + s
            int(acc)
            dt = (time.perf_counter() - t0) / iters
            best = dt if best is None else min(best, dt)
        fps = F / best
        if base_fps is None:
            base_fps = fps
        eff = fps / (base_fps * nd)
        xrt = fps * B / 44100
        print(f"{nd:7d}  {fps:8.0f}   {xrt:10.0f}   {eff:9.1%}")

    # On a VIRTUAL mesh (8 "devices" = the same physical cores) linear
    # scaling is impossible by construction; the honest host-side
    # figure is the *sharding overhead at constant total work*: the
    # same F frames dense on 1 device vs dp-sharded over all devices.
    F = fpd * ndev
    samples = rng.integers(-30000, 30000, (F, B, 2)).astype(np.int32)
    hdr = np.full((F,), 48, np.int32)

    from flake_tpu.ops.frame import analyze_frames_jit

    def timeit(fn):
        fn()
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            dt = (time.perf_counter() - t0) / 3
            best = dt if best is None else min(best, dt)
        return best

    sj = jnp.asarray(samples)
    hj = jnp.asarray(hdr)
    t_dense = timeit(lambda: int(jnp.sum(
        analyze_frames_jit(sj, cfg, hj)["frame_bytes"])))
    run = make_sharded_analyzer(cfg, make_mesh(ndev))
    t_shard = timeit(lambda: int(jnp.sum(
        run(samples, hdr)["frame_bytes"])))
    print(f"\nconstant-work comparison ({F} frames, {ndev} devices):")
    print(f"  dense 1-device   {t_dense * 1e3:8.1f} ms")
    print(f"  dp-sharded       {t_shard * 1e3:8.1f} ms")
    print(f"  sharding overhead {100 * (t_shard / t_dense - 1):+6.1f}%  "
          "(<= 0 means the partitioned program is no slower than the "
          "dense one on the same silicon)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
