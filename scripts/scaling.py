"""Scaling-efficiency measurement (BASELINE north star: >= 0.8 efficiency
from 1 device to N).

Measures the sharded wavefront renderer's throughput at mesh sizes
1/2/4/... and reports per-device efficiency  eff(n) = T(n) / (n * T(1))
where T is work items per second, writing the result to
chiprun_out/scaling.json (git-ignored).

On real multi-device hardware this is the true number (the artifact is
tagged "real"). Without it, the virtual CPU mesh (JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=8) tags the artifact
"virtual": virtual devices share the same host cores, so ABSOLUTE
efficiency there is meaningless — the virtual run validates that the
sharded program compiles, drains every work item, and has no hidden
cross-device serialization (efficiency collapsing far below 1/n would
indicate added collectives inside the drain loop; there is exactly one
psum, at the end). tests/test_dist.py::test_scaling_script_core invokes
`measure` so this path cannot rot.

Usage: python scripts/scaling.py [--sizes 1,2,4,8] [--spp 16] [--dim 128]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(sizes, spp=16, dim=128, scene="cornell_box.yaml",
            max_depth=16, verbose=True):
    """Render the scene at each mesh size; returns the artifact dict
    {"platform", "mode", "runs": [{mesh_size, items_per_s,
    efficiency_vs_1}, ...]}. Real-vs-virtual mode is detected from the
    device platform (cpu = virtual host mesh)."""
    import jax

    from hobbyraytracer_tpu.parallel.shard import (make_mesh,
                                                   render_wavefront_sharded)
    from hobbyraytracer_tpu.scene import build_scene, load_scene_desc
    from hobbyraytracer_tpu.scene.fixtures import ensure_assets

    ensure_assets()
    job = build_scene(load_scene_desc(os.path.join(REPO, "scenes", scene)))
    w = h = dim
    total = w * h * spp
    key = jax.random.PRNGKey(0)
    n_avail = len(jax.devices())
    sizes = [s for s in sizes if s <= n_avail]
    platform = jax.devices()[0].platform
    mode = "virtual-host-mesh" if platform == "cpu" else "real"

    runs = []
    base = None
    for n in sizes:
        mesh = make_mesh(n)
        # warmup/compile excluded
        img = render_wavefront_sharded(job.scene, job.camera, w, h, 1, key,
                                       mesh, max_depth=max_depth)
        jax.block_until_ready(img)
        t0 = time.time()
        img = render_wavefront_sharded(job.scene, job.camera, w, h, spp,
                                       key, mesh, max_depth=max_depth)
        jax.block_until_ready(img)
        dt = time.time() - t0
        rate = total / dt
        if base is None:
            base = (n, rate)
        eff = rate * base[0] / (n * base[1])
        row = {"mesh_size": n, "items_per_s": round(rate),
               "efficiency_vs_1": round(eff, 3)}
        runs.append(row)
        if verbose:
            print(json.dumps({**row, "platform": platform}))
    return {"platform": platform, "mode": mode,
            "workload": {"scene": scene, "dim": dim, "spp": spp,
                         "max_depth": max_depth},
            "note": ("virtual devices share one host's cores: this run "
                     "validates compile/drain/no-hidden-serialization, "
                     "NOT hardware efficiency — the >=0.8 north star "
                     "needs real devices"
                     if mode != "real" else
                     "real-hardware per-device scaling efficiency"),
            "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--scene", default="cornell_box.yaml")
    ap.add_argument("--max-depth", type=int, default=16)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "scaling.json"))
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    artifact = measure([int(s) for s in args.sizes.split(",")],
                       spp=args.spp, dim=args.dim, scene=args.scene,
                       max_depth=args.max_depth)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(artifact, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
