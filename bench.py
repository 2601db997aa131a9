"""Benchmark driver: renders the reference's headline workload and prints
ONE JSON line {"metric", "value", "unit", "vs_baseline", "device"}.

Baseline (BASELINE.md): the reference C++ tracer renders Utah-Teapot
640x640 @ 100spp in ~150s on a 12-thread CPU => ~273k primary rays/s.
This bench renders the same workload shape (teapot-class mesh in a box,
640x640 @ 100spp) on one GPU and reports primary rays/s. It exits
non-zero, printing no result, when JAX finds no GPU.

Run: python bench.py
     BENCH_SCENE=cornell python bench.py
     BENCH_SPP=20 python bench.py   (shorter smoke run)
     BENCH_REPEATS=5 python bench.py (median + spread over 5 timed runs)

Every timed repeat uses a FRESH PRNG key, the compile + warm-up render is
excluded, and with BENCH_REPEATS > 1 the JSON line reports the MEDIAN
with min/max spread fields.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

BASELINE_PRIMARY_RAYS_PER_S = 273_000.0


def main() -> int:
    import jax

    from hobbyraytracer_tpu.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    device = require_gpu()

    from hobbyraytracer_tpu.integrator import path as path_mod
    from hobbyraytracer_tpu.integrator import wavefront
    from hobbyraytracer_tpu.scene import build_scene, load_scene_desc
    from hobbyraytracer_tpu.scene.fixtures import ensure_assets

    ensure_assets()
    here = os.path.dirname(os.path.abspath(__file__))
    which = os.environ.get("BENCH_SCENE", "teapot")
    scene_file = {
        "teapot": "teapot_scene.yaml",
        "cornell": "cornell_box.yaml",
        "balls": "scattered_balls.yaml",
        "teapot_hires": "teapot_hires.yaml",
        "two_teapots": "two_teapots.yaml",
    }.get(which, "teapot_scene.yaml")
    width = height = int(os.environ.get("BENCH_SIZE", "640"))
    samples = int(os.environ.get("BENCH_SPP", "100"))
    integrator = os.environ.get("BENCH_INTEGRATOR", "wavefront")

    job = build_scene(load_scene_desc(os.path.join(here, "scenes",
                                                   scene_file)))
    repeats = max(1, int(os.environ.get("BENCH_REPEATS", "3")))

    if integrator == "wavefront":
        pool = int(os.environ.get("BENCH_POOL", str(wavefront.DEFAULT_POOL)))

        def render(spp, key):
            img = wavefront.render_image(job.scene, job.camera, width,
                                         height, spp, key, pool=pool)
            jax.block_until_ready(img)
    else:
        chunk = max(1, min(samples, 2_000_000 // (width * height)))

        def render(spp, key):
            img = path_mod.render_image(job.scene, job.camera, width,
                                        height, spp, key,
                                        sample_chunk=chunk)
            img.block_until_ready()

    # warmup / compile (excluded from the timing, like the reference's
    # load-vs-render split in main.cpp:164-192)
    render(1, jax.random.PRNGKey(0))
    rates = []
    for rep in range(repeats):
        # fresh key per repeat: same-input repeats under-measure
        t0 = time.time()
        render(samples, jax.random.PRNGKey(100 + rep))
        rates.append(width * height * samples / (time.time() - t0))

    rays_per_s = statistics.median(rates)
    line = {
        "metric": f"primary_rays_per_s_{which}_{width}x{height}@{samples}spp",
        "value": round(rays_per_s),
        "unit": "rays/s/device",
        "vs_baseline": round(rays_per_s / BASELINE_PRIMARY_RAYS_PER_S, 3),
        "device": device,
    }
    if repeats > 1:
        line["repeats"] = repeats
        line["min"] = round(min(rates))
        line["max"] = round(max(rates))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
