"""Smoke test of the path tracer on an NVIDIA GPU, in one process.

    python chip_smoke.py          # one card: the phases below, in order
    python chip_smoke.py --four   # four cards: only the sharded path

Phases on one card:
  1. device check (exits non-zero when JAX finds no GPU) and the card's
     name and power limit;
  2. parity of the compiled mesh-find kernel with the plain XLA find on a
     196,608-ray wavefront (camera rays + random bounce rays) against the
     teapot_scene tables, and with the brute-force triangle scan on the
     same wavefront for teapot_scene and teapot_hires; then the repo's
     card-only tests (pytest -m gpu);
  3. kernel vs XLA timing: the find alone at pool width, and end to end on
     teapot, teapot_hires and two_teapots;
  4. CLI renders of four scenes at 640x640, max depth 50, default pool;
     each PNG is decoded and checked;
  5. a 3-step CLI fit with a falling loss.

With --four: a sharded wavefront render compared with the single-device
render of the same scene and key (statistically: the workers draw
independent RNG streams), with steady-state samples/s on one card and on
four; and the sharded fit step's loss and gradients compared with one
card's (float32 reduction order only).

Precision: the mesh find is elementwise float32 (no matrix products, so
TF32 never applies). Tolerances, fixed beforehand:
  - hit masks agree except on at most 1e-4 of the rays (grazing hits);
  - t agrees to rtol = atol = 1e-5 wherever the triangle agrees;
  - the winning triangle agrees on at least 99.9% of the hits (t-ties);
  - normals and UVs agree to 1e-4 wherever the triangle agrees.

Any failed phase ends the run with a non-zero exit and without the last
line; on success the last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
PNGs go to chiprun_out/smoke/.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(HERE, "scenes")
OUT_DIR = os.path.join(HERE, "chiprun_out", "smoke")
POOL_RAYS = 196_608
SIZE = 640
RENDER_SPP = 16
TIMING_SPP = 8
# mesh cells of the kernel-vs-XLA decision
MESH_SCENES = ("teapot_scene", "teapot_hires", "two_teapots")
# scenes whose XLA find compiles in practical time: on teapot_hires (822
# clusters) XLA's GPU compiler spends minutes on the find's slab-entry
# reduction alone (PERF.md), so its XLA baseline is not measured here
XLA_SCENES = ("teapot_scene", "two_teapots")
CLI_SCENES = ("teapot_scene", "teapot_hires", "cornell_box",
              "scattered_balls")
HIT_MISMATCH_MAX = 1e-4
T_TOL = 1e-5
TRI_AGREE_MIN = 0.999
ATTR_TOL = 1e-4


class SmokeFailure(Exception):
    """A phase's check failed."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def scene_path(name: str) -> str:
    return os.path.join(SCENES, name + ".yaml")


def load_job(name: str):
    from hobbyraytracer_tpu.scene import build_scene, load_scene_desc
    from hobbyraytracer_tpu.scene.fixtures import ensure_assets

    ensure_assets()
    with contextlib.redirect_stdout(io.StringIO()):
        return build_scene(load_scene_desc(scene_path(name)))


def mesh_instance(job):
    return next(i for i in job.scene.instances
                if i.kind == "mesh" and i.mesh.use_bvh)


def wavefront(job, n: int, seed: int = 0):
    """n rays: half camera rays at random jittered film positions, half
    bounce rays leaving the first hits of other camera rays in random
    directions (rays that missed keep their camera origin)."""
    import jax
    import jax.numpy as jnp

    from hobbyraytracer_tpu.core.types import Rays
    from hobbyraytracer_tpu.ops.camera import get_rays
    from hobbyraytracer_tpu.scene import ir as scene_ir

    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    uv = jax.random.uniform(k[0], (2, n))
    cam = get_rays(job.camera, uv[0], uv[1], key=k[1])
    half = n // 2
    first = jax.jit(lambda s, r, kk: scene_ir.intersect_scene(
        s, r, kk, 0, mesh_backend="auto"))(
            job.scene, Rays(o=cam.o[half:], d=cam.d[half:]), k[2])
    dirs = jax.random.normal(k[3], (n - half, 3))
    o2 = jnp.where(first.hit[:, None], first.p, cam.o[half:])
    return Rays(o=jnp.concatenate([cam.o[:half], o2]),
                d=jnp.concatenate([cam.d[:half], dirs]))


def object_rays(inst, rays):
    return inst.transform.ray_to_object(rays) if inst.transform else rays


def find_kernel(m, r):
    from hobbyraytracer_tpu.core.mathx import BIG
    from hobbyraytracer_tpu.ops import intersect as isect
    from hobbyraytracer_tpu.scene import ir as scene_ir

    backend, interpret = scene_ir._resolve_mesh_backend("auto", m)
    check(backend == "pallas", f"mesh find resolved to {backend!r}")
    return isect.intersect_mesh_clustered_pallas(
        r, None, m.cluster_id, m.cluster_bmin, m.cluster_bmax, BIG,
        interpret=interpret, tri_soa=m.tri_soa, bounds8=m.bounds8,
        need_uv=True)


def find_xla(m, r):
    """(t, triangle id, hit, normal, uv) from the plain XLA traversal and
    the repo's differentiable attribute replay."""
    import jax.numpy as jnp

    from hobbyraytracer_tpu.core.mathx import BIG
    from hobbyraytracer_tpu.ops import intersect as isect

    tri_verts = m.verts[m.indices[jnp.maximum(m.cluster_id, 0)]]
    t, gid, hit = isect.intersect_mesh_clustered(
        r, tri_verts, m.cluster_id, m.cluster_bmin, m.cluster_bmax, BIG)
    h = isect.intersect_triangles_bvh(
        r, m.verts, m.normals, m.uvs, m.indices, tri_verts, m.cluster_id,
        m.cluster_bmin, m.cluster_bmax, m.mat_id, BIG, backend="xla")
    return t, gid, hit, h.normal, h.uv


def find_brute(m, r):
    """(t, triangle id, hit, normal, uv) from the dense scan over every
    triangle (watertight test, no BVH): intersect_triangles' t and hits,
    the winning index from the same running-min scan, and the winner's
    normal/UV interpolated with Moller-Trumbore barycentrics (the
    kernel's formula: on the ~1e-3-wide triangles of teapot_hires the
    watertight and Moller-Trumbore barycentrics differ by ~1e-4 in f32)."""
    import jax
    import jax.numpy as jnp

    from hobbyraytracer_tpu.core.mathx import BIG
    from hobbyraytracer_tpu.ops import intersect as isect

    n = m.indices.shape[0]
    chunk = isect.DEFAULT_CHUNK
    np_ = -(-n // chunk) * chunk
    tri = [isect._pad(m.verts[m.indices[:, c]], np_, 0.0) for c in range(3)]

    def per_chunk(start):
        v = [jax.lax.dynamic_slice_in_dim(x, start, chunk, 0) for x in tri]
        t = isect.triangle_t(r, *v, BIG)
        ids = start + jax.lax.iota("int32", chunk)
        return jnp.where(ids[None, :] < n, t, BIG)

    _, idx = isect._chunked_argmin(per_chunk, np_, r.o.shape[0], chunk)
    h = isect.intersect_triangles(r, m.verts, m.normals, m.uvs, m.indices,
                                  m.mat_id, BIG)
    corner = m.indices[jnp.maximum(idx, 0)]                   # (R, 3)
    v0, v1, v2 = (m.verts[corner[:, c]] for c in range(3))
    e1, e2, tv = v1 - v0, v2 - v0, r.o - v0
    p = jnp.cross(r.d, e2)
    det = jnp.sum(e1 * p, axis=-1)
    inv = 1.0 / jnp.where(det == 0.0, 1.0, det)
    u = jnp.sum(tv * p, axis=-1) * inv
    v = jnp.sum(r.d * jnp.cross(tv, e1), axis=-1) * inv
    w = jnp.stack([1.0 - u - v, u, v], axis=-1)[..., None]   # (R, 3, 1)
    normal = jnp.sum(w * m.normals[corner], axis=1)
    uv = jnp.sum(w * m.uvs[corner], axis=1)
    return h.t, idx, h.hit, normal, uv


def compare(label, kern, ref) -> None:
    """Check kernel results against a reference under the stated
    tolerances; print the measured errors."""
    import numpy as np

    t_k, g_k, h_k, n_k, uv_k = (np.asarray(x) for x in kern)
    t_r, g_r, h_r, n_r, uv_r = (np.asarray(x) for x in ref)
    n = len(t_r)
    hit_diff = int((h_k != h_r).sum())
    both = h_k & h_r
    same = both & (g_k == g_r)
    tri_agree = same.sum() / max(both.sum(), 1)
    # t where the winning triangle agrees; a ray through a shared edge
    # can win different triangles under the two tests, which the
    # triangle-agreement bound covers
    t_err = float(np.max(np.abs(t_k[same] - t_r[same])
                         - T_TOL * np.abs(t_r[same]), initial=0.0))
    n_err = float(np.abs(n_k[same] - n_r[same]).max(initial=0.0))
    uv_err = float(np.abs(uv_k[same] - uv_r[same]).max(initial=0.0))
    n_other = int((both & ~same).sum())
    print(f"parity {label}: {n} rays, {int(h_r.sum())} hits; hit "
          f"mismatches {hit_diff}; other triangle on {n_other} hits; "
          f"same triangle: max(|dt| - rtol|t|) {t_err:.3g} (atol "
          f"{T_TOL}); triangle agreement {tri_agree:.6f}; max |normal| err "
          f"{n_err:.3g}, max |uv| err {uv_err:.3g}")
    check(hit_diff <= HIT_MISMATCH_MAX * n, f"{label}: hit masks")
    check(t_err <= T_TOL, f"{label}: t beyond rtol=atol={T_TOL}")
    check(tri_agree >= TRI_AGREE_MIN, f"{label}: triangle agreement")
    check(n_err <= ATTR_TOL and uv_err <= ATTR_TOL,
          f"{label}: normals/UVs beyond {ATTR_TOL}")


def phase_parity() -> None:
    import jax

    for name in ("teapot_scene", "teapot_hires"):
        job = load_job(name)
        inst = mesh_instance(job)
        m = inst.mesh
        r = object_rays(inst, wavefront(job, POOL_RAYS))
        t0 = time.perf_counter()
        kern = jax.block_until_ready(jax.jit(find_kernel)(m, r))
        print(f"kernel {name}: K={m.cluster_id.shape[0]} clusters, first "
              f"call (compile + run) {time.perf_counter() - t0:.1f}s")
        if name in XLA_SCENES:
            compare(f"{name} vs XLA find", kern,
                    jax.jit(find_xla)(m, r))
        compare(f"{name} vs brute force", kern, jax.jit(find_brute)(m, r))


def phase_card_tests() -> None:
    """The repo's card-only tests (pytest marker `gpu`), in this process."""
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests", "test_gpu_kernel.py")])
    check(rc == 0, f"card-only tests: pytest exit code {rc}")


def _time(fn, reps: int) -> float:
    """Median seconds of fn() over reps timed calls (fn blocks)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_timing() -> None:
    import jax

    from hobbyraytracer_tpu.integrator import wavefront as wf
    from hobbyraytracer_tpu.scene import ir as scene_ir

    for name in MESH_SCENES:
        job = load_job(name)
        rays = wavefront(job, POOL_RAYS, seed=1)
        inst = mesh_instance(job)
        backends = ("auto", "xla") if name in XLA_SCENES else ("auto",)
        find = {}
        for backend in backends:
            f = jax.jit(lambda i, r, b=backend: scene_ir._intersect_instance(
                i, r, 1e-3, mesh_backend=b))
            jax.block_until_ready(f(inst, rays))
            find[backend] = _time(
                lambda: jax.block_until_ready(f(inst, rays)), 10)
        # end to end, in turns (kernel, xla, xla, kernel)
        e2e = {b: [] for b in backends}
        for backend in backends:
            jax.block_until_ready(wf.render_image(
                job.scene, job.camera, SIZE, SIZE, 1,
                jax.random.PRNGKey(0), mesh_backend=backend))
        order = [b for b in ("auto", "xla", "xla", "auto") if b in backends]
        for i, backend in enumerate(order):
            t0 = time.perf_counter()
            jax.block_until_ready(wf.render_image(
                job.scene, job.camera, SIZE, SIZE, TIMING_SPP,
                jax.random.PRNGKey(10 + i), mesh_backend=backend))
            e2e[backend].append(
                SIZE * SIZE * TIMING_SPP / (time.perf_counter() - t0))
        rate = {b: statistics.mean(v) for b, v in e2e.items()}
        xla = (f"xla {find['xla'] * 1e3:.3f} ms" if "xla" in find
               else "xla not measured")
        line = (f"timing {name}: find alone at {POOL_RAYS} rays: kernel "
                f"{find['auto'] * 1e3:.3f} ms, {xla}; end to end "
                f"{SIZE}x{SIZE}@{TIMING_SPP}spp primary rays/s: kernel "
                f"{rate['auto']:,.0f} {e2e['auto']}")
        if "xla" in rate:
            line += (f", xla {rate['xla']:,.0f} {e2e['xla']}; kernel/xla "
                     f"{rate['auto'] / rate['xla']:.3f}")
        print(line, flush=True)


def _cli(argv) -> tuple:
    """Run the CLI in this process; (exit code, captured stdout)."""
    from hobbyraytracer_tpu.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    return rc, buf.getvalue()


def phase_cli_renders(card: str) -> None:
    import numpy as np

    from hobbyraytracer_tpu.io.images import read_image

    os.makedirs(OUT_DIR, exist_ok=True)
    for name in CLI_SCENES:
        png = os.path.join(OUT_DIR, name + ".png")
        rc, out = _cli(["render", scene_path(name), "-o", png,
                        "--width", str(SIZE), "--height", str(SIZE),
                        "--spp", str(RENDER_SPP), "--max-depth", "50"])
        rate = [ln for ln in out.splitlines() if "primary rays/s" in ln]
        # render returns the film writer's stb-style code: 1 = written
        check(rc == 1 and rate, f"render {name}: exit {rc}")
        img = read_image(png)[..., :3].astype(np.float32) / 255.0
        check(img.shape == (SIZE, SIZE, 3), f"{name}: shape {img.shape}")
        check(bool(np.isfinite(img).all()) and img.mean() > 0.02,
              f"{name}: black or non-finite image (mean {img.mean():.4f})")
        print(f"render {name}: {rate[-1].strip()} [{card}]; image mean "
              f"{img.mean():.4f}")
        if name == "cornell_box":
            rows = slice(SIZE * 3 // 10, SIZE * 7 // 10)
            left = img[rows, : SIZE // 20].mean(axis=(0, 1))
            right = img[rows, -SIZE // 20:].mean(axis=(0, 1))
            print(f"cornell walls: left rgb {np.round(left, 3)}, right "
                  f"rgb {np.round(right, 3)}")
            # the scene (and its golden) puts green left, red right
            check(left[1] > left[0] and right[0] > right[1],
                  "cornell wall colours")


def phase_fit() -> None:
    rc, out = _cli(["fit", scene_path("shiny_teapot"), "--steps", "3"])
    lines = [ln for ln in out.splitlines() if "loss" in ln]
    for ln in lines:
        print(f"fit: {ln.strip()}")
    check(rc == 0 and lines, f"fit: exit {rc} (1 = loss did not fall)")


def phase_four() -> None:
    """The four-card path: sharded render and fit vs one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hobbyraytracer_tpu.diff.fit import render_loss, select_params
    from hobbyraytracer_tpu.integrator import wavefront as wf
    from hobbyraytracer_tpu.ops import film as film_ops
    from hobbyraytracer_tpu.parallel.shard import (make_mesh,
                                                   render_wavefront_sharded,
                                                   sharded_render_loss)

    check(len(jax.devices()) == 4, f"--four needs 4 GPUs, JAX found "
          f"{len(jax.devices())}")
    mesh = make_mesh(4)
    job = load_job("teapot_scene")
    key = jax.random.PRNGKey(0)
    spp = 2 * RENDER_SPP
    # samples retired per second between the first and the last chunk of
    # the drain: excludes the first chunk, which carries the compilation
    marks = {"one": [], "four": []}

    def mark(name):
        return lambda done, total: marks[name].append(
            (time.perf_counter(), done))

    st = wf.render_state(job.scene, job.camera, SIZE, SIZE, spp, key,
                         pool=wf.DEFAULT_POOL, steps_per_call=16,
                         progress_cb=mark("one"))
    a = np.asarray(film_ops.tonemap(wf.framebuffer(st, SIZE, SIZE) / spp)
                   ).reshape(SIZE, SIZE, 3)
    b = np.asarray(render_wavefront_sharded(
        job.scene, job.camera, SIZE, SIZE, spp, key, mesh,
        pool=wf.DEFAULT_POOL, steps_per_call=16, progress_cb=mark("four")))
    rate = {k: (v[-1][1] - v[0][1]) / (v[-1][0] - v[0][0])
            for k, v in marks.items() if len(v) > 1}
    # independent RNG streams per worker: statistical parity
    rel = abs(a.mean() - b.mean()) / a.mean()
    n_blk = SIZE // 16
    blk = lambda x: x.reshape(n_blk, 16, n_blk, 16, 3).mean(axis=(1, 3, 4))
    corr = float(np.corrcoef(blk(a).ravel(), blk(b).ravel())[0, 1])
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in jax.devices()]
    print(f"four: render {SIZE}x{SIZE}@{spp}spp, steady samples/s one "
          f"card {rate.get('one', 'not measured')}, four cards "
          f"{rate.get('four', 'not measured')}; image mean rel diff "
          f"{rel:.4f}, 16x16-block correlation {corr:.5f}; peak bytes per "
          f"card {peaks}")
    check(bool(np.isfinite(b).all()), "sharded image not finite")
    check(rel < 0.02 and corr > 0.97, "sharded render vs one card")
    check(all(p > 0 for p in peaks), "a card held no work")

    # the sharded fit step's loss and gradients: value_and_grad of
    # sharded_render_loss, the function make_sharded_fit_step (the CLI's
    # multi-device fit) differentiates
    w = h = 64
    target = jnp.zeros((w * h, 3), jnp.float32)
    params, rebuild = select_params(job.scene)
    l1, g1 = jax.value_and_grad(lambda p: render_loss(
        p, rebuild, job.camera, w, h, key, 1, target, 3))(params)
    l4, g4 = jax.value_and_grad(lambda p: sharded_render_loss(
        p, rebuild, job.camera, w, h, key, 1, target, mesh, 3))(params)
    g_err = max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))
                             / (np.abs(np.asarray(x)) + 1e-6)))
                for x, y in zip(jax.tree_util.tree_leaves(g1),
                                jax.tree_util.tree_leaves(g4)))
    print(f"four: fit loss one card {float(l1):.8f}, four cards "
          f"{float(l4):.8f}; max relative gradient difference {g_err:.3g}")
    # psum reassociates the per-card sums: float32 reduction-order noise
    check(abs(float(l4) - float(l1)) <= 1e-5 * abs(float(l1)),
          "sharded loss")
    check(g_err <= 1e-3, "sharded gradients")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)

    from hobbyraytracer_tpu.runtime import (enable_compile_cache,
                                            gpu_name_and_power_limit,
                                            require_gpu)

    enable_compile_cache()
    device = require_gpu()
    card = gpu_name_and_power_limit()
    print(f"card (name, power limit): {card}")
    print(f"jax devices: {device}")
    t0 = time.perf_counter()
    phases = ([("four", phase_four)] if args.four else [
        ("parity", phase_parity), ("card tests", phase_card_tests),
        ("timing", phase_timing),
        ("cli renders", lambda: phase_cli_renders(card.splitlines()[0])),
        ("fit", phase_fit)])
    for name, phase in phases:
        t = time.perf_counter()
        try:
            phase()
        except SmokeFailure as e:
            print(f"FAILED phase {name}: {e}", file=sys.stderr)
            return 1
        print(f"phase {name} done in {time.perf_counter() - t:.1f}s",
              flush=True)
    print(f"all phases done in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
