"""CLI entry point (reference: main.cpp:142-195).

`python -m hobbyraytracer_tpu.cli.main render [scene.yaml]` mirrors the
reference binary: positional scene path defaulting to teapot_scene.yaml,
H:M:S load/total timing lines ("Loaded scene: ...! (completed in H:M:S)" /
"Done! (completed in H:M:S)"), exit -1 on load failure, and the film's
output-extension dispatch. Extensions: `fit` (differentiable material fit)
and `bench` (rays/s meter) subcommands, plus flags for spp / size / depth /
device selection that the reference hardcodes.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from ..runtime import device_info, enable_compile_cache


def _hms(seconds: float) -> str:
    h = int(seconds // 3600)
    m = int((seconds - h * 3600) // 60)
    s = seconds - h * 3600 - m * 60
    return f"{h}:{m}:{s:g}"


def _progress(done: int, total: int) -> None:
    print(f"\rPixels rendered: {done}/{total}", end="", flush=True)


def cmd_render(args) -> int:
    t_start = time.time()
    import jax
    import jax.numpy as jnp  # noqa: F401  (async checkpoint snapshot)

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    if args.num_processes and args.num_processes > 1:
        from ..parallel.shard import init_multihost
        init_multihost(args.coordinator, args.num_processes,
                       args.process_id)

    from ..integrator import path as path_mod
    from ..integrator import wavefront
    from ..ops import film as film_ops
    from ..scene import build_scene, load_scene_desc
    from ..scene.schema import SceneError

    try:
        job = build_scene(load_scene_desc(args.scene))
    except SceneError as e:
        print(e)
        return -1

    width = args.width or job.width
    height = args.height or job.height
    samples = args.spp or job.samples
    output = args.output or job.output

    print(f"\nLoaded scene: {args.scene}! (completed in "
          f"{_hms(time.time() - t_start)})")

    key = jax.random.PRNGKey(args.seed)
    total_px = width * height
    import numpy as np
    if getattr(args, "profile", None):
        jax.profiler.start_trace(args.profile)
    t_render0 = time.time()

    if args.integrator == "wavefront":
        # periodic progress at <= ~500 ms cadence (main.cpp:95-109's
        # reporter thread becomes a between-chunks host callback)
        last = [0.0]

        def progress_cb(retired, total):
            now = time.time()
            if retired >= total or now - last[0] >= 0.5:
                last[0] = now
                _progress(min(retired // samples, total_px), total_px)

        ckpt_cb = None
        state = None
        n_dev = len(jax.devices())
        if args.checkpoint:
            from ..io import checkpoint as ckpt
            meta = ckpt.render_meta(width, height, samples,
                                    wavefront.SAMPLE_CHUNK,
                                    n_workers=n_dev)
            if args.resume and os.path.exists(args.checkpoint):
                state = ckpt.load_state(args.checkpoint, expect=meta)
                # multi-device checkpoints stack per-worker states, so
                # retired is an (n_devices,) array — sum, don't int()
                done = int(np.sum(np.asarray(state.retired)))
                print(f"Resumed checkpoint: {args.checkpoint} "
                      f"({done} samples done)")
            last_ck = [time.time()]
            ck_thread = [None]
            ck_err = [None]

            def _write(snap):
                try:
                    ckpt.save_state(args.checkpoint, snap, meta=meta)
                except BaseException as e:  # surfaced on the next tick
                    ck_err[0] = e

            def ckpt_cb(s):
                # ASYNC checkpointing: the device->host fetch and the
                # file write would otherwise serialize the render for
                # their whole duration. Snapshot
                # the state on DEVICE (cheap device copy — the live buffers
                # are donated to the next chunk and must not be read
                # concurrently), then fetch+write on a worker thread
                # overlapped with the next render chunks. If a save is
                # still in flight at the next cadence tick, skip — the
                # following tick retries with fresher state.
                import threading

                if ck_err[0] is not None:
                    # a failed save must abort like the old synchronous
                    # write did — a render that "succeeds" with a stale
                    # or absent checkpoint hides the failure until a
                    # resume is actually needed
                    raise RuntimeError(
                        f"checkpoint write failed: {ck_err[0]}"
                    ) from ck_err[0]
                if time.time() - last_ck[0] < args.checkpoint_every:
                    return
                t = ck_thread[0]
                if t is not None and t.is_alive():
                    return
                snap = jax.tree.map(jnp.copy, s)
                ck_thread[0] = threading.Thread(target=_write,
                                                args=(snap,), daemon=False)
                ck_thread[0].start()
                last_ck[0] = time.time()
        if n_dev > 1:
            # multi-chip: one drain loop per device over its item slice,
            # chunked on the host so progress + checkpoint/resume work
            # exactly like the single-device path (the state checkpoint
            # carries a leading device axis; resume needs the same mesh)
            from ..parallel.shard import make_mesh, render_wavefront_sharded
            img = render_wavefront_sharded(
                job.scene, job.camera, width, height, samples, key,
                make_mesh(n_dev), max_depth=args.max_depth,
                pool=args.pool or wavefront.DEFAULT_POOL,
                progress_cb=progress_cb, checkpoint_cb=ckpt_cb,
                state=state, rr=not args.no_rr)
        else:
            img = wavefront.render_image(
                job.scene, job.camera, width, height, samples, key,
                max_depth=args.max_depth,
                pool=args.pool or wavefront.DEFAULT_POOL,
                progress_cb=progress_cb, state=state, checkpoint_cb=ckpt_cb,
                rr=not args.no_rr)
        if args.checkpoint and ck_thread[0] is not None:
            ck_thread[0].join()  # never exit with a half-written file
            if ck_err[0] is not None:
                print(f"warning: final checkpoint write failed: "
                      f"{ck_err[0]}")
        img = np.asarray(img)
    else:
        chunk = args.chunk
        if chunk <= 0:
            # bound device memory: target <= ~2M rays in flight
            chunk = max(1, min(samples,
                               (2_000_000 // max(1, width * height))))
        last = [0.0]

        def batch_progress(done, total):
            now = time.time()
            if done >= total or now - last[0] >= 0.5:
                last[0] = now
                _progress(min(done // samples, total_px), total_px)

        img = path_mod.render_image(job.scene, job.camera, width, height,
                                    samples, key, max_depth=args.max_depth,
                                    sample_chunk=chunk,
                                    progress_cb=batch_progress)
        img = np.asarray(img)
    t_render = time.time() - t_render0
    if getattr(args, "profile", None):
        jax.profiler.stop_trace()
        print(f"\n[profile trace written to {args.profile}]")
    _progress(total_px, total_px)
    print()

    t_enc0 = time.time()
    rc = film_ops.output_film(film_ops.quantize(img), output)
    t_enc = time.time() - t_enc0

    dt = time.time() - t_start
    print(f"\nDone! (completed in {_hms(dt)})")
    rays = width * height * samples
    dev = device_info()
    print(f"[{rays / max(t_render, 1e-9):,.0f} primary rays/s "
          f"({width}x{height} @ {samples}spp; load "
          f"{t_render0 - t_start:.1f}s render {t_render:.1f}s "
          f"encode {t_enc:.1f}s) on {dev['platform']} {dev['kind']} "
          f"x{dev['count']}]")
    return rc


def cmd_fit(args) -> int:
    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from ..diff.fit import fit_materials, render_linear, select_params
    from ..scene import build_scene, load_scene_desc
    from ..scene.schema import SceneError

    try:
        job = build_scene(load_scene_desc(args.scene))
    except SceneError as e:
        print(e)
        return -1

    w = args.width or max(16, job.width // 8)
    h = args.height or max(16, job.height // 8)
    key = jax.random.PRNGKey(args.seed)

    # target: render the scene as-authored (ground truth), then perturb
    # the fit parameters and recover them; same key as the fit renders
    # (correlated sampling)
    target = render_linear(job.scene, job.camera, w, h, key, args.spp,
                           args.max_depth)
    params, rebuild = select_params(job.scene)
    perturbed = job.scene.replace(materials=job.scene.materials.replace(
        albedo=jnp.clip(job.scene.materials.albedo * 0.3 + 0.3, 0, 1),
        roughness=jnp.clip(job.scene.materials.roughness + 0.4, 0, 1)))

    n_dev = len(jax.devices())
    if (n_dev > 1 and not args.fit_vertices and not args.boundary
            and (w * h) % n_dev == 0):
        # multi-chip: data-parallel fit via shard_map (per-device pixel
        # slices, Pallas find, psum'd grads) — bitwise-equal loss to the
        # single-device path (parallel/shard.py:sharded_render_loss)
        import optax

        from ..parallel.shard import make_mesh, make_sharded_fit_step
        p0, rebuild = select_params(perturbed)
        opt = optax.adam(2e-2)
        opt_state = opt.init(p0)
        step = make_sharded_fit_step(rebuild, job.camera, w, h, args.spp,
                                     target, make_mesh(n_dev), opt,
                                     max_depth=args.max_depth)
        losses = []
        for i in range(args.steps):
            p0, opt_state, loss = step(p0, opt_state, key)
            losses.append(float(loss))
            if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
                print(f"fit step {i}: loss {losses[-1]:.6f} "
                      f"({n_dev}-device mesh)")
        print(f"final loss: {losses[-1]:.6f} (start {losses[0]:.6f})")
        return 0 if losses[-1] < losses[0] else 1

    res = fit_materials(perturbed, job.camera, target, w, h,
                        steps=args.steps, n_samples=args.spp,
                        max_depth=args.max_depth, key=key,
                        fit_vertices=args.fit_vertices,
                        boundary=args.boundary)
    print(f"final loss: {float(res.losses[-1]):.6f} "
          f"(start {float(res.losses[0]):.6f})")
    return 0 if res.losses[-1] < res.losses[0] else 1


def cmd_bench(args) -> int:
    import runpy
    sys.argv = ["bench.py"]
    runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "bench.py"),
        run_name="__main__")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hobbyraytracer_tpu")
    sub = p.add_subparsers(dest="cmd")

    def common(sp):
        sp.add_argument("scene", nargs="?", default="teapot_scene.yaml")
        sp.add_argument("-o", "--output", default=None)
        sp.add_argument("--spp", type=int, default=None)
        sp.add_argument("--width", type=int, default=None)
        sp.add_argument("--height", type=int, default=None)
        sp.add_argument("--max-depth", type=int, default=50)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--chunk", type=int, default=0,
                        help="samples per device batch (0 = auto)")
        sp.add_argument("--cpu", action="store_true",
                        help="force the CPU backend")
        sp.add_argument("--integrator", choices=["wavefront", "batch"],
                        default="wavefront",
                        help="wavefront = regenerative ray pool (fast); "
                             "batch = whole-image bounce loop")
        sp.add_argument("--pool", type=int, default=0,
                        help="wavefront pool lanes (0 = auto)")
        sp.add_argument("--checkpoint", default=None,
                        help="checkpoint file; resumable with --resume")
        sp.add_argument("--resume", action="store_true",
                        help="resume from --checkpoint if it exists")
        sp.add_argument("--checkpoint-every", type=float, default=30.0,
                        help="seconds between checkpoint writes")
        sp.add_argument("--no-rr", action="store_true",
                        help="disable Russian roulette in the wavefront "
                             "integrator (trace every path to --max-depth "
                             "like the reference, main.cpp:43; slower, "
                             "identical expected radiance)")
        # multi-host bootstrap (jax.distributed); single host = no-op
        sp.add_argument("--coordinator", default=None,
                        help="coordinator address host:port for multi-host")
        sp.add_argument("--num-processes", type=int, default=None)
        sp.add_argument("--process-id", type=int, default=None)
        sp.add_argument("--profile", default=None, metavar="DIR",
                        help="write a jax.profiler trace of the render "
                             "to DIR (view with xprof/tensorboard)")
        sp.add_argument("--debug-nans", action="store_true",
                        help="jax debug_nans: fail loudly on the first "
                             "NaN instead of scrubbing at the film")

    sp = sub.add_parser("render", help="render a YAML scene")
    common(sp)
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("fit", help="differentiable material fit demo")
    common(sp)
    sp.add_argument("--steps", type=int, default=30)
    sp.add_argument("--fit-vertices", action="store_true",
                    help="also optimize mesh vertex positions")
    sp.add_argument("--boundary", action="store_true",
                    help="add edge-sampled silhouette gradients to the "
                         "vertex fit (diff/edges.py)")
    sp.set_defaults(fn=cmd_fit, spp=4, max_depth=6)

    sp = sub.add_parser("bench", help="run the benchmark")
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    enable_compile_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    # bare `prog scene.yaml` mirrors the reference binary: treat the first
    # token as a scene path for `render` (main.cpp:146-151)
    if not argv or argv[0] not in ("render", "fit", "bench", "-h",
                                   "--help"):
        argv = ["render"] + argv
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
