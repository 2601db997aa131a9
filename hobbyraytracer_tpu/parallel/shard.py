"""Distributed execution over a jax.sharding.Mesh.

The reference's only parallelism is a single-node pixel thread pool with a
mutex-guarded framebuffer (std::for_each_n(std::execution::par, ...),
main.cpp:111-135; mutex main.cpp:90,130). Replacement (SURVEY.md §2.3):

- rays are independent, the scene is small: classic data parallelism.
  Pixel/sample batches are sharded over the mesh's 'rays' axis; the scene
  pytree (BVH, triangle soup, material/texture tables) is replicated —
  broadcast once at put time.
- the SAME single-device jitted program is partitioned by XLA's SPMD
  (GSPMD) via input shardings: no mutex, no manual collectives; each
  device owns its slice of the framebuffer, and parameter gradients in the
  fit path come out of jit as an XLA-inserted psum (reduce over the mesh).
- multi-host: `init_multihost` wires jax.distributed — hidden behind the
  same mesh.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.types import Rays
from ..integrator import path as path_mod

RAY_AXIS = "rays"


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """jax.distributed bootstrap for multi-host pods. On a single host this
    is a no-op. (The reference has no multi-process mode at all.)"""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(n_devices: Optional[int] = None, axis: str = RAY_AXIS) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def replicate_scene(scene, mesh: Mesh):
    """Broadcast the scene pytree to every device (fully replicated)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(scene, sharding)


def shard_rays(rays: Rays, mesh: Mesh) -> Rays:
    """Shard a ray wavefront along its batch axis over the mesh."""
    sharding = NamedSharding(mesh, P(RAY_AXIS))
    return Rays(o=jax.device_put(rays.o, sharding),
                d=jax.device_put(rays.d, sharding))


def _warn_batch_xla_find(scene) -> bool:
    """True (and a logged warning) when the GSPMD batch path will pin a
    kernel-eligible mesh scene to the slower XLA traversal."""
    import logging

    from ..scene import ir as scene_ir
    for inst in scene.instances:
        if inst.kind == "mesh" and inst.mesh.use_bvh:
            backend, _ = scene_ir._resolve_mesh_backend("auto", inst.mesh)
            if backend in ("pallas", "pallas_replay"):
                logging.getLogger(__name__).warning(
                    "multi-device batch render uses the XLA mesh "
                    "traversal (the fused Pallas kernel has no GSPMD "
                    "partitioning rule) — expect slower mesh "
                    "intersection; prefer the wavefront integrator "
                    "(render_wavefront_sharded), which runs the kernel "
                    "on every device via shard_map.")
                return True
    return False


def render_sharded(scene, camera, width: int, height: int, samples: int,
                   key, mesh: Mesh, max_depth: int = path_mod.MAX_DEPTH,
                   sample_chunk: int = 0):
    """Data-parallel render: the single-device render program, partitioned
    by GSPMD from input shardings. Pixel count must divide the mesh size
    (pad the image if needed). Semantics — including RNG streams — are
    identical to the single-device render, so sharded == unsharded
    bit-for-bit (the distributed test's assertion)."""
    scene_r = replicate_scene(scene, mesh)
    camera_r = jax.device_put(camera, NamedSharding(mesh, P()))
    out_sharding = NamedSharding(mesh, P(RAY_AXIS))

    # mesh_backend="xla": the Pallas traversal has no GSPMD partitioning
    # rule; the XLA traversal partitions over the rays axis like any op.
    # That choice is slower on mesh scenes — say so instead of silently
    # degrading; the shard_map wavefront path
    # (render_wavefront_sharded) runs the fused kernel per device and is
    # the recommended multi-device renderer.
    _warn_batch_xla_find(scene)
    fn = jax.jit(path_mod.sample_radiance, static_argnums=(2, 3, 5, 6, 7),
                 out_shardings=out_sharding)
    if sample_chunk <= 0 or sample_chunk >= samples:
        total = fn(scene_r, camera_r, width, height, key, samples,
                   max_depth, "xla")
    else:
        total = None
        done = 0
        i = 0
        while done < samples:
            c = min(sample_chunk, samples - done)
            part = fn(scene_r, camera_r, width, height,
                      jax.random.fold_in(key, 1000003 + i), c, max_depth,
                      "xla")
            total = part if total is None else total + part
            done += c
            i += 1
    from ..ops import film
    img = film.tonemap(total / jax.numpy.float32(samples))
    return img.reshape(height, width, 3)


def render_wavefront_sharded(scene, camera, width: int, height: int,
                             samples: int, key, mesh: Mesh,
                             max_depth: int = path_mod.MAX_DEPTH,
                             pool: int = 0, steps_per_call: int = 256,
                             progress_cb=None, checkpoint_cb=None,
                             state=None, rr: bool = True):
    """Data-parallel regenerative-wavefront render over the mesh.

    Data-parallel version of the reference's per-pixel thread pool
    (main.cpp:111-135): the (pixel, sample) work queue is split into one
    contiguous slice per device; `shard_map` runs each device's OWN
    drain loop (integrator/wavefront.py) over its slice with its own ray
    pool and RNG stream — zero collectives inside the loop, exactly the
    reference's embarrassing parallelism — and the per-device framebuffer
    partials are summed at the end (each device's items cover its own
    pixels; colliding pixels across devices sum correctly).

    The drain runs in host-driven chunks of `steps_per_call` segments
    (like the single-device renderer), so progress reporting and
    checkpoint/resume work on multi-chip renders too:
    - progress_cb(retired_samples, total_samples) after every chunk;
    - checkpoint_cb(stacked_state) after every chunk — the state is a
      PoolState whose leaves carry a leading device axis (n, ...); it
      round-trips through io/checkpoint unchanged;
    - state resumes from such a stacked checkpoint (device count must
      match the mesh).

    Returns the tonemapped (H, W, 3) image. RNG streams differ from the
    single-device renderer (each worker folds its shard index into the
    key), so parity with it is statistical, not bitwise.
    """
    import jax.numpy as jnp
    from jax import shard_map

    from ..integrator import wavefront as wf
    from ..ops import film as film_ops

    n = mesh.devices.size
    _, n_chunks, _ = wf._chunk_geometry(samples, wf.SAMPLE_CHUNK)
    total = width * height * n_chunks  # work ITEMS (sample chunks)
    total_samples = width * height * samples
    per = -(-total // n)  # ceil
    pool_per = min(max(pool // n, 1) if pool else wf.DEFAULT_POOL // n
                   or 1, per)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    item0 = jnp.arange(n, dtype=jnp.int32) * per
    tot_local = jnp.clip(jnp.int32(total) - item0, 0, per)

    scene_r = replicate_scene(scene, mesh)
    camera_r = jax.device_put(camera, NamedSharding(mesh, P()))
    shard1 = NamedSharding(mesh, P(RAY_AXIS))

    if state is None:
        base = wf.init_state(width, height, pool_per)
        state = jax.tree.map(
            lambda x: jnp.tile(x[None], (n,) + (1,) * x.ndim), base)
    else:
        # stacked multi-worker states carry a leading device axis on every
        # leaf; a scalar `retired` means a single-device checkpoint
        if state.retired.ndim != 1:
            raise ValueError(
                "checkpoint is a single-device render state; this render "
                f"runs on a {n}-device mesh — resume it with one device "
                "or restart")
        lead = state.retired.shape[0]
        if lead != n:
            raise ValueError(
                f"checkpoint has {lead} worker states, mesh has {n} "
                "devices — resume on the same mesh size")
    state = jax.device_put(state, shard1)

    def worker_chunk(state_l, scene, camera, keys_l, item0_l, tot_l):
        k = keys_l[0]
        i0 = item0_l[0]
        tl = tot_l[0]
        s0 = jax.tree.map(lambda x: x[0], state_l)

        def cond(c):
            s, i = c
            return ((i < steps_per_call)
                    & ((s.counter < tl) | jnp.any(s.item >= 0)))

        def body(c):
            s, i = c
            s = wf._regenerate(s, camera, width, height, tl, k, item0=i0)
            s = wf._segment(s, scene, width, height, k, max_depth,
                            samples, rr=rr)
            return s, i + 1

        s, _ = jax.lax.while_loop(cond, body, (s0, jnp.int32(0)))
        return jax.tree.map(lambda x: x[None], s)

    # check_vma=False: the integrator's scan carries start as replicated
    # constants and become device-varying on the first iteration — the
    # varying-type checker rejects that; there are no collectives inside
    # the drain loop at all.
    step = jax.jit(shard_map(
        worker_chunk, mesh=mesh,
        in_specs=(P(RAY_AXIS), P(), P(), P(RAY_AXIS), P(RAY_AXIS),
                  P(RAY_AXIS)),
        out_specs=P(RAY_AXIS), check_vma=False),
        donate_argnums=0)

    while True:
        state = step(state, scene_r, camera_r, keys, item0, tot_local)
        retired = int(jax.device_get(jnp.sum(state.retired)))
        if progress_cb is not None:
            progress_cb(retired, total_samples)
        if checkpoint_cb is not None:
            checkpoint_cb(state)
        if retired >= total_samples:
            break

    fb = jnp.sum(state.fb, axis=0)  # (3, W*H) merged over workers
    img = film_ops.tonemap(fb.T / jnp.float32(samples))
    return img.reshape(height, width, 3)


def sharded_render_loss(params, rebuild, camera, width, height, key,
                        n_samples, target, mesh: Mesh, max_depth: int = 6,
                        mesh_backend: str = "auto_diff"):
    """The fit loss with the pixel batch split over the mesh by
    shard_map: each device renders its OWN contiguous pixel slice with
    the per-device differentiable integrator — including the
    pallas_replay mesh find, which has no GSPMD partitioning rule and
    therefore could not run under jit-partitioning. Parameters are
    replicated; their gradient under jax.grad is the psum of per-device
    contributions, like any data-parallel trainer's all-reduce.

    Every RNG draw inside the slice render is the full-image stream
    sliced to the device's rows (diff/fit.py:render_linear_slice), so the
    loss — and its gradients — are BIT-IDENTICAL to the single-device
    render_loss regardless of mesh size (up to the psum's reduction
    order). target: (W*H, 3), W*H divisible by the mesh size."""
    import jax.numpy as jnp
    from jax import shard_map

    from ..diff.fit import _loss_from_image, render_linear_slice

    n = mesh.devices.size
    wh = width * height
    if wh % n:
        raise ValueError(f"{wh} pixels do not divide over {n} devices")
    per = wh // n

    def worker(p, t_l):
        pix0 = jax.lax.axis_index(RAY_AXIS).astype(jnp.int32) * per
        scene = rebuild(p)
        img = render_linear_slice(scene, camera, width, height, key,
                                  n_samples, pix0, per, max_depth,
                                  mesh_backend=mesh_backend)
        # local mean over the slice / n == this device's share of the
        # global mean; psum reassembles the exact global loss
        local = _loss_from_image(img, t_l) / n
        return jax.lax.psum(local, RAY_AXIS)

    # check_vma=False: the slice renderer's scan carries replicated-zero
    # accumulators that become device-varying on the first iteration —
    # same waiver as render_wavefront_sharded's drain loop
    # the jit wrapper also makes eager calls work (shard_map bodies with
    # remat'd scans can't be evaluated eagerly); under an outer jit it is
    # a no-op inline
    return jax.jit(shard_map(worker, mesh=mesh,
                             in_specs=(P(), P(RAY_AXIS)), out_specs=P(),
                             check_vma=False))(params, target)


def make_sharded_fit_step(rebuild, camera, width, height, n_samples,
                          target, mesh: Mesh, opt, max_depth: int = 6,
                          mesh_backend: str = "auto_diff"):
    """Build ONE jitted data-parallel fit step (compile once, call per
    step): per-device shard_map render of the pixel slice (Pallas find
    included — see sharded_render_loss), psum'd loss/grads, replicated
    optimizer update. A gradient all-reduce trainer; the reference has no
    gradient communication at all (SURVEY §2.3). Returns step(params, opt_state, key) ->
    (params, opt_state, loss)."""
    import optax

    target = jax.device_put(target, NamedSharding(mesh, P(RAY_AXIS)))

    def loss_fn(p, k):
        return sharded_render_loss(p, rebuild, camera, width, height, k,
                                   n_samples, target, mesh, max_depth,
                                   mesh_backend)

    from ..diff.fit import project_materials

    @jax.jit
    def step(params, opt_state, key):
        loss, grads = jax.value_and_grad(loss_fn)(params, key)
        updates, opt_state = opt.update(grads, opt_state)
        # shared physical-range projection: the two fit paths must share
        # a trajectory, not just a loss function
        params = project_materials(optax.apply_updates(params, updates))
        return params, opt_state, loss

    return step


def sharded_fit_step(params, rebuild, camera, width, height, key, n_samples,
                     target, mesh: Mesh, opt, opt_state,
                     max_depth: int = 6, mesh_backend: str = "auto_diff"):
    """One-shot convenience wrapper around make_sharded_fit_step. For a
    fit LOOP, build the step once with the factory — this wrapper
    re-traces on every call (new closure, new jit cache entry)."""
    params = jax.device_put(params, NamedSharding(mesh, P()))
    step = make_sharded_fit_step(rebuild, camera, width, height, n_samples,
                                 target, mesh, opt, max_depth, mesh_backend)
    return step(params, opt_state, key)
