"""Wavefront path-tracing integrator.

The reference integrates one ray at a time with an iterative bounce loop
(rayColour, main.cpp:38-79) inside a per-pixel thread pool (render,
main.cpp:81-140). Here the whole pixel/sample batch is one SoA
wavefront; the bounce loop is a `lax.while_loop` whose per-ray `break`s are
active-mask updates, with an early exit when every ray has terminated
(average path length is far below MAX_DEPTH, so this matters).

Radiance recurrence per bounce (exactly main.cpp:43-76):
    miss: result += throughput * background(env_uv(dir)); stop
    hit:  result += throughput * emitted
          scatter ? (throughput *= attenuation; continue) : stop
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import mathx
from ..core.types import Rays
from ..ops import film as film_ops
from ..ops import shade as shade_ops
from ..ops import texture as tex_ops
from ..ops.camera import Camera, get_rays
from ..scene import ir as scene_ir

MAX_DEPTH = 50  # main.cpp:32


def background_colour(scene: scene_ir.SceneIR, d: jnp.ndarray) -> jnp.ndarray:
    """Miss shading: equirectangular lookup from the normalized direction
    (main.cpp:46-58): phi=atan2(z,x), theta=acos(y), u=phi/2pi+0.5,
    v=theta/pi; evaluated through the background texture (solid textures
    ignore uv)."""
    nd = mathx.normalize(d)
    phi = jnp.arctan2(nd[..., 2], nd[..., 0])
    theta = mathx.safe_arccos(nd[..., 1])  # exact value, bounded derivative
    u = phi / (2.0 * jnp.pi) + 0.5
    v = theta / jnp.pi
    tex_id = jnp.broadcast_to(scene.background_tex, u.shape)
    p = jnp.zeros(u.shape + (3,), jnp.float32)
    return tex_ops.colour_value(scene.textures, tex_id, u, v, p)


def trace(scene: scene_ir.SceneIR, rays: Rays, key: jax.Array,
          max_depth: int = MAX_DEPTH,
          mesh_backend: str = "auto") -> jnp.ndarray:
    """Radiance for a wavefront of rays. key: single PRNG key; per-ray
    decorrelation comes from array-shaped draws (core/rng.py)."""
    n = rays.o.shape[0]

    def cond(state):
        bounce, _, _, _, _, active = state
        return (bounce < max_depth) & jnp.any(active)

    def body(state):
        bounce, o, d, result, throughput, active = state
        r = Rays(o=o, d=d)
        hits = scene_ir.intersect_scene(scene, r, key, bounce,
                                        mesh_backend=mesh_backend)

        miss = active & ~hits.hit
        bg = background_colour(scene, d)
        result = result + jnp.where(miss[..., None], throughput * bg, 0.0)

        emit = shade_ops.emitted(scene.materials, scene.textures, hits)
        hit_active = active & hits.hit
        result = result + jnp.where(hit_active[..., None],
                                    throughput * emit, 0.0)

        ok, atten, new_d = shade_ops.scatter(scene.materials, scene.textures,
                                             r, hits, key, bounce)
        cont = hit_active & ok
        throughput = jnp.where(cont[..., None], throughput * atten,
                               throughput)
        o = jnp.where(cont[..., None], hits.p, o)
        d = jnp.where(cont[..., None], new_d, d)
        return bounce + 1, o, d, result, throughput, cont

    init = (jnp.int32(0), rays.o, rays.d,
            jnp.zeros((n, 3), jnp.float32), jnp.ones((n, 3), jnp.float32),
            jnp.ones((n,), jnp.bool_))
    _, _, _, result, _, _ = jax.lax.while_loop(cond, body, init)
    return result


def trace_diff(scene: scene_ir.SceneIR, rays: Rays, key: jax.Array,
               max_depth: int = 8,
               mesh_backend: str = "auto_diff",
               rng_span=None) -> jnp.ndarray:
    """Differentiable variant of `trace` for the inverse-rendering path.

    `lax.while_loop` has no reverse-mode derivative, so the bounce loop runs
    as a fixed-length `lax.scan` (no early exit; masked lanes do dead work).
    Use a smaller max_depth than the forward path's 50 — gradient fitting
    converges fine at ~4-8 bounces. Radiance math is identical to `trace`;
    discrete decisions (hit ids, reflect/refract, absorb) are
    stop-gradiented so gradients flow through the sampled path's shading
    chain ("differentiable path replay").

    mesh_backend "auto_diff" (default) finds mesh hits with the Pallas
    kernel over BUILD-TIME tables and replays differentiably — correct
    while the geometry is static (material/texture fits). Vertex fits
    must pass "xla" so the find tracks the moving vertices.
    """
    n = rays.o.shape[0]

    def body(state, bounce):
        o, d, result, throughput, active = state
        r = Rays(o=o, d=d)
        hits = scene_ir.intersect_scene(scene, r, key, bounce,
                                        mesh_backend=mesh_backend,
                                        rng_span=rng_span)

        miss = active & ~hits.hit
        bg = background_colour(scene, d)
        result = result + jnp.where(miss[..., None], throughput * bg, 0.0)

        emit = shade_ops.emitted(scene.materials, scene.textures, hits)
        hit_active = active & hits.hit
        result = result + jnp.where(hit_active[..., None],
                                    throughput * emit, 0.0)

        ok, atten, new_d = shade_ops.scatter(scene.materials, scene.textures,
                                             r, hits, key, bounce,
                                             span=rng_span)
        cont = hit_active & ok
        throughput = jnp.where(cont[..., None], throughput * atten,
                               throughput)
        o = jnp.where(cont[..., None], hits.p, o)
        d = jnp.where(cont[..., None], new_d, d)
        return (o, d, result, throughput, cont), None

    init = (rays.o, rays.d, jnp.zeros((n, 3), jnp.float32),
            jnp.ones((n, 3), jnp.float32), jnp.ones((n,), jnp.bool_))
    # rematerialize each bounce in the backward pass: reverse-mode memory
    # is O(depth x carry) instead of O(depth x every intermediate) —
    # without this, fits above toy sizes OOM long before device memory is
    # the limit
    (_, _, result, _, _), _ = jax.lax.scan(
        jax.checkpoint(body), init, jnp.arange(max_depth, dtype=jnp.int32))
    return result


def pixel_grid(width: int, height: int):
    """Pixel centers in the reference's indexing (main.cpp:114-116):
    x = pIdx % W, y = H - pIdx // W (note: y in [1, H], v can exceed 1 at
    the top row — reference quirk kept)."""
    pidx = jnp.arange(width * height, dtype=jnp.int32)
    x = (pidx % width).astype(jnp.float32)
    y = (height - pidx // width).astype(jnp.float32)
    return x, y


def sample_radiance(scene: scene_ir.SceneIR, camera: Camera, width: int,
                    height: int, key: jax.Array, n_samples: int,
                    max_depth: int = MAX_DEPTH,
                    mesh_backend: str = "auto") -> jnp.ndarray:
    """Sum of radiance over n_samples jittered samples per pixel.
    Returns (W*H, 3). Jitter: u=(x+U)/(W-1), v=(y+U)/(H-1)
    (main.cpp:120-121). mesh_backend "xla" is required under GSPMD
    auto-partitioning (parallel/shard.py:render_sharded) — the Pallas
    traversal has no SPMD partitioning rule."""
    x, y = pixel_grid(width, height)

    def one_sample(s, acc):
        k = jax.random.fold_in(key, s)
        ku, kv, kt = jax.random.split(k, 3)
        ju = jax.random.uniform(ku, x.shape, jnp.float32)
        jv = jax.random.uniform(kv, y.shape, jnp.float32)
        u = (x + ju) / (width - 1)
        v = (y + jv) / (height - 1)
        rays = get_rays(camera, u, v, key=kt)
        return acc + trace(scene, rays, kt, max_depth,
                           mesh_backend=mesh_backend)

    acc = jnp.zeros((width * height, 3), jnp.float32)
    return jax.lax.fori_loop(0, n_samples, one_sample, acc)


_sample_radiance_jit = jax.jit(sample_radiance,
                               static_argnums=(2, 3, 5, 6, 7))


def render_image(scene: scene_ir.SceneIR, camera: Camera, width: int,
                 height: int, samples: int, key: jax.Array,
                 max_depth: int = MAX_DEPTH,
                 sample_chunk: int = 0, progress_cb=None) -> jnp.ndarray:
    """Full render -> tonemapped (H, W, 3) float image in [0,1].

    sample_chunk > 0 bounds device memory by accumulating the sample loop
    in chunks under one jitted function per chunk (the framebuffer
    accumulator stays on device, main.cpp's film writeColour equivalent).
    progress_cb(done_samples, total_samples) fires per chunk — the batch
    integrator's version of the reference's 500 ms reporter
    (main.cpp:95-109); a single-chunk render reports only completion.
    """
    wh = width * height
    if sample_chunk <= 0 or sample_chunk >= samples:
        total = _sample_radiance_jit(scene, camera, width, height, key,
                                     samples, max_depth)
        if progress_cb is not None:
            jax.block_until_ready(total)
            progress_cb(wh * samples, wh * samples)
    else:
        fn = _sample_radiance_jit
        total = jnp.zeros((width * height, 3), jnp.float32)
        done = 0
        chunk_i = 0
        while done < samples:
            c = min(sample_chunk, samples - done)
            total = total + fn(scene, camera, width, height,
                               jax.random.fold_in(key, 1000003 + chunk_i),
                               c, max_depth)
            done += c
            chunk_i += 1
            if progress_cb is not None:
                jax.block_until_ready(total)
                progress_cb(wh * done, wh * samples)
    mean = total / jnp.float32(samples)
    img = film_ops.tonemap(mean)
    return img.reshape(height, width, 3)
