"""Regenerative wavefront integrator (the performance path).

The round-1 integrator traced the whole pixel batch through a bounce
`while_loop` that only stops when EVERY ray has terminated — so by bounce
30 a few percent of lanes carry live paths while 100% of lanes pay for
traversal. The reference has no such waste: each CPU thread simply moves to
the next pixel when a path dies (main.cpp:111-135).

The data-parallel equivalent of "move to the next pixel" is *ray
regeneration*: keep a fixed-size pool of P lanes; every iteration traces
ONE path segment for every lane; lanes whose paths terminate immediately
start the next sample (or pull the next work item off a global queue).
Every lane does useful work every iteration (except the final drain),
shapes stay static for XLA, and the whole render is one `lax.while_loop`.

Radiance recurrence per segment is identical to integrator/path.py (and
main.cpp:43-76): miss adds throughput*background, hits add
throughput*emitted, scatter multiplies throughput or terminates.

Two design points, both driven by the cost of scatters (which grows with
the number of scattered elements, whatever the formulation):

- SAMPLE CHUNKING: one work item covers SAMPLE_CHUNK consecutive samples
  of one pixel. A lane finishing a sample starts the pixel's next sample
  in place, accumulating radiance in its own register file (rad); only
  the completed chunk retires to the framebuffer. Framebuffer traffic
  drops by the chunk factor with zero idle lanes.
- COMPACTED PLANAR RETIREMENT: finished lanes are compacted with ONE
  argsort, then at most RETIRE_CAP (pixel, rgb) entries are scatter-added
  per channel into a PLANAR (3, W*H) accumulator as three flat (C,)
  scatters instead of one row-wise (P,3) scatter. Colliding indices are
  ALLOWED (scatter-add is atomic in XLA semantics), so no winner election
  or deferral machinery is needed; the cap only defers retirement (flag
  `defer`) in the rare segment where more than RETIRE_CAP lanes finish.

Work-item order is sample-chunk-major: item i covers pixel (i % W*H) of
sample chunk (i // W*H), so the image completes in whole-image passes —
progress and checkpoint state are "n samples done + a partial pass".
"""
from __future__ import annotations

import os
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..core import rng, struct
from ..core.types import Rays
from ..ops import film as film_ops
from ..ops import shade as shade_ops
from ..ops.camera import Camera, get_rays
from ..scene import ir as scene_ir
from .path import MAX_DEPTH, background_colour

# Lanes in the ray pool. Not yet swept on the H100.
DEFAULT_POOL = 196_608   # 1.5 * 2^17 lanes
SAMPLE_CHUNK = int(os.environ.get("HRT_SAMPLE_CHUNK", "4"))
# RETIRE_CAP divisor: cap = pool // RETIRE_DIV rows scattered per
# segment. The three flat per-channel scatters scale with cap, so the cap
# wants to sit JUST above the typical finishers per segment (pool / mean
# segments-per-sample / chunk); too low and the defer path adds segments.
# Not yet swept on the H100. Floor of 64 keeps tiny pools exact.
RETIRE_DIV = int(os.environ.get("HRT_RETIRE_DIV", "12"))
if RETIRE_DIV < 1:
    raise ValueError(
        f"HRT_RETIRE_DIV={RETIRE_DIV}: the retirement-cap divisor must be "
        ">= 1 (cap = pool // HRT_RETIRE_DIV rows scattered per segment)")
RR_START = 4             # bounces before Russian roulette begins
RR_MIN_P = 0.05          # survival-probability floor
_BIGI = 2 ** 30  # plain int: a module-level jnp array would
                 # initialize the XLA backend at import time

# RNG purpose tag for work-item issue order (distinct from core/rng tags)
_REGEN = 101

# Pool-level coherence sort period (see _segment): 0 = off (per-mesh
# sort inside intersect), N >= 1 = permute the whole lane pool by the
# mesh key every N segments and skip the per-mesh sort. Read ONCE at
# import — an env lookup inside the traced function is a hidden
# trace-time dependency the jit cache cannot see.
POOL_SORT = int(os.environ.get("HRT_POOL_SORT", "0") or 0)


@struct.dataclass
class PoolState:
    """Complete render state — serializable for checkpoint/resume."""
    fb: jnp.ndarray        # (3, W*H) f32 PLANAR radiance accumulator (sum)
    o: jnp.ndarray         # (P, 3) ray origin
    d: jnp.ndarray         # (P, 3) ray direction
    thr: jnp.ndarray       # (P, 3) path throughput
    rad: jnp.ndarray       # (P, 3) radiance accumulated by the current ITEM
    item: jnp.ndarray      # (P,) int32 work item id, -1 = idle lane
    depth: jnp.ndarray     # (P,) int32 segments traced for the current
                           # sample; -1 = sample done, needs a fresh ray
    sub: jnp.ndarray       # (P,) int32 samples of the chunk already complete
    defer: jnp.ndarray     # (P,) bool: chunk finished, retirement deferred
                           # because the segment hit RETIRE_CAP (rare)
    counter: jnp.ndarray   # () int32 next unissued work item
    retired: jnp.ndarray   # () int32 completed SAMPLES (not items)
    it: jnp.ndarray        # () int32 global iteration (RNG stream index)


def framebuffer(state: PoolState, width: int, height: int) -> jnp.ndarray:
    """The (W*H, 3) image radiance-sum accumulator."""
    return state.fb.T


def init_state(width: int, height: int, pool: int = DEFAULT_POOL
               ) -> PoolState:
    return PoolState(
        fb=jnp.zeros((3, width * height), jnp.float32),
        o=jnp.zeros((pool, 3), jnp.float32),
        d=jnp.ones((pool, 3), jnp.float32),
        thr=jnp.zeros((pool, 3), jnp.float32),
        rad=jnp.zeros((pool, 3), jnp.float32),
        item=jnp.full((pool,), -1, jnp.int32),
        depth=jnp.zeros((pool,), jnp.int32),
        sub=jnp.zeros((pool,), jnp.int32),
        defer=jnp.zeros((pool,), jnp.bool_),
        counter=jnp.int32(0),
        retired=jnp.int32(0),
        it=jnp.int32(0),
    )


def _chunk_geometry(samples, chunk):
    """(chunk, n_chunks, last_chunk_size) for spp=samples split into
    chunks. Works on Python ints (host bookkeeping) AND traced int32
    scalars (inside jit — spp stays a TRACED value so re-rendering at a
    different sample count reuses the compiled executable)."""
    if isinstance(samples, int) and isinstance(chunk, int):
        chunk = max(1, min(chunk, samples))
    else:
        chunk = jnp.clip(chunk, 1, samples)
    n_chunks = -(-samples // chunk)
    last = samples - (n_chunks - 1) * chunk
    return chunk, n_chunks, last


def _regenerate(state: PoolState, camera: Camera, width: int, height: int,
                total_items: int, key, item0=0) -> PoolState:
    """Issue new items to idle lanes and fresh camera rays to every lane
    that needs one (newly issued, or starting the next sample of its
    chunk — flagged by depth == -1).

    item0: global offset of this worker's item range — state.counter /
    total_items stay worker-local, but the stored ids (and thus pixel
    assignment) are global, so sharded workers cover disjoint slices of
    the same image (parallel/shard.py)."""
    pool = state.item.shape[0]
    wh = width * height
    idle = state.item < 0
    # exclusive prefix rank among idle lanes -> contiguous item ids
    rank = jnp.cumsum(idle.astype(jnp.int32)) - 1
    new_local = state.counter + rank
    new_item = item0 + new_local
    issue = idle & (new_local < total_items)

    item = jnp.where(issue, new_item, state.item)
    fresh = issue | ((state.item >= 0) & (state.depth < 0))
    pix = jnp.maximum(item, 0) % wh
    x = (pix % width).astype(jnp.float32)
    y = (height - pix // width).astype(jnp.float32)  # main.cpp:116 y-flip
    ku = rng.stream(key, rng.PIXEL_JITTER_U, state.it)
    kv = rng.stream(key, rng.PIXEL_JITTER_V, state.it)
    ju = rng.uniform(ku, (pool,))
    jv = rng.uniform(kv, (pool,))
    u = (x + ju) / (width - 1)   # main.cpp:120-121
    v = (y + jv) / (height - 1)
    cam_rays = get_rays(camera, u, v, key=rng.stream(key, rng.LENS, state.it))

    f3 = fresh[:, None]
    i3 = issue[:, None]
    n_issued = jnp.minimum(jnp.sum(idle.astype(jnp.int32)),
                           jnp.int32(total_items) - state.counter)
    return state.replace(
        o=jnp.where(f3, cam_rays.o, state.o),
        d=jnp.where(f3, cam_rays.d, state.d),
        thr=jnp.where(f3, 1.0, state.thr),
        rad=jnp.where(i3, 0.0, state.rad),   # rad persists across the chunk
        item=item,
        depth=jnp.where(fresh, 0, state.depth),
        sub=jnp.where(issue, 0, state.sub),
        counter=state.counter + jnp.maximum(n_issued, 0),
    )


def _segment(state: PoolState, scene: scene_ir.SceneIR, width: int,
             height: int, key, max_depth: int, samples: int,
             sample_chunk: int = SAMPLE_CHUNK, rr: bool = True,
             pool_sort: Optional[int] = None,
             mesh_backend: str = "auto") -> PoolState:
    """Trace one path segment for every active lane; roll finished samples
    into the next sample of their chunk; retire finished chunks into the
    framebuffer via the compacted planar scatter. mesh_backend: the mesh
    find ("auto" = the platform's default, scene/ir.py:
    _resolve_mesh_backend; "xla" forces the lock-step traversal)."""
    wh = width * height
    pool = state.item.shape[0]
    chunk, n_chunks, last = _chunk_geometry(samples, sample_chunk)
    active = (state.item >= 0) & (state.depth >= 0) & ~state.defer
    # Pool-LEVEL coherence sort (pool_sort=N / HRT_POOL_SORT=N): permute
    # the whole lane pool by the mesh key every N segments and skip the
    # per-mesh sort+unsort inside intersect for ALL segments. Wavefronts
    # mutate slowly (mean path length ~3-4 segments under RR), so a
    # stale permutation keeps most of the visit-count win while paying
    # the packed (P,16) permute gather only 1/N of the time. Off by
    # default; not yet measured on the H100.
    if pool_sort is None:
        pool_sort = POOL_SORT
    period = int(pool_sort)
    mesh_cohsort = None
    if period > 0:
        def _pool_permute(s: PoolState) -> PoolState:
            sort_key = scene_ir.wavefront_sort_key(
                scene, Rays(o=s.o, d=s.d),
                (s.item >= 0) & (s.depth >= 0) & ~s.defer)
            perm = jnp.argsort(sort_key).astype(jnp.int32)
            ints = jnp.stack([s.item, s.depth, s.sub,
                              s.defer.astype(jnp.int32)], axis=1)
            packed = jnp.concatenate(
                [s.o, s.d, s.thr, s.rad,
                 jax.lax.bitcast_convert_type(ints, jnp.float32)], axis=1)
            packed = packed[perm]
            ints = jax.lax.bitcast_convert_type(packed[:, 12:16], jnp.int32)
            return s.replace(
                o=packed[:, 0:3], d=packed[:, 3:6], thr=packed[:, 6:9],
                rad=packed[:, 9:12], item=ints[:, 0], depth=ints[:, 1],
                sub=ints[:, 2], defer=ints[:, 3] != 0)

        if (mesh_backend == "auto"
                and scene_ir.has_wavefront_sort_key(scene)):
            if period == 1:
                state = _pool_permute(state)
            else:
                state = jax.lax.cond(state.it % period == 0,
                                     _pool_permute, lambda s: s, state)
            active = ((state.item >= 0) & (state.depth >= 0)
                      & ~state.defer)
            mesh_cohsort = False
    r = Rays(o=state.o, d=state.d)
    hits = scene_ir.intersect_scene(scene, r, key, state.it,
                                    ray_valid=active,
                                    mesh_backend=mesh_backend,
                                    mesh_cohsort=mesh_cohsort)

    miss = active & ~hits.hit
    bg = background_colour(scene, state.d)
    rad = state.rad + jnp.where(miss[:, None], state.thr * bg, 0.0)

    emit = shade_ops.emitted(scene.materials, scene.textures, hits)
    hit_active = active & hits.hit
    rad = rad + jnp.where(hit_active[:, None], state.thr * emit, 0.0)

    ok, atten, new_d = shade_ops.scatter(scene.materials, scene.textures,
                                         r, hits, key, state.it)
    depth = state.depth + 1
    cont = hit_active & ok & (depth < max_depth)  # 50-bounce cap main.cpp:43
    thr = jnp.where(cont[:, None], state.thr * atten, state.thr)
    if rr:
        # Russian roulette (documented divergence: the reference traces
        # every path to depth 50, main.cpp:43 — RR is the standard
        # UNBIASED estimator change that kills low-throughput paths with
        # probability 1-p and scales survivors by 1/p; it cut the bench's
        # mean path length ~35% at identical expected radiance).
        p = jnp.clip(jnp.max(thr, axis=1), RR_MIN_P, 1.0)
        u_rr = rng.uniform(rng.stream(key, rng.RUSSIAN_ROULETTE, state.it),
                           (pool,))
        rr_on = cont & (depth >= RR_START)
        kill = rr_on & (u_rr >= p)
        thr = jnp.where((rr_on & ~kill)[:, None], thr / p[:, None], thr)
        cont = cont & ~kill
    o = jnp.where(cont[:, None], hits.p, state.o)
    d = jnp.where(cont[:, None], new_d, state.d)

    # sample bookkeeping: a lane whose sample just ended either starts the
    # next sample of its chunk (depth=-1 -> fresh ray next regenerate) or
    # owes a framebuffer retirement for the whole chunk
    chunk_n = jnp.where(state.item // wh == n_chunks - 1, last, chunk)
    sample_end = active & ~cont
    more = sample_end & (state.sub + 1 < chunk_n)
    finished = sample_end & (state.sub + 1 >= chunk_n)
    sub = jnp.where(more, state.sub + 1, state.sub)
    depth = jnp.where(more, -1, depth)

    # Retirement: compact (pixel, rgb) of finished chunks with one argsort
    # (cheap), then flat per-channel scatter-adds into the planar fb.
    # Collisions (two lanes retiring the same pixel) are legal scatter-add
    # semantics — no election needed. RETIRE_CAP bounds the scatter size;
    # overflow lanes keep the `defer` flag and retry next segment.
    cap = min(max(pool // RETIRE_DIV, 64), pool)
    done = finished | state.defer
    skey = jnp.where(done, state.item % wh, _BIGI)
    order = jnp.argsort(skey).astype(jnp.int32)[:cap]
    pix_c = skey[order]
    rad_c = rad[order]
    ok_c = pix_c < _BIGI
    tgt = jnp.where(ok_c, pix_c, 0)
    vals = jnp.where(ok_c[:, None], rad_c, 0.0)
    fb = state.fb
    for c in range(3):
        fb = fb.at[c, tgt].add(vals[:, c])

    n_done = jnp.sum(done.astype(jnp.int32))
    retired_mask = jax.lax.cond(
        n_done <= cap,
        lambda: done,
        # rare overflow: only the first `cap` ranks actually landed
        lambda: jnp.zeros((pool,), jnp.bool_).at[order].set(
            ok_c, unique_indices=True))
    samples_out = jnp.where(retired_mask, chunk_n, 0)

    return state.replace(
        fb=fb, o=o, d=d, thr=thr, rad=rad,
        item=jnp.where(retired_mask, -1, state.item),
        depth=depth,
        sub=sub,
        defer=done & ~retired_mask,
        retired=state.retired + jnp.sum(samples_out),
        it=state.it + 1,
    )


@partial(jax.jit, static_argnums=(5, 6, 8, 11, 12, 13), donate_argnums=0)
def _pool_run(state: PoolState, scene, camera, key, n_steps,
              width: int, height: int, total_items,
              max_depth: int, samples=1,
              sample_chunk=SAMPLE_CHUNK, rr: bool = True,
              pool_sort: Optional[int] = None,
              mesh_backend: str = "auto") -> PoolState:
    """Advance the pool by up to n_steps iterations (stops early when the
    whole render is done). Donated state -> in-place buffer reuse."""

    def cond(c):
        s, i = c
        return ((i < n_steps)
                & ((s.counter < total_items) | jnp.any(s.item >= 0)))

    def body(c):
        s, i = c
        s = _regenerate(s, camera, width, height, total_items, key)
        s = _segment(s, scene, width, height, key, max_depth, samples,
                     sample_chunk, rr, pool_sort, mesh_backend)
        return s, i + 1

    state, _ = jax.lax.while_loop(cond, body, (state, jnp.int32(0)))
    return state


def render_state(scene: scene_ir.SceneIR, camera: Camera, width: int,
                 height: int, samples: int, key: jax.Array,
                 max_depth: int = MAX_DEPTH, pool: int = DEFAULT_POOL,
                 steps_per_call: int = 256,
                 progress_cb: Optional[Callable[[int, int], None]] = None,
                 state: Optional[PoolState] = None,
                 checkpoint_cb: Optional[Callable[[PoolState], None]] = None,
                 sample_chunk: int = SAMPLE_CHUNK,
                 rr: bool = True,
                 pool_sort: Optional[int] = None,
                 mesh_backend: str = "auto",
                 ) -> PoolState:
    """Run the pool to completion; returns the final state (fb holds the
    radiance SUM over `samples` samples per pixel).

    progress_cb(retired_samples, total_samples) fires after every jitted
    chunk of `steps_per_call` iterations (the reference's 500 ms reporter
    thread, main.cpp:95-109, becomes a between-chunks callback).
    checkpoint_cb(state) fires on the same cadence with the full state.
    `state` resumes from a checkpoint (see checkpoint.py).
    pool_sort: pool-level coherence-sort PERIOD (int: permute the whole
    lane pool every N segments, 0 = off = per-mesh sort; default the
    HRT_POOL_SORT env knob) — see _segment. mesh_backend: see _segment.
    """
    wh = width * height
    chunk, n_chunks, _ = _chunk_geometry(samples, sample_chunk)
    total_items = wh * n_chunks
    total_samples = wh * samples
    pool = min(pool, total_items)
    if state is None:
        state = init_state(width, height, pool)
    elif state.retired.ndim != 0:
        # stacked multi-worker checkpoints (leading device axis on every
        # leaf) belong to parallel.shard.render_wavefront_sharded
        raise ValueError(
            f"checkpoint holds {state.retired.shape[0]} stacked worker "
            "states; resume it on a mesh of that size, not single-device")
    while True:
        state = _pool_run(state, scene, camera, key,
                          jnp.int32(steps_per_call), width, height,
                          jnp.int32(total_items), max_depth,
                          jnp.int32(samples), jnp.int32(sample_chunk), rr,
                          pool_sort, mesh_backend)
        retired = int(jax.device_get(state.retired))
        if progress_cb is not None:
            progress_cb(retired, total_samples)
        if checkpoint_cb is not None:
            checkpoint_cb(state)
        if retired >= total_samples:
            return state


def render_image(scene: scene_ir.SceneIR, camera: Camera, width: int,
                 height: int, samples: int, key: jax.Array,
                 max_depth: int = MAX_DEPTH, pool: int = DEFAULT_POOL,
                 progress_cb=None, state: Optional[PoolState] = None,
                 checkpoint_cb=None,
                 sample_chunk: int = SAMPLE_CHUNK,
                 rr: bool = True,
                 pool_sort: Optional[int] = None,
                 mesh_backend: str = "auto") -> jnp.ndarray:
    """Full render -> tonemapped (H, W, 3) float image in [0,1]; same film
    pipeline as integrator/path.py (average -> ACES -> gamma)."""
    state = render_state(scene, camera, width, height, samples, key,
                         max_depth=max_depth, pool=pool,
                         progress_cb=progress_cb, state=state,
                         checkpoint_cb=checkpoint_cb,
                         sample_chunk=sample_chunk, rr=rr,
                         pool_sort=pool_sort, mesh_backend=mesh_backend)
    mean = framebuffer(state, width, height) / jnp.float32(samples)
    img = film_ops.tonemap(mean)
    return img.reshape(height, width, 3)
