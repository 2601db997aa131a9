"""Batched primitive intersection kernels (jnp reference path).

Replaces the reference's per-ray virtual `Hittable::hit` dispatch
(hittable.h:27-32) with dense vectorized tests: every kernel intersects a
whole ray wavefront against a whole primitive table, in two phases:

  1. find: compute only (t, prim_index) per ray with a chunked running-min
     scan (bounded memory, elementwise with zero divergence);
  2. attrib: recompute the full hit record (p, normal, uv) once per ray for
     the winning primitive via gathers.

This is the data-parallel answer to the reference's linear closest-hit
scan (hittableList.cpp:4-21): dense math instead of branchy tree walks.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ..core.mathx import BIG, ray_at, take_rows as _take
from ..core.types import Hits, Rays, set_face_normal

# chunk of primitives processed per scan step; keeps the (R x chunk)
# intermediate below ~tens of MB for multi-million-ray wavefronts.
DEFAULT_CHUNK = 128

# Knobs read ONCE at import: the jit cache is not keyed on env vars, so
# a trace-time read would silently ignore mid-process flips after the
# first trace — the hidden dependency class that broke round 3.
# HRT_KEY_MODE: "auto" (default: "cheap" below CORRIDOR_MIN_K clusters,
# "corridor" at or above) | "cheap" | "corridor" — see coherence_key /
# cheap_key_from_box.
KEY_MODE = os.environ.get("HRT_KEY_MODE", "auto")
if KEY_MODE not in ("auto", "cheap", "corridor"):
    raise ValueError(f"HRT_KEY_MODE={KEY_MODE!r}: expected 'auto', "
                     "'cheap' or 'corridor'")
# cluster count at which "auto" switches the key from octant|entry to
# entry|exit (not yet swept on the H100)
CORRIDOR_MIN_K = int(os.environ.get("HRT_CORRIDOR_MIN_K", "256"))
# HRT_NO_COHSORT=1: skip the per-mesh coherence sort entirely.
NO_COHSORT = bool(os.environ.get("HRT_NO_COHSORT"))
# HRT_UNSORT_MODE: how the per-mesh coherence sort is undone after the
# traversal kernel — "argsort" (default: inverse permutation via a
# second argsort, then gathers) | "scatter" (.at[perm].set on the
# outputs). Read ONCE at import (trace-time env reads are invisible to
# the jit cache). Both modes covered by tests/test_kernel_variants.py.
UNSORT_MODE = os.environ.get("HRT_UNSORT_MODE", "argsort")
if UNSORT_MODE not in ("scatter", "argsort"):
    raise ValueError(f"HRT_UNSORT_MODE={UNSORT_MODE!r}: expected "
                     "'scatter' or 'argsort'")


def _pad(x, n_padded: int, fill):
    """Pad a primitive table along axis 0 with a never-hit sentinel value."""
    n = x.shape[0]
    if n == n_padded:
        return x
    pad_width = [(0, n_padded - n)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=fill)


def _chunked_argmin(per_chunk_t, n_prims: int, n_rays: int, chunk: int):
    """Scan over primitive chunks keeping the running (t_best, idx_best).

    per_chunk_t(start) -> (R, chunk) candidate t values (BIG where invalid,
    already windowed). n_prims must be a multiple of chunk (callers pad
    tables with never-hit sentinels). Returns (t_best, idx_best).
    """
    assert n_prims % chunk == 0
    n_chunks = n_prims // chunk
    starts = jnp.arange(n_chunks, dtype=jnp.int32) * chunk

    def step(carry, start):
        t_best, i_best = carry
        tc = per_chunk_t(start)  # (R, chunk)
        t_min_c = jnp.min(tc, axis=1)
        i_min_c = jnp.argmin(tc, axis=1).astype(jnp.int32) + start
        take = t_min_c < t_best
        return (jnp.where(take, t_min_c, t_best),
                jnp.where(take, i_min_c, i_best)), None

    init = (jnp.full((n_rays,), BIG, jnp.float32),
            jnp.full((n_rays,), -1, jnp.int32))
    (t_best, i_best), _ = jax.lax.scan(step, init, starts)
    return t_best, i_best


# ---------------------------------------------------------------- spheres

def sphere_t(rays: Rays, center, radius, t_min, t_max):
    """Candidate t per (ray, sphere): the reference's half-b quadratic with
    two-root window test (sphere.cpp:20-49). center: (S,3), radius: (S,).
    Returns (R, S) t values, BIG where miss.
    """
    # component-scalarized: every intermediate is (R,S) or (R,1)/(1,S),
    # never a (R,S,3) tensor with a size-3 minor axis
    ox, oy, oz = (rays.o[:, i, None] for i in range(3))   # (R,1)
    dx, dy, dz = (rays.d[:, i, None] for i in range(3))
    cx, cy, cz = (center[None, :, i] for i in range(3))   # (1,S)
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    a = dx * dx + dy * dy + dz * dz                       # (R,1)
    half_b = ocx * dx + ocy * dy + ocz * dz               # (R,S)
    c = (ocx * ocx + ocy * ocy + ocz * ocz
         - (radius * radius)[None, :])
    disc = half_b * half_b - a * c
    # safe-where: d(sqrt)/dx -> inf at 0 would turn masked misses into NaN
    # gradients (inf * 0); substitute 1 under the miss mask
    sqrtd = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))
    # reciprocal on the packed (R,) shape, then broadcast multiply
    inv_a = (1.0 / a[:, 0])[:, None]
    r1 = (-half_b - sqrtd) * inv_a
    r2 = (-half_b + sqrtd) * inv_a
    in1 = (r1 >= t_min) & (r1 <= t_max)
    in2 = (r2 >= t_min) & (r2 <= t_max)
    root = jnp.where(in1, r1, jnp.where(in2, r2, BIG))
    return jnp.where(disc >= 0.0, root, BIG)


def sphere_uv(outward_normal):
    """getSphereUV (sphere.cpp:4-18): theta=acos(-n.y), phi=atan2(-n.z,n.x)+pi.
    safe_arccos: exact value, derivative clamped at the poles."""
    from ..core.mathx import safe_arccos
    theta = safe_arccos(-outward_normal[..., 1])
    phi = jnp.arctan2(-outward_normal[..., 2], outward_normal[..., 0]) + jnp.pi
    return jnp.stack([phi / (2.0 * jnp.pi), theta / jnp.pi], axis=-1)


def _sphere_attribs(rays: Rays, center, radius, mat_id, t, idx) -> Hits:
    """Hit record from a sphere find's (t, winning index): gather the
    winner's params and recompute p/normal/uv (sphere.cpp:50-57).

    Large sphere pools pack (center, radius, mat_id) into ONE row
    gather instead of three per-lane (N,) gathers (as shade's
    _gather_params does); small pools keep the per-field gathers XLA
    lowers to selects."""
    n = center.shape[0]
    hit = (t < BIG) & (idx >= 0)
    safe = jnp.minimum(jnp.maximum(idx, 0), n - 1)
    if n < 32:
        c = _take(center, safe)
        r = _take(radius, safe)
        m = _take(mat_id, safe)
    else:
        packed = jnp.concatenate([
            center, radius[:, None],
            jax.lax.bitcast_convert_type(
                mat_id.astype(jnp.int32), jnp.float32)[:, None]], axis=1)
        rows = packed[safe]
        c = rows[:, 0:3]
        r = rows[:, 3]
        m = jax.lax.bitcast_convert_type(rows[:, 4], jnp.int32)
    r = jnp.maximum(r, 1e-20)
    p = ray_at(rays.o, rays.d, jnp.where(hit, t, 1.0))
    outward = (p - c) / r[:, None]
    normal, front = set_face_normal(rays.d, outward)
    return Hits(hit=hit, t=jnp.where(hit, t, BIG), p=p, normal=normal,
                uv=sphere_uv(outward), front_face=front,
                mat_id=jnp.where(hit, m, -1))


def intersect_spheres(rays: Rays, center, radius, mat_id, t_min, t_max,
                      chunk: int = DEFAULT_CHUNK) -> Hits:
    n_rays = rays.o.shape[0]
    n = center.shape[0]
    if n == 0:
        return Hits.none(n_rays)
    chunk = min(chunk, n)
    np_ = ((n + chunk - 1) // chunk) * chunk
    center_p = _pad(center, np_, 1e30)  # far away: disc < 0, never hits
    radius_p = _pad(radius, np_, 0.0)

    def per_chunk(start):
        c = jax.lax.dynamic_slice_in_dim(center_p, start, chunk, 0)
        r = jax.lax.dynamic_slice_in_dim(radius_p, start, chunk, 0)
        return sphere_t(rays, c, r, t_min, t_max)

    t, idx = _chunked_argmin(per_chunk, np_, n_rays, chunk)
    return _sphere_attribs(rays, center, radius, mat_id, t, idx)


# ------------------------------------------------------------------ rects

# For normal-axis n: in-plane axes (a, b) and the rect's outward normal
# (+unit on axis n), matching YZRect/XZRect/XYRect (aarect.h:5-144):
#   yz_rect: n=0 (x), a=y, b=z;  xz_rect: n=1 (y), a=x, b=z;
#   xy_rect: n=2 (z), a=x, b=y.
# plain tuples, materialized per-trace: module-level jnp arrays would
# initialize the XLA backend at import (breaks jax.distributed ordering)
_AXIS_A_LIST = (1, 0, 0)
_AXIS_B_LIST = (2, 2, 1)


def rect_t(rays: Rays, axis, a0, a1, b0, b1, k, t_min, t_max):
    """Candidate t per (ray, rect). axis: (Q,) int32 normal axis.

    Scalarized: instead of gathering per-rect ray components (a (R,Q)
    gather), compute the plane solve for all three
    axis choices with dense (R,Q) ops and select by the rect's axis mask.
    """
    oc = [rays.o[:, i, None] for i in range(3)]  # 3 x (R,1)
    dc = [rays.d[:, i, None] for i in range(3)]
    kq = k[None, :]                              # (1,Q)
    t = jnp.zeros((rays.o.shape[0], axis.shape[0]), jnp.float32)
    pa = jnp.zeros_like(t)
    pb = jnp.zeros_like(t)
    parallel = jnp.zeros(t.shape, jnp.bool_)
    for ax in range(3):
        ia = _AXIS_A_LIST[ax]
        ib = _AXIS_B_LIST[ax]
        sel = (axis == ax)[None, :]
        par_ax = dc[ax] == 0.0
        # safe-where: parallel rays must not produce inf t (NaN gradients
        # through the masked branch); rejected via `ok`.
        # reciprocal on the packed (R,) shape (division cost scales with
        # padded lanes), then a cheap broadcast multiply
        d_flat = rays.d[:, ax]
        inv_ax = (1.0 / jnp.where(d_flat == 0.0, 1.0, d_flat))[:, None]
        t_ax = (kq - oc[ax]) * inv_ax
        t = jnp.where(sel, t_ax, t)
        pa = jnp.where(sel, oc[ia] + t_ax * dc[ia], pa)
        pb = jnp.where(sel, oc[ib] + t_ax * dc[ib], pb)
        parallel = jnp.where(sel, jnp.broadcast_to(par_ax, t.shape),
                             parallel)
    ok = (~parallel & (t >= t_min) & (t <= t_max)
          & (pa >= a0[None, :]) & (pa <= a1[None, :])
          & (pb >= b0[None, :]) & (pb <= b1[None, :]))
    return jnp.where(ok, t, BIG)


def intersect_rects(rays: Rays, axis, a0, a1, b0, b1, k, mat_id,
                    t_min, t_max, chunk: int = DEFAULT_CHUNK) -> Hits:
    n_rays = rays.o.shape[0]
    n = axis.shape[0]
    if n == 0:
        return Hits.none(n_rays)
    chunk = min(chunk, n)
    np_ = ((n + chunk - 1) // chunk) * chunk
    axis_p = _pad(axis, np_, 0)
    a0_p = _pad(a0, np_, 1.0)  # a0 > a1: bounds test can never pass
    a1_p = _pad(a1, np_, 0.0)
    b0_p = _pad(b0, np_, 1.0)
    b1_p = _pad(b1, np_, 0.0)
    k_p = _pad(k, np_, 0.0)

    def per_chunk(start):
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, start, chunk, 0)
        return rect_t(rays, sl(axis_p), sl(a0_p), sl(a1_p), sl(b0_p),
                      sl(b1_p), sl(k_p), t_min, t_max)

    t, idx = _chunked_argmin(per_chunk, np_, n_rays, chunk)
    hit = t < BIG
    safe = jnp.minimum(jnp.maximum(idx, 0), n - 1)
    ax = _take(axis, safe)
    p = ray_at(rays.o, rays.d, jnp.where(hit, t, 1.0))
    ia = jnp.asarray(_AXIS_A_LIST, jnp.int32)[ax]
    ib = jnp.asarray(_AXIS_B_LIST, jnp.int32)[ax]
    rr = jnp.arange(n_rays)
    pa = p[rr, ia]
    pb = p[rr, ib]
    a0s, a1s = _take(a0, safe), _take(a1, safe)
    b0s, b1s = _take(b0, safe), _take(b1, safe)
    u = (pa - a0s) / (a1s - a0s)
    v = (pb - b0s) / (b1s - b0s)
    outward = jax.nn.one_hot(ax, 3, dtype=jnp.float32)
    normal, front = set_face_normal(rays.d, outward)
    return Hits(hit=hit, t=jnp.where(hit, t, BIG), p=p, normal=normal,
                uv=jnp.stack([u, v], axis=-1), front_face=front,
                mat_id=jnp.where(hit, _take(mat_id, safe), -1))


# -------------------------------------------------------------- triangles

def triangle_t(rays: Rays, v0, v1, v2, t_max):
    """Candidate t per (ray, tri): watertight intersection after PBRT-3
    (reference ITriangle::hit, triangle.cpp:57-109).

    v0/v1/v2 are either (T,3) — shared triangle table, result (R,T) — or
    (R,T,3) — per-ray gathered triangles (the clustered-BVH leaf path).

    Divergence (fix-and-document, SURVEY.md §7): the reference picks the
    projection axis from the RAY ORIGIN's components (triangle.cpp:70),
    which breaks when d[kz] ~ 0; we use max |d| as PBRT does. Like the
    reference, t_min is ignored: valid window is 0 < t <= t_max
    (triangle.cpp:106-109).
    """
    d = rays.d  # (R,3)
    # kz = argmax |d|, kx = kz+1 mod 3, ky = kx+1 mod 3  (per ray)
    ad = jnp.abs(d)
    kz = jnp.argmax(ad, axis=-1).astype(jnp.int32)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    rr = jnp.arange(d.shape[0])
    dx_f = d[rr, kx]
    dy_f = d[rr, ky]
    dz_f = d[rr, kz]
    # shear coefficients on packed (R,) shapes (divisions are expensive on
    # lane-padded (R,1) layouts), broadcast afterwards
    inv_dz = 1.0 / dz_f
    sx = (-dx_f * inv_dz)[:, None]
    sy = (-dy_f * inv_dz)[:, None]
    sz = inv_dz[:, None]

    def permuted(v):
        # v: (T,3) or (R,T,3) -> components (R,T) after per-ray permutation
        if v.ndim == 2:
            t0 = v[None, :, :] - rays.o[:, None, :]
        else:
            t0 = v - rays.o[:, None, :]
        px = jnp.take_along_axis(t0, kx[:, None, None], axis=2)[..., 0]
        py = jnp.take_along_axis(t0, ky[:, None, None], axis=2)[..., 0]
        pz = jnp.take_along_axis(t0, kz[:, None, None], axis=2)[..., 0]
        return px, py, pz

    p0x, p0y, p0z = permuted(v0)
    p1x, p1y, p1z = permuted(v1)
    p2x, p2y, p2z = permuted(v2)
    p0x = p0x + sx * p0z; p0y = p0y + sy * p0z
    p1x = p1x + sx * p1z; p1y = p1y + sy * p1z
    p2x = p2x + sx * p2z; p2y = p2y + sy * p2z

    e0 = p1x * p2y - p1y * p2x
    e1 = p2x * p0y - p2y * p0x
    e2 = p0x * p1y - p0y * p1x

    inside = ~(((e0 < 0) | (e1 < 0) | (e2 < 0))
               & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    t_scaled = (e0 * p0z + e1 * p1z + e2 * p2z) * sz
    neg_ok = (det < 0) & (t_scaled < 0) & (t_scaled >= t_max * det)
    pos_ok = (det > 0) & (t_scaled > 0) & (t_scaled <= t_max * det)
    ok = inside & (det != 0) & (neg_ok | pos_ok)
    t = t_scaled / jnp.where(det == 0, 1.0, det)  # safe-where for grads
    return jnp.where(ok, t, BIG)


def triangle_attribs(rays: Rays, v0, v1, v2):
    """Barycentrics for the winning triangle (per ray): solve with the same
    edge-function construction, then b_i = e_i / det."""
    d = rays.d
    ad = jnp.abs(d)
    kz = jnp.argmax(ad, axis=-1).astype(jnp.int32)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    rr = jnp.arange(d.shape[0])
    dx = d[rr, kx]
    dy = d[rr, ky]
    dz = d[rr, kz]
    sx = -dx / dz
    sy = -dy / dz

    def permute(v):
        t0 = v - rays.o
        px = t0[rr, kx]
        py = t0[rr, ky]
        pz = t0[rr, kz]
        return px + sx * pz, py + sy * pz

    p0x, p0y = permute(v0)
    p1x, p1y = permute(v1)
    p2x, p2y = permute(v2)
    e0 = p1x * p2y - p1y * p2x
    e1 = p2x * p0y - p2y * p0x
    e2 = p0x * p1y - p0y * p1x
    det = e0 + e1 + e2
    inv = 1.0 / jnp.where(det == 0, 1.0, det)
    return e0 * inv, e1 * inv, e2 * inv


def intersect_triangles(rays: Rays, verts, normals, uvs, indices, mat_id,
                        t_max, chunk: int = DEFAULT_CHUNK) -> Hits:
    """Brute-force dense mesh intersection: stream triangle chunks through a
    running-min scan. verts/normals: (V,3), uvs: (V,2), indices: (T,3),
    mat_id: scalar int32 for the whole mesh (meshes share one material,
    mesh.cpp:24-34).

    Hit attributes follow ITriangle::hit (triangle.cpp:112-128): normal and
    uv are barycentric-interpolated; the normal is NOT normalized and NOT
    face-flipped here (no setFaceNormal in the reference triangle path —
    instance wrappers may flip it later). front_face is computed from the
    geometric orientation as a sane extension (the reference leaves it
    stale; only dielectrics consume it, which the reference YAML cannot
    attach to meshes).
    """
    n_rays = rays.o.shape[0]
    n = indices.shape[0]
    if n == 0:
        return Hits.none(n_rays)
    chunk = min(chunk, n)
    np_ = ((n + chunk - 1) // chunk) * chunk
    tri_v0 = _pad(verts[indices[:, 0]], np_, 0.0)
    tri_v1 = _pad(verts[indices[:, 1]], np_, 0.0)
    tri_v2 = _pad(verts[indices[:, 2]], np_, 0.0)
    # explicit pad mask: degenerate zero-area padding is NOT enough — XLA
    # FMA contraction can make the edge functions of an all-equal-vertex
    # triangle cancel inexactly, yielding det != 0 and a phantom hit
    tri_ok = (jnp.arange(np_, dtype=jnp.int32) < n)

    def per_chunk(start):
        v0 = jax.lax.dynamic_slice_in_dim(tri_v0, start, chunk, 0)
        v1 = jax.lax.dynamic_slice_in_dim(tri_v1, start, chunk, 0)
        v2 = jax.lax.dynamic_slice_in_dim(tri_v2, start, chunk, 0)
        ok = jax.lax.dynamic_slice_in_dim(tri_ok, start, chunk, 0)
        return jnp.where(ok[None, :], triangle_t(rays, v0, v1, v2, t_max),
                         BIG)

    t, idx = _chunked_argmin(per_chunk, np_, n_rays, chunk)
    hit = t < BIG
    safe = jnp.minimum(jnp.maximum(idx, 0), n - 1)
    i0 = indices[safe, 0]
    i1 = indices[safe, 1]
    i2 = indices[safe, 2]
    b0, b1, b2 = triangle_attribs(rays, verts[i0], verts[i1], verts[i2])
    w = lambda a: (b0[:, None] * a[i0] + b1[:, None] * a[i1]
                   + b2[:, None] * a[i2])
    normal = w(normals)
    uv = b0[:, None] * uvs[i0] + b1[:, None] * uvs[i1] + b2[:, None] * uvs[i2]
    front = jnp.sum(rays.d * normal, axis=-1) < 0.0
    return Hits(hit=hit, t=jnp.where(hit, t, BIG),
                p=ray_at(rays.o, rays.d, jnp.where(hit, t, 1.0)),
                normal=normal, uv=uv,
                front_face=front,
                mat_id=jnp.where(hit, mat_id, -1))


def block_entries(o, d, valid, bmin, bmax, t_max):
    """Slab-test all K cluster boxes (aabb.h:26-39) for every ray of every
    block; -> (NB, K) nearest entry distance (clamped >= 0) over each
    block's valid rays, +inf where none enters. o/d: (NB, B, 3); valid:
    (NB, B); bmin/bmax: (K, 3).

    The (NB, K, B) intermediate keeps the block's rays on the minor axis,
    so the min is a row reduction: XLA's GPU compiler takes minutes over
    the same reduction written across the middle axis of (NB, B, K) once
    K reaches the hundreds."""
    near = far = None
    for ax in range(3):  # per-axis: all intermediates are (NB, K, B)
        o_ax = o[:, None, :, ax]                               # (NB,1,B)
        d_ax = d[:, None, :, ax]
        inv = 1.0 / jnp.where(jnp.abs(d_ax) < 1e-30, 1e-30, d_ax)
        t0 = (bmin[None, :, ax, None] - o_ax) * inv
        t1 = (bmax[None, :, ax, None] - o_ax) * inv
        n_ax = jnp.minimum(t0, t1)
        f_ax = jnp.maximum(t0, t1)
        near = n_ax if near is None else jnp.maximum(near, n_ax)
        far = f_ax if far is None else jnp.minimum(far, f_ax)
    entry = jnp.maximum(near, 0.0)
    ok = (far > entry) & (entry < t_max) & valid[:, None, :]
    return jnp.min(jnp.where(ok, entry, jnp.inf), axis=2)


RAY_BLOCK = 64  # rays per visit-list block


def coherence_key(o, d, valid, bounds8, t_max):
    """The coherence-sort key for a wavefront against one mesh's cluster
    bounds (8, K), resolved by HRT_KEY_MODE. Rays that cannot hit the
    mesh AT ALL (one slab test against the ROOT box = union of cluster
    bounds) sort last, so whole blocks of missers exit the traversal
    kernel after zero visits; potential hitters group by where they
    enter the root box (see cheap_key_from_box).

    "auto" (default): octant|entry Morton below CORRIDOR_MIN_K clusters,
    entry|exit Morton ("corridor") at or above — fine clusters let the
    exit cell discriminate visit sets, coarse ones do not."""
    bmin = bounds8[:3, :].min(axis=1)           # (3,) root box
    bmax = bounds8[3:6, :].max(axis=1)
    return cheap_key_from_box(o, d, valid, bmin, bmax, t_max,
                              corridor=use_corridor_key(bounds8.shape[1]))


def use_corridor_key(k_clusters: int) -> bool:
    """Whether HRT_KEY_MODE picks the entry|exit key for k_clusters."""
    return (KEY_MODE == "corridor"
            or (KEY_MODE == "auto" and k_clusters >= CORRIDOR_MIN_K))


def cheap_key_from_box(o, d, valid, bmin, bmax, t_max,
                       corridor: bool = False):
    """coherence_key against an EXPLICIT box — the pool-level
    multi-mesh sort keys on the world-space UNION of every kernel
    mesh's root box (scene/ir.py:wavefront_sort_key), so rays heading
    for ANY mesh stay locality-grouped (keying on one mesh's box sorts
    the other meshes' hitters into the random 'misser' tail)."""
    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-30, 1e-30, d)
    t0 = (bmin[None, :] - o) * inv
    t1 = (bmax[None, :] - o) * inv
    lo = jnp.max(jnp.minimum(t0, t1), axis=1)
    hi = jnp.min(jnp.maximum(t0, t1), axis=1)
    entry = jnp.maximum(lo, 0.0)
    could_hit = (hi > entry) & (entry < t_max) & valid

    # Morton-code the point where the ray ENTERS the root box, not the
    # origin: camera rays share one origin (zero discrimination) but
    # their entry points spread over the box face and track the first
    # cluster; for rays born inside (entry=0) this IS the origin.
    pe = o + d * entry[:, None]
    q = jnp.clip((pe - bmin[None, :]) / jnp.maximum(bmax - bmin, 1e-30),
                 0.0, 1.0)
    cell = (q * 31.0).astype(jnp.int32)          # 5 bits/axis

    def spread(x):                               # abcde -> a00b00c00d00e
        x = (x | (x << 8)) & 0x100F
        x = (x | (x << 4)) & 0x10C3
        x = (x | (x << 2)) & 0x1249
        return x

    morton = (spread(cell[:, 0]) | (spread(cell[:, 1]) << 1)
              | (spread(cell[:, 2]) << 2))       # 15 bits

    if corridor:
        # corridor key: replace the 3-bit direction octant with the
        # 15-bit Morton cell of the root-box EXIT point — two rays share
        # a key prefix iff they enter AND leave the box in nearby cells,
        # i.e. traverse the same corridor of clusters. With coarse
        # clusters the finer split only fragments blocks whose visit sets
        # already fit a few clusters, hence the auto switch on cluster
        # count (use_corridor_key).
        px = o + d * jnp.maximum(hi, entry)[:, None]
        qx = jnp.clip((px - bmin[None, :])
                      / jnp.maximum(bmax - bmin, 1e-30), 0.0, 1.0)
        cx = (qx * 31.0).astype(jnp.int32)
        m_exit = (spread(cx[:, 0]) | (spread(cx[:, 1]) << 1)
                  | (spread(cx[:, 2]) << 2))
        key = (morton << 15) | m_exit            # 30 bits
        return jnp.where(could_hit, key, jnp.int32(1 << 30))

    octant = ((d[:, 0] > 0).astype(jnp.int32)
              | ((d[:, 1] > 0).astype(jnp.int32) << 1)
              | ((d[:, 2] > 0).astype(jnp.int32) << 2))
    key = (octant << 15) | morton
    return jnp.where(could_hit, key, jnp.int32(1 << 20))


def _tri_soa(tri_verts):
    """(K, L, 3, 3) leaf vertices -> Moller-Trumbore SoA (K, 9, L):
    [v0, e1=v1-v0, e2=v2-v0] with triangles on the minor (lane) axis so
    gathered cluster blocks stay packed."""
    v0 = tri_verts[:, :, 0, :]
    e1 = tri_verts[:, :, 1, :] - v0
    e2 = tri_verts[:, :, 2, :] - v0
    soa = jnp.concatenate([v0, e1, e2], axis=2)           # (K, L, 9)
    return jnp.swapaxes(soa, 1, 2)                        # (K, 9, L)


def intersect_mesh_clustered(rays: Rays, tri_verts, tri_id, bmin, bmax,
                             t_max, ray_valid=None):
    """Closest triangle via the flattened cluster BVH (scene/bvh.py).

    EXACT traversal (replaces the round-1 fixed-C nearest-cluster heuristic
    that could silently drop geometry): rays are grouped into blocks of
    RAY_BLOCK; each block sorts the clusters its rays' slab tests entered by
    nearest entry distance and visits them in that order with a
    `lax.while_loop`, stopping only when the next cluster's entry exceeds
    every ray-in-block's current best t (or the entries run out). This is
    the vectorized equivalent of the reference's recursive ordered descent
    (BVHNode::hit, bvh.cpp:69-78: box test, then children bounded by the
    closer child's t) — every entered cluster that could still win IS
    visited, so no false misses.

    tri_verts: (K, L, 3, 3); tri_id: (K, L) int32 (-1 pads); bounds (K,3).
    ray_valid: optional (R,) bool — lanes to ignore (padded/dead rays do not
    open clusters or extend the block's termination bound).
    Returns (t_best (R,), global_tri_id (R,) int32, hit (R,) bool).
    """
    n_rays = rays.o.shape[0]
    k_clusters, leaf = tri_id.shape
    b = RAY_BLOCK
    n_pad = ((n_rays + b - 1) // b) * b
    nb = n_pad // b

    o = _pad(rays.o, n_pad, 0.0).reshape(nb, b, 3)
    d = _pad(rays.d, n_pad, 1.0).reshape(nb, b, 3)
    if ray_valid is None:
        ray_valid = jnp.ones((n_rays,), jnp.bool_)
    valid = _pad(ray_valid, n_pad, False).reshape(nb, b)  # (NB, B)

    # dense ray x cluster slab entries; invalid lanes never open a cluster
    block_entry = block_entries(o, d, valid, bmin, bmax, t_max)  # (NB, K)
    order = jnp.argsort(block_entry, axis=1).astype(jnp.int32)   # (NB, K)
    e_sorted = jnp.take_along_axis(block_entry, order, axis=1)   # (NB, K)
    # sentinel column so e_sorted[:, j+1] is always in range
    e_sorted = jnp.concatenate(
        [e_sorted, jnp.full((nb, 1), jnp.inf, jnp.float32)], axis=1)

    tri_soa = _tri_soa(tri_verts)                         # (K, 9, L)
    pad_ok = tri_id >= 0                                  # (K, L)

    ox, oy, oz = o[..., 0:1], o[..., 1:2], o[..., 2:3]    # (NB, B, 1)
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]

    def col(a, j):
        return jax.lax.dynamic_slice_in_dim(a, j, 1, axis=1)[:, 0]

    def cond(carry):
        j, _, _, alive = carry
        return (j < k_clusters) & jnp.any(alive)

    def body(carry):
        j, t_best, id_best, alive = carry                 # t/id: (NB, B)
        slot = col(order, j)                              # (NB,)
        e_j = col(e_sorted, j)                            # (NB,)
        visit = alive & jnp.isfinite(e_j)                 # (NB,)
        blk = tri_soa[slot]                               # (NB, 9, L) gather
        ok = pad_ok[slot] & visit[:, None]                # (NB, L)
        v0x = blk[:, 0, None, :]                          # (NB, 1, L)
        v0y = blk[:, 1, None, :]
        v0z = blk[:, 2, None, :]
        e1x = blk[:, 3, None, :]
        e1y = blk[:, 4, None, :]
        e1z = blk[:, 5, None, :]
        e2x = blk[:, 6, None, :]
        e2y = blk[:, 7, None, :]
        e2z = blk[:, 8, None, :]
        # Moller-Trumbore, all ops (NB, B, L)
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv = 1.0 / jnp.where(det == 0.0, 1.0, det)
        tx = ox - v0x
        ty = oy - v0y
        tz = oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        good = ((det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                & (t > 0.0) & (t <= t_max) & ok[:, None, :])
        t = jnp.where(good, t, BIG)
        l_best = jnp.argmin(t, axis=2)                    # (NB, B)
        t_c = jnp.min(t, axis=2)
        take = t_c < t_best
        gid = jnp.take_along_axis(tri_id[slot], l_best, axis=1)  # (NB, B)
        t_best = jnp.where(take, t_c, t_best)
        id_best = jnp.where(take, gid, id_best)
        # a block stays alive while the NEXT sorted entry could still beat
        # the worst best-t among its valid rays
        worst = jnp.max(jnp.where(valid, t_best, -BIG), axis=1)  # (NB,)
        e_next = col(e_sorted, j + 1)
        alive = visit & (e_next < worst)
        return j + 1, t_best, id_best, alive

    init = (jnp.int32(0),
            jnp.full((nb, b), BIG, jnp.float32),
            jnp.full((nb, b), -1, jnp.int32),
            jnp.isfinite(col(e_sorted, 0)))
    _, t_best, id_best, _ = jax.lax.while_loop(cond, body, init)
    # invalid lanes ride along in their block's vector ops; scrub them
    t_best = jnp.where(valid, t_best, BIG)
    id_best = jnp.where(valid, id_best, -1)
    t_best = t_best.reshape(-1)[:n_rays]
    id_best = id_best.reshape(-1)[:n_rays]
    return t_best, id_best, t_best < BIG


def intersect_mesh_clustered_pallas(rays: Rays, tri_verts, tri_id, bmin,
                                    bmax, t_max, ray_valid=None,
                                    interpret: bool = False,
                                    tri_normals=None, tri_uvs=None,
                                    tri_soa=None, bounds8=None,
                                    cohsort=None, need_uv: bool = True):
    """Same contract as intersect_mesh_clustered, but traversal + leaf
    intersection + attribute interpolation run as the fused Pallas kernel
    (kernels/mesh_traverse.py): the cluster slab tests, near-to-far visit
    order and per-block dynamic trip counts live inside the kernel — no
    (rays x clusters) entry matrix in device memory — and the winning
    triangle's smooth normal/UV come straight out of it. Forward-only (no
    custom VJP — the differentiable path replays from the winning id).

    tri_soa (K,24,L) / bounds8 (8,K): prebuilt device tables
    (kernels.pack_mesh_soa / pack_bounds). Pass them when the mesh is
    static; when omitted they are built here from
    tri_verts/tri_normals/tri_uvs (zeros when those are omitted too —
    pure-occlusion queries).
    Returns (t (R,), gid (R,) int32, hit (R,), normal (R,3), uv (R,2)).
    """
    from ..kernels import mesh_traverse as kmod

    n_rays = rays.o.shape[0]
    k_clusters, leaf = tri_id.shape
    if cohsort is None:
        # callers that already sorted the wavefront (integrator/wavefront
        # presorts the whole lane pool) pass False
        cohsort = not NO_COHSORT
    b = kmod.BLOCK
    n_pad = ((n_rays + b - 1) // b) * b

    if ray_valid is None:
        ray_valid = jnp.ones((n_rays,), jnp.bool_)
    valid = _pad(ray_valid, n_pad, False)
    o = _pad(rays.o, n_pad, 0.0)
    d = _pad(rays.d, n_pad, 1.0)

    if tri_soa is None:
        if tri_normals is None:
            tri_normals = jnp.zeros(tri_verts.shape, jnp.float32)
        if tri_uvs is None:
            tri_uvs = jnp.zeros((k_clusters, leaf, 3, 2), jnp.float32)
        tri_soa = kmod.pack_mesh_soa(tri_verts, tri_normals, tri_uvs)
    if bounds8 is None:
        bounds8 = kmod.pack_bounds(bmin, bmax)

    rays8 = jnp.concatenate(
        [o.T, d.T, valid.astype(jnp.float32)[None, :],
         jnp.zeros((1, n_pad), jnp.float32)], axis=0)      # (8, n_pad)

    if cohsort:
        # coherence sort: rays that miss the mesh pack LAST (whole blocks
        # of missers exit the kernel loop after zero visits) and the rest
        # group by where they enter the mesh, so a block's rays open
        # mostly the same clusters. The reference gets this "for free"
        # from per-ray recursion. HRT_NO_COHSORT=1 disables.
        perm = jnp.argsort(coherence_key(o, d, valid, bounds8,
                                         float(t_max)))
        rays8 = rays8[:, perm]

    out, id_best = kmod.traverse_clusters_pallas(
        rays8, bounds8, tri_soa, tri_id, t_max=float(t_max),
        interpret=interpret, need_uv=need_uv)
    if cohsort:
        # undo the coherence sort (HRT_UNSORT_MODE)
        if UNSORT_MODE == "argsort":
            inv = jnp.argsort(perm).astype(jnp.int32)
            out = out[:, inv]
            id_best = id_best[inv]
        else:
            out = jnp.zeros_like(out).at[:, perm].set(out)
            id_best = jnp.zeros_like(id_best).at[perm].set(id_best)
    out = out[:, :n_rays]
    id_best = id_best[:n_rays]
    t_best = out[0]
    return (t_best, id_best, t_best < BIG, out[1:4].T, out[4:6].T)


def intersect_triangles_bvh(rays: Rays, verts, normals, uvs, indices,
                            tri_verts, tri_id, bmin, bmax, mat_id, t_max,
                            ray_valid=None, backend: str = "xla",
                            interpret: bool = False,
                            tri_soa=None, bounds8=None,
                            cohsort=None, need_uv: bool = True) -> Hits:
    """Full mesh hit via the cluster BVH: find (t, tri) then interpolate
    attributes exactly like intersect_triangles. backend: "xla" (exact
    lockstep loop, differentiable), "pallas" (fused GPU kernel with
    in-kernel attribute interpolation — no per-ray vertex gathers) or
    "pallas_replay" (kernel find, differentiable replay).
    tri_soa/bounds8: prebuilt kernel tables for static meshes (see
    intersect_mesh_clustered_pallas)."""
    if backend == "pallas":
        if tri_soa is None:
            safe_cl = jnp.maximum(tri_id, 0)              # (K,L)
            corner = indices[safe_cl]                     # (K,L,3)
            tri_normals, tri_uvs = normals[corner], uvs[corner]
        else:
            tri_normals = tri_uvs = None
        t, gid, hit, normal, uv = intersect_mesh_clustered_pallas(
            rays, tri_verts, tri_id, bmin, bmax, t_max, ray_valid,
            interpret=interpret, tri_normals=tri_normals,
            tri_uvs=tri_uvs, tri_soa=tri_soa, bounds8=bounds8,
            cohsort=cohsort, need_uv=need_uv)
        front = jnp.sum(rays.d * normal, axis=-1) < 0.0
        return Hits(hit=hit, t=jnp.where(hit, t, BIG),
                    p=ray_at(rays.o, rays.d, jnp.where(hit, t, 1.0)),
                    normal=normal, uv=uv, front_face=front,
                    mat_id=jnp.where(hit, mat_id, -1))
    # Differentiable paths: the discrete FIND (which triangle wins) runs
    # behind stop_gradient — via the exact XLA traversal (backend="xla",
    # always correct, tracks live vertex positions) or the fused Pallas
    # kernel over the BUILD-TIME tables (backend="pallas_replay"; exact
    # while the geometry is static, i.e. material/texture
    # fits — vertex fits must use "xla" so moved vertices are FOUND, not
    # just replayed). Everything differentiable is then REPLAYED from the
    # winning triangle id: t via the watertight formula, attributes via
    # barycentrics — the same path-replay discipline the shading chain
    # uses for discrete decisions.
    sg = jax.lax.stop_gradient
    if backend == "pallas_replay":
        assert tri_soa is not None and bounds8 is not None
        t_nd, gid, hit, _, _ = intersect_mesh_clustered_pallas(
            Rays(o=sg(rays.o), d=sg(rays.d)), None, tri_id,
            bmin, bmax, t_max, ray_valid, interpret=interpret,
            tri_soa=tri_soa, bounds8=bounds8, cohsort=cohsort,
            need_uv=False)
    else:
        t_nd, gid, hit = intersect_mesh_clustered(
            Rays(o=sg(rays.o), d=sg(rays.d)), sg(tri_verts), tri_id,
            sg(bmin), sg(bmax), t_max, ray_valid)
    safe = jnp.maximum(gid, 0)
    i0 = indices[safe, 0]
    i1 = indices[safe, 1]
    i2 = indices[safe, 2]
    t_replay = triangle_t(rays, verts[i0][:, None, :],
                          verts[i1][:, None, :], verts[i2][:, None, :],
                          t_max)[:, 0]
    # grazing hits can numerically miss on replay: fall back to the
    # traversal's (non-differentiable) t so the value never degrades
    t = jnp.where(t_replay < BIG, t_replay, sg(t_nd))
    b0, b1, b2 = triangle_attribs(rays, verts[i0], verts[i1], verts[i2])
    w = lambda a: (b0[:, None] * a[i0] + b1[:, None] * a[i1]
                   + b2[:, None] * a[i2])
    normal = w(normals)
    uv = b0[:, None] * uvs[i0] + b1[:, None] * uvs[i1] + b2[:, None] * uvs[i2]
    front = jnp.sum(rays.d * normal, axis=-1) < 0.0
    return Hits(hit=hit, t=jnp.where(hit, t, BIG),
                p=ray_at(rays.o, rays.d, jnp.where(hit, t, 1.0)),
                normal=normal, uv=uv, front_face=front,
                mat_id=jnp.where(hit, mat_id, -1))


# ------------------------------------------------------------------- slab

def aabb_hit(o, inv_d, bmin, bmax, t_min, t_max):
    """Branchless slab test (reference AABB::hit, aabb.h:26-39): reject when
    the interval empties; matches the reference's strict `t_max <= t_min`
    reject. o/inv_d: (...,3); bmin/bmax broadcastable to (...,3)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    tmin = jnp.maximum(jnp.max(lo, axis=-1), t_min)
    tmax = jnp.minimum(jnp.min(hi, axis=-1), t_max)
    return tmax > tmin
