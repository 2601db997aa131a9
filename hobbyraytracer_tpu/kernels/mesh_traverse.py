"""Fused cluster-BVH mesh find as a Pallas kernel (Triton route).

Replaces the lock-step XLA traversal in
ops/intersect.py:intersect_mesh_clustered for the forward render path and
for the find half of the differentiable replay. The XLA loop is LOCKSTEP:
it builds a dense (rays x clusters) slab-entry matrix in device memory,
and every `while_loop` trip intersects every ray block until the slowest
block is done. Here every program owns one small block of rays and runs
its OWN loop, so the total cost is the SUM of per-block visits — the same
early-out economics as the reference's per-ray recursive descent
(bvh.cpp:69-78).

One program (BLOCK rays, a power of two):

1. builds the block's entry ROW: for every cluster, the nearest slab
   entry (aabb.h:26-39 semantics, as ops/intersect.py:block_entries)
   over the block's valid rays. The row is held in registers as a few
   ROW_CHUNK-wide vectors, filled by a loop over the block's rays — the
   (B, K) entry matrix never exists;
2. visits clusters near to far by that row (min-and-match first index,
   not argmin). A cluster is VISITED only while some ray's OWN entry into
   it (re-tested from the cluster's box) is below that ray's best t — the
   per-ray masked visit rule; others are skipped for the cost of B slab
   tests. The loop ends when the nearest remaining entry cannot beat the
   block's worst best t;
3. intersects a visited leaf in LEAF_TILE-wide sub-tiles (Moller-Trumbore;
   the reference's watertight variant, triangle.cpp:57-109, stays on the
   XLA/differentiable path — the two agree to float rounding,
   tests/test_kernels.py), keeping per ray (t, cluster, lane) of the first
   minimum;
4. re-gathers the winning triangle once per ray and interpolates its
   smooth normal and UV from the Moller-Trumbore barycentrics
   (triangle.cpp:112-128).

All arithmetic is elementwise float32: there are no matrix products, so
TF32 never applies. Blocks are independent and run in any order.

Table layout (built once on the host, scene/build.py):
- tri table (K, 24, L) f32: rows [v0, e1=v1-v0, e2=v2-v0, n0, n1, n2,
  uv0, uv1, uv2] with the L leaf triangles on the minor axis, so a
  sub-tile row is one contiguous load;
- ids (K, L) int32 global triangle ids, -1 for leaf padding;
- bounds (8, K) f32 rows [bmin.xyz, bmax.xyz, 0, 0].
Rays enter as (8, R) rows [ox oy oz dx dy dz valid 0] and results leave
as (8, R) rows [t nx ny nz u v 0 0] plus (R,) int32 triangle ids.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..core.mathx import BIG

# Rays per program (a power of two). Not yet swept on the H100.
BLOCK = int(os.environ.get("HRT_BLOCK", "32"))
# Triangles per leaf sub-tile: the live (BLOCK, LEAF_TILE) f32 temporaries
# of one Moller-Trumbore pass must stay in registers.
LEAF_TILE = 32
# Widest register vector of the block's entry row; wider meshes hold the
# row as several such chunks.
ROW_CHUNK = 1024
# Meshes with more clusters than this (~1M triangles at leaf 128) take the
# XLA find: the entry row would no longer fit in registers.
MAX_CLUSTERS = 8 * ROW_CHUNK
NUM_WARPS = 4
SOA_ROWS = 24        # v0,e1,e2 (9) + n0,n1,n2 (9) + uv0,uv1,uv2 (6)
_INF = float("inf")
# never-hit padding box: degenerate AT DISTANCE, not inverted — the slab
# test takes min/max per axis, which turns an inverted box into one that
# covers all space. A zero-size box gives hi == entry (strict reject), and
# at 3e37 the products overflow to +-inf, which the comparisons reject too.
_PAD_BOX = 3e37


def kernel_fits(k_clusters: int) -> bool:
    """Whether the kernel can traverse a mesh of k_clusters clusters."""
    return k_clusters <= MAX_CLUSTERS


def row_geometry(k_clusters: int):
    """(chunk, padded K) of the entry row: one power-of-two chunk for small
    meshes, ROW_CHUNK-wide chunks for large ones."""
    chunk = min(ROW_CHUNK, pl.next_power_of_2(max(k_clusters, 1)))
    return chunk, -(-k_clusters // chunk) * chunk


def pack_mesh_soa(tri_verts, tri_normals, tri_uvs):
    """(K,L,3,3) verts / (K,L,3,3) corner normals / (K,L,3,2) corner UVs
    -> (K, 24, L) SoA with the leaf triangles on the minor axis."""
    v0 = tri_verts[:, :, 0, :]
    e1 = tri_verts[:, :, 1, :] - v0
    e2 = tri_verts[:, :, 2, :] - v0
    cols = [v0, e1, e2,
            tri_normals[:, :, 0, :], tri_normals[:, :, 1, :],
            tri_normals[:, :, 2, :],
            tri_uvs[:, :, 0, :], tri_uvs[:, :, 1, :], tri_uvs[:, :, 2, :]]
    soa = jnp.concatenate(cols, axis=2)                   # (K, L, 24)
    return jnp.swapaxes(soa, 1, 2)                        # (K, 24, L)


def pack_bounds(bmin, bmax):
    """(K,3)/(K,3) cluster bounds -> (8, K) f32 rows [bmin.xyz, bmax.xyz,
    0, 0]."""
    rows = jnp.concatenate([bmin.T, bmax.T,
                            jnp.zeros((2, bmin.shape[0]), jnp.float32)],
                           axis=0)
    return rows.astype(jnp.float32)


def _slab(o, inv, lo, hi, t_max: float):
    """Slab entry distance (>= 0), +inf where missed. o/inv/lo/hi: three
    per-axis values that broadcast against each other."""
    near = far = None
    for ax in range(3):
        t0 = (lo[ax] - o[ax]) * inv[ax]
        t1 = (hi[ax] - o[ax]) * inv[ax]
        n_ax = jnp.minimum(t0, t1)
        f_ax = jnp.maximum(t0, t1)
        near = n_ax if near is None else jnp.maximum(near, n_ax)
        far = f_ax if far is None else jnp.minimum(far, f_ax)
    entry = jnp.maximum(near, 0.0)
    return jnp.where((far > entry) & (entry < t_max), entry, _INF)


def _safe_inv(d):
    return 1.0 / jnp.where(jnp.abs(d) < 1e-30, 1e-30, d)


def _moller_trumbore(o, d, v0, e1, e2):
    """(det, u, v, t) of rays o/d against triangles v0/e1/e2 (per-axis
    lists of broadcastable values)."""
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    inv = 1.0 / jnp.where(det == 0.0, 1.0, det)
    tx = o[0] - v0[0]
    ty = o[1] - v0[1]
    tz = o[2] - v0[2]
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv
    return det, u, v, t


def _kernel(rays_ref, bounds_ref, tri_ref, id_ref, out_f_ref, out_i_ref, *,
            k_clusters: int, chunk: int, n_chunks: int, leaf: int,
            block: int, t_max: float, need_uv: bool):
    base = pl.program_id(0) * block
    rows = pl.ds(base, block)
    o = [rays_ref[a, rows] for a in range(3)]               # (B,) each
    d = [rays_ref[3 + a, rows] for a in range(3)]
    inv = [_safe_inv(x) for x in d]
    valid = rays_ref[6, rows] > 0.0

    # 1. the block's entry row, one register chunk at a time
    def row_chunk(c):
        cols = pl.ds(c * chunk, chunk)
        lo = [bounds_ref[a, cols] for a in range(3)]          # (chunk,)
        hi = [bounds_ref[3 + a, cols] for a in range(3)]

        def per_ray(j, row):
            r = base + j
            oj = [rays_ref[a, r] for a in range(3)]
            ij = [_safe_inv(rays_ref[3 + a, r]) for a in range(3)]
            e = _slab(oj, ij, lo, hi, t_max)
            return jnp.minimum(row, jnp.where(rays_ref[6, r] > 0.0, e, _INF))

        return jax.lax.fori_loop(0, block, per_ray,
                                 jnp.full((chunk,), _INF, jnp.float32))

    row0 = tuple(row_chunk(c) for c in range(n_chunks))
    iotas = [jax.lax.broadcasted_iota(jnp.int32, (chunk,), 0) + c * chunk
             for c in range(n_chunks)]

    def pick(row):
        e = functools.reduce(jnp.minimum, [jnp.min(r) for r in row])
        k = functools.reduce(jnp.minimum, [
            jnp.min(jnp.where(r == e, i, n_chunks * chunk))
            for r, i in zip(row, iotas)])
        return e, k

    def worst(best_t):
        return jnp.max(jnp.where(valid, best_t, -_INF))

    lane = jax.lax.broadcasted_iota(jnp.int32, (block, LEAF_TILE), 1)

    def visit(k, best):
        best_t, best_k, best_l = best
        for s in range(leaf // LEAF_TILE):
            cols = pl.ds(s * LEAF_TILE, LEAF_TILE)
            tri = [tri_ref[k, r, cols][None, :] for r in range(9)]
            ids = id_ref[k, cols][None, :]
            det, u, v, t = _moller_trumbore(
                [x[:, None] for x in o], [x[:, None] for x in d],
                tri[0:3], tri[3:6], tri[6:9])
            good = ((det != 0.0) & (u >= 0.0) & (v >= 0.0)
                    & (u + v <= 1.0) & (t > 0.0) & (t <= t_max)
                    & (ids >= 0))
            t = jnp.where(good, t, BIG)
            t_min = jnp.min(t, axis=1)                        # (B,)
            first = jnp.min(jnp.where(t == t_min[:, None], lane, leaf),
                            axis=1)
            take = (t_min < best_t) & valid
            best_t = jnp.where(take, t_min, best_t)
            best_k = jnp.where(take, k, best_k)
            best_l = jnp.where(take, first + s * LEAF_TILE, best_l)
        return best_t, best_k, best_l

    def cond(carry):
        _, best_t, _, _, e, _ = carry
        return e < worst(best_t)

    def body(carry):
        row, best_t, best_k, best_l, _, k = carry
        kc = jnp.minimum(k, k_clusters - 1)
        lo = [bounds_ref[a, kc] for a in range(3)]
        hi = [bounds_ref[3 + a, kc] for a in range(3)]
        need = (_slab(o, inv, lo, hi, t_max) < best_t) & valid
        best_t, best_k, best_l = jax.lax.cond(
            jnp.max(need.astype(jnp.int32)) > 0,
            functools.partial(visit, kc), lambda b: b,
            (best_t, best_k, best_l))
        row = tuple(jnp.where(i == k, _INF, r) for r, i in zip(row, iotas))
        e, k = pick(row)
        return row, best_t, best_k, best_l, e, k

    e0, k0 = pick(row0)
    init = (row0, jnp.full((block,), BIG, jnp.float32),
            jnp.zeros((block,), jnp.int32), jnp.zeros((block,), jnp.int32),
            e0, k0)
    _, best_t, best_k, best_l, _, _ = jax.lax.while_loop(cond, body, init)

    # 4. re-gather the winner once per ray; interpolate its attributes
    hit = best_t < BIG
    kk = jnp.where(hit, best_k, 0)
    ll = jnp.where(hit, best_l, 0)
    g = [tri_ref[kk, r, ll] for r in range(9 + 9 + (6 if need_uv else 0))]
    _, u, v, _ = _moller_trumbore(o, d, g[0:3], g[3:6], g[6:9])
    w0 = 1.0 - u - v

    def interp(r0):       # corner rows r0, r0 + n, r0 + 2n of one attribute
        n = 3 if r0 < 18 else 2
        return w0 * g[r0] + u * g[r0 + n] + v * g[r0 + 2 * n]

    zero = jnp.zeros((block,), jnp.float32)
    cols = [jnp.where(hit, best_t, BIG)]
    cols += [jnp.where(hit, interp(9 + a), 0.0) for a in range(3)]
    if need_uv:
        cols += [jnp.where(hit, interp(18 + a), 0.0) for a in range(2)]
    else:
        cols += [zero, zero]
    for c, x in enumerate(cols + [zero, zero]):
        out_f_ref[c, rows] = x
    out_i_ref[rows] = jnp.where(hit, id_ref[kk, ll], -1)


@functools.partial(jax.jit, static_argnames=("t_max", "interpret",
                                             "need_uv", "block"))
def traverse_clusters_pallas(rays8, bounds8, tri_soa, tri_id,
                             t_max: float = float(BIG),
                             interpret: bool = False,
                             need_uv: bool = True,
                             block: int = BLOCK):
    """rays8: (8, R) ray rows, R a multiple of `block`; bounds8: (8, K)
    (pack_bounds); tri_soa: (K, 24, L) (pack_mesh_soa); tri_id: (K, L)
    int32. Returns (out (8, R) f32 rows [t nx ny nz u v 0 0], triangle id
    (R,) int32, -1 where nothing was hit)."""
    n_rays = rays8.shape[1]
    k_clusters, rows, leaf = tri_soa.shape
    if rows != SOA_ROWS or bounds8.shape != (8, k_clusters):
        raise ValueError(f"tables {tri_soa.shape} / {bounds8.shape} do not "
                         "match the (K, 24, L) / (8, K) kernel layout")
    if n_rays % block or leaf % LEAF_TILE or block & (block - 1):
        raise ValueError(f"{n_rays} rays, leaf {leaf}, block {block}: rays "
                         "must fill whole power-of-two blocks and leaves "
                         f"whole {LEAF_TILE}-triangle tiles")
    if not kernel_fits(k_clusters):
        raise ValueError(f"{k_clusters} clusters exceed MAX_CLUSTERS")
    chunk, k_pad = row_geometry(k_clusters)
    if k_pad != k_clusters:
        pad = jnp.concatenate(
            [jnp.full((6, k_pad - k_clusters), _PAD_BOX, jnp.float32),
             jnp.zeros((2, k_pad - k_clusters), jnp.float32)], axis=0)
        bounds8 = jnp.concatenate([bounds8, pad], axis=1)
    kern = functools.partial(
        _kernel, k_clusters=k_clusters, chunk=chunk,
        n_chunks=k_pad // chunk, leaf=leaf, block=block,
        t_max=float(t_max), need_uv=need_uv)
    out_f, out_i = pl.pallas_call(
        kern,
        grid=(n_rays // block,),
        out_shape=[jax.ShapeDtypeStruct((8, n_rays), jnp.float32),
                   jax.ShapeDtypeStruct((n_rays,), jnp.int32)],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="mesh_find",
    )(rays8, bounds8, tri_soa, tri_id)
    return out_f, out_i
