"""Edge-sampled visibility gradients for vertex positions.

The interior (shading-chain) vertex gradients in diff/fit.py miss the
DISCONTINUOUS part of the pixel integral: moving a vertex sweeps the
mesh's silhouette across pixels, and hit/miss is not differentiable. The
missing term is a boundary integral over silhouette edges (Li et al.
2018, "Differentiable Monte Carlo Ray Tracing through Edge Sampling"),
which we estimate for PRIMARY visibility — the dominant term for
camera-facing silhouettes — by sampling points on the mesh's silhouette
edges in image space:

    dL/dθ += (1/A_pix) Σ_edges ∮ w(x) (f_in(x) - f_out(x))
                               (n̂(x) · ∂x_img/∂θ) dl

where w is the per-pixel loss weight, f_in/f_out the radiance on the two
sides of the edge (estimated with the forward integrator at x ± ε n̂),
n̂ the image-space edge normal, and ∂x_img/∂θ the image-space velocity of
the edge point under the vertex parameters (exact, via VJP through the
camera projection).

SHADOW silhouettes (round 3, `shadow_boundary_grad`): a blocker's vertex
also sweeps the SHADOW it casts across receiver surfaces — a secondary
discontinuity the primary term cannot see (the blocker may be entirely
off-screen). For a compact emitter at position l, the shadow boundary in
image space is the projection of the blocker's l-silhouette edges through
l onto the receiver: edge point x maps to the receiver point
y = l + τ(x)(x − l) (τ from the receiver's local tangent plane, found
with one forward occlusion cast), and then through the camera. The same
boundary estimator then applies with ∂x_img/∂θ following the whole chain
x → y → image by VJP. Penumbra blur from emitter AREA is not modeled
(the emitter is treated as a point at l — exact in the small-emitter
limit; set eps_px to roughly the penumbra width in pixels so the two-
sided radiance probes straddle the whole ramp). Glossy-reflection
silhouettes, and variance reduction strong enough for shadow-DRIVEN
optimization under this no-NEE integrator, remain future work — the term
is FD-validated (tests/test_edges.py::test_shadow_boundary_grad_matches
_fd) and wired into fit_materials(shadow_light=...).

The reference renderer has no autodiff at all — this subsystem is the
framework's extension target (BASELINE.json north star:
"reparameterized/edge-aware where intersections discontinue").
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Rays
from ..ops.camera import Camera, get_rays

# RNG purpose tags local to edge sampling
_EDGE_PICK = 201
_EDGE_S = 202
_EDGE_PICK_SH = 203
_EDGE_S_SH = 204


def build_edge_table(indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: unique undirected mesh edges and their adjacent faces.

    indices: (T,3) int. Returns (edges (E,2) int32 vertex ids,
    efaces (E,2) int32 face ids, -1 for boundary edges' missing side)."""
    indices = np.asarray(indices)
    emap = {}
    for f, (a, b, c) in enumerate(indices):
        for i, j in ((a, b), (b, c), (c, a)):
            k = (min(int(i), int(j)), max(int(i), int(j)))
            if k in emap:
                emap[k].append(f)
            else:
                emap[k] = [f]
    edges = np.array(sorted(emap.keys()), np.int32).reshape(-1, 2)
    efaces = np.full((len(edges), 2), -1, np.int32)
    for r, k in enumerate(sorted(emap.keys())):
        fs = emap[k][:2]
        efaces[r, :len(fs)] = fs
    return edges, efaces


def project(cam: Camera, p: jnp.ndarray) -> jnp.ndarray:
    """World points (N,3) -> image coordinates (N,2) = (s,t) in [0,1]
    (the get_rays parameterization): intersect the origin->p line with the
    focal plane spanned by (horizontal, vertical) at lower_left_corner."""
    # 3-vector dot products as elementwise sums: a float32 matmul may run
    # in TF32 on a GPU (~3 decimal digits), too coarse for pixel positions
    def dot(x, y):
        return jnp.sum(x * y, axis=-1)

    d = p - cam.origin
    f = -dot(cam.lower_left_corner - cam.origin, cam.w)
    denom = dot(d, cam.w)                   # negative for points in front
    alpha = -f / denom
    x = cam.origin + alpha[:, None] * d
    rel = x - cam.lower_left_corner
    s = dot(rel, cam.u) / dot(cam.horizontal, cam.u)
    t = dot(rel, cam.v) / dot(cam.vertical, cam.v)
    return jnp.stack([s, t], axis=-1)


def silhouette_mask(verts, indices, edges, efaces, cam_origin) -> jnp.ndarray:
    """(E,) bool: edge is on the silhouette as seen from cam_origin —
    boundary edge (one face) or adjacent faces with opposite facing."""
    tri = verts[indices]                                  # (T,3,3)
    n = jnp.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    centroid = tri.mean(axis=1)
    facing = jnp.sum(n * (centroid - cam_origin), axis=-1) < 0.0  # (T,)
    f0, f1 = efaces[:, 0], efaces[:, 1]
    is_boundary = f1 < 0
    flip = facing[jnp.maximum(f0, 0)] != facing[jnp.maximum(f1, 0)]
    return is_boundary | flip


def _edge_estimator(vjp, x_img, pa_img, pb_img, valid, weight, width,
                    height, radiance_fn, n_edges, n_samples, eps_px,
                    cam):
    """The shared boundary-integral estimator: given the image-space edge
    sample positions (and the VJP back to the vertices), weight each
    sample by the two-sided radiance difference and the per-pixel loss
    weight, and pull the image-space normal velocity back to verts.

    Both boundary terms (primary silhouettes via direct projection,
    shadow silhouettes via projection through the emitter onto the
    receiver) reduce to exactly this once x_img/vjp are built."""
    # image-space edge direction -> normal (orientation cancels in the
    # product w * (f_+ - f_-) * (n̂·v), so either perpendicular works)
    ev = pb_img - pa_img                                  # (K,2)
    elen = jnp.linalg.norm(ev, axis=-1)                   # image-space length
    ehat = ev / jnp.maximum(elen, 1e-12)[:, None]
    nhat = jnp.stack([-ehat[:, 1], ehat[:, 0]], axis=-1)  # (K,2)

    # radiance on both sides (forward render, two offset rays per sample)
    eps = jnp.asarray([eps_px / (width - 1), eps_px / (height - 1)],
                      jnp.float32)
    x_p = x_img + eps * nhat
    x_m = x_img - eps * nhat
    f_p = radiance_fn(get_rays(cam, x_p[:, 0], x_p[:, 1]))  # (K,3)
    f_m = radiance_fn(get_rays(cam, x_m[:, 0], x_m[:, 1]))

    # loss weight at the sample's pixel (zero outside the image).
    # Pixel (row r, col c) owns s in [c, c+1)/(W-1) and t in [y, y+1)/(H-1)
    # with y = H - r (the reference's y-flip, main.cpp:116-121)
    col = jnp.floor(x_img[:, 0] * (width - 1)).astype(jnp.int32)
    y = jnp.floor(x_img[:, 1] * (height - 1)).astype(jnp.int32)
    row = height - y
    inside = ((col >= 0) & (col < width) & (row >= 0) & (row < height))
    w_pix = jnp.where(
        inside[:, None],
        weight[jnp.clip(row, 0, height - 1), jnp.clip(col, 0, width - 1)],
        0.0)                                              # (K,3)

    # scalar coefficient per sample; A_pix = footprint in (s,t) units.
    # (f_- - f_+) with +/- along n̂ equals (f_in - f_out) along the OUTWARD
    # normal regardless of n̂'s orientation (both factors flip together)
    a_pix = (1.0 / (width - 1)) * (1.0 / (height - 1))
    df = jnp.sum(w_pix * (f_m - f_p), axis=-1)            # (K,)
    valid = valid & jnp.isfinite(elen)
    coeff = (jnp.where(valid, 1.0, 0.0) * df * elen
             * (n_edges / n_samples) / a_pix)             # (K,)
    cot = jnp.where(valid[:, None], coeff[:, None] * nhat, 0.0)
    (dverts,) = vjp(jax.lax.stop_gradient(cot))
    return dverts


def boundary_grad(verts: jnp.ndarray, edges, efaces, indices, cam: Camera,
                  weight: jnp.ndarray, width: int, height: int,
                  radiance_fn: Callable[[Rays], jnp.ndarray],
                  key: jax.Array, n_samples: int = 4096,
                  eps_px: float = 0.35) -> jnp.ndarray:
    """d(sum(weight * image)) / d(verts), boundary term only.

    weight: (H, W, 3) per-pixel loss weight (dL/dI). radiance_fn maps a
    Rays batch to (N,3) linear radiance with the FORWARD integrator.
    image convention matches integrator/path.py: pixel (row r, col c)
    samples s=(c+U)/(W-1), t=(H-r+U)/(H-1)."""
    e_sel = jax.random.randint(jax.random.fold_in(key, _EDGE_PICK),
                               (n_samples,), 0, edges.shape[0])
    s_par = jax.random.uniform(jax.random.fold_in(key, _EDGE_S),
                               (n_samples,))
    sil = silhouette_mask(verts, indices, edges, efaces, cam.origin)[e_sel]

    va_idx = edges[e_sel, 0]
    vb_idx = edges[e_sel, 1]

    def img_pos(vs):
        pa = vs[va_idx]
        pb = vs[vb_idx]
        p = (1.0 - s_par)[:, None] * pa + s_par[:, None] * pb
        return project(cam, p)

    x_img, vjp = jax.vjp(img_pos, verts)                  # (K,2)
    return _edge_estimator(vjp, x_img, project(cam, verts[va_idx]),
                           project(cam, verts[vb_idx]), sil, weight,
                           width, height, radiance_fn, edges.shape[0],
                           n_samples, eps_px, cam)


def shadow_boundary_grad(verts: jnp.ndarray, edges, efaces, indices,
                         light_pos: jnp.ndarray, cam: Camera,
                         weight: jnp.ndarray, width: int, height: int,
                         radiance_fn: Callable[[Rays], jnp.ndarray],
                         hit_fn: Callable[[Rays], object],
                         key: jax.Array, n_samples: int = 4096,
                         eps_px: float = 0.5) -> jnp.ndarray:
    """d(sum(weight * image)) / d(verts): SHADOW-silhouette boundary term
    for a blocker mesh lit by a compact emitter at `light_pos`.

    hit_fn maps a Rays batch to a Hits record (forward scene intersect;
    only .p / .normal / .hit are read, all under stop_gradient) — it finds
    the RECEIVER surface behind each sampled edge point along the
    light->edge line. radiance_fn is the forward integrator; the radiance
    difference across the projected shadow edge supplies f_in - f_out
    (which includes every indirect effect the renderer models)."""
    l = jnp.asarray(light_pos, jnp.float32)
    e_sel = jax.random.randint(jax.random.fold_in(key, _EDGE_PICK_SH),
                               (n_samples,), 0, edges.shape[0])
    s_par = jax.random.uniform(jax.random.fold_in(key, _EDGE_S_SH),
                               (n_samples,))
    sil = silhouette_mask(verts, indices, edges, efaces, l)[e_sel]

    va_idx = edges[e_sel, 0]
    vb_idx = edges[e_sel, 1]
    sg = jax.lax.stop_gradient

    # receiver behind the edge point along the light ray (forward cast,
    # non-differentiable): origin just past the blocker
    x0 = sg((1.0 - s_par)[:, None] * verts[va_idx]
            + s_par[:, None] * verts[vb_idx])
    dvec = x0 - l
    dist = jnp.linalg.norm(dvec, axis=-1, keepdims=True)
    dhat = dvec / jnp.maximum(dist, 1e-12)
    h = hit_fn(Rays(o=x0 + 1e-3 * dhat, d=dhat))
    y0 = sg(h.p)                                          # (K,3)
    n0 = sg(h.normal)
    ok_recv = sg(h.hit)
    # degenerate receiver orientation (grazing plane) -> drop sample
    denom0 = jnp.sum((x0 - l) * n0, axis=-1)
    ok_recv = ok_recv & (jnp.abs(denom0) > 1e-6)

    def shadow_img(p):
        """Blocker point (K,3) -> image position of its shadow on the
        receiver's local tangent plane (differentiable in p)."""
        tau = (jnp.sum((y0 - l) * n0, axis=-1)
               / jnp.sum((p - l) * n0, axis=-1))
        y = l + tau[:, None] * (p - l)
        return project(cam, y)

    def img_pos(vs):
        p = ((1.0 - s_par)[:, None] * vs[va_idx]
             + s_par[:, None] * vs[vb_idx])
        return shadow_img(p)

    x_img, vjp = jax.vjp(img_pos, verts)                  # (K,2)
    # image-space direction of the PROJECTED edge (same tangent planes)
    return _edge_estimator(vjp, x_img, shadow_img(verts[va_idx]),
                           shadow_img(verts[vb_idx]), sil & ok_recv,
                           weight, width, height, radiance_fn,
                           edges.shape[0], n_samples, eps_px, cam)
