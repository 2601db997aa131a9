"""Device-side scene IR + world intersection.

The reference's scene is a vector of polymorphic Hittables scanned linearly
(HittableList, hittableList.cpp:4-21; built by Scene::loadScene,
scene.cpp:272-359). Here the scene is a pytree of flat SoA tables:

- all untransformed spheres/rects are pooled into single batched tables;
- each transformed object (and each mesh) is an `Instance` with a TRS
  transform applied to rays on entry and hits on exit (replacing the
  Translate/Scale/RotateQuat wrapper chain, translate.cpp / scale.cpp /
  rotateQuat.cpp);
- constant media are resolved after solids using the solid closest-t as
  their max window (the reference's order-dependent shrinking t_max,
  constantMedium.cpp:4-38).

Transform parameterization divergence (fix-and-document, SURVEY.md §7):
RotateQuat re-normalizes the rotated ray direction (rotateQuat.cpp:51),
silently rescaling the reported t for non-unit directions; Scale keeps t in
scaled units. We keep t in WORLD units everywhere (o' = q^-1((o-T)/S),
d' = q^-1(d/S) preserves the parameter), so closest-hit comparisons between
transformed and untransformed objects are consistent.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core import mathx, quat, rng, struct
from ..core.mathx import BIG
from ..core.types import Hits, Rays, closer, set_face_normal
from ..ops import intersect as isect
from ..ops.shade import MaterialTable
from ..ops.texture import TextureTable


@struct.dataclass
class Transform:
    """TRS instance transform. World = translate + scale * rotate(obj)
    (the reference wraps Translate(Scale(RotateQuat(obj))),
    scene.cpp:334-354)."""
    translate: jnp.ndarray  # (3,)
    scale: jnp.ndarray      # (3,)
    quat: jnp.ndarray       # (4,) [w,x,y,z]

    def ray_to_object(self, rays: Rays) -> Rays:
        o = (rays.o - self.translate) / self.scale
        d = rays.d / self.scale
        return Rays(o=quat.inverse_rotate(self.quat, o),
                    d=quat.inverse_rotate(self.quat, d))

    def point_to_world(self, p: jnp.ndarray) -> jnp.ndarray:
        return self.scale * quat.rotate(self.quat, p) + self.translate

    def normal_to_world(self, n: jnp.ndarray) -> jnp.ndarray:
        # The reference only rotates normals (rotateQuat.cpp:61); Scale does
        # NOT rescale them (scale.cpp:24) — correct for uniform scale, and
        # we keep the same behavior so normal magnitudes (which feed the
        # unnormalized lambertian scatter) match.
        return quat.rotate(self.quat, n)


@struct.dataclass
class SphereTable:
    center: jnp.ndarray  # (S,3)
    radius: jnp.ndarray  # (S,)
    mat_id: jnp.ndarray  # (S,)

    @property
    def empty(self):
        return self.center.shape[0] == 0


@struct.dataclass
class RectTable:
    axis: jnp.ndarray  # (Q,) int32 normal axis 0/1/2
    a0: jnp.ndarray
    a1: jnp.ndarray
    b0: jnp.ndarray
    b1: jnp.ndarray
    k: jnp.ndarray
    mat_id: jnp.ndarray

    @property
    def empty(self):
        return self.axis.shape[0] == 0


@struct.dataclass
class MeshGeom:
    """Triangle soup for one mesh: flat vertex/normal/uv arrays + index
    triples (reference: Mesh/assimpLoadFile, mesh.cpp:53-120). The vertex
    array is a differentiable leaf for vertex-position gradients.

    When `use_bvh` is set, cluster_* hold the flattened uniform-leaf BVH
    (scene/bvh.py): cluster_id (K,L) global tri ids (-1 pad) and cluster
    bounds (K,3). Leaf triangle vertices are re-gathered from `verts` at
    trace time so vertex gradients flow through the BVH path too; cluster
    bounds are recomputed from those vertices per traversal (see
    _intersect_instance), so optimized vertices never drift outside their
    boxes — the stored bounds are the host build's artifact."""
    verts: jnp.ndarray    # (V,3)
    normals: jnp.ndarray  # (V,3)
    uvs: jnp.ndarray      # (V,2)
    indices: jnp.ndarray  # (T,3) int32
    mat_id: jnp.ndarray   # () int32 — whole mesh shares one material
    cluster_id: Optional[jnp.ndarray] = None    # (K,L) int32
    cluster_bmin: Optional[jnp.ndarray] = None  # (K,3)
    cluster_bmax: Optional[jnp.ndarray] = None  # (K,3)
    # Prebuilt Pallas kernel tables (kernels.pack_mesh_soa / pack_bounds),
    # computed ON HOST at build time (scene/build.py) so the forward path
    # pays no per-trace gathers of (K,L,3,x) corner attributes. These
    # snapshot the BUILD-time geometry; the differentiable (XLA) path
    # below regathers from the live vertex array instead, so fitting
    # never sees them stale.
    tri_soa: Optional[jnp.ndarray] = None       # (K,24,L) f32
    bounds8: Optional[jnp.ndarray] = None       # (8,K) f32
    use_bvh: bool = struct.field(pytree_node=False, default=False)


@struct.dataclass
class Instance:
    """One transformed object: a geometry payload + optional Transform.
    kind is static so the intersect dispatch unrolls at trace time."""
    kind: str = struct.field(pytree_node=False)  # sphere|rect|mesh
    spheres: Optional[SphereTable] = None
    rects: Optional[RectTable] = None
    mesh: Optional[MeshGeom] = None
    transform: Optional[Transform] = None


@struct.dataclass
class Medium:
    """Constant-density medium (reference: constantMedium.h/.cpp). The
    reference wraps ANY Hittable (constantMedium.h:10-14); here the
    boundary is sphere | axis-aligned box | closed mesh. (The reference's
    YAML grammar exposes no medium at all, SURVEY.md §2.2 — this is the
    documented schema extension.)"""
    btype: str = struct.field(pytree_node=False)  # sphere|box|mesh
    center: jnp.ndarray = None   # (3,) sphere
    radius: jnp.ndarray = None   # ()   sphere
    bmin: jnp.ndarray = None     # (3,) box
    bmax: jnp.ndarray = None     # (3,) box
    mesh: Optional["MeshGeom"] = None  # mesh boundary
    neg_inv_density: jnp.ndarray = None  # () = -1/density
    mat_id: jnp.ndarray = None   # () phase-function material (isotropic)
    transform: Optional[Transform] = None


@struct.dataclass
class SceneIR:
    spheres: SphereTable
    rects: RectTable
    instances: Tuple[Instance, ...]
    media: Tuple[Medium, ...]
    materials: MaterialTable
    textures: TextureTable
    background_tex: jnp.ndarray  # () int32 texture id


# ------------------------------------------------------------ intersection

_FALLBACK_WARNED: set = set()


def _resolve_mesh_backend(backend: str, mesh: MeshGeom) -> Tuple[str, bool]:
    """Resolve "auto" / "auto_diff" to (backend, interpret) for one mesh:
    the compiled Pallas kernel on a GPU, the XLA traversal on the CPU.
    "auto_diff" (the differentiable-trace request) resolves to
    "pallas_replay" — kernel FIND over the build-time tables +
    differentiable replay — instead of the forward-only "pallas". Meshes
    with more clusters than the kernel holds (kernels.kernel_fits) take
    the XLA traversal, with a warning. HRT_NO_PALLAS=1 forces XLA;
    HRT_PALLAS_INTERPRET=1 runs the kernel in interpreter mode (CPU
    parity tests)."""
    import logging

    from ..kernels import kernel_fits
    if backend not in ("auto", "auto_diff"):
        return backend, False
    usable, interpret = _pallas_platform()
    if not usable:
        return "xla", False
    k = mesh.cluster_id.shape[0]
    if not kernel_fits(k):
        if k not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(k)
            logging.getLogger(__name__).warning(
                "mesh with %d clusters exceeds the kernel's entry-row "
                "budget; falling back to the XLA traversal (slower).", k)
        return "xla", False
    return ("pallas_replay" if backend == "auto_diff" else "pallas",
            interpret)


def _pallas_platform() -> Tuple[bool, bool]:
    """(usable, interpret) for the Pallas mesh kernel on the current
    backend: compiled on "gpu", not at all on "cpu" (the XLA traversal
    runs there), interpreted only when a test sets HRT_PALLAS_INTERPRET.
    Any other platform is an error — there is no kernel for it and no
    silent fallback."""
    import os
    if os.environ.get("HRT_NO_PALLAS"):
        return False, False
    if os.environ.get("HRT_PALLAS_INTERPRET"):
        return True, True
    platform = jax.devices()[0].platform
    if platform == "gpu":
        return True, False
    if platform == "cpu":
        return False, False
    raise RuntimeError(f"no mesh find for platform {platform!r}: "
                       "expected 'gpu' or 'cpu'")


def refresh_kernel_tables(m: MeshGeom) -> MeshGeom:
    """Recompute the Pallas find tables (tri_soa / bounds8 / cluster
    bounds) from the mesh's LIVE vertex array, on device, inside jit.

    The build-time tables snapshot the geometry, which is exactly right
    for static meshes (the host pack avoids per-trace device gathers,
    see MeshGeom.tri_soa) — but a VERTEX fit moves `verts` every
    optimizer step, and a stale find would keep reporting hits where the
    triangles used to be. Refreshing costs one (K,L,3)-row gather + SoA
    transpose per fit STEP, which unpins vertex fits from the lockstep
    XLA find.

    The tables feed only the stop-gradiented FIND; everything
    differentiable is replayed from the live verts afterwards
    (ops/intersect.py:intersect_triangles_bvh, backend pallas_replay),
    so stop_gradient here is correct, not an approximation."""
    if not m.use_bvh or m.tri_soa is None:
        return m
    from ..kernels import mesh_traverse as kmod
    v = jax.lax.stop_gradient(m.verts)
    safe = jnp.maximum(m.cluster_id, 0)
    corner = m.indices[safe]                          # (K,L,3)
    pad = (m.cluster_id < 0)[..., None]               # (K,L,1)
    tri_verts = jnp.where(pad[..., None], 0.0, v[corner])  # degenerate pad
    # cluster bounds like the host build (scene/bvh.py): pad masked,
    # boxes inflated +-1e-4 (aabb padding, triangle.cpp:42-55 semantics)
    tmin = jnp.where(pad, BIG, tri_verts.min(axis=2)).min(axis=1) - 1e-4
    tmax = jnp.where(pad, -BIG, tri_verts.max(axis=2)).max(axis=1) + 1e-4
    soa = kmod.pack_mesh_soa(tri_verts, m.normals[corner], m.uvs[corner])
    return m.replace(tri_soa=soa, bounds8=kmod.pack_bounds(tmin, tmax),
                     cluster_bmin=tmin, cluster_bmax=tmax)


def has_wavefront_sort_key(scene: "SceneIR") -> bool:
    """Static (trace-free) predicate: does wavefront_sort_key return a
    key for this scene? True iff some mesh instance resolves to the
    Pallas traversal (same walk as wavefront_sort_key)."""
    for inst in scene.instances:
        if (inst.kind == "mesh" and inst.mesh.use_bvh
                and inst.mesh.bounds8 is not None):
            backend, _ = _resolve_mesh_backend("auto", inst.mesh)
            if backend == "pallas":
                return True
    return False


def wavefront_sort_key(scene: "SceneIR", rays: Rays, ray_valid=None):
    """Coherence sort key for a whole wavefront, or None when the scene
    has no Pallas-traversed mesh (then sorting buys nothing). Keys on
    the WORLD-SPACE UNION of every kernel mesh's root box
    (ops/intersect.cheap_key_from_box): the integrator can permute its
    entire lane pool by it once per segment instead of paying the
    per-mesh sort+unsort inside intersect. Keying on one mesh's box
    would sort the other meshes' hitters into the random 'misser' tail.
    The corridor (entry|exit) key is used when any kernel mesh is fine
    enough for it (ops/intersect.use_corridor_key), as the per-mesh sort
    would."""
    boxes = []
    corridor = False
    for inst in scene.instances:
        if (inst.kind == "mesh" and inst.mesh.use_bvh
                and inst.mesh.bounds8 is not None):
            backend, _ = _resolve_mesh_backend("auto", inst.mesh)
            if backend == "pallas":
                b8 = inst.mesh.bounds8
                corridor |= isect.use_corridor_key(b8.shape[1])
                bmin = b8[:3, :].min(axis=1)
                bmax = b8[3:6, :].max(axis=1)
                if inst.transform is not None:
                    # conservative world AABB of the transformed box
                    corners = jnp.stack(
                        [jnp.where(jnp.asarray(
                            [(i >> ax) & 1 for ax in range(3)], bool),
                            bmax, bmin) for i in range(8)])
                    wc = inst.transform.point_to_world(corners)
                    bmin, bmax = wc.min(axis=0), wc.max(axis=0)
                boxes.append((bmin, bmax))
    if not boxes:
        return None
    bmin = boxes[0][0]
    bmax = boxes[0][1]
    for lo, hi in boxes[1:]:
        bmin = jnp.minimum(bmin, lo)
        bmax = jnp.maximum(bmax, hi)
    n = rays.o.shape[0]
    if ray_valid is None:
        ray_valid = jnp.ones((n,), jnp.bool_)
    return isect.cheap_key_from_box(rays.o, rays.d, ray_valid, bmin,
                                    bmax, float(BIG), corridor=corridor)


def _intersect_instance(inst: Instance, rays: Rays, t_min,
                        ray_valid=None, mesh_backend: str = "xla",
                        mesh_cohsort=None, need_uv: bool = True) -> Hits:
    r = inst.transform.ray_to_object(rays) if inst.transform else rays
    if inst.kind == "sphere":
        h = isect.intersect_spheres(r, inst.spheres.center,
                                    inst.spheres.radius, inst.spheres.mat_id,
                                    t_min, BIG)
    elif inst.kind == "rect":
        rt = inst.rects
        h = isect.intersect_rects(r, rt.axis, rt.a0, rt.a1, rt.b0, rt.b1,
                                  rt.k, rt.mat_id, t_min, BIG)
    elif inst.kind == "mesh":
        m = inst.mesh
        if m.use_bvh:
            backend, interpret = _resolve_mesh_backend(mesh_backend, m)
            if backend == "pallas" and m.tri_soa is not None:
                # static forward path: host-prebuilt kernel tables, zero
                # per-trace gathers (see MeshGeom.tri_soa)
                h = isect.intersect_triangles_bvh(
                    r, m.verts, m.normals, m.uvs, m.indices, None,
                    m.cluster_id, m.cluster_bmin, m.cluster_bmax,
                    m.mat_id, BIG, ray_valid=ray_valid, backend="pallas",
                    interpret=interpret, tri_soa=m.tri_soa,
                    bounds8=m.bounds8, cohsort=mesh_cohsort,
                    need_uv=need_uv)
            elif backend == "pallas_replay" and m.tri_soa is not None:
                # differentiable path: kernel FIND over the build-time
                # tables (static geometry), replay over the live vertex
                # array — material/texture gradients at kernel speed.
                # Vertex fits pass mesh_backend="xla" instead (the find
                # must track moving vertices).
                h = isect.intersect_triangles_bvh(
                    r, m.verts, m.normals, m.uvs, m.indices, None,
                    m.cluster_id, m.cluster_bmin, m.cluster_bmax,
                    m.mat_id, BIG, ray_valid=ray_valid,
                    backend="pallas_replay", interpret=interpret,
                    tri_soa=m.tri_soa, bounds8=m.bounds8,
                    cohsort=mesh_cohsort)
            else:
                # leaf vertices regathered from the differentiable vertex
                # array
                safe_id = jnp.maximum(m.cluster_id, 0)
                tri_verts = m.verts[m.indices[safe_id]]  # (K,L,3,3)
                # cluster bounds recomputed from the SAME vertices (cheap
                # K*L reduction): during differentiable fitting optimized
                # vertices would otherwise drift outside the build-time
                # boxes and hits would vanish discontinuously.
                # stop_gradient: culling is discrete, bounds carry no
                # derivative. Build-time bounds (m.cluster_bmin/bmax)
                # remain the host-build artifact that parity tests check.
                pad = (m.cluster_id < 0)[..., None]             # (K,L,1)
                tmin = jnp.where(pad, BIG, tri_verts.min(axis=2))
                tmax = jnp.where(pad, -BIG, tri_verts.max(axis=2))
                bmin = jax.lax.stop_gradient(tmin.min(axis=1) - 1e-4)
                bmax = jax.lax.stop_gradient(tmax.max(axis=1) + 1e-4)
                h = isect.intersect_triangles_bvh(
                    r, m.verts, m.normals, m.uvs, m.indices, tri_verts,
                    m.cluster_id, bmin, bmax, m.mat_id,
                    BIG, ray_valid=ray_valid,
                    # replay without prebuilt tables degrades to the XLA
                    # find (it needs the build-time tri_soa/bounds8)
                    backend="xla" if backend == "pallas_replay"
                    else backend,
                    interpret=interpret)
        else:
            h = isect.intersect_triangles(r, m.verts, m.normals, m.uvs,
                                          m.indices, m.mat_id, BIG)
    else:
        raise ValueError(inst.kind)
    if inst.transform is not None:
        p = inst.transform.point_to_world(h.p)
        nrm = inst.transform.normal_to_world(h.normal)
        # the wrapper chain ends with setFaceNormal against the incoming ray
        # (translate.cpp:16); net effect for positive uniform scale.
        nrm, front = set_face_normal(rays.d, nrm)
        h = h.replace(p=p, normal=nrm, front_face=front)
    return h


def _medium_span(med: Medium, r: Rays):
    """Entry/exit parameters of the boundary along the ray (world t units).
    Returns (t_enter, t_exit, valid)."""
    if med.btype == "sphere":
        oc = r.o - med.center
        a = jnp.sum(r.d * r.d, axis=-1)
        half_b = jnp.sum(oc * r.d, axis=-1)
        c = jnp.sum(oc * oc, axis=-1) - med.radius * med.radius
        disc = half_b * half_b - a * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        return (-half_b - sq) / a, (-half_b + sq) / a, disc > 0.0
    elif med.btype == "box":
        lo = hi = None
        for ax in range(3):  # per-axis: divisions on packed (R,) shapes
            inv = 1.0 / r.d[:, ax]
            t0 = (med.bmin[ax] - r.o[:, ax]) * inv
            t1 = (med.bmax[ax] - r.o[:, ax]) * inv
            lo_ax = jnp.minimum(t0, t1)
            hi_ax = jnp.maximum(t0, t1)
            lo = lo_ax if lo is None else jnp.maximum(lo, lo_ax)
            hi = hi_ax if hi is None else jnp.minimum(hi, hi_ax)
        return lo, hi, hi > lo
    elif med.btype == "mesh":
        # any-Hittable boundary (constantMedium.h:10-14): first hit =
        # entry; exit = first hit of a re-cast from just past it. A ray
        # starting INSIDE a closed boundary sees its first hit as the
        # exit (span [0, t1]); non-convex boundaries contribute their
        # first span only (documented approximation — the reference's
        # own mesh path would return the same first two crossings).
        m = med.mesh
        t1, h1 = _mesh_first_t(m, r, BIG)
        eps = 1e-4  # constantMedium.cpp:11's re-cast offset
        o2 = r.o + r.d * (t1 + eps)[:, None]
        t2r, h2 = _mesh_first_t(m, Rays(o=o2, d=r.d), BIG)
        t2 = t1 + eps + t2r
        t_enter = jnp.where(h2, t1, 0.0)
        t_exit = jnp.where(h2, t2, t1)
        return t_enter, t_exit, h1
    raise ValueError(med.btype)


def _mesh_first_t(m: MeshGeom, r: Rays, t_max):
    """Nearest-hit parameter against a mesh (t only, no attributes)."""
    if m.use_bvh:
        safe_id = jnp.maximum(m.cluster_id, 0)
        tri_verts = m.verts[m.indices[safe_id]]
        pad = (m.cluster_id < 0)[..., None]
        tmin = jnp.where(pad, BIG, tri_verts.min(axis=2))
        tmax_ = jnp.where(pad, -BIG, tri_verts.max(axis=2))
        bmin = jax.lax.stop_gradient(tmin.min(axis=1) - 1e-4)
        bmax = jax.lax.stop_gradient(tmax_.max(axis=1) + 1e-4)
        t, _, hit = isect.intersect_mesh_clustered(
            r, tri_verts, m.cluster_id, bmin, bmax, t_max)
        return t, hit
    h = isect.intersect_triangles(r, m.verts, m.normals, m.uvs, m.indices,
                                  m.mat_id, t_max)
    return h.t, h.hit


def _intersect_medium(med: Medium, rays: Rays, key, bounce, med_index: int,
                      t_min, t_max, span=None) -> Hits:
    """ConstantMedium::hit vectorized (constantMedium.cpp:4-38):
    two boundary hits -> clamp to [t_min, t_max] -> exponential free-flight
    -> scatter point if within the span."""
    r = med.transform.ray_to_object(rays) if med.transform else rays
    t1, t2, valid = _medium_span(med, r)
    # reference: second hit searched from t1+1e-4 (constantMedium.cpp:11)
    valid &= t2 > t1 + 1e-4
    t1 = jnp.maximum(t1, t_min)   # clamp (constantMedium.cpp:14-21)
    t2 = jnp.minimum(t2, t_max)
    valid &= t1 < t2
    ray_len = mathx.length(rays.d)  # world-units parameterization
    dist_inside = (t2 - t1) * ray_len
    u = rng.uniform(rng.stream(key, rng.MEDIUM_FLIGHT,
                               bounce * 131 + med_index), t1.shape, span)
    hit_dist = med.neg_inv_density * jnp.log(jnp.maximum(u, 1e-37))
    valid &= hit_dist <= dist_inside
    t = t1 + hit_dist / ray_len
    n = rays.o.shape[0]
    p = rays.at(jnp.where(valid, t, 1.0))
    return Hits(
        hit=valid,
        t=jnp.where(valid, t, BIG),
        p=p,
        normal=jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n, 3)),
        front_face=jnp.ones((n,), jnp.bool_),
        uv=jnp.zeros((n, 2), jnp.float32),
        mat_id=jnp.where(valid, med.mat_id, -1),
    )


def intersect_scene(scene: SceneIR, rays: Rays, key, bounce,
                    t_min=mathx.T_MIN, ray_valid=None,
                    mesh_backend: str = "xla", mesh_cohsort=None,
                    rng_span=None) -> Hits:
    """Closest hit against the whole scene (vectorized HittableList::hit).

    Solids are evaluated independently and min-merged (equivalent to the
    reference's sequential shrinking-t_max scan); media are evaluated last
    with t_max = closest solid t, matching the reference when media appear
    after their occluders in the object list (documented divergence: the
    reference is YAML-order-dependent here).

    ray_valid: optional (N,) bool — dead wavefront lanes. Mesh BVH blocks
    skip clusters only dead lanes would open; dead lanes report no mesh hit
    (callers mask everything by their own active mask anyway).
    """
    n = rays.o.shape[0]
    best = Hits.none(n)
    if not scene.spheres.empty:
        sp = scene.spheres
        best = closer(best, isect.intersect_spheres(
            rays, sp.center, sp.radius, sp.mat_id, t_min, BIG))
    if not scene.rects.empty:
        rt = scene.rects
        best = closer(best, isect.intersect_rects(
            rays, rt.axis, rt.a0, rt.a1, rt.b0, rt.b1, rt.k, rt.mat_id,
            t_min, BIG))
    # STATIC: when no material in the scene samples a texture, hit UVs are
    # never consumed — the traversal kernel skips interpolating them
    need_uv = len(scene.materials.textured) > 0
    for inst in scene.instances:
        best = closer(best, _intersect_instance(inst, rays, t_min,
                                                ray_valid=ray_valid,
                                                mesh_backend=mesh_backend,
                                                mesh_cohsort=mesh_cohsort,
                                                need_uv=need_uv))
    for i, med in enumerate(scene.media):
        best = closer(best, _intersect_medium(med, rays, key, bounce, i,
                                              t_min, best.t, rng_span))
    return best
