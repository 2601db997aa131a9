"""Intersection kernels vs scalar numpy oracles (SURVEY.md §4: sphere
quadratic sphere.cpp:20-49, watertight tri triangle.cpp:57-131, slab
aabb.h:26-39, rects aarect.h)."""
import jax.numpy as jnp
import numpy as np

from hobbyraytracer_tpu.core.mathx import BIG
from hobbyraytracer_tpu.core.types import Rays
from hobbyraytracer_tpu.ops import intersect as isect


def rays(o, d):
    return Rays(o=jnp.asarray(o, jnp.float32), d=jnp.asarray(d, jnp.float32))


# ------------------------------------------------------------------ sphere

def test_sphere_hit_front_and_inside():
    r = rays([[0, 0, 0], [0, 0, 0]], [[0, 0, -1], [0, 0, -1]])
    center = jnp.asarray([[0, 0, -3], [0, 0, 0.0]], jnp.float32)
    radius = jnp.asarray([1.0, 0.5], jnp.float32)
    t = isect.sphere_t(r, center, radius, 1e-3, BIG)
    # ray 0 vs sphere 0: hits at t=2 (front face)
    np.testing.assert_allclose(t[0, 0], 2.0, rtol=1e-5)
    # ray 0 vs sphere 1 (origin inside): far root t=0.5
    np.testing.assert_allclose(t[0, 1], 0.5, rtol=1e-5)


def test_sphere_window_rejects():
    r = rays([[0, 0, 0]], [[0, 0, -1]])
    center = jnp.asarray([[0, 0, -3]], jnp.float32)
    radius = jnp.asarray([1.0], jnp.float32)
    # both roots (2, 4) outside window
    t = isect.sphere_t(r, center, radius, 5.0, BIG)
    assert float(t[0, 0]) >= 1e29
    t = isect.sphere_t(r, center, radius, 1e-3, 1.0)
    assert float(t[0, 0]) >= 1e29
    # window between roots: picks far root
    t = isect.sphere_t(r, center, radius, 3.0, BIG)
    np.testing.assert_allclose(t[0, 0], 4.0, rtol=1e-5)


def test_sphere_non_unit_direction():
    # t is in units of |d| (reference uses a = |d|^2)
    r = rays([[0, 0, 0]], [[0, 0, -2]])
    t = isect.sphere_t(r, jnp.asarray([[0, 0, -3.0]]), jnp.asarray([1.0]),
                       1e-3, BIG)
    np.testing.assert_allclose(t[0, 0], 1.0, rtol=1e-5)


def test_sphere_uv_reference_points():
    # sphere.cpp:4-18 documented examples
    cases = [([1, 0, 0], (0.5, 0.5)), ([-1, 0, 0], (0.0, 0.5)),
             ([0, 1, 0], (0.5, 1.0)), ([0, -1, 0], (0.5, 0.0)),
             ([0, 0, 1], (0.25, 0.5)), ([0, 0, -1], (0.75, 0.5))]
    for n, (eu, ev) in cases:
        uv = isect.sphere_uv(jnp.asarray([n], jnp.float32))
        np.testing.assert_allclose(uv[0], [eu, ev], atol=1e-6)


def test_intersect_spheres_closest_and_attribs():
    r = rays([[0, 0, 5]], [[0, 0, -1]])
    center = jnp.asarray([[0, 0, 0], [0, 0, 2.0]], jnp.float32)
    radius = jnp.asarray([1.0, 0.5], jnp.float32)
    mid = jnp.asarray([7, 8], jnp.int32)
    h = isect.intersect_spheres(r, center, radius, mid, 1e-3, BIG)
    assert bool(h.hit[0])
    np.testing.assert_allclose(h.t[0], 2.5, rtol=1e-5)  # near sphere first
    assert int(h.mat_id[0]) == 8
    np.testing.assert_allclose(h.p[0], [0, 0, 2.5], atol=1e-5)
    np.testing.assert_allclose(h.normal[0], [0, 0, 1], atol=1e-5)
    assert bool(h.front_face[0])


# -------------------------------------------------------------------- rect

def test_rect_all_axes():
    # yz at x=2, xz at y=2, xy at z=2
    axis = jnp.asarray([0, 1, 2], jnp.int32)
    a0 = jnp.asarray([-1.0, -1.0, -1.0])
    a1 = jnp.asarray([1.0, 1.0, 1.0])
    b0 = jnp.asarray([-1.0, -1.0, -1.0])
    b1 = jnp.asarray([1.0, 1.0, 1.0])
    k = jnp.asarray([2.0, 2.0, 2.0])
    r = rays([[0, 0.5, 0.25]] * 3,
             [[1, 0, 0], [0, 1, 0], [0, 0, 1]])
    t = isect.rect_t(r, axis, a0, a1, b0, b1, k, 1e-3, BIG)
    np.testing.assert_allclose(t[0, 0], 2.0, rtol=1e-5)     # +x ray hits yz
    np.testing.assert_allclose(t[1, 1], 1.5, rtol=1e-5)     # +y ray hits xz
    np.testing.assert_allclose(t[2, 2], 1.75, rtol=1e-5)    # +z ray hits xy
    assert float(t[0, 1]) >= 1e29 and float(t[0, 2]) >= 1e29


def test_rect_uv_and_normal():
    axis = jnp.asarray([1], jnp.int32)  # xz rect (y normal)
    h = isect.intersect_rects(
        rays([[0.5, 5, -0.5]], [[0, -1, 0]]), axis,
        jnp.asarray([-1.0]), jnp.asarray([1.0]),
        jnp.asarray([-1.0]), jnp.asarray([1.0]), jnp.asarray([0.0]),
        jnp.asarray([3], jnp.int32), 1e-3, BIG)
    assert bool(h.hit[0])
    np.testing.assert_allclose(h.t[0], 5.0, rtol=1e-5)
    # u from x: (0.5-(-1))/2 = 0.75 ; v from z: (-0.5+1)/2 = 0.25
    np.testing.assert_allclose(h.uv[0], [0.75, 0.25], atol=1e-5)
    np.testing.assert_allclose(h.normal[0], [0, 1, 0], atol=1e-6)
    assert bool(h.front_face[0])


# ---------------------------------------------------------------- triangle

def _moller_trumbore(o, d, v0, v1, v2):
    """Independent oracle: classic MT returning (t, u, v) or None."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = np.cross(d, e2)
    det = np.dot(e1, p)
    if abs(det) < 1e-12:
        return None
    inv = 1.0 / det
    s = o - v0
    u = np.dot(s, p) * inv
    if u < 0 or u > 1:
        return None
    q = np.cross(s, e1)
    v = np.dot(d, q) * inv
    if v < 0 or u + v > 1:
        return None
    t = np.dot(e2, q) * inv
    return t, u, v


def test_triangle_vs_mt_oracle_random():
    rs = np.random.RandomState(3)
    n_match = 0
    for _ in range(200):
        v0, v1, v2 = rs.randn(3, 3).astype(np.float32)
        o = rs.randn(3).astype(np.float32) * 2
        target = (v0 + v1 + v2) / 3 + rs.randn(3) * 0.3
        d = (target - o).astype(np.float32)
        r = rays([o], [d])
        t = isect.triangle_t(r, jnp.asarray([v0]), jnp.asarray([v1]),
                             jnp.asarray([v2]), BIG)
        oracle = _moller_trumbore(o, d, v0.astype(np.float64),
                                  v1.astype(np.float64),
                                  v2.astype(np.float64))
        ours = float(t[0, 0])
        if oracle is not None and oracle[0] > 0:
            assert ours < 1e29, (o, d, v0, v1, v2)
            np.testing.assert_allclose(ours, oracle[0], rtol=1e-3)
            n_match += 1
        elif oracle is None or oracle[0] < -1e-4:
            # miss or behind: ours must reject (edge grazers may differ)
            assert ours >= 1e29 or abs(ours) < 1e-3
    assert n_match > 50  # the sampling actually exercised hits


def test_triangle_backface_still_hits():
    # watertight version hits both orientations (det<0 branch)
    v0 = np.array([0, 0, -2], np.float32)
    v1 = np.array([1, 0, -2], np.float32)
    v2 = np.array([0, 1, -2], np.float32)
    for wind in [(v0, v1, v2), (v0, v2, v1)]:
        t = isect.triangle_t(rays([[0.2, 0.2, 0]], [[0, 0, -1]]),
                             jnp.asarray([wind[0]]), jnp.asarray([wind[1]]),
                             jnp.asarray([wind[2]]), BIG)
        np.testing.assert_allclose(float(t[0, 0]), 2.0, rtol=1e-5)


def test_triangle_attribs_interpolation():
    verts = jnp.asarray([[0, 0, -1], [2, 0, -1], [0, 2, -1]], jnp.float32)
    normals = jnp.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1]], jnp.float32)
    uvs = jnp.asarray([[0, 0], [1, 0], [0, 1]], jnp.float32)
    idx = jnp.asarray([[0, 1, 2]], jnp.int32)
    r = rays([[0.5, 0.5, 0]], [[0, 0, -1]])
    h = isect.intersect_triangles(r, verts, normals, uvs, idx,
                                  jnp.asarray(5, jnp.int32), BIG)
    assert bool(h.hit[0])
    np.testing.assert_allclose(h.t[0], 1.0, rtol=1e-5)
    # barycentrics at (0.5, 0.5): b1 = 0.25, b2 = 0.25, b0 = 0.5
    np.testing.assert_allclose(h.normal[0], [0.5, 0.25, 0.25], atol=1e-5)
    np.testing.assert_allclose(h.uv[0], [0.25, 0.25], atol=1e-5)
    assert int(h.mat_id[0]) == 5


def test_chunked_scan_beyond_one_chunk():
    # >chunk primitives: padding + index bookkeeping must stay correct
    rs = np.random.RandomState(0)
    n = 300  # > 2 chunks of 128
    centers = rs.randn(n, 3).astype(np.float32) * 10
    centers[:, 2] -= 30
    radii = np.full((n,), 0.7, np.float32)
    # aim at sphere 257 dead center
    target = centers[257]
    r = rays([[0, 0, 10]], [target - np.array([0, 0, 10], np.float32)])
    # make sure no other sphere is closer along this ray: shrink others
    radii_small = radii.copy()
    radii_small[:257] = 0.01
    radii_small[258:] = 0.01
    h = isect.intersect_spheres(r, jnp.asarray(centers),
                                jnp.asarray(radii_small),
                                jnp.arange(n, dtype=jnp.int32), 1e-3, BIG)
    assert bool(h.hit[0])
    assert int(h.mat_id[0]) == 257


# -------------------------------------------------------------------- slab

def test_aabb_slab():
    o = jnp.asarray([[0, 0, 0]], jnp.float32)
    inv_d = 1.0 / jnp.asarray([[1, 1, 1]], jnp.float32)
    assert bool(isect.aabb_hit(o, inv_d, jnp.asarray([1.0, 1, 1]),
                               jnp.asarray([2.0, 2, 2]), 1e-3, BIG)[0])
    assert not bool(isect.aabb_hit(o, inv_d, jnp.asarray([1.0, 1, 5]),
                                   jnp.asarray([2.0, 2, 6]), 1e-3, BIG)[0])
    # behind the origin
    assert not bool(isect.aabb_hit(o, inv_d, jnp.asarray([-3.0, -3, -3]),
                                   jnp.asarray([-2.0, -2, -2]), 1e-3,
                                   BIG)[0])


# ------------------------------------------------- cluster BVH parity

def _random_mesh(seed, n_tris=400, spread=3.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    v0 = base
    v1 = base + rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    v2 = base + rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    verts = np.concatenate([v0, v1, v2], axis=0).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T.copy()
    return verts, idx


def _random_rays(seed, n=512, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return rays(o, d)


def _bvh_tables(verts, idx, leaf_size):
    from hobbyraytracer_tpu.scene.bvh import build_clusters
    c = build_clusters(verts, idx, leaf_size=leaf_size)
    return (jnp.asarray(c["tri_verts"]), jnp.asarray(c["tri_id"]),
            jnp.asarray(c["bmin"]), jnp.asarray(c["bmax"]))


def test_bvh_matches_brute_force_random():
    """The exact traversal must agree with the dense scan on random rays —
    including rays whose blocks collectively enter many clusters (the
    round-1 fixed-C heuristic silently tunneled here)."""
    verts, idx = _random_mesh(0)
    r = _random_rays(1)
    tv, tid, bmin, bmax = _bvh_tables(verts, idx, leaf_size=16)
    t_bvh, gid, hit = isect.intersect_mesh_clustered(
        r, tv, tid, bmin, bmax, BIG)
    tri_v0 = jnp.asarray(verts)[jnp.asarray(idx)[:, 0]]
    tri_v1 = jnp.asarray(verts)[jnp.asarray(idx)[:, 1]]
    tri_v2 = jnp.asarray(verts)[jnp.asarray(idx)[:, 2]]
    # dense oracle: every (ray, tri) MT test, windowed 0 < t <= BIG like the
    # clustered path
    t_all = []
    for s in range(0, idx.shape[0], 128):
        e = min(s + 128, idx.shape[0])
        tt = isect.triangle_t(r, tri_v0[s:e], tri_v1[s:e], tri_v2[s:e], BIG)
        t_all.append(np.asarray(tt))
    t_all = np.concatenate(t_all, axis=1)
    t_ref = t_all.min(axis=1)
    hit_ref = t_ref < BIG
    np.testing.assert_array_equal(np.asarray(hit), hit_ref)
    # watertight (triangle_t) and plain MT (clustered) differ in rounding;
    # parity is near-exact t agreement on hits
    np.testing.assert_allclose(np.asarray(t_bvh)[hit_ref], t_ref[hit_ref],
                               rtol=2e-4, atol=2e-4)


def test_bvh_long_diagonal_rays_no_tunneling():
    """Adversarial: long diagonal rays crossing MANY clusters of a stretched
    mesh (K >> the old visit cap). Every hit the brute-force path finds must
    be found by the BVH path."""
    rng = np.random.default_rng(7)
    n_tris = 600
    # mesh stretched along the diagonal so a diagonal ray enters most leaves
    t_param = np.linspace(0, 1, n_tris, dtype=np.float32)
    base = np.stack([t_param * 20 - 10] * 3, axis=1)
    base += rng.normal(0, 0.2, (n_tris, 3)).astype(np.float32)
    v1 = base + rng.normal(0, 0.15, (n_tris, 3)).astype(np.float32)
    v2 = base + rng.normal(0, 0.15, (n_tris, 3)).astype(np.float32)
    verts = np.concatenate([base, v1, v2], 0).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T.copy()
    tv, tid, bmin, bmax = _bvh_tables(verts, idx, leaf_size=8)
    assert tid.shape[0] > 32  # many clusters
    n = 256
    o = np.full((n, 3), -12.0, np.float32)
    o += rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    d = np.tile(np.asarray([[1.0, 1.0, 1.0]], np.float32), (n, 1))
    d += rng.normal(0, 0.02, (n, 3)).astype(np.float32)
    r = rays(o, d)
    t_bvh, gid, hit = isect.intersect_mesh_clustered(
        r, tv, tid, bmin, bmax, BIG)
    h_ref = isect.intersect_triangles(
        r, jnp.asarray(verts), jnp.zeros_like(jnp.asarray(verts)),
        jnp.zeros((verts.shape[0], 2), jnp.float32), jnp.asarray(idx),
        jnp.int32(0), BIG)
    np.testing.assert_array_equal(np.asarray(hit), np.asarray(h_ref.hit))
    m = np.asarray(h_ref.hit)
    np.testing.assert_allclose(np.asarray(t_bvh)[m],
                               np.asarray(h_ref.t)[m], rtol=2e-4, atol=2e-4)


def test_bvh_ray_valid_mask_excluded():
    """Invalid lanes must not open clusters for their block (and must report
    no hit themselves)."""
    verts, idx = _random_mesh(3, n_tris=100)
    r = _random_rays(4, n=128)
    tv, tid, bmin, bmax = _bvh_tables(verts, idx, leaf_size=16)
    valid = np.zeros((128,), bool)
    valid[::2] = True
    t1, g1, h1 = isect.intersect_mesh_clustered(
        r, tv, tid, bmin, bmax, BIG, ray_valid=jnp.asarray(valid))
    t0, g0, h0 = isect.intersect_mesh_clustered(r, tv, tid, bmin, bmax, BIG)
    h1 = np.asarray(h1)
    assert not h1[~valid].any()
    # valid lanes get exactly the unmasked result
    np.testing.assert_array_equal(h1[valid], np.asarray(h0)[valid])
    np.testing.assert_allclose(np.asarray(t1)[valid & h1],
                               np.asarray(t0)[valid & h1], rtol=1e-6)


def test_native_cluster_build_matches_numpy():
    from hobbyraytracer_tpu.native import build_clusters as native_build
    from hobbyraytracer_tpu.scene import bvh as bvh_mod
    verts, idx = _random_mesh(5, n_tris=300)
    nat = native_build(verts, idx, 32)
    if nat is None:
        import pytest
        pytest.skip("native lib unavailable")
    # numpy path, forced
    import os
    tvn = verts[idx]
    leaves = bvh_mod.median_split_order(tvn.mean(axis=1), 32)
    # invariants (exact leaf assignment may differ): full coverage, bounds
    ids = nat["tri_id"]
    got = np.sort(ids[ids >= 0])
    np.testing.assert_array_equal(got, np.arange(idx.shape[0]))
    for k in range(ids.shape[0]):
        sel = ids[k][ids[k] >= 0]
        lo = tvn[sel].reshape(-1, 3).min(axis=0)
        hi = tvn[sel].reshape(-1, 3).max(axis=0)
        assert (nat["bmin"][k] <= lo + 1e-5).all()
        assert (nat["bmax"][k] >= hi - 1e-5).all()
        # leaf verts match the indexed triangles
        nsel = (ids[k] >= 0).sum()
        np.testing.assert_allclose(nat["tri_verts"][k][:nsel], tvn[sel],
                                   rtol=1e-6)


def test_native_obj_parse_matches_python():
    import os
    import pytest
    from hobbyraytracer_tpu.native import parse_obj as native_parse
    from hobbyraytracer_tpu.scene import objloader
    path = os.path.join(os.path.dirname(__file__), "..", "assets",
                        "teapot.obj")
    if not os.path.exists(path):
        from hobbyraytracer_tpu.scene.fixtures import ensure_assets
        ensure_assets()
    nat = native_parse(path)
    if nat is None:
        pytest.skip("native lib unavailable")
    py = objloader.parse_obj_python(path)
    assert nat["indices"].shape == py["indices"].shape
    assert nat["verts"].shape == py["verts"].shape
    # same triangles in the same order, same corner data
    np.testing.assert_allclose(nat["verts"][nat["indices"]],
                               py["verts"][py["indices"]], rtol=1e-6)
    np.testing.assert_allclose(nat["normals"][nat["indices"]],
                               py["normals"][py["indices"]], rtol=1e-6)
    np.testing.assert_allclose(nat["uvs"][nat["indices"]],
                               py["uvs"][py["indices"]], rtol=1e-6)


def test_vmem_fallback_triggers_and_renders_correctly(caplog, monkeypatch):
    """A mesh whose cluster count exceeds the kernel's register-held entry
    row (kernels.kernel_fits) must fall back to the XLA traversal (with a
    warning) where the kernel would otherwise run, and still intersect
    exactly. Clusters beyond the real geometry are -1 padding, so the
    table is huge while the actual work stays test-sized."""
    import logging

    from hobbyraytracer_tpu.kernels import kernel_fits
    from hobbyraytracer_tpu.scene import ir as scene_ir

    monkeypatch.setenv("HRT_PALLAS_INTERPRET", "1")   # kernel-capable

    verts, idx = _random_mesh(11, n_tris=100)
    tv, tid, bmin, bmax = _bvh_tables(verts, idx, leaf_size=16)
    k, leaf = tid.shape
    k_big = k
    while kernel_fits(k_big):
        k_big *= 2
    pad_k = k_big - k
    tid_big = jnp.concatenate(
        [tid, jnp.full((pad_k, leaf), -1, jnp.int32)], axis=0)
    # padding clusters: point boxes far away -> slab test never enters
    far = jnp.full((pad_k, 3), 1e30, jnp.float32)
    mesh = scene_ir.MeshGeom(
        verts=jnp.asarray(verts), normals=jnp.zeros_like(jnp.asarray(verts)),
        uvs=jnp.zeros((verts.shape[0], 2), jnp.float32),
        indices=jnp.asarray(idx), mat_id=jnp.int32(0),
        cluster_id=tid_big,
        cluster_bmin=jnp.concatenate([bmin, far]),
        cluster_bmax=jnp.concatenate([bmax, far]),
        use_bvh=True)
    scene_ir._FALLBACK_WARNED.clear()
    with caplog.at_level(logging.WARNING,
                         logger="hobbyraytracer_tpu.scene.ir"):
        backend, interp = scene_ir._resolve_mesh_backend("auto", mesh)
    assert backend == "xla"
    assert any("entry-row budget" in rec.message
               for rec in caplog.records)
    # and the auto path still intersects exactly like the explicit XLA path
    inst = scene_ir.Instance(kind="mesh", mesh=mesh)
    r = _random_rays(12, n=128)
    h_auto = scene_ir._intersect_instance(inst, r, 1e-3,
                                          mesh_backend="auto")
    h_xla = scene_ir._intersect_instance(inst, r, 1e-3, mesh_backend="xla")
    np.testing.assert_array_equal(np.asarray(h_auto.hit),
                                  np.asarray(h_xla.hit))
    np.testing.assert_allclose(np.asarray(h_auto.t), np.asarray(h_xla.t),
                               rtol=1e-6)
