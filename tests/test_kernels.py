"""Pallas kernel parity: the fused traversal/intersection kernel
(kernels/mesh_traverse.py) must agree with the XLA exact traversal
(ops/intersect.py:intersect_mesh_clustered) — interpreter mode on CPU —
plus the wrapper's padding, shape checks and choice of backend."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from hobbyraytracer_tpu.core.mathx import BIG
from hobbyraytracer_tpu.core.types import Rays
from hobbyraytracer_tpu.ops import intersect as isect


def _random_mesh(seed, n_tris=500, spread=3.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    v1 = base + rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    v2 = base + rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    verts = np.concatenate([base, v1, v2], axis=0).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T.copy()
    return verts, idx


def _tables(verts, idx, leaf_size=128):
    from hobbyraytracer_tpu.scene.bvh import build_clusters
    c = build_clusters(verts, idx, leaf_size=leaf_size)
    return (jnp.asarray(c["tri_verts"]), jnp.asarray(c["tri_id"]),
            jnp.asarray(c["bmin"]), jnp.asarray(c["bmax"]))


def _rays(seed, n, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    return Rays(o=jnp.asarray(o), d=jnp.asarray(d))


def test_pallas_traversal_matches_xla():
    verts, idx = _random_mesh(0)
    tv, tid, bmin, bmax = _tables(verts, idx)
    r = _rays(1, 600)  # not a multiple of BLOCK: exercises padding
    t_x, g_x, h_x = isect.intersect_mesh_clustered(r, tv, tid, bmin, bmax,
                                                   BIG)
    t_p, g_p, h_p, _, _ = isect.intersect_mesh_clustered_pallas(
        r, tv, tid, bmin, bmax, BIG, interpret=True)
    np.testing.assert_array_equal(np.asarray(h_p), np.asarray(h_x))
    m = np.asarray(h_x)
    np.testing.assert_allclose(np.asarray(t_p)[m], np.asarray(t_x)[m],
                               rtol=1e-6, atol=1e-6)
    # identical winning triangle except exact t-ties
    ties = np.asarray(g_p) != np.asarray(g_x)
    assert (ties & m).mean() < 0.01


def test_pallas_traversal_ray_valid():
    verts, idx = _random_mesh(2, n_tris=200)
    tv, tid, bmin, bmax = _tables(verts, idx, leaf_size=64)
    r = _rays(3, 512)
    valid = np.zeros((512,), bool)
    valid[::3] = True
    t_p, g_p, h_p, _, _ = isect.intersect_mesh_clustered_pallas(
        r, tv, tid, bmin, bmax, BIG, ray_valid=jnp.asarray(valid),
        interpret=True)
    t_x, g_x, h_x = isect.intersect_mesh_clustered(
        r, tv, tid, bmin, bmax, BIG, ray_valid=jnp.asarray(valid))
    h_p = np.asarray(h_p)
    assert not h_p[~valid].any()
    np.testing.assert_array_equal(h_p, np.asarray(h_x))
    m = h_p
    np.testing.assert_allclose(np.asarray(t_p)[m], np.asarray(t_x)[m],
                               rtol=1e-6, atol=1e-6)


def test_pallas_full_scene_render_matches_xla():
    """End-to-end: one wavefront segment with mesh_backend pallas-interpret
    vs xla on the teapot scene."""
    import os
    import jax
    from hobbyraytracer_tpu.scene import build_scene, load_scene_desc
    from hobbyraytracer_tpu.scene.fixtures import ensure_assets
    from hobbyraytracer_tpu.scene import ir as scene_ir
    from hobbyraytracer_tpu.integrator.path import pixel_grid
    from hobbyraytracer_tpu.ops.camera import get_rays

    ensure_assets()
    here = os.path.join(os.path.dirname(__file__), "..", "scenes")
    job = build_scene(load_scene_desc(os.path.join(here,
                                                   "teapot_scene.yaml")))
    key = jax.random.PRNGKey(0)
    x, y = pixel_grid(64, 64)
    u = (x + 0.5) / 63.0
    v = (y + 0.5) / 63.0
    rays = get_rays(job.camera, u, v, key=key)
    h_x = scene_ir.intersect_scene(job.scene, rays, key, 0,
                                   mesh_backend="xla")
    os.environ["HRT_PALLAS_INTERPRET"] = "1"
    try:
        h_p = scene_ir.intersect_scene(job.scene, rays, key, 0,
                                       mesh_backend="auto")
    finally:
        del os.environ["HRT_PALLAS_INTERPRET"]
    np.testing.assert_array_equal(np.asarray(h_p.hit), np.asarray(h_x.hit))
    m = np.asarray(h_x.hit)
    np.testing.assert_allclose(np.asarray(h_p.t)[m], np.asarray(h_x.t)[m],
                               rtol=2e-4, atol=2e-4)
    same_mat = np.asarray(h_p.mat_id) == np.asarray(h_x.mat_id)
    assert same_mat.mean() > 0.99
    # in-kernel attribute interpolation (MT barycentrics) vs the XLA
    # watertight interpolation: same up to fp + rare tie-breaking.
    # The mesh shares its material with the walls (scene file), so mesh
    # hits are identified by intersecting the mesh instance alone and
    # asking where it won the closest-hit race.
    h_mesh = scene_ir._intersect_instance(job.scene.instances[0], rays,
                                          1e-3, mesh_backend="xla")
    mesh_hit = (m & np.asarray(h_mesh.hit)
                & (np.abs(np.asarray(h_mesh.t) - np.asarray(h_x.t)) < 1e-3))
    if mesh_hit.any():
        n_p = np.asarray(h_p.normal)[mesh_hit]
        n_x = np.asarray(h_x.normal)[mesh_hit]
        cos = (n_p * n_x).sum(1) / np.maximum(
            np.linalg.norm(n_p, axis=1) * np.linalg.norm(n_x, axis=1),
            1e-12)
        assert (cos > 0.999).mean() > 0.98, (cos > 0.999).mean()
        uv_p = np.asarray(h_p.uv)[mesh_hit]
        uv_x = np.asarray(h_x.uv)[mesh_hit]
        if job.scene.materials.textured:
            assert (np.abs(uv_p - uv_x) < 2e-3).all(axis=1).mean() > 0.98
        else:
            # no textured material in the scene: the kernel statically
            # skips UV interpolation and reports zeros (never consumed)
            assert (uv_p == 0.0).all()
            # exercise the interpolating variant directly for parity
            from hobbyraytracer_tpu.ops import intersect as isect
            mesh = job.scene.instances[0].mesh
            tf = job.scene.instances[0].transform
            r_obj = tf.ray_to_object(rays) if tf is not None else rays
            t2, g2, hit2, n2, uv2 = isect.intersect_mesh_clustered_pallas(
                r_obj, None, mesh.cluster_id, mesh.cluster_bmin,
                mesh.cluster_bmax, float(1e30), interpret=True,
                tri_soa=mesh.tri_soa, bounds8=mesh.bounds8, need_uv=True)
            uv2 = np.asarray(uv2)[mesh_hit]
            assert (np.abs(uv2 - uv_x) < 2e-3).all(axis=1).mean() > 0.98


def _traverse(r, tv, tid, bmin, bmax, block, interpret=True):
    """(t, gid, hit) straight from the kernel at a given block size."""
    from hobbyraytracer_tpu.kernels import mesh_traverse as kmod

    n = r.o.shape[0]
    n_pad = -(-n // block) * block
    rays8 = (jnp.zeros((8, n_pad)).at[3:6].set(1.0)
             .at[:3, :n].set(r.o.T).at[3:6, :n].set(r.d.T).at[6, :n].set(1))
    soa = kmod.pack_mesh_soa(tv, jnp.zeros(tv.shape),
                             jnp.zeros(tv.shape[:3] + (2,)))
    out, gid = kmod.traverse_clusters_pallas(
        rays8, kmod.pack_bounds(bmin, bmax), soa, tid,
        interpret=interpret, block=block)
    return out[0, :n], gid[:n], out[0, :n] < BIG


@pytest.mark.parametrize("block", [8, 64])
def test_kernel_result_independent_of_block(block):
    """Blocks only change the visit order: t and hits are identical for
    any power-of-two block, the winner differs only on exact t-ties."""
    verts, idx = _random_mesh(4, n_tris=700)
    tables = _tables(verts, idx)
    r = _rays(5, 300)
    ref = _traverse(r, *tables, block=32)
    out = _traverse(r, *tables, block=block)
    np.testing.assert_array_equal(np.asarray(out[2]), np.asarray(ref[2]))
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(ref[0]))
    assert (np.asarray(out[1]) == np.asarray(ref[1])).mean() > 0.99


def test_kernel_multi_chunk_row_matches_xla():
    """A mesh with more clusters than one ROW_CHUNK holds its entry row as
    several register chunks (and pads K to a chunk multiple with never-hit
    boxes)."""
    from hobbyraytracer_tpu.kernels import mesh_traverse as kmod

    verts, idx = _random_mesh(6, n_tris=(kmod.ROW_CHUNK + 100) * 32,
                              spread=30.0)
    tv, tid, bmin, bmax = _tables(verts, idx, leaf_size=32)
    assert tid.shape[0] > kmod.ROW_CHUNK
    r = _rays(7, 200, spread=40.0)
    t_x, g_x, h_x = isect.intersect_mesh_clustered(r, tv, tid, bmin, bmax,
                                                   BIG)
    t_p, g_p, h_p, _, _ = isect.intersect_mesh_clustered_pallas(
        r, tv, tid, bmin, bmax, BIG, interpret=True)
    np.testing.assert_array_equal(np.asarray(h_p), np.asarray(h_x))
    m = np.asarray(h_x)
    assert m.sum() > 20
    np.testing.assert_allclose(np.asarray(t_p)[m], np.asarray(t_x)[m],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,chunk,k_pad", [
    (1, 1, 1), (30, 32, 32), (822, 1024, 1024), (1024, 1024, 1024),
    (1500, 1024, 2048)])
def test_row_geometry(k, chunk, k_pad):
    from hobbyraytracer_tpu.kernels import mesh_traverse as kmod

    assert kmod.row_geometry(k) == (chunk, k_pad)


@pytest.mark.parametrize("n_rays,block,leaf", [
    (100, 32, 128),     # rays not a multiple of the block
    (96, 24, 128),      # block not a power of two
    (96, 32, 48),       # leaf not a multiple of LEAF_TILE
])
def test_traverse_rejects_bad_shapes(n_rays, block, leaf):
    from hobbyraytracer_tpu.kernels import mesh_traverse as kmod

    with pytest.raises(ValueError):
        kmod.traverse_clusters_pallas(
            jnp.zeros((8, n_rays)), jnp.zeros((8, 2)),
            jnp.zeros((2, 24, leaf)), jnp.zeros((2, leaf), jnp.int32),
            interpret=True, block=block)


def test_wrapper_pads_rays_and_never_hits_padding():
    """The wrapper pads the wavefront to whole blocks; padded and invalid
    rays report no hit, and outputs keep the caller's ray count."""
    verts, idx = _random_mesh(8, n_tris=300)
    tv, tid, bmin, bmax = _tables(verts, idx)
    r = _rays(9, 37)
    valid = np.ones((37,), bool)
    valid[::2] = False
    t, g, h, n, uv = isect.intersect_mesh_clustered_pallas(
        r, tv, tid, bmin, bmax, BIG, ray_valid=jnp.asarray(valid),
        interpret=True)
    assert t.shape == g.shape == h.shape == (37,)
    assert n.shape == (37, 3) and uv.shape == (37, 2)
    h = np.asarray(h)
    assert not h[~valid].any()
    assert (np.asarray(g)[~h] == -1).all()
    assert (np.asarray(t)[~h] == BIG).all()


@pytest.mark.parametrize("env,expect", [
    ({}, ("xla", False)),
    ({"HRT_PALLAS_INTERPRET": "1"}, ("pallas", True)),
    ({"HRT_PALLAS_INTERPRET": "1", "HRT_NO_PALLAS": "1"}, ("xla", False)),
])
def test_mesh_backend_dispatch_on_cpu(monkeypatch, env, expect):
    """auto resolves to the XLA find on the CPU, to the kernel in
    interpret mode only when a test asks, and HRT_NO_PALLAS wins."""
    from hobbyraytracer_tpu.scene import ir as scene_ir

    for k in ("HRT_PALLAS_INTERPRET", "HRT_NO_PALLAS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    verts, idx = _random_mesh(1, n_tris=200)
    _, tid, _, _ = _tables(verts, idx)
    mesh = scene_ir.MeshGeom(verts=None, normals=None, uvs=None,
                             indices=None, mat_id=None, cluster_id=tid,
                             use_bvh=True)
    assert scene_ir._resolve_mesh_backend("auto", mesh) == expect
    diff = scene_ir._resolve_mesh_backend("auto_diff", mesh)
    assert diff == (("pallas_replay", True) if expect[0] == "pallas"
                    else expect)
    assert scene_ir._resolve_mesh_backend("xla", mesh) == ("xla", False)


@pytest.mark.parametrize("platform,expect", [
    ("gpu", (True, False)), ("cpu", (False, False))])
def test_pallas_platform(monkeypatch, platform, expect):
    """Compiled kernel on a GPU, none on the CPU; any other platform is
    an error, never a silent fallback."""
    import jax

    from hobbyraytracer_tpu.scene import ir as scene_ir

    class Dev:
        pass

    dev = Dev()
    dev.platform = platform
    for k in ("HRT_PALLAS_INTERPRET", "HRT_NO_PALLAS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    assert scene_ir._pallas_platform() == expect
    dev.platform = "rocm"
    with pytest.raises(RuntimeError, match="rocm"):
        scene_ir._pallas_platform()
