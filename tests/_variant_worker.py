"""Subprocess worker for tests/test_kernel_variants.py.

Builds a deterministic random mesh + ray set, runs the fused Pallas
traversal in interpreter mode under WHATEVER HRT_* env the parent set
(the knobs are read once at module import, so each variant needs a fresh
interpreter), and writes the results to the npz path in argv[1].
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from hobbyraytracer_tpu.core.mathx import BIG  # noqa: E402
from hobbyraytracer_tpu.core.types import Rays  # noqa: E402
from hobbyraytracer_tpu.ops import intersect as isect  # noqa: E402
from hobbyraytracer_tpu.scene.bvh import build_clusters  # noqa: E402


def main() -> int:
    out_path = sys.argv[1]
    rng = np.random.default_rng(7)
    n_tris = 400
    base = rng.uniform(-3.0, 3.0, (n_tris, 3)).astype(np.float32)
    v1 = base + rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    v2 = base + rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    verts = np.concatenate([base, v1, v2], axis=0).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T.copy()
    c = build_clusters(verts, idx, leaf_size=128)
    tv = jnp.asarray(c["tri_verts"])
    tid = jnp.asarray(c["tri_id"])
    bmin = jnp.asarray(c["bmin"])
    bmax = jnp.asarray(c["bmax"])

    n = 700  # not a BLOCK multiple: exercises padding in every variant
    o = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    r = Rays(o=jnp.asarray(o), d=jnp.asarray(d))

    # corner attributes so normal/uv interpolation is exercised too
    nrm = rng.normal(0, 1, verts.shape).astype(np.float32)
    uvs = rng.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    safe = np.maximum(np.asarray(tid), 0)
    corner = idx[safe]
    t, gid, hit, normal, uv = isect.intersect_mesh_clustered_pallas(
        r, tv, tid, bmin, bmax, BIG, interpret=True,
        tri_normals=jnp.asarray(nrm[corner]),
        tri_uvs=jnp.asarray(uvs[corner]))

    # sphere path through the FULL scene routing
    os.environ["HRT_PALLAS_INTERPRET"] = "1"
    from hobbyraytracer_tpu.ops import shade as shade_ops
    from hobbyraytracer_tpu.ops import texture as tex_ops
    from hobbyraytracer_tpu.scene import ir as scene_ir

    s_n = 300
    s_center = rng.uniform(-8, 8, (s_n, 3)).astype(np.float32)
    s_radius = rng.uniform(0.2, 1.0, (s_n,)).astype(np.float32)
    spheres = scene_ir.SphereTable(
        center=jnp.asarray(s_center), radius=jnp.asarray(s_radius),
        mat_id=jnp.zeros((s_n,), jnp.int32))
    scene = scene_ir.SceneIR(
        spheres=spheres,
        rects=scene_ir.RectTable(
            axis=jnp.zeros((0,), jnp.int32),
            a0=jnp.zeros((0,), jnp.float32),
            a1=jnp.zeros((0,), jnp.float32),
            b0=jnp.zeros((0,), jnp.float32),
            b1=jnp.zeros((0,), jnp.float32),
            k=jnp.zeros((0,), jnp.float32),
            mat_id=jnp.zeros((0,), jnp.int32)),
        instances=(), media=(),
        materials=shade_ops.build_table([{}]),
        textures=tex_ops.build_table(
            [{"type": 0, "solid": (1.0, 1.0, 1.0)}]),
        background_tex=jnp.asarray(0, jnp.int32))
    h = scene_ir.intersect_scene(scene, r, jax.random.PRNGKey(0), 0,
                                 mesh_backend="auto")
    np.savez(out_path, t=np.asarray(t), gid=np.asarray(gid),
             hit=np.asarray(hit), normal=np.asarray(normal),
             uv=np.asarray(uv),
             s_t=np.asarray(h.t), s_hit=np.asarray(h.hit),
             s_normal=np.asarray(h.normal))
    return 0


if __name__ == "__main__":
    sys.exit(main())
