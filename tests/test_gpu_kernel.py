"""The mesh-find kernel as compiled for the GPU (no interpret mode): parity
with the plain XLA find. Card-only: these skip unless JAX computes on a
GPU (`python -m pytest -m gpu tests/`; chip_smoke.py runs them)."""
import jax.numpy as jnp
import numpy as np
import pytest

from hobbyraytracer_tpu.core.mathx import BIG
from hobbyraytracer_tpu.ops import intersect as isect
from test_kernels import _random_mesh, _rays, _tables, _traverse

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("block", [8, 32, 128])
def test_compiled_kernel_matches_xla(gpu, block):
    verts, idx = _random_mesh(0, n_tris=3000)
    tv, tid, bmin, bmax = _tables(verts, idx)
    r = _rays(1, 5000)
    t_x, g_x, h_x = isect.intersect_mesh_clustered(r, tv, tid, bmin, bmax,
                                                   BIG)
    t_k, g_k, h_k = _traverse(r, tv, tid, bmin, bmax, block,
                              interpret=False)
    np.testing.assert_array_equal(np.asarray(h_k), np.asarray(h_x))
    m = np.asarray(h_x)
    np.testing.assert_allclose(np.asarray(t_k)[m], np.asarray(t_x)[m],
                               rtol=1e-5, atol=1e-5)
    assert (np.asarray(g_k) == np.asarray(g_x))[m].mean() >= 0.999


def test_compiled_kernel_matches_interpret(gpu):
    verts, idx = _random_mesh(2, n_tris=1000)
    tv, tid, bmin, bmax = _tables(verts, idx)
    r = _rays(3, 2000)
    valid = jnp.asarray(np.arange(2000) % 3 != 0)
    out = [isect.intersect_mesh_clustered_pallas(
        r, tv, tid, bmin, bmax, BIG, ray_valid=valid, interpret=interp)
        for interp in (False, True)]
    for a, b in zip(*out):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
