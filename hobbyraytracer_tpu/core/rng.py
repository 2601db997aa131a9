"""Counter-based RNG discipline.

The reference uses glm's global stateful RNG (`glm::linearRand`,
`glm::sphericalRand`, `glm::ballRand` — e.g. main.cpp:120-121,
material.h:139,81, constantMedium.cpp:25), which is unreproducible across
threads. Replacement: explicit `jax.random` threefry keys folded
by (purpose, bounce); per-ray decorrelation comes from drawing shaped arrays
indexed by the ray's position in the batch, so a render is a pure function
of (seed, batch layout). Parity with the reference is therefore statistical
(allclose at matched spp), per SURVEY.md §2 component #33.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Stable purpose tags so streams never collide across call sites.
PIXEL_JITTER_U = 0
PIXEL_JITTER_V = 1
SCATTER_SPHERE = 2   # unit-sphere offsets (lambertian/metal/dielectric fuzz)
SCATTER_BALL = 3     # isotropic phase function
DIELECTRIC_CHOICE = 4
MEDIUM_FLIGHT = 5
LENS = 6
RUSSIAN_ROULETTE = 7


def stream(key: jax.Array, purpose: int, bounce=0) -> jax.Array:
    """Derive a sub-key for (purpose, bounce). `bounce` may be traced."""
    return jax.random.fold_in(jax.random.fold_in(key, purpose), bounce)


def _span_slice(full: jnp.ndarray, span, shape) -> jnp.ndarray:
    """Take this worker's rows of a full-batch draw. span = (offset,
    total): `full` has leading dim `total`; the result has `shape` (whose
    leading dim is the local count). The offset may be traced (a
    shard_map worker computes it from its axis index)."""
    off, _ = span
    start = (off,) + (0,) * (full.ndim - 1)
    return jax.lax.dynamic_slice(full, start, shape)


def uniform(key: jax.Array, shape=(), span=None) -> jnp.ndarray:
    """U[0,1) float32 (glm::linearRand(0,1)).

    span=(offset, total): draw the FULL (total, ...) stream and slice this
    worker's rows — a sliced wavefront then sees bit-identical randomness
    to the same rows of an unsliced one, which is what makes the
    shard_map fit path match the single-device fit exactly
    (parallel/shard.py:sharded_fit_step)."""
    if span is None:
        return jax.random.uniform(key, shape, dtype=jnp.float32)
    full = jax.random.uniform(key, (span[1],) + tuple(shape[1:]),
                              dtype=jnp.float32)
    return _span_slice(full, span, shape)


def unit_sphere(key: jax.Array, shape=(), span=None) -> jnp.ndarray:
    """Uniform on the unit sphere surface (glm::sphericalRand(1))."""
    k1, k2 = jax.random.split(key)
    z = uniform(k1, shape, span) * 2.0 - 1.0
    phi = uniform(k2, shape, span) * (2.0 * jnp.pi)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def in_ball(key: jax.Array, shape=(), span=None) -> jnp.ndarray:
    """Uniform inside the unit ball (glm::ballRand(1))."""
    k1, k2 = jax.random.split(key)
    d = unit_sphere(k1, shape, span)
    u = uniform(k2, shape, span)
    return d * jnp.cbrt(u)[..., None]


def in_disk(key: jax.Array, shape=(), span=None) -> jnp.ndarray:
    """Uniform inside the unit disk (glm::circularRand-style, for the lens).

    The reference computes lensRadius but has defocus disabled
    (camera.h:34-35); we keep this for the opt-in lens flag.
    """
    k1, k2 = jax.random.split(key)
    r = jnp.sqrt(uniform(k1, shape, span))
    phi = uniform(k2, shape, span) * (2.0 * jnp.pi)
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)
