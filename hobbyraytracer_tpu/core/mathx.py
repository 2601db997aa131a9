"""Vector math helpers (batched, float32, differentiable).

Replaces the reference's glm usage (reference: hobbyraytracer.h:1-42,
ray.h). All functions operate on arrays whose last axis is the vector
dimension, so they vectorize over arbitrary leading batch axes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# plain python floats: a module-level jnp constant would initialize the
# XLA backend at import time, breaking jax.distributed.initialize ordering
EPS_F32 = 1.1920929e-07  # FLT_EPSILON
NEAR_ZERO = 1e-8  # reference: hobbyraytracer.h:34-38 (nearZero, s = 1e-8)
T_MIN = 1e-3      # reference: main.cpp:45 shadow epsilon
BIG = 1e30        # stand-in for +INFINITY in closest-hit windows


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the last axis, keepdims dropped."""
    return jnp.sum(a * b, axis=-1)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def normalize(v: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """glm::normalize. With eps=0 matches glm (NaN on zero vectors).

    rsqrt on the (batch,) reduction + broadcast multiply: one square root
    per vector instead of one division per component."""
    n2 = jnp.sum(v * v, axis=-1)
    if eps:
        n2 = jnp.maximum(n2, eps * eps)
    return v * jax.lax.rsqrt(n2)[..., None]


def near_zero(v: jnp.ndarray) -> jnp.ndarray:
    """True where all components are < 1e-8 in magnitude
    (reference: hobbyraytracer.h:34-38)."""
    return jnp.all(jnp.abs(v) < NEAR_ZERO, axis=-1)


def reflect(i: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """glm::reflect: i - 2*dot(n,i)*n (n assumed unit by caller)."""
    return i - 2.0 * dot(n, i)[..., None] * n


def refract(i: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray) -> jnp.ndarray:
    """glm::refract. i unit incident, n unit normal, eta = n1/n2.

    k = 1 - eta^2 * (1 - dot(n,i)^2); returns 0-vector where k < 0 (TIR).
    Reference dielectric uses this via material.h:225.
    """
    cos_i = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    # safe-where: sqrt(0) has an infinite derivative; substitute 1 in the
    # TIR branch so the masked-out lane can't poison gradients with inf*0
    k_safe = jnp.where(k > 0.0, k, 1.0)
    out = eta[..., None] * i - (eta * cos_i + jnp.sqrt(k_safe))[..., None] * n
    return jnp.where((k < 0.0)[..., None], jnp.zeros_like(out), out)


def schlick(cosine: jnp.ndarray, ref_idx: jnp.ndarray) -> jnp.ndarray:
    """Schlick reflectance approximation (reference: material.h:236-241).
    pow(x, 5) as a multiply chain — jnp.power lowers to exp/log."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x2 * x2 * x)


@jax.custom_jvp
def safe_arccos(x: jnp.ndarray) -> jnp.ndarray:
    """arccos with an exact forward value but a clamped derivative: the true
    derivative is infinite at +-1, which poisons gradient accumulations
    with inf*0=NaN at sphere poles / straight-up env lookups."""
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


@safe_arccos.defjvp
def _safe_arccos_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = safe_arccos(x)
    dydx = -1.0 / jnp.sqrt(jnp.maximum(1.0 - x * x, 1e-12))
    return y, dydx * dx


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def ray_at(o: jnp.ndarray, d: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """ray::at — o + t*d (reference: ray.h)."""
    return o + t[..., None] * d


def take_rows(table: jnp.ndarray, idx: jnp.ndarray,
              max_select: int = 8) -> jnp.ndarray:
    """`table[idx]` for a SMALL leading axis without a device gather.

    For tables of <= max_select rows a compare+select chain is pure
    wavefront-wide elementwise work instead of a per-lane gather. Larger
    tables fall back to the native gather. Gradients flow to each
    selected row exactly as the gather's would.
    """
    m = table.shape[0]
    if m > max_select or m == 0:
        return table[idx]
    expand = (Ellipsis,) + (None,) * (table.ndim - 1)
    out = jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
    for i in range(1, m):
        sel = (idx == i)[expand]
        out = jnp.where(sel, table[i], out)
    return out
