"""Core SoA pytrees: rays, hit records, film state.

Replaces the reference's per-ray structs (`ray` in ray.h, `hitRecord` in
hittable.h:8-25) with struct-of-arrays pytrees: every field is a batched
array over N rays, so the whole wavefront lives in device memory and
every op is a vectorized kernel.
"""
from __future__ import annotations

import jax.numpy as jnp

from . import struct


@struct.dataclass
class Rays:
    """A wavefront of rays. o/d: (N,3) float32."""
    o: jnp.ndarray
    d: jnp.ndarray

    def at(self, t: jnp.ndarray) -> jnp.ndarray:
        return self.o + t[..., None] * self.d

    @property
    def n(self) -> int:
        return self.o.shape[0]


@struct.dataclass
class Hits:
    """SoA hit records (reference: hittable.h:8-25 `hitRecord`).

    hit: (N,) bool — whether anything was hit (replaces the bool return).
    t: (N,) float32 — ray parameter (BIG where no hit).
    p: (N,3) — hit point.
    normal: (N,3) — shading normal, already faced against the ray where the
        reference calls setFaceNormal (hittable.h:16-24). NOTE: triangle
        hits keep the raw interpolated (unnormalized, un-faced) normal to
        match ITriangle::hit (triangle.cpp:112-124).
    uv: (N,2) — texture coordinates.
    front_face: (N,) bool.
    mat_id: (N,) int32 — index into the material table (replaces matPtr).
    """
    hit: jnp.ndarray
    t: jnp.ndarray
    p: jnp.ndarray
    normal: jnp.ndarray
    uv: jnp.ndarray
    front_face: jnp.ndarray
    mat_id: jnp.ndarray

    @staticmethod
    def none(n: int, big: float = 1e30) -> "Hits":
        return Hits(
            hit=jnp.zeros((n,), jnp.bool_),
            t=jnp.full((n,), big, jnp.float32),
            p=jnp.zeros((n, 3), jnp.float32),
            normal=jnp.zeros((n, 3), jnp.float32),
            uv=jnp.zeros((n, 2), jnp.float32),
            front_face=jnp.zeros((n,), jnp.bool_),
            mat_id=jnp.full((n,), -1, jnp.int32),
        )


def closer(a: Hits, b: Hits) -> Hits:
    """Closest-hit merge of two hit sets for the same rays.

    Vectorized equivalent of HittableList::hit's shrinking-closest scan
    (hittableList.cpp:4-21).
    """
    take_b = b.hit & (~a.hit | (b.t < a.t))
    tb = take_b
    tb3 = take_b[..., None]
    return Hits(
        hit=a.hit | b.hit,
        t=jnp.where(tb, b.t, a.t),
        p=jnp.where(tb3, b.p, a.p),
        normal=jnp.where(tb3, b.normal, a.normal),
        uv=jnp.where(take_b[..., None], b.uv, a.uv),
        front_face=jnp.where(tb, b.front_face, a.front_face),
        mat_id=jnp.where(tb, b.mat_id, a.mat_id),
    )


def set_face_normal(d: jnp.ndarray, outward_normal: jnp.ndarray):
    """hitRecord::setFaceNormal (hittable.h:16-24).

    Returns (normal, front_face): normal flipped against the ray direction.
    """
    front = jnp.sum(d * outward_normal, axis=-1) < 0.0
    n = jnp.where(front[..., None], outward_normal, -outward_normal)
    return n, front
