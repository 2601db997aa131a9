"""Material table + batched scatter/emission kernels.

Replaces the reference's `Material::scatter` virtual dispatch
(material.h:60-71) with a typed SoA material table and masked per-type
vectorized sampling. With only ~7 material types, computing every lobe and
selecting by mask beats sort-by-material (SURVEY.md §7 hard part 3).

MatVec3/MatScalar (constant-or-texture variants, material.h:10-58) become
(constant, tex_id) pairs with tex_id == -1 meaning "use the constant".
All constants here are differentiable leaves for the inverse-rendering path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import mathx, rng, struct
from ..core.mathx import take_rows as _take
from ..core.types import Hits, Rays
from . import texture as tex_ops

MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4
MAT_PBR = 5
MAT_UVTEST = 6


_ALL_TYPES = (MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT,
              MAT_ISOTROPIC, MAT_PBR, MAT_UVTEST)


@struct.dataclass
class MaterialTable:
    """M materials; index 0 is a reserved default lambertian 50% grey.

    `present` is the STATIC set of material types in the table: scatter()
    skips absent lobes (and their RNG draws / texture gathers) at trace
    time — the analogue of the reference never calling a scatter()
    that no object's vtable points to."""
    mtype: jnp.ndarray         # (M,) int32
    albedo: jnp.ndarray        # (M,3)
    albedo_tex: jnp.ndarray    # (M,) int32, -1 = constant
    roughness: jnp.ndarray     # (M,)  metal/dielectric roughness
    roughness_tex: jnp.ndarray # (M,) int32
    strength: jnp.ndarray      # (M,)  diffuse_light strength
    strength_tex: jnp.ndarray  # (M,) int32
    ior: jnp.ndarray           # (M,)  dielectric index of refraction
    metallness: jnp.ndarray    # (M,)  PBR mix constant
    metallness_tex: jnp.ndarray  # (M,) int32
    present: tuple = struct.field(pytree_node=False,
                                       default=_ALL_TYPES)
    # static per-channel "any material uses a texture here" flags: a
    # constant-only channel skips the texture gather entirely
    textured: tuple = struct.field(
        pytree_node=False,
        default=("albedo", "roughness", "strength", "metallness"))
    # static set of texture TYPES material channels can reference: lets
    # colour_value skip whole lookup branches — e.g. a scene whose only
    # material texture is checkered never pays the image/env atlas
    # gathers in shade, even though the env map shares the texture table
    tex_types: tuple = struct.field(
        pytree_node=False, default=(0, 1, 2, 3))


def build_table(specs, tex_ttypes=None) -> MaterialTable:
    """specs: list of dicts with keys mtype, albedo, albedo_tex, roughness,
    roughness_tex, strength, strength_tex, ior, metallness, metallness_tex
    (missing keys get defaults). tex_ttypes: optional (T,) sequence of the
    texture table's ttype column — when given, tex_types is narrowed to
    the types actually referenced by some material channel."""
    def col(key, default, dtype=np.float32):
        return jnp.asarray(
            np.asarray([s.get(key, default) for s in specs], dtype))
    tex_types = (0, 1, 2, 3)
    if tex_ttypes is not None:
        tex_ttypes = [int(t) for t in tex_ttypes]
        used = set()
        for s in specs:
            for f in ("albedo_tex", "roughness_tex", "strength_tex",
                      "metallness_tex"):
                t = int(s.get(f, -1))
                if 0 <= t < len(tex_ttypes):
                    used.add(tex_ttypes[t])
        tex_types = tuple(sorted(used))
    return MaterialTable(
        tex_types=tex_types,
        mtype=col("mtype", MAT_LAMBERTIAN, np.int32),
        albedo=col("albedo", (0.5, 0.5, 0.5)),
        albedo_tex=col("albedo_tex", -1, np.int32),
        roughness=col("roughness", 0.0),
        roughness_tex=col("roughness_tex", -1, np.int32),
        strength=col("strength", 1.0),
        strength_tex=col("strength_tex", -1, np.int32),
        ior=col("ior", 1.5),
        metallness=col("metallness", 0.0),
        metallness_tex=col("metallness_tex", -1, np.int32),
        present=tuple(sorted({int(s.get("mtype", MAT_LAMBERTIAN))
                              for s in specs})),
        textured=tuple(f for f in ("albedo", "roughness", "strength",
                                   "metallness")
                       if any(int(s.get(f + "_tex", -1)) >= 0
                              for s in specs)),
    )


def _gather_params(mats: MaterialTable, mid):
    """ONE packed row gather of every per-lane material channel.

    Separate (N,) gathers pay per gathered row, and row width is nearly
    free, so: concatenate
    the (M,) channels into one (M, 12) matrix (an M-sized op, ~free),
    gather (N, 12) once, slice. Ints ride along bitcast to f32
    (lossless round trip). Differentiable channels (albedo, roughness,
    strength, ior, metallness) flow through concatenate+gather+slice
    with exact VJPs (scatter-add back to the table rows).

    SMALL tables skip the packing: XLA lowers gathers from a table with
    few rows to vectorized selects that are cheaper than one real
    packed gather (the static M >= 32 switch; not yet re-measured on
    the H100).
    Returns dict of per-lane channels."""
    if mats.mtype.shape[0] < 32:
        return {f: _take(getattr(mats, f), mid)
                for f in ("mtype", "albedo", "roughness", "ior",
                          "strength", "metallness", "albedo_tex",
                          "roughness_tex", "strength_tex",
                          "metallness_tex")}
    bc = lambda a: jax.lax.bitcast_convert_type(
        a.astype(jnp.int32), jnp.float32)[..., None]
    packed = jnp.concatenate([
        bc(mats.mtype), mats.albedo,                       # 0, 1:4
        mats.roughness[:, None], mats.ior[:, None],        # 4, 5
        mats.strength[:, None], mats.metallness[:, None],  # 6, 7
        bc(mats.albedo_tex), bc(mats.roughness_tex),       # 8, 9
        bc(mats.strength_tex), bc(mats.metallness_tex),    # 10, 11
    ], axis=1)
    rows = packed[mid]
    ib = lambda c: jax.lax.bitcast_convert_type(rows[..., c], jnp.int32)
    return {
        "mtype": ib(0), "albedo": rows[..., 1:4],
        "roughness": rows[..., 4], "ior": rows[..., 5],
        "strength": rows[..., 6], "metallness": rows[..., 7],
        "albedo_tex": ib(8), "roughness_tex": ib(9),
        "strength_tex": ib(10), "metallness_tex": ib(11),
    }


def _vec3_value(constant, tex_id, tab, u, v, p, textured=True,
                types=None):
    """MatVec3::valueAt — constant unless tex_id >= 0 (material.h:10-35).
    textured=False (static): no material in the table uses a texture for
    this channel, skip the lookup. types: static reachable-texture-type
    set (MaterialTable.tex_types) forwarded to colour_value."""
    if not textured:
        return constant
    from_tex = tex_ops.colour_value(tab, tex_id, u, v, p, types)
    return jnp.where((tex_id >= 0)[..., None], from_tex, constant)


def _scalar_value(constant, tex_id, tab, u, v, p, textured=True,
                  types=None):
    """MatScalar::valueAt — constant or length(texture rgb)
    (material.h:37-58)."""
    if not textured:
        return constant
    from_tex = tex_ops.scalar_value(tab, tex_id, u, v, p, types)
    return jnp.where(tex_id >= 0, from_tex, constant)


def emitted(mats: MaterialTable, tab: tex_ops.TextureTable,
            hits: Hits) -> jnp.ndarray:
    """Material::emitted — black except DiffuseLight's albedo*strength
    (material.h:67-70, 101-104). Returns (N,3)."""
    if MAT_DIFFUSE_LIGHT not in mats.present:  # static: no lights at all
        return jnp.zeros(hits.t.shape + (3,), jnp.float32)
    mid = jnp.maximum(hits.mat_id, 0)
    pr = _gather_params(mats, mid)  # XLA CSEs this with scatter()'s
    u, v = hits.uv[..., 0], hits.uv[..., 1]
    alb = _vec3_value(pr["albedo"], pr["albedo_tex"], tab, u, v,
                      hits.p, "albedo" in mats.textured, mats.tex_types)
    s = _scalar_value(pr["strength"], pr["strength_tex"], tab, u, v,
                      hits.p, "strength" in mats.textured, mats.tex_types)
    e = alb * s[..., None]
    is_light = (pr["mtype"] == MAT_DIFFUSE_LIGHT) & hits.hit
    return jnp.where(is_light[..., None], e, 0.0)


def scatter(mats: MaterialTable, tab: tex_ops.TextureTable, rays: Rays,
            hits: Hits, key: jax.Array, bounce, span=None) -> tuple:
    """Batched Material::scatter over the whole wavefront.

    Returns (did_scatter (N,) bool, attenuation (N,3), new_d (N,3)).
    The new ray origin is hits.p for every material (reference behavior).
    Each lobe follows its reference implementation exactly; see per-branch
    comments. Discrete decisions (absorb, reflect-vs-refract) take gradients
    through the chosen branch only (stop-gradient on the choice itself).
    """
    n = hits.t.shape[0]
    mid = jnp.maximum(hits.mat_id, 0)
    pr = _gather_params(mats, mid)
    mt = pr["mtype"]
    u, v = hits.uv[..., 0], hits.uv[..., 1]
    p = hits.p
    nrm = hits.normal
    # static lobe gating (see MaterialTable.present): absent material
    # types contribute no sampling code, no RNG draws, no texture gathers
    present = set(mats.present)
    has_metal = MAT_METAL in present
    has_dielectric = MAT_DIELECTRIC in present
    has_isotropic = MAT_ISOTROPIC in present
    has_pbr = MAT_PBR in present
    has_uvtest = MAT_UVTEST in present

    albedo = _vec3_value(pr["albedo"], pr["albedo_tex"], tab, u, v,
                         p, "albedo" in mats.textured, mats.tex_types)
    need_rough = has_metal or has_dielectric or has_pbr
    rough = (_scalar_value(pr["roughness"], pr["roughness_tex"],
                           tab, u, v, p, "roughness" in mats.textured,
                           mats.tex_types)
             if need_rough else jnp.zeros((n,), jnp.float32))

    # shared random draws (one stream per purpose per bounce)
    sph = rng.unit_sphere(rng.stream(key, rng.SCATTER_SPHERE, bounce), (n,),
                          span)

    unit_d = mathx.normalize(rays.d)
    unit_n = (mathx.normalize(nrm, eps=1e-12)  # eps large enough that the
              # backward 1/norm^2 terms stay finite in float32
              if has_metal or has_pbr else nrm)

    # --- Lambertian (material.h:132-157): dir = normal + unit_sphere,
    # near-zero fallback to normal. NOTE the raw (possibly unnormalized)
    # hit normal is used, as in the reference.
    lam_dir = nrm + sph
    lam_dir = jnp.where(mathx.near_zero(lam_dir)[..., None], nrm, lam_dir)
    new_d = lam_dir  # lambertian & uvtest
    atten = albedo
    ok = mt != MAT_DIFFUSE_LIGHT

    if has_metal or has_pbr:
        # --- Metal (material.h:159-182): reflect(unit_d, unit_n) +
        # clamp(roughness,<=1)*unit_sphere + FLT_EPSILON; absorb when
        # dot(scattered, unit_n) <= 0.
        met_rough = jnp.minimum(jnp.abs(rough), 1.0)
        met_dir = (mathx.reflect(unit_d, unit_n)
                   + met_rough[..., None] * sph + mathx.EPS_F32)
        met_ok = mathx.dot(met_dir, unit_n) > 0.0
        if has_metal:
            sel = (mt == MAT_METAL)
            new_d = jnp.where(sel[..., None], met_dir, new_d)
            ok = jnp.where(sel, met_ok, ok)

    if has_dielectric:
        # --- Dielectric (material.h:199-242): Schlick + stochastic
        # reflect/refract with rough offset; attenuation (1,1,1). Uses the
        # raw hit normal (reference passes rec.normal unnormalized).
        u_choice = rng.uniform(
            rng.stream(key, rng.DIELECTRIC_CHOICE, bounce), (n,), span)
        ior = pr["ior"]
        ratio = jnp.where(hits.front_face, 1.0 / ior, ior)
        cos_t = jnp.minimum(mathx.dot(-unit_d, nrm), 1.0)
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
        cannot = ratio * sin_t > 1.0
        refl_p = mathx.schlick(cos_t, ratio)  # ref passes refractionRatio
        choose_reflect = cannot | (refl_p > u_choice)
        choose_reflect = jax.lax.stop_gradient(choose_reflect)
        d_reflect = mathx.reflect(unit_d, nrm)
        d_refract = mathx.refract(unit_d, nrm, ratio)
        die_dir = (jnp.where(choose_reflect[..., None], d_reflect,
                             d_refract) + rough[..., None] * sph)
        sel = (mt == MAT_DIELECTRIC)
        new_d = jnp.where(sel[..., None], die_dir, new_d)
        atten = jnp.where(sel[..., None], jnp.ones((n, 3), jnp.float32),
                          atten)

    if has_isotropic:
        # --- Isotropic (material.h:73-89): uniform-in-ball direction.
        ball = rng.in_ball(rng.stream(key, rng.SCATTER_BALL, bounce), (n,),
                           span)
        sel = (mt == MAT_ISOTROPIC)
        new_d = jnp.where(sel[..., None], ball, new_d)

    if has_pbr:
        # --- PBR (material.cpp:4-27): length(metallness value) > 0.5 ->
        # metal lobe (roughness), else lambertian; both share albedo.
        metl = _scalar_value(pr["metallness"], pr["metallness_tex"],
                             tab, u, v, p, "metallness" in mats.textured,
                             mats.tex_types)
        pbr_is_metal = jnp.abs(metl) > 0.5
        sel = (mt == MAT_PBR)
        new_d = jnp.where((sel & pbr_is_metal)[..., None], met_dir, new_d)
        ok = jnp.where(sel & pbr_is_metal, met_ok, ok)

    if has_uvtest:
        # --- UVTest (material.h:111-130): lambertian scatter,
        # attenuation = raw normal.
        atten = jnp.where((mt == MAT_UVTEST)[..., None], nrm, atten)

    ok = ok & hits.hit
    return ok, atten, new_d
