"""Texture table + batched lookups (reference: texture.h/texture.cpp).

The reference's `Texture::colourValue(u, v, p)` virtual dispatch
(texture.h:3-7) becomes a typed SoA table + one vectorized gather kernel:
all image/environment pixel data lives in a single flat fp32 atlas on device;
solid and checkered are pure arithmetic; dispatch is a masked select over
the (tiny) set of texture types.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core import struct
from ..core.mathx import take_rows as _take

TEX_SOLID = 0       # SolidColourTexture (texture.h:9-25)
TEX_IMAGE = 1       # ImageTexture (texture.cpp:30-74)
TEX_CHECKERED = 2   # CheckeredTexture (texture.cpp:17-28)
TEX_ENVIRONMENT = 3 # EnvironmentMap (texture.cpp:76-115)

DEBUG_CYAN = (0.0, 1.0, 1.0)  # missing-data fallback (texture.cpp:56-57)


@struct.dataclass
class TextureTable:
    """All scene textures. T = number of textures (>= 1; index 0 is a
    reserved solid-white so mat tables can always hold a valid id).

    `bilinear` (static, default False) switches image/environment lookups
    from the reference's nearest-neighbor (texture.cpp:63-74,86-97) to
    bilinear filtering — an extension the differentiable path uses so UV /
    direction gradients are smooth instead of piecewise-constant."""
    ttype: jnp.ndarray    # (T,) int32
    solid: jnp.ndarray    # (T,3) solid colour / checkered `even`
    solid2: jnp.ndarray   # (T,3) checkered `odd`
    atlas: jnp.ndarray    # (Npix, 3) fp32 flattened image data (>=1 px)
    offset: jnp.ndarray   # (T,) int32 start into atlas
    width: jnp.ndarray    # (T,) int32
    height: jnp.ndarray   # (T,) int32
    bilinear: bool = struct.field(pytree_node=False, default=False)


def build_table(specs) -> TextureTable:
    """specs: list of dicts from the scene builder:
    {"type": int, "solid": (3,), "solid2": (3,), "image": (H,W,3) float32}.
    """
    ttypes, solids, solids2, offsets, widths, heights = [], [], [], [], [], []
    atlas_parts = [np.zeros((1, 3), np.float32)]  # keep atlas non-empty
    cursor = 1
    for s in specs:
        ttypes.append(s["type"])
        solids.append(np.asarray(s.get("solid", (0, 0, 0)), np.float32))
        solids2.append(np.asarray(s.get("solid2", (0, 0, 0)), np.float32))
        img = s.get("image")
        if img is not None and img.size > 0:
            h, w, _ = img.shape
            atlas_parts.append(np.asarray(img, np.float32).reshape(-1, 3))
            offsets.append(cursor)
            widths.append(w)
            heights.append(h)
            cursor += h * w
        else:
            offsets.append(0)
            widths.append(0)   # width 0 => "no data" => debug cyan
            heights.append(0)
    return TextureTable(
        ttype=jnp.asarray(ttypes, jnp.int32),
        solid=jnp.asarray(np.stack(solids), jnp.float32),
        solid2=jnp.asarray(np.stack(solids2), jnp.float32),
        atlas=jnp.asarray(np.concatenate(atlas_parts, axis=0), jnp.float32),
        offset=jnp.asarray(offsets, jnp.int32),
        width=jnp.asarray(widths, jnp.int32),
        height=jnp.asarray(heights, jnp.int32),
    )


def white_table() -> TextureTable:
    return build_table([{"type": TEX_SOLID, "solid": (1.0, 1.0, 1.0)}])


def colour_value(tab: TextureTable, tex_id, u, v, p,
                 types=None) -> jnp.ndarray:
    """Batched Texture::colourValue. tex_id: (N,) int32; u,v: (N,); p: (N,3).

    `types` (STATIC, optional): the set of texture types the tex_id batch
    can actually reference — e.g. a material table whose channels only
    point at solid/checkered textures passes (TEX_SOLID, TEX_CHECKERED)
    and the image/environment atlas gathers are skipped at trace time.
    The (N,) atlas row gathers are the expensive part of a lookup; None
    computes all types.

    Per-type semantics match the reference exactly:
    - solid: constant (texture.h:20-23)
    - checkered: sign of sin(10x)sin(10y)sin(10z) picks odd/even
      (texture.cpp:17-28)
    - image: clamp u, flip v, nearest by truncation, /255 data already
      folded into the fp32 atlas (texture.cpp:53-74)
    - environment: clamp both, nearest with +0.5 rounding on (dim-1), NO v
      flip (texture.cpp:76-97)
    - image/environment with no data: debug cyan (texture.cpp:56-57,79-80)
    """
    if types is None:
        types = (TEX_SOLID, TEX_IMAGE, TEX_CHECKERED, TEX_ENVIRONMENT)
    types = set(types) | {TEX_SOLID}   # id<0 falls back to texture 0
    tid = jnp.maximum(tex_id, 0)
    tt = _take(tab.ttype, tid)
    w = _take(tab.width, tid)
    h = _take(tab.height, tid)
    off = _take(tab.offset, tid)

    # solid
    c_solid = _take(tab.solid, tid)

    # checkered
    if TEX_CHECKERED in types:
        sines = (jnp.sin(10.0 * p[..., 0]) * jnp.sin(10.0 * p[..., 1])
                 * jnp.sin(10.0 * p[..., 2]))
        c_check = jnp.where((sines < 0.0)[..., None],
                            _take(tab.solid2, tid), c_solid)
    else:
        c_check = c_solid

    uc = jnp.clip(u, 0.0, 1.0)
    wi = jnp.maximum(w, 1)
    hi = jnp.maximum(h, 1)

    def fetch(i, j):
        idx = off + jnp.clip(j, 0, hi - 1) * wi + jnp.clip(i, 0, wi - 1)
        return tab.atlas[jnp.clip(idx, 0, tab.atlas.shape[0] - 1)]

    def bilerp(x, y):
        """Sample at continuous texel coords (x, y): smooth in (x, y)."""
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        i0 = x0.astype(jnp.int32)
        j0 = y0.astype(jnp.int32)
        c00 = fetch(i0, j0)
        c10 = fetch(i0 + 1, j0)
        c01 = fetch(i0, j0 + 1)
        c11 = fetch(i0 + 1, j0 + 1)
        return ((1 - fx) * (1 - fy) * c00 + fx * (1 - fy) * c10
                + (1 - fx) * fy * c01 + fx * fy * c11)

    cyan = jnp.asarray(DEBUG_CYAN, jnp.float32)
    has_data = (w > 0)[..., None]

    # image (v flipped)
    if TEX_IMAGE in types:
        vc = 1.0 - jnp.clip(v, 0.0, 1.0)
        if tab.bilinear:
            c_img = bilerp(uc * (w - 1).astype(jnp.float32),
                           vc * (h - 1).astype(jnp.float32))
        else:  # nearest by truncation (texture.cpp:63-74)
            i_img = jnp.minimum(
                (uc * w.astype(jnp.float32)).astype(jnp.int32), wi - 1)
            j_img = jnp.minimum(
                (vc * h.astype(jnp.float32)).astype(jnp.int32), hi - 1)
            c_img = fetch(i_img, j_img)
        c_img = jnp.where(has_data, c_img, cyan)
    else:
        c_img = c_solid

    # environment (no v flip)
    if TEX_ENVIRONMENT in types:
        ve = jnp.clip(v, 0.0, 1.0)
        if tab.bilinear:
            c_env = bilerp(uc * (w - 1).astype(jnp.float32),
                           ve * (h - 1).astype(jnp.float32))
        else:  # nearest with +0.5 rounding on (dim-1) (texture.cpp:86-97)
            i_env = (uc * (w - 1).astype(jnp.float32)
                     + 0.5).astype(jnp.int32)
            j_env = (ve * (h - 1).astype(jnp.float32)
                     + 0.5).astype(jnp.int32)
            c_env = fetch(i_env, j_env)
        c_env = jnp.where(has_data, c_env, cyan)
    else:
        c_env = c_solid

    out = jnp.where((tt == TEX_SOLID)[..., None], c_solid,
          jnp.where((tt == TEX_CHECKERED)[..., None], c_check,
          jnp.where((tt == TEX_IMAGE)[..., None], c_img, c_env)))
    return out


def scalar_value(tab: TextureTable, tex_id, u, v, p,
                 types=None) -> jnp.ndarray:
    """MatScalar from a texture = length(rgb) (material.h:49)."""
    c = colour_value(tab, tex_id, u, v, p, types)
    return jnp.sqrt(jnp.sum(c * c, axis=-1))
