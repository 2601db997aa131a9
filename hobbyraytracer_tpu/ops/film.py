"""Film: accumulation, tonemap, quantization (reference: film.h/film.cpp).

The reference keeps a uint8 framebuffer and tonemaps per pixel under a mutex
(film.cpp:18-46, main.cpp:126-131). Here: an fp32 device accumulator per
device tile, with NaN-scrub + Narkowicz ACES + gamma as one vectorized,
differentiable op; quantize+encode happen on host at output time.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def tonemap(colour: jnp.ndarray, grad_eps: float = 0.0) -> jnp.ndarray:
    """NaN scrub + ACES fit + clamp + gamma (film.cpp:32-52).

    - NaN -> 0 (film.cpp:35-37)
    - Narkowicz ACES fit, a=2.51 b=0.03 c=2.43 d=0.59 e=0.14 (film.cpp:39-46)
    - clamp to [0,1], then gamma = sqrt i.e. gamma 2.0 (film.cpp:49)

    Divergence (fix-and-document): the reference scrubs only NaN, so +inf
    radiance becomes NaN via inf/inf inside the ACES ratio. We scrub +inf to
    a large finite value (ACES(1e4) ~= its asymptote a/c, clamps to 1) and
    -inf to 0.

    `grad_eps`: the derivative of sqrt is infinite at 0, which NaN-poisons
    loss gradients at pure-black pixels; the differentiable fit path passes
    a tiny epsilon (forward change is far below quantization).
    """
    c = jnp.nan_to_num(colour, nan=0.0, posinf=1e4, neginf=0.0)
    a, b, cc, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    c = (c * (a * c + b)) / (c * (cc * c + d) + e)
    c = jnp.clip(c, 0.0, 1.0)
    return jnp.sqrt(c + grad_eps)


def quantize(colour: np.ndarray) -> np.ndarray:
    """uint8(256 * clamp(c, 0, 0.9999)) (film.cpp:25-30). Host-side."""
    c = np.clip(np.asarray(colour, np.float32), 0.0, 0.9999)
    return (256.0 * c).astype(np.uint8)


def output_film(pixels_u8: np.ndarray, output_name: str) -> int:
    """Write the framebuffer by extension: .png / .tga / else BMP fallback
    (film.cpp:59-79, including the "File type not supported, generating
    bitmap!" behavior). pixels_u8: (H, W, 3) uint8, row 0 = top.
    Returns nonzero on success (stb convention).
    """
    from ..io import images
    name = output_name
    if name.endswith(".png"):
        return images.write_png(name, pixels_u8)
    if name.endswith(".tga"):
        return images.write_tga(name, pixels_u8)
    if not name.endswith(".bmp"):
        print("File type not supported, generating bitmap!")
    print(">>> " + name)
    return images.write_bmp(name, pixels_u8)
