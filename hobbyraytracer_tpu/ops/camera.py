"""Camera ray generation (reference: camera.h).

The reference Camera precomputes an orthonormal basis and viewport vectors
(camera.h:14-30) and getRay(s,t) builds a ray through the thin lens
(camera.h:32-39) — with defocus hardcoded off ("TODO: Add back in
randomness", camera.h:34-35). We keep the camera as a small pytree and ray
generation as a pure batched function; lens sampling is an opt-in flag
(`use_lens`) defaulting to the reference's off-for-parity behavior.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core import rng, struct
from ..core.types import Rays


@struct.dataclass
class Camera:
    origin: jnp.ndarray            # (3,)
    lower_left_corner: jnp.ndarray # (3,)
    horizontal: jnp.ndarray        # (3,)
    vertical: jnp.ndarray          # (3,)
    u: jnp.ndarray                 # (3,) basis right
    v: jnp.ndarray                 # (3,) basis up
    w: jnp.ndarray                 # (3,) basis back
    lens_radius: jnp.ndarray       # () aperture/2 (camera.h:29)
    use_lens: bool = struct.field(pytree_node=False, default=False)


def make_camera(look_from, look_at, up, vfov_deg, aspect_ratio,
                aperture=0.0, focus_distance=1.0, use_lens=False) -> Camera:
    """Build the camera basis exactly as camera.h:14-30."""
    look_from = np.asarray(look_from, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up = np.asarray(up, np.float32)

    theta = np.radians(np.float32(vfov_deg))
    h = np.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    horizontal = focus_distance * viewport_width * u
    vertical = focus_distance * viewport_height * v
    llc = look_from - horizontal / 2.0 - vertical / 2.0 - focus_distance * w

    return Camera(
        origin=jnp.asarray(look_from),
        lower_left_corner=jnp.asarray(llc.astype(np.float32)),
        horizontal=jnp.asarray(horizontal.astype(np.float32)),
        vertical=jnp.asarray(vertical.astype(np.float32)),
        u=jnp.asarray(u.astype(np.float32)),
        v=jnp.asarray(v.astype(np.float32)),
        w=jnp.asarray(w.astype(np.float32)),
        lens_radius=jnp.float32(aperture / 2.0),
        use_lens=use_lens,
    )


def get_rays(cam: Camera, s: jnp.ndarray, t: jnp.ndarray,
             key=None, span=None) -> Rays:
    """Batched Camera::getRay (camera.h:32-39). s,t: (N,) in [0,1].

    Directions are intentionally NOT normalized (matches the reference; the
    integrator and intersections handle non-unit dirs the same way).
    """
    if cam.use_lens and key is not None:
        rd = (rng.in_disk(rng.stream(key, rng.LENS), s.shape, span)
              * cam.lens_radius)
        offset = rd[..., 0:1] * cam.u + rd[..., 1:2] * cam.v
    else:
        offset = jnp.zeros(s.shape + (3,), jnp.float32)
    o = cam.origin + offset
    d = (cam.lower_left_corner
         + s[..., None] * cam.horizontal
         + t[..., None] * cam.vertical
         - cam.origin - offset)
    return Rays(o=o, d=d)
