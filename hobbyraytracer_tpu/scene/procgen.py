"""Procedural mesh generation (test/bench fixtures).

The reference ships `teapot.obj` via git-LFS and it is absent from the
snapshot (like old_hall_4k.hdr, /root/reference/.MISSING_LARGE_BLOBS). The
benchmark scenes need a teapot-class mesh (~6k tris, SURVEY.md §3.4), so we
generate one: a classic Utah-teapot-silhouette surface of revolution (body +
lid + knob) plus swept tubes for spout and handle. Also simple uv-sphere
and box meshes for unit tests.
"""
from __future__ import annotations

import numpy as np


def _grid_indices(nu: int, nv: int, wrap_u: bool) -> np.ndarray:
    """Triangulate an (nu x nv) vertex grid into 2 tris per cell."""
    tris = []
    ucount = nu if wrap_u else nu - 1
    for i in range(ucount):
        i2 = (i + 1) % nu
        for j in range(nv - 1):
            a = i * nv + j
            b = i2 * nv + j
            tris.append((a, b, a + 1))
            tris.append((a + 1, b, b + 1))
    return np.asarray(tris, np.int32)


def uv_sphere(radius=1.0, n_theta=16, n_phi=32, center=(0.0, 0.0, 0.0)):
    """Unit-test mesh with exact analytic normals."""
    thetas = np.linspace(0, np.pi, n_theta)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    verts, normals, uvs = [], [], []
    for p in phis:
        for t in thetas:
            n = np.array([np.sin(t) * np.cos(p), np.cos(t),
                          np.sin(t) * np.sin(p)])
            verts.append(center + radius * n)
            normals.append(n)
            uvs.append((p / (2 * np.pi), 1.0 - t / np.pi))
    idx = _grid_indices(n_phi, n_theta, wrap_u=True)
    return {"verts": np.asarray(verts, np.float32),
            "normals": np.asarray(normals, np.float32),
            "uvs": np.asarray(uvs, np.float32),
            "indices": idx}


def box_mesh(bmin=(-1, -1, -1), bmax=(1, 1, 1)):
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    verts, normals, uvs, tris = [], [], [], []
    # 6 faces, axis n with sign s
    for axis in range(3):
        for s in (-1.0, 1.0):
            a, b = [i for i in range(3) if i != axis]
            base = len(verts)
            for da, db in ((0, 0), (1, 0), (1, 1), (0, 1)):
                v = np.empty(3, np.float32)
                v[axis] = bmax[axis] if s > 0 else bmin[axis]
                v[a] = bmin[a] + da * (bmax[a] - bmin[a])
                v[b] = bmin[b] + db * (bmax[b] - bmin[b])
                verts.append(v)
                n = np.zeros(3, np.float32)
                n[axis] = s
                normals.append(n)
                uvs.append((float(da), float(db)))
            order = (0, 1, 2, 0, 2, 3) if s > 0 else (0, 2, 1, 0, 3, 2)
            tris += [(base + order[0], base + order[1], base + order[2]),
                     (base + order[3], base + order[4], base + order[5])]
    return {"verts": np.asarray(verts, np.float32),
            "normals": np.asarray(normals, np.float32),
            "uvs": np.asarray(uvs, np.float32),
            "indices": np.asarray(tris, np.int32)}


# Utah-teapot-like silhouette: (height, radius) control points for the body
# profile, Catmull-Rom smoothed. Heights in [0, 3.15]-ish like the classic
# dataset; radius 0 closes poles.
_TEAPOT_PROFILE = np.asarray([
    (0.00, 0.001),
    (0.00, 0.80),
    (0.06, 1.10),
    (0.25, 1.35),
    (0.60, 1.48),
    (1.00, 1.50),
    (1.40, 1.40),
    (1.80, 1.17),
    (2.10, 0.95),
    (2.25, 0.90),   # rim
    (2.30, 0.83),   # lid lip
    (2.45, 0.70),
    (2.70, 0.42),
    (2.90, 0.22),
    (3.00, 0.18),   # knob stem
    (3.08, 0.28),   # knob bulge
    (3.15, 0.001),
], np.float32)


def _catmull_rom(points: np.ndarray, samples: int) -> np.ndarray:
    pts = np.vstack([points[0], points, points[-1]])
    out = []
    n_seg = len(points) - 1
    for s in range(samples):
        f = s / (samples - 1) * n_seg
        i = min(int(f), n_seg - 1)
        t = f - i
        p0, p1, p2, p3 = pts[i], pts[i + 1], pts[i + 2], pts[i + 3]
        out.append(0.5 * ((2 * p1) + (-p0 + p2) * t
                          + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t * t
                          + (-p0 + 3 * p1 - 3 * p2 + p3) * t ** 3))
    return np.asarray(out, np.float32)


def _revolve(profile: np.ndarray, n_seg: int):
    """Surface of revolution about +Y from (y, r) profile samples."""
    nv = len(profile)
    phis = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    verts, uvs = [], []
    for p in phis:
        for j, (y, r) in enumerate(profile):
            verts.append((r * np.cos(p), y, r * np.sin(p)))
            uvs.append((p / (2 * np.pi), j / (nv - 1)))
    verts = np.asarray(verts, np.float32)
    idx = _grid_indices(n_seg, nv, wrap_u=True)
    return verts, np.asarray(uvs, np.float32), idx


def _tube(path_pts: np.ndarray, radii, n_seg: int):
    """Sweep a circle of varying radius along a polyline (spout/handle)."""
    path_pts = np.asarray(path_pts, np.float32)
    n = len(path_pts)
    radii = np.broadcast_to(np.asarray(radii, np.float32), (n,))
    # parallel-transport-ish frames
    tangents = np.gradient(path_pts, axis=0)
    tangents /= np.linalg.norm(tangents, axis=1, keepdims=True) + 1e-9
    up = np.array([0.0, 1.0, 0.0], np.float32)
    verts, uvs = [], []
    phis = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    for i in range(n):
        t = tangents[i]
        side = np.cross(up, t)
        if np.linalg.norm(side) < 1e-6:
            side = np.array([1.0, 0.0, 0.0], np.float32)
        side /= np.linalg.norm(side)
        up2 = np.cross(t, side)
        for p in phis:
            ring = radii[i] * (np.cos(p) * side + np.sin(p) * up2)
            verts.append(path_pts[i] + ring)
            uvs.append((p / (2 * np.pi), i / (n - 1)))
    # grid: rings along axis 0? arrange as (n_seg columns) x (n rows):
    # we emitted ring-major; build indices accordingly
    tris = []
    for i in range(n - 1):
        for s in range(n_seg):
            s2 = (s + 1) % n_seg
            a = i * n_seg + s
            b = i * n_seg + s2
            c = (i + 1) * n_seg + s
            d = (i + 1) * n_seg + s2
            tris.append((a, c, b))
            tris.append((b, c, d))
    return (np.asarray(verts, np.float32), np.asarray(uvs, np.float32),
            np.asarray(tris, np.int32))


def _smooth_normals(verts: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    n = np.zeros_like(verts)
    v0 = verts[indices[:, 0]]
    v1 = verts[indices[:, 1]]
    v2 = verts[indices[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    for k in range(3):
        np.add.at(n, indices[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-12)).astype(np.float32)


def teapot(n_seg=44, n_profile=40, scale=1.0):
    """Teapot-class benchmark mesh (~6.5k tris at defaults, comparable to
    the 6.3k-tri Utah teapot the reference renders, SURVEY.md §3.4)."""
    profile = _catmull_rom(_TEAPOT_PROFILE, n_profile)
    profile[:, 1] = np.maximum(profile[:, 1], 0.001)
    bv, buv, bidx = _revolve(profile, n_seg)

    # spout: curve from body out and up
    spout_path = np.asarray([
        (1.30, 0.75, 0.0), (1.75, 0.95, 0.0), (2.05, 1.30, 0.0),
        (2.15, 1.70, 0.0), (2.25, 1.95, 0.0)], np.float32)
    spout_r = np.asarray([0.30, 0.24, 0.18, 0.14, 0.12], np.float32)
    sv, suv, sidx = _tube(spout_path, spout_r, max(10, n_seg // 3))

    # handle: C-curve on the other side
    ang = np.linspace(-0.45 * np.pi, 0.55 * np.pi, 9)
    handle_path = np.stack([
        -1.30 - 0.75 * np.cos(ang), 1.45 + 0.75 * np.sin(ang),
        np.zeros_like(ang)], axis=1).astype(np.float32)
    hv, huv, hidx = _tube(handle_path, 0.12, max(8, n_seg // 4))

    verts = np.concatenate([bv, sv, hv])
    uvs = np.concatenate([buv, suv, huv])
    indices = np.concatenate([bidx, sidx + len(bv),
                              hidx + len(bv) + len(sv)])
    normals = _smooth_normals(verts, indices)
    verts = verts * np.float32(scale)
    return {"verts": verts, "normals": normals,
            "uvs": uvs.astype(np.float32), "indices": indices}


def teapot_hires(scale=1.0):
    """~105k-tri version of the teapot (n_seg=260, n_profile=200): the
    large-mesh benchmark (~822 clusters), at the scale the reference's
    recursive BVH (bvh.cpp:6-78) handles without special-casing."""
    return teapot(n_seg=260, n_profile=200, scale=scale)


def ensure_asset_obj(path: str, kind: str = "teapot") -> str:
    """Write the procedural mesh as an OBJ file if missing; returns path."""
    import os
    if not os.path.exists(path):
        from .objloader import write_obj
        m = {"teapot": teapot, "teapot_hires": teapot_hires,
             "sphere": uv_sphere, "box": box_mesh}[kind]()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        write_obj(path, m["verts"], m["indices"], m["normals"], m["uvs"])
    return path
