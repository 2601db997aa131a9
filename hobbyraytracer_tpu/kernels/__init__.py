"""Pallas kernels for the hot compute path.

The reference's hottest loops are the recursive BVH descent
(bvh.cpp:69-78) and the per-triangle watertight test (triangle.cpp:57-109).
Here they are one fused GPU kernel, compiled through Pallas's Triton
route: per ray-block ordered cluster traversal + Moller-Trumbore over the
visited leaves + winner attribute interpolation
(kernels/mesh_traverse.py).
"""
from .mesh_traverse import (  # noqa: F401
    kernel_fits,
    pack_bounds,
    pack_mesh_soa,
    traverse_clusters_pallas,
)
