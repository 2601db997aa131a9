"""hobbyraytracer_tpu — a differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
Todegal/HobbyRaytracer (reference: /root/reference): YAML scene description,
unidirectional path tracing (Shirley/PBRT lineage), triangle meshes with BVH
acceleration, Lambertian/metal/dielectric/emissive/isotropic materials,
solid/checkered/image/environment textures, constant-density participating
media, ACES tonemapping, and PNG/TGA/BMP output — rebuilt for an
accelerator (an NVIDIA GPU):

- batched SoA ray/hit buffers in device memory, bounce loop as masked
  `lax.while_loop`
  (the reference's per-ray recursion, `main.cpp:38-79`, becomes a wavefront);
- dense streaming ray/primitive intersection plus a flattened-BVH mesh
  find, fused into one Pallas kernel on the GPU (the reference's pointer
  BVH, `bvh.cpp`);
- counter-based `jax.random` keys instead of global stateful RNG;
- image tiles / sample batches sharded over a `jax.sharding.Mesh` with psum'd
  parameter gradients (the reference's `std::execution::par` thread pool,
  `main.cpp:111`);
- everything differentiable w.r.t. material parameters and vertex positions.
"""

__version__ = "0.1.0"
