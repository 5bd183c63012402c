"""Multi-device / multi-host parallelism: device meshes, sharded rendering.

The reference is single-process (rayon scanline threads,
``src/books/*/camera.rs:66-88``; one wgpu/CUDA device).  This build scales
the same two axes the reference already parallelizes — pixels and samples —
across a ``jax.sharding.Mesh`` with named axes ``('px', 'spp')``:

* ``px``  — data-parallel over pixel blocks (the scanline/workgroup analog),
* ``spp`` — sample batches traced on different cards and reduced with
  ``psum`` over the interconnect (the analog of the reference's sequential spp pass loops,
  ``src/gpu/mod.rs:444-481`` / ``src/cuda/mod.rs:403-432``).

Scene and camera pytrees are replicated (KBs; SURVEY.md §2.7).
"""

from .mesh import make_mesh, mesh_axis_sizes
from .render import render_pass_sharded, render_image_sharded

__all__ = [
    "make_mesh",
    "mesh_axis_sizes",
    "render_pass_sharded",
    "render_image_sharded",
]
