"""rustraytrace_tpu — a differentiable Monte Carlo path tracer in JAX.

A from-scratch re-design (NOT a port) of the capabilities of the reference
Rust ray tracer ``jwheo12/RustRayTrace`` (the *Ray Tracing in One Weekend*
trilogy: CPU/rayon + wgpu/WGSL + CUDA backends), re-architected for an
accelerator driven from JAX (today an NVIDIA H100):

* counter-based per-sample RNG streams (threefry) instead of per-thread
  stateful RNG (reference: ``src/books/*/rtweekend.rs:9-11``,
  ``src/gpu/renderer.wgsl:51-75``),
* a fixed-depth masked ``lax.scan`` bounce loop instead of recursion
  (reference: ``src/books/in_one_weekend/camera.rs:182-209``) or a
  device-side ``loop`` (``src/gpu/renderer.wgsl:175-246``),
* scenes as SoA pytrees of device arrays — the same idea as the reference's
  GPU scene compiler (``src/gpu/mod.rs:113-301``) — which double as the
  differentiable parameter vector,
* a Pallas (Triton) closest-hit kernel for box-free scenes, and
* ``shard_map`` over a device mesh for pixel/spp sharding with ``psum``
  framebuffer reduction (the reference is single-process: rayon scanlines,
  ``src/books/*/camera.rs:66-88``).

Public API re-exports live here; see README.md for the layer map.
"""

from .config import RenderConfig, CameraParams, derive_camera
from .scene import (
    SceneBuilder,
    Scene,
    LAMBERTIAN,
    METAL,
    DIELECTRIC,
    DIFFUSE_LIGHT,
    ISOTROPIC,
)
from .render import render_image, render_pass, finalize_image
from . import models
from . import parallel
from . import diff

__all__ = [
    "RenderConfig",
    "CameraParams",
    "derive_camera",
    "SceneBuilder",
    "Scene",
    "LAMBERTIAN",
    "METAL",
    "DIELECTRIC",
    "DIFFUSE_LIGHT",
    "ISOTROPIC",
    "render_image",
    "render_pass",
    "finalize_image",
    "models",
    "parallel",
    "diff",
]

__version__ = "0.1.0"
