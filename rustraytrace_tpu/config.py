"""Render configuration and camera derivation.

The reference exposes exactly eleven camera/render knobs (``src/config.rs:2-14``
``RenderOverrides``: aspect_ratio, image_width, samples_per_pixel, max_depth,
vfov, lookfrom, lookat, vup, defocus_angle, focus_dist, background), applied as
a compile-time const.  Here the same fields are a runtime dataclass, plus
device-side execution knobs (pass batching, ray chunking) that play the role of
the reference's GPU pass constants (64 spp/pass: ``src/gpu/mod.rs:10-11``;
256 spp/pass: ``src/cuda/mod.rs:9``).

Camera derivation reproduces ``src/books/in_one_weekend/camera.rs:102-150``
(identical math in all three books and in the GPU scene compiler,
``src/gpu/mod.rs:174-198``): viewport basis from (lookfrom, lookat, vup, vfov,
focus_dist), pixel00/pixel-delta precomputation, defocus disk radius.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Background modes (reference: params_u.w in src/gpu/renderer.wgsl:233-239 —
# 0 selects the sky gradient, 1 a flat color; book 1's CPU path hardcodes the
# gradient, books 2/3 use a configurable flat background).
BG_SKY = 0
BG_FLAT = 1


@dataclasses.dataclass
class RenderConfig:
    """User-facing render settings (the reference's 11 fields + device knobs)."""

    aspect_ratio: float = 1.0
    image_width: int = 100
    samples_per_pixel: int = 10
    max_depth: int = 10
    vfov: float = 90.0
    lookfrom: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lookat: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    vup: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    defocus_angle: float = 0.0
    focus_dist: float = 10.0
    # None => sky-gradient miss shading (book 1); a color => flat background
    # (books 2/3, reference src/books/the_next_week/camera.rs:174-201).
    background: Optional[Tuple[float, float, float]] = None

    # --- device execution knobs (not in the reference's config) ---
    # Samples per device pass; plays the role of gpu/mod.rs:11 SPP_PER_PASS.
    # 0 (the default) = AUTO: 16 (render.effective_spp_per_pass).  An
    # explicit value is honored exactly (small values buy finer
    # checkpoint/progress grain at more dispatches).
    spp_per_pass: int = 0
    # Use stratified sqrt(spp) x sqrt(spp) sub-pixel sampling (book 3,
    # src/books/the_rest_of_your_life/camera.rs:114-116,173-177).
    stratified: bool = False
    seed: int = 0

    @property
    def image_height(self) -> int:
        h = int(self.image_width / self.aspect_ratio)
        return max(h, 1)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CameraParams:
    """Derived camera uniforms, all f32 device scalars/vectors.

    Mirrors the reference's ``CameraInternals`` (camera.rs:47-56) and the GPU
    ``CameraUniform`` (src/gpu/mod.rs:13-25): everything the per-ray code
    needs, precomputed once on host.
    """

    center: jnp.ndarray  # [3]
    pixel00: jnp.ndarray  # [3]
    pixel_delta_u: jnp.ndarray  # [3]
    pixel_delta_v: jnp.ndarray  # [3]
    defocus_disk_u: jnp.ndarray  # [3]
    defocus_disk_v: jnp.ndarray  # [3]
    background: jnp.ndarray  # [3] (zeros when bg_mode == BG_SKY)
    # static (pytree metadata) fields:
    lens_radius_gt0: bool = dataclasses.field(metadata=dict(static=True))
    bg_mode: int = dataclasses.field(metadata=dict(static=True))
    image_width: int = dataclasses.field(metadata=dict(static=True))
    image_height: int = dataclasses.field(metadata=dict(static=True))


_CAM_CACHE: dict = {}


def derive_camera(cfg: RenderConfig, dtype=jnp.float32) -> CameraParams:
    """Compute viewport basis and pixel grid; reference camera.rs:102-150.

    Memoized by config VALUE: repeated calls with equal configs return the
    SAME CameraParams object, so repeated renders skip re-deriving and
    re-uploading the small camera arrays."""
    key = (dataclasses.astuple(cfg), dtype)
    hit = _CAM_CACHE.get(key)
    if hit is not None:
        return hit
    cam = _derive_camera_uncached(cfg, dtype)
    if len(_CAM_CACHE) > 64:
        _CAM_CACHE.clear()
    _CAM_CACHE[key] = cam
    return cam


def _derive_camera_uncached(cfg: RenderConfig,
                            dtype=jnp.float32) -> CameraParams:
    width = cfg.image_width
    height = cfg.image_height

    lookfrom = np.asarray(cfg.lookfrom, dtype=np.float64)
    lookat = np.asarray(cfg.lookat, dtype=np.float64)
    vup = np.asarray(cfg.vup, dtype=np.float64)

    theta = math.radians(cfg.vfov)
    h = math.tan(theta / 2.0)
    viewport_height = 2.0 * h * cfg.focus_dist
    viewport_width = viewport_height * (width / height)

    w = lookfrom - lookat
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    viewport_u = viewport_width * u
    viewport_v = viewport_height * -v
    pixel_delta_u = viewport_u / width
    pixel_delta_v = viewport_v / height

    viewport_upper_left = lookfrom - cfg.focus_dist * w - viewport_u / 2.0 - viewport_v / 2.0
    pixel00 = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    defocus_radius = cfg.focus_dist * math.tan(math.radians(cfg.defocus_angle / 2.0))
    defocus_disk_u = u * defocus_radius
    defocus_disk_v = v * defocus_radius

    if cfg.background is None:
        bg_mode = BG_SKY
        background = np.zeros(3)
    else:
        bg_mode = BG_FLAT
        background = np.asarray(cfg.background, dtype=np.float64)

    return CameraParams(
        center=jnp.asarray(lookfrom, dtype=dtype),
        pixel00=jnp.asarray(pixel00, dtype=dtype),
        pixel_delta_u=jnp.asarray(pixel_delta_u, dtype=dtype),
        pixel_delta_v=jnp.asarray(pixel_delta_v, dtype=dtype),
        defocus_disk_u=jnp.asarray(defocus_disk_u, dtype=dtype),
        defocus_disk_v=jnp.asarray(defocus_disk_v, dtype=dtype),
        lens_radius_gt0=cfg.defocus_angle > 0.0,
        background=jnp.asarray(background, dtype=dtype),
        bg_mode=bg_mode,
        image_width=width,
        image_height=height,
    )
