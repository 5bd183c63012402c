"""Texture evaluation: compute-all-kinds-and-select.

Reference enum dispatch ``TextureObject::value`` (src/books/the_next_week/
texture.rs:159-168) becomes masked vector evaluation: each texture kind is
evaluated for every ray and the per-ray kind selects the result.  Static
feature flags on the Scene skip whole kinds (noise / image) at trace time when
a scene doesn't use them, so e.g. Book-1 scenes pay nothing for Perlin.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..scene import Scene, TEX_CHECKER, TEX_IMAGE, TEX_NOISE
from . import perlin


def image_texel(scene: Scene, img_id: jnp.ndarray, u: jnp.ndarray,
                v: jnp.ndarray) -> jnp.ndarray:
    """Clamped-UV nearest-texel lookup, v flipped (texture.rs:89-109).

    img_id/u/v: any matching batch shape; returns [..., 3]."""
    hw = scene.image_hw[img_id]  # [...,2]
    h = hw[..., 0].astype(u.dtype)
    w = hw[..., 1].astype(u.dtype)
    uc = jnp.clip(u, 0.0, 1.0)
    vc = 1.0 - jnp.clip(v, 0.0, 1.0)
    i = jnp.minimum((uc * w).astype(jnp.int32), hw[..., 1] - 1)
    j = jnp.minimum((vc * h).astype(jnp.int32), hw[..., 0] - 1)
    # one row-take on a linearized index (a single 1-D gather instead of
    # the multi-operand advanced index images[img_id, j, i])
    IH, IW = scene.images.shape[1], scene.images.shape[2]
    lin = (img_id * IH + j) * IW + i
    return jnp.take(scene.images.reshape(-1, 3), lin, axis=0)


def texture_value(tex_id: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
                  p: jnp.ndarray, scene: Scene) -> jnp.ndarray:
    """Evaluate textures for rays: tex_id [R] i32, u,v [R], p [R,3] -> [R,3]."""
    kind = scene.tex_kind[tex_id]  # [R]
    c1 = scene.tex_color1[tex_id]  # [R,3]
    value = c1  # TEX_SOLID default (texture.rs:33-37)

    if "checker" in scene.features:
        # 3-D lattice parity (texture.rs:63-77)
        inv_scale = scene.tex_inv_scale[tex_id][:, None]
        cell = jnp.floor(inv_scale * p).astype(jnp.int32)
        is_even = (cell[:, 0] + cell[:, 1] + cell[:, 2]) % 2 == 0
        c2 = scene.tex_color2[tex_id]
        checker = jnp.where(is_even[:, None], c1, c2)
        value = jnp.where((kind == TEX_CHECKER)[:, None], checker, value)

    if "image" in scene.features:
        texel = image_texel(scene, scene.tex_image[tex_id], u, v)
        value = jnp.where((kind == TEX_IMAGE)[:, None], texel, value)

    if "noise" in scene.features:
        # marble: 0.5*(1 + sin(scale*z + 10*turb(p,7))) (texture.rs:122-126)
        nscale = scene.tex_noise_scale[tex_id]
        t = perlin.turb(p, scene.perlin_randvec, scene.perlin_perm, depth=7)
        marble = 0.5 * (1.0 + jnp.sin(nscale * p[:, 2] + 10.0 * t))
        value = jnp.where((kind == TEX_NOISE)[:, None], marble[:, None], value)

    return value
