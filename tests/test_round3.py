"""Image texture on a quad: the XLA oracle's planar (u, v) lookup."""

import jax
import numpy as np

from rustraytrace_tpu import RenderConfig, SceneBuilder
from rustraytrace_tpu.config import derive_camera
from rustraytrace_tpu.models.scenes import _finish


def _image_quad_scene(mis=False):
    """A quad carrying an image texture (+ a quad light for MIS)."""
    b = SceneBuilder()
    img = np.stack(np.meshgrid(np.linspace(0.1, 0.9, 8),
                               np.linspace(0.2, 0.8, 4),
                               indexing="ij"), -1)
    img = np.concatenate([img, 0.5 * np.ones((8, 4, 1))], -1)
    tex = b.image_texture(np.ascontiguousarray(
        img.transpose(1, 0, 2), np.float32))
    b.add_quad((-2, 0, -3), (4, 0, 0), (0, 3, 0), b.lambertian(tex=tex))
    b.add_sphere((0.0, -100.5, -3.0), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    if mis:
        b.add_quad((-1, 4, -2), (2, 0, 0), (0, 0, 2),
                   b.diffuse_light((6.0, 6.0, 6.0)))
        b.add_light_quad((-1, 4, -2), (2, 0, 0), (0, 0, 2))
    cfg = RenderConfig(image_width=32, samples_per_pixel=8, max_depth=6,
                       background=(0.0, 0.0, 0.0) if mis else (0.7, 0.8, 1.0),
                       lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 1.0, -3.0))
    return _finish(b, cfg, "mis" if mis else "path", None)


def test_xla_image_on_quad_uv():
    """The XLA oracle itself: an image-textured quad renders with the
    planar (alpha, beta) as (u, v) — nearest-texel values must appear in
    the primary-hit radiance (validates the oracle tests/test_gpu.py compares the
    card against)."""
    from rustraytrace_tpu.render import render_pass

    scene, cfg, _ = _image_quad_scene()
    cam = derive_camera(cfg)
    w, h = cfg.image_width, cfg.image_height
    acc = np.asarray(render_pass(
        scene, cam, jax.random.key(0), width=w, height=h, spp=16,
        max_depth=4, integrator="path", chunk=w * h, backend="xla")) / 16
    assert np.all(np.isfinite(acc))
    assert acc.mean() > 0.01  # the quad is lit by the sky background
