"""Regression tests: pole-UV gradient guard, full-buffer checkpoint
fingerprints, stratified sample-index wrapping, and CLI book-name
normalization (reference main.rs:7-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustraytrace_tpu import models
from rustraytrace_tpu.config import derive_camera
from rustraytrace_tpu.render import trace_rays


def test_sphere_uv_pole_gradients_finite():
    """arccos at the poles must not emit inf/NaN into the backward pass
    (advisor: 1-1e-12 rounds to 1.0 in f32, so the old clip was a no-op)."""
    from rustraytrace_tpu.ops.intersect import sphere_uv

    def loss(outward):
        u, v = sphere_uv(outward)
        return jnp.sum(u + v)

    # exact poles, out-of-range junk (gathered from non-sphere lanes), interior
    outward = jnp.asarray(
        [[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [3.0, -7.0, 1.0],
         [0.5, 0.5, 0.70710678]], jnp.float32)
    u, v = sphere_uv(outward)
    np.testing.assert_allclose(np.asarray(v[0]), 1.0, atol=1e-6)  # top pole
    np.testing.assert_allclose(np.asarray(v[1]), 0.0, atol=1e-6)
    g = jax.grad(loss)(outward)
    assert np.isfinite(np.asarray(g)).all()


def test_checkpoint_fingerprint_covers_whole_buffer():
    """Scenes differing only past the first 4KB of an array must fingerprint
    differently (advisor: the old hash truncated each leaf at 4096 bytes)."""
    from rustraytrace_tpu.utils.checkpoint import _fingerprint

    scene, cfg, _ = models.book1_random_spheres(dict(image_width=8))
    assert scene.sph_center.size * 4 > 4096  # the failure needs a big leaf
    import dataclasses

    scene2 = dataclasses.replace(
        scene, sph_center=scene.sph_center.at[-1, 0].add(1.0))
    assert _fingerprint(cfg, scene) != _fingerprint(cfg, scene2)


def test_stratified_sample_index_wraps():
    """s_idx beyond sqrt_spp^2 (spp-sharded round-up) must wrap into the
    sub-pixel grid, not jitter outside the pixel footprint."""
    scene, cfg, _ = models.book1_three_spheres(dict(image_width=16))
    cam = derive_camera(cfg)
    px = jnp.arange(16, dtype=jnp.float32)
    py = jnp.zeros(16, jnp.float32)
    key = jax.random.key(5)
    kw = dict(max_depth=3, stratified=True, sqrt_spp=3)
    r_wrapped = trace_rays(scene, cam, key, jnp.asarray(9), px, py, **kw)
    r_base = trace_rays(scene, cam, key, jnp.asarray(0), px, py, **kw)
    np.testing.assert_array_equal(np.asarray(r_wrapped), np.asarray(r_base))


@pytest.mark.parametrize("raw,expected", [
    ("OneWeekend", "in_one_weekend"),
    ("in-one-weekend", "in_one_weekend"),
    ("weekend", "in_one_weekend"),
    ("NextWeek", "the_next_week"),
    ("book2", "the_next_week"),
    ("REST", "the_rest_of_your_life"),
    ("restoflife", "the_rest_of_your_life"),
    ("Book2-Earth", "book2_earth"),
    ("book3_cornell_box", "book3_cornell_box"),
])
def test_book_name_normalization(raw, expected):
    from rustraytrace_tpu.models.scenes import normalize_scene_name

    assert normalize_scene_name(raw) == expected
