"""Integrator golden tests: JAX renderer vs the independent NumPy oracle,
compared on sample means within Monte-Carlo tolerance (the implementations
use different RNG streams by design)."""

import numpy as np
import pytest

from rustraytrace_tpu import models, render
from oracle import OracleSphere, render_oracle

W, H = 24, 14
SPP = 400


@pytest.fixture(scope="module")
def jax_vs_oracle():
    scene, cfg, integ = models.book1_three_spheres(
        {"image_width": W, "aspect_ratio": W / H, "samples_per_pixel": SPP,
         "max_depth": 16, "spp_per_pass": 100}
    )
    img_u8, state = render.render_image(scene, cfg, integrator=integ, chunk=512)
    jax_mean = state["accum"] / state["spp_done"]

    spheres = [
        OracleSphere((0, -100.5, -1), 100.0, "lam", (0.8, 0.8, 0.0)),
        OracleSphere((0, 0, -1.2), 0.5, "lam", (0.1, 0.2, 0.5)),
        OracleSphere((-1, 0, -1), 0.5, "diel", ior=1.5),
        OracleSphere((1, 0, -1), 0.5, "metal", (0.8, 0.6, 0.2), fuzz=0.0),
    ]
    oracle_mean = render_oracle(
        spheres, W, H, SPP, 16, vfov=90.0, lookfrom=(0, 0, 0),
        lookat=(0, 0, -1), focus_dist=1.0,
    )
    return np.asarray(jax_mean), oracle_mean


def test_image_mean_matches_oracle(jax_vs_oracle):
    jax_mean, oracle_mean = jax_vs_oracle
    # aggregate means must agree tightly (MC error of the aggregate is tiny)
    np.testing.assert_allclose(
        jax_mean.mean(axis=(0, 1)), oracle_mean.mean(axis=(0, 1)), atol=0.015
    )


def test_per_pixel_matches_oracle(jax_vs_oracle):
    jax_mean, oracle_mean = jax_vs_oracle
    err = np.abs(jax_mean - oracle_mean)
    # per-pixel MC std at 400 spp is ~0.025; allow 6 sigma plus bias slack
    assert np.quantile(err, 0.95) < 0.1
    assert err.mean() < 0.03


def test_render_deterministic():
    scene, cfg, integ = models.book1_three_spheres(
        {"image_width": 16, "samples_per_pixel": 8, "max_depth": 6,
         "spp_per_pass": 8, "seed": 42}
    )
    img1, _ = render.render_image(scene, cfg, integrator=integ, chunk=256)
    img2, _ = render.render_image(scene, cfg, integrator=integ, chunk=256)
    np.testing.assert_array_equal(img1, img2)


def test_chunk_size_invariance():
    """The chunked scan must not change results: rays are seeded by absolute
    (sample, chunk) position only through fold_in of the chunk index — so use
    the same chunk count but verify pass-splitting invariance instead."""
    scene, cfg, integ = models.book1_three_spheres(
        {"image_width": 16, "samples_per_pixel": 16, "max_depth": 6, "seed": 3}
    )
    img_a, state_a = render.render_image(
        scene, cfg.replace(spp_per_pass=16), integrator=integ, chunk=256
    )
    img_b, state_b = render.render_image(
        scene, cfg.replace(spp_per_pass=4), integrator=integ, chunk=256
    )
    # identical sample streams regardless of pass batching
    np.testing.assert_allclose(state_a["accum"], state_b["accum"], rtol=1e-4, atol=1e-4)


def test_resume_accumulation():
    scene, cfg, integ = models.book1_three_spheres(
        {"image_width": 16, "samples_per_pixel": 8, "max_depth": 6,
         "spp_per_pass": 4, "seed": 9}
    )
    img_full, state_full = render.render_image(scene, cfg, integrator=integ, chunk=256)
    # render half, checkpoint, resume
    cfg_half = cfg.replace(samples_per_pixel=4)
    _, state_half = render.render_image(scene, cfg_half, integrator=integ, chunk=256)
    img_resumed, state_resumed = render.render_image(
        scene, cfg, integrator=integ, chunk=256, accum_state=state_half
    )
    assert state_resumed["spp_done"] == 8
    np.testing.assert_allclose(state_full["accum"], state_resumed["accum"],
                               rtol=1e-4, atol=1e-4)


def test_background_flat_vs_sky():
    scene, cfg, integ = models.book1_three_spheres(
        {"image_width": 8, "samples_per_pixel": 4, "max_depth": 4,
         "background": (1.0, 0.0, 0.0), "spp_per_pass": 4}
    )
    img, _ = render.render_image(scene, cfg, integrator=integ, chunk=64)
    # top rows are pure background: red channel dominant
    top = img[0].astype(np.int32)
    assert (top[:, 0] > 200).all() and (top[:, 2] < 60).all()
