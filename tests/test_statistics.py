"""Statistical estimator tests (SURVEY.md §4.5).

* The book-3 NEE/MIS estimator must agree with the plain path estimator in
  expectation (both unbiased for the same integral) and must not have HIGHER
  variance on the Cornell box — importance sampling toward the light is the
  entire point (the_rest_of_your_life/camera.rs:184-254).
* Russian roulette preserves the mean (weight 1/p on survival) — renders
  with RR active (depth past RR_START_BOUNCE) agree with a long
  truncation-free estimate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustraytrace_tpu import models
from rustraytrace_tpu.config import derive_camera
from rustraytrace_tpu.render import render_pass
from rustraytrace_tpu.parallel import make_mesh


@pytest.fixture(scope="module")
def cornell():
    scene, cfg, _ = models.book3_cornell_box(
        dict(image_width=24, samples_per_pixel=8, max_depth=8)
    )
    return scene, cfg


def _renders(scene, cfg, integrator, n_reps, spp, key0=0):
    cam = derive_camera(cfg)
    kw = dict(width=cfg.image_width, height=cfg.image_height, spp=spp,
              max_depth=cfg.max_depth, integrator=integrator, chunk=576,
              backend="xla")
    return np.stack([
        np.asarray(render_pass(scene, cam, jax.random.key(key0 + i), **kw)) / spp
        for i in range(n_reps)
    ])


def test_mis_mean_matches_plain(cornell):
    """Same integral, two estimators: means agree within joint MC error."""
    scene, cfg = cornell
    plain = _renders(scene, cfg, "path", n_reps=6, spp=16)
    mis = _renders(scene, cfg, "mis", n_reps=6, spp=16, key0=100)
    m_p = plain.mean()
    m_m = mis.mean()
    # plain Cornell at this spp is noisy; bound the relative gap loosely
    assert abs(m_p - m_m) / max(m_m, 1e-9) < 0.15, (m_p, m_m)


def test_mis_variance_not_worse(cornell):
    """Per-pixel variance of the MIS estimator <= plain estimator's
    (aggregate over pixels; NEE is a massive variance reduction here)."""
    scene, cfg = cornell
    plain = _renders(scene, cfg, "path", n_reps=6, spp=8)
    mis = _renders(scene, cfg, "mis", n_reps=6, spp=8, key0=100)
    var_plain = plain.var(axis=0).mean()
    var_mis = mis.var(axis=0).mean()
    assert var_mis < var_plain, (var_mis, var_plain)


def test_rr_preserves_mean():
    """Depth-20 render (RR active from bounce 5) agrees with a depth-6
    truncated render on a LOW-albedo scene where bounces past 6 carry
    negligible energy — isolates RR's reweighting from truncation bias."""
    scene, cfg, _ = models.book1_three_spheres(
        dict(image_width=32, samples_per_pixel=64)
    )
    cam = derive_camera(cfg)
    kw = dict(width=32, height=18, chunk=576, backend="xla")
    deep = np.asarray(render_pass(scene, cam, jax.random.key(0), spp=64,
                                  max_depth=20, **kw)) / 64
    shallow = np.asarray(render_pass(scene, cam, jax.random.key(7), spp=64,
                                     max_depth=6, **kw)) / 64
    assert abs(deep.mean() - shallow.mean()) / shallow.mean() < 0.03


def test_volumetric_mis_unbiased_vs_plain_path():
    """The MIS estimator WITH media (isotropic scatter lanes drawn
    from the NEE mixture) must estimate the same integral as the plain path
    estimator on the same smoke-Cornell scene — a distribution-level pin of
    the volumetric MIS weights (wrong 1/4π handling would shift the mean by
    ~2x, far outside the MC tolerance here)."""
    import jax
    import numpy as np

    from rustraytrace_tpu.config import derive_camera
    from rustraytrace_tpu.render import render_pass

    scene, cfg = _smoke_mis_scene()
    cam = derive_camera(cfg.replace(image_width=48))
    spp = 96
    kw = dict(width=48, height=48, spp=spp, max_depth=10, backend="xla")
    mis = np.asarray(render_pass(scene, cam, jax.random.key(2),
                                 integrator="mis", **kw)) / spp
    pth = np.asarray(render_pass(scene, cam, jax.random.key(5),
                                 integrator="path", **kw)) / spp
    m_m, m_p = float(mis.mean()), float(pth.mean())
    assert np.isfinite(mis).all() and m_m > 0.01
    assert abs(m_m - m_p) < 0.08 * m_p, (m_m, m_p)


def _smoke_mis_scene():
    """Cornell box + smoke medium box + NEE light: the volumetric-MIS
    combination (isotropic scatter lanes drawn from the NEE mixture)."""
    from rustraytrace_tpu.config import RenderConfig
    from rustraytrace_tpu.scene import SceneBuilder

    b = SceneBuilder()
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light((15.0, 15.0, 15.0))
    b.add_quad((555, 0, 0), (0, 0, 555), (0, 555, 0), green)
    b.add_quad((0, 0, 555), (0, 0, -555), (0, 555, 0), red)
    b.add_quad((0, 555, 0), (555, 0, 0), (0, 0, 555), white)
    b.add_quad((0, 0, 555), (555, 0, 0), (0, 0, -555), white)
    b.add_quad((555, 0, 555), (-555, 0, 0), (0, 555, 0), white)
    b.add_quad((213, 554, 227), (130, 0, 0), (0, 0, 105), light)
    b.add_medium_box((0, 0, 0), (165, 330, 165), 0.01,
                     b.isotropic((0.0, 0.0, 0.0)), rotate_y_deg=15.0,
                     translate=(265, 0, 295))
    b.add_sphere((190, 90, 190), 90.0, b.dielectric(1.5))
    b.add_light_quad((343, 554, 332), (-130, 0, 0), (0, 0, -105))
    cfg = RenderConfig(
        aspect_ratio=1.0, image_width=96, samples_per_pixel=64,
        max_depth=12, background=(0.0, 0.0, 0.0), vfov=40.0,
        lookfrom=(278.0, 278.0, -800.0), lookat=(278.0, 278.0, 0.0))
    return b.build(), cfg
