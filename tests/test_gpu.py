"""Checks that need the card: the Triton kernel compiled for the GPU, and
GPU renders against the in-process CPU backend's XLA reference.

Marked ``gpu``: skipped unless JAX's default backend is the GPU; run on the
card by ``chip_smoke.py`` (``pytest -m gpu tests/`` in its process).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustraytrace_tpu import models, render
from rustraytrace_tpu.config import derive_camera

pytestmark = pytest.mark.gpu


def _cpu_mean(build, cfg, integrator):
    """Radiance mean of the same render on the CPU backend's XLA path."""
    with jax.default_device(jax.devices("cpu")[0]):
        scene = build()
        _, st = render.render_image(scene, cfg, integrator=integrator,
                                    backend="xla")
    return float(st["accum"].mean() / st["spp_done"])


@pytest.mark.parametrize("n", [1, 129, 4097, 65536])
def test_kernel_compiled_matches_xla(n):
    from rustraytrace_tpu.ops.intersect import T_MAX, T_MIN, hit_spheres
    from rustraytrace_tpu.ops.pallas_hit import kernel_hits

    scene, cfg, _ = models.book1_random_spheres()
    cam = derive_camera(cfg)
    pix = jnp.arange(n) * (cfg.image_width * cfg.image_height // n)
    from rustraytrace_tpu.camera import generate_rays

    o, d, tm = generate_rays(
        cam, (pix % cfg.image_width).astype(jnp.float32),
        (pix // cfg.image_width).astype(jnp.float32),
        jax.random.uniform(jax.random.key(n), (n, 5)), None)
    t, idx = kernel_hits(o, d, tm, scene)
    _, i_r, hit = hit_spheres(o, d, tm, scene, jnp.full((n,), T_MIN),
                              jnp.full((n,), T_MAX))
    i_r = np.where(np.asarray(hit), np.asarray(i_r), -1)
    assert (np.asarray(idx) == i_r).mean() >= (0.999 if n > 1000 else 1.0)
    assert np.isfinite(np.asarray(t)).all()


def test_kernel_render_matches_xla_render():
    """Same key, same streams: the kernel route and the XLA route render
    the same image up to rare f32 branch flips."""
    scene, cfg, _ = models.book1_three_spheres(
        dict(image_width=64, samples_per_pixel=16, max_depth=8))
    cam = derive_camera(cfg)
    kw = dict(width=cfg.image_width, height=cfg.image_height, spp=16,
              max_depth=8, chunk=4096)
    a = np.asarray(render.render_pass(scene, cam, jax.random.key(0),
                                      backend="sphere_kernel", **kw)) / 16
    b = np.asarray(render.render_pass(scene, cam, jax.random.key(0),
                                      backend="xla", **kw)) / 16
    assert np.isfinite(a).all()
    assert abs(a.mean() - b.mean()) < 1e-3 * b.mean()
    assert (np.abs(a - b).max(axis=-1) < 1e-2).mean() > 0.99


def test_image_on_quad_matches_cpu():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_round3 import _image_quad_scene

    scene, cfg, integ = _image_quad_scene()
    assert render.resolve_backend(scene, integ) == "sphere_kernel"
    _, st = render.render_image(scene, cfg, integrator=integ)
    m_gpu = float(st["accum"].mean() / st["spp_done"])
    m_cpu = _cpu_mean(lambda: _image_quad_scene()[0], cfg, integ)
    assert m_gpu > 0.01
    assert abs(m_gpu - m_cpu) < 0.02 * m_cpu, (m_gpu, m_cpu)


def test_mis_matches_cpu():
    scene, cfg, integ = models.book3_cornell_box(
        dict(image_width=48, samples_per_pixel=16, max_depth=8))
    assert integ == "mis" and render.resolve_backend(scene, integ) == "xla"
    _, st = render.render_image(scene, cfg, integrator=integ)
    m_gpu = float(st["accum"].mean() / st["spp_done"])
    m_cpu = _cpu_mean(lambda: models.book3_cornell_box(
        dict(image_width=48))[0], cfg, integ)
    assert abs(m_gpu - m_cpu) < 0.02 * m_cpu, (m_gpu, m_cpu)


def test_sharded_pass_on_card_matches_single():
    from rustraytrace_tpu.parallel import make_mesh, render_pass_sharded

    scene, cfg, _ = models.book1_three_spheres(
        dict(image_width=64, samples_per_pixel=4, max_depth=6))
    cam = derive_camera(cfg)
    kw = dict(width=cfg.image_width, height=cfg.image_height, spp=4,
              max_depth=6, chunk=1024, backend="sphere_kernel")
    one = render.render_pass(scene, cam, jax.random.key(3), **kw)
    sh = render_pass_sharded(scene, cam, jax.random.key(3),
                             mesh=make_mesh(jax.devices()[:1]), **kw)
    # same samples and keys; XLA may fuse the two programs differently
    np.testing.assert_allclose(np.asarray(sh), np.asarray(one), rtol=1e-5,
                               atol=1e-5)
