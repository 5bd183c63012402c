"""Multi-device sharding tests on the 8-virtual-device CPU mesh (SURVEY.md §4.4).

The key invariant: sharding is an EXECUTION choice, not a semantics choice.
Pixel-sharded renders must be bit-identical to single-device renders (same key
derivation per (sample, chunk) unit); spp-sharded renders agree up to f32
summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from rustraytrace_tpu import models
from rustraytrace_tpu.config import derive_camera
from rustraytrace_tpu.parallel import make_mesh, render_pass_sharded, render_image_sharded
from rustraytrace_tpu.parallel.render import spp_traced
from rustraytrace_tpu.render import render_image, render_pass


CHUNK = 256  # shared by both paths so (sample, chunk) keys coincide


@pytest.fixture(scope="module")
def small_scene():
    scene, cfg, integ = models.book1_three_spheres(
        dict(image_width=32, samples_per_pixel=4, max_depth=5, spp_per_pass=4)
    )
    cfg = cfg.replace(aspect_ratio=2.0)  # 32x16
    return scene, cfg, integ


def test_pixel_sharded_bit_identical(small_scene):
    scene, cfg, _ = small_scene
    cam = derive_camera(cfg)
    key = jax.random.key(7)
    kw = dict(width=cfg.image_width, height=cfg.image_height, spp=4,
              max_depth=5, chunk=CHUNK)

    single = render_pass(scene, cam, key, **kw)
    mesh = make_mesh(jax.devices())  # (8, 1): all pixel-sharded
    assert mesh.shape == {"px": 8, "spp": 1}
    sharded = render_pass_sharded(scene, cam, key, mesh=mesh, **kw)

    np.testing.assert_array_equal(np.asarray(single), np.asarray(sharded))


def test_spp_sharded_allclose(small_scene):
    scene, cfg, _ = small_scene
    cam = derive_camera(cfg)
    key = jax.random.key(7)
    kw = dict(width=cfg.image_width, height=cfg.image_height, spp=4,
              max_depth=5, chunk=CHUNK)

    single = render_pass(scene, cam, key, **kw)
    mesh = make_mesh(jax.devices(), spp_shards=2)  # (4, 2)
    assert spp_traced(4, mesh) == 4
    sharded = render_pass_sharded(scene, cam, key, mesh=mesh, **kw)

    np.testing.assert_allclose(
        np.asarray(single), np.asarray(sharded), rtol=1e-5, atol=1e-5
    )


def test_spp_round_up():
    mesh = make_mesh(jax.devices(), spp_shards=2)
    assert spp_traced(5, mesh) == 6


def test_render_image_sharded_matches_single(small_scene):
    scene, cfg, integ = small_scene
    # both loops route 'auto' through render.resolve_backend (the XLA path
    # on the CPU mesh), so the images are bit-identical
    img1, st1 = render_image(scene, cfg, integrator=integ, chunk=CHUNK)
    mesh = make_mesh(jax.devices())
    img8, st8 = render_image_sharded(
        scene, cfg, mesh=mesh, integrator=integ, chunk=CHUNK
    )
    assert st1["spp_done"] == st8["spp_done"]
    np.testing.assert_array_equal(img1, img8)


def test_sharded_routing_decision_table(small_scene, monkeypatch):
    """The sharded loop routes through render.resolve_backend — the same
    table as the single-device loop — and rejects what it rejects."""
    import rustraytrace_tpu.parallel.render as pr
    from rustraytrace_tpu import render as render_mod

    scene, cfg, integ = small_scene
    mesh = make_mesh(jax.devices())
    seen = []
    real = pr.render_pass_sharded

    def spy(*a, **kw):
        seen.append(kw["backend"])
        return real(*a, **kw)

    monkeypatch.setattr(pr, "render_pass_sharded", spy)
    render_image_sharded(scene, cfg, mesh=mesh, integrator=integ, chunk=CHUNK)
    assert seen and set(seen) == {"xla"}  # auto on the CPU mesh
    monkeypatch.setattr(render_mod.jax, "default_backend", lambda: "gpu")
    assert render_mod.resolve_backend(scene, integ) == "sphere_kernel"
    with pytest.raises(ValueError):
        render_image_sharded(scene, cfg, mesh=mesh, integrator=integ,
                             chunk=CHUNK, backend="megakernel")
    with pytest.raises(ValueError):
        render_image_sharded(scene, cfg, mesh=mesh, integrator="mis",
                             chunk=CHUNK, backend="sphere_kernel")


def test_mis_integrator_sharded(small_scene):
    """The book-3 MIS estimator also runs under shard_map."""
    scene, cfg, _ = models.book3_cornell_box(
        dict(image_width=16, samples_per_pixel=4, max_depth=4)
    )
    cam = derive_camera(cfg)
    key = jax.random.key(3)
    kw = dict(width=cfg.image_width, height=cfg.image_height, spp=4,
              max_depth=4, chunk=CHUNK, integrator="mis")
    single = render_pass(scene, cam, key, **kw)
    mesh = make_mesh(jax.devices())
    sharded = render_pass_sharded(scene, cam, key, mesh=mesh, **kw)
    np.testing.assert_array_equal(np.asarray(single), np.asarray(sharded))
