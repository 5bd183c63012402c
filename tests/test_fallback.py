"""No hidden fallback: a failing pass raises out of both pass loops, and
the pass size is exactly what the config asks for."""

import jax
import pytest

from rustraytrace_tpu import models
from rustraytrace_tpu.parallel import make_mesh, render_image_sharded
from rustraytrace_tpu.render import render_image


@pytest.fixture(scope="module")
def small():
    scene, cfg, integ = models.book1_three_spheres(
        dict(image_width=32, samples_per_pixel=4, max_depth=4,
             spp_per_pass=2)
    )
    return scene, cfg.replace(aspect_ratio=2.0), integ  # 32x16


def test_render_image_pass_failure_raises(small, monkeypatch):
    """A failing pass propagates; nothing re-runs it on another backend."""
    import rustraytrace_tpu.render as r

    calls = []

    def failing(*a, **kw):
        calls.append(kw["backend"])
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(r, "render_pass", failing)
    scene, cfg, integ = small
    with pytest.raises(RuntimeError, match="injected device failure"):
        render_image(scene, cfg, integrator=integ, chunk=256)
    assert len(calls) == 1


def test_render_image_sharded_pass_failure_raises(small, monkeypatch):
    """The sharded loop keeps the completed passes' state and raises on the
    failing one."""
    import rustraytrace_tpu.parallel.render as pr

    real = pr.render_pass_sharded
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected mid-render device failure")
        return real(*a, **kw)

    monkeypatch.setattr(pr, "render_pass_sharded", flaky)
    scene, cfg, integ = small
    states = []
    with pytest.raises(RuntimeError, match="mid-render"):
        render_image_sharded(scene, cfg, mesh=make_mesh(jax.devices()),
                             integrator=integ, chunk=256,
                             on_pass=states.append)
    assert [s["spp_done"] for s in states] == [2]


def test_no_fallback_argument(small):
    scene, cfg, integ = small
    with pytest.raises(TypeError):
        render_image(scene, cfg, integrator=integ, fallback=True)


def test_effective_spp_per_pass_folding():
    """The AUTO default (spp_per_pass=0) renders 16 samples per pass on
    every backend; an EXPLICIT spp_per_pass is honored exactly in both
    directions, and no pass traces more samples than the render needs."""
    from rustraytrace_tpu.config import RenderConfig
    from rustraytrace_tpu.render import (DEFAULT_SPP_PER_PASS,
                                         effective_spp_per_pass)

    auto = RenderConfig(image_width=400, aspect_ratio=16 / 9,
                        samples_per_pixel=100)
    assert DEFAULT_SPP_PER_PASS == 16
    assert effective_spp_per_pass(auto, 100) == 16
    assert effective_spp_per_pass(auto, 5) == 5
    explicit = RenderConfig(image_width=16, samples_per_pixel=100000,
                            spp_per_pass=4096)
    assert effective_spp_per_pass(explicit, 100000) == 4096
    fine = RenderConfig(image_width=400, samples_per_pixel=100,
                        spp_per_pass=4)
    assert effective_spp_per_pass(fine, 100) == 4
    assert effective_spp_per_pass(fine, 1) == 1
