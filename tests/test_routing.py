"""Backend routing: ``render.resolve_backend``'s decision table.

'auto' takes the closest-hit kernel only for box-free 'path' scenes when
JAX's default backend is the GPU; every other case runs the XLA path.
The platform is monkeypatched, so the table is checked without a card.
"""

import functools

import pytest

from rustraytrace_tpu import models, render
from rustraytrace_tpu.models.scenes import SCENES

# one name per scene builder (the registry also holds book aliases)
CATALOG = sorted({fn: name for name, fn in reversed(SCENES.items())}.values())


@functools.lru_cache(maxsize=None)
def _scene(name):
    scene, _, integ = models.get_scene(name, dict(image_width=16))
    return scene, integ


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("integrator", ["path", "mis"])
@pytest.mark.parametrize("name", CATALOG)
def test_auto_route(name, integrator, platform, monkeypatch):
    monkeypatch.setattr(render.jax, "default_backend", lambda: platform)
    scene, _ = _scene(name)
    want = ("sphere_kernel" if platform == "gpu" and integrator == "path"
            and "boxes" not in scene.features else "xla")
    assert render.resolve_backend(scene, integrator) == want


def test_catalog_routes_on_gpu(monkeypatch):
    """Each scene's own integrator: the flagship and every box-free path
    scene take the kernel; book 3 (MIS) and book2_final (boxes) stay XLA."""
    monkeypatch.setattr(render.jax, "default_backend", lambda: "gpu")
    routes = {name: render.resolve_backend(*_scene(name)) for name in CATALOG}
    assert routes["book1_random_spheres"] == "sphere_kernel"
    assert routes["book3_cornell_box"] == "xla"
    assert routes["book2_final_scene"] == "xla"


def test_explicit_backend_validated():
    scene, _ = _scene("book1_three_spheres")
    assert render.resolve_backend(scene, "path", "xla") == "xla"
    assert render.resolve_backend(scene, "mis", "xla") == "xla"
    assert (render.resolve_backend(scene, "path", "sphere_kernel")
            == "sphere_kernel")
    with pytest.raises(ValueError):
        render.resolve_backend(scene, "path", "megakernel")
    with pytest.raises(ValueError):
        render.resolve_backend(scene, "mis", "sphere_kernel")
