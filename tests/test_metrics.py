"""Metrics / multihost scaffolding tests."""

import json

import jax
import numpy as np

from rustraytrace_tpu import models
from rustraytrace_tpu.parallel.multihost import (
    global_mesh,
    initialize,
    render_image_multihost,
)
from rustraytrace_tpu.utils.metrics import RenderMeter, time_best


def test_render_meter():
    m = RenderMeter(n_pixels=100).start()
    m.lap(4)
    m.lap(4)
    assert m.total_paths == 800
    line = json.loads(m.json_line(scene="x"))
    assert line["passes"] == 2 and line["scene"] == "x"
    assert line["paths_per_sec"] > 0


def test_time_best_waits_for_the_result():
    """time_best blocks on every rep's result and returns the best rep."""
    reps = []
    x = jax.numpy.ones((64, 64))
    f = jax.jit(lambda a: a @ a)
    f(x)
    best = time_best(lambda: f(x), repeats=3,
                     on_rep=lambda i, dt: reps.append((i, dt)))
    assert [i for i, _ in reps] == [0, 1, 2]
    assert best == min(dt for _, dt in reps) > 0.0


def test_multihost_single_process_path():
    """initialize() is a no-op single-process; the multihost render runs on
    the 8-virtual-device mesh and matches the plain sharded render."""
    initialize(num_processes=1)
    mesh = global_mesh()
    assert mesh.shape["px"] * mesh.shape["spp"] == len(jax.devices())
    scene, cfg, integ = models.book1_three_spheres(
        dict(image_width=16, samples_per_pixel=2, max_depth=2)
    )
    img, state = render_image_multihost(scene, cfg, integrator=integ,
                                        chunk=256)
    assert img.shape[1] == 16
    assert state["spp_done"] == 2
