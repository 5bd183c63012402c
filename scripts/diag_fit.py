#!/usr/bin/env python
"""Instrumented inverse-rendering fit: logs params/grad norms per step to
find where/why the recovery diverges.
"""

import sys

import jax

if "gpu" not in sys.argv:  # pass "gpu" to run on the card
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp
import optax

from rustraytrace_tpu import RenderConfig, SceneBuilder
from rustraytrace_tpu.config import derive_camera
from rustraytrace_tpu.diff import (extract_params, render_mean,
                                   value_and_grad_loss)
from rustraytrace_tpu.parallel import make_mesh


def build_scene(albedo, center):
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.6, 0.6, 0.6)))
    b.add_sphere(center, 0.5, b.lambertian(albedo))
    b.add_sphere((1.2, 0.0, -1.4), 0.4, b.metal((0.8, 0.8, 0.8), 0.1))
    return b.build()


def main():
    steps = int(sys.argv[sys.argv.index("--steps") + 1]) if "--steps" in sys.argv else 250
    true_albedo = (0.75, 0.25, 0.15)
    true_center = (-0.1, 0.05, -1.2)
    cfg = RenderConfig(aspect_ratio=16 / 9, image_width=64,
                       samples_per_pixel=16, max_depth=4, vfov=60.0,
                       lookfrom=(0, 0.3, 0.6), lookat=(0, 0, -1), seed=3)
    mesh = make_mesh()
    cam = derive_camera(cfg)
    kw = dict(width=cfg.image_width, height=cfg.image_height, spp=16,
              max_depth=4, mesh=mesh, chunk=4096)

    true_scene = build_scene(true_albedo, true_center)
    target = render_mean(true_scene, cam, jax.random.key(42), **kw)

    scene = build_scene((0.2, 0.5, 0.7), (0.12, -0.1, -1.25))
    params = extract_params(scene, ["sph_center", "tex_color1"])

    masks = {
        "sph_center": np.zeros_like(np.asarray(scene.sph_center)),
        "tex_color1": np.zeros_like(np.asarray(scene.tex_color1)),
    }
    masks["sph_center"][1, 0:3] = 1.0
    masks["tex_color1"][1] = 1.0
    masks = {k: jnp.asarray(v) for k, v in masks.items()}

    def row_mask():
        def update(updates, state, params=None):
            return {k: u * masks[k] for k, u in updates.items()}, state
        return optax.GradientTransformation(
            lambda p: optax.EmptyState(), update)

    opt = optax.chain(
        optax.zero_nans(),
        optax.clip_by_global_norm(1.0),
        row_mask(),
        optax.multi_transform(
            {"alb": optax.adam(0.03), "ctr": optax.adam(0.004)},
            {"tex_color1": "alb", "sph_center": "ctr"}),
    )
    opt_state = opt.init(params)

    @jax.jit
    def update_step(grads, opt_state, params):
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    key = jax.random.key(cfg.seed + 1)
    for step in range(steps):
        key, sub = jax.random.split(key)
        loss, g = value_and_grad_loss(scene, params, target, cam, sub, **kw)
        params, opt_state = update_step(g, opt_state, params)
        if step % 5 == 0 or step == steps - 1 or 40 <= step <= 80:
            c = np.asarray(params["sph_center"])[1]
            a = np.asarray(params["tex_color1"])[1]
            gc = np.asarray(g["sph_center"])[1]
            ga = np.asarray(g["tex_color1"])[1]
            print(f"{step:4d} loss={float(loss):.4e} "
                  f"c=({c[0]:+.3f},{c[1]:+.3f},{c[2]:+.3f}) "
                  f"a=({a[0]:.3f},{a[1]:.3f},{a[2]:.3f}) "
                  f"gc=({gc[0]:+.2e},{gc[1]:+.2e},{gc[2]:+.2e}) "
                  f"|ga|={np.abs(ga).max():.2e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
