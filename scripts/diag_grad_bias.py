#!/usr/bin/env python
"""Mean gradient at the TRUE parameters over many keys: nonzero mean =>
the per-step loss gradient has a systematic component at the optimum
(e.g. the MC-variance term of ||noisy render - fixed target||^2)."""

import sys

import jax

if "gpu" not in sys.argv:  # pass "gpu" to run on the card
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from rustraytrace_tpu import RenderConfig, SceneBuilder
from rustraytrace_tpu.config import derive_camera
from rustraytrace_tpu.diff import (extract_params, render_mean,
                                   value_and_grad_loss)
from rustraytrace_tpu.parallel import make_mesh


def build_scene(albedo, center):
    import sys as _s
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.6, 0.6, 0.6)))
    b.add_sphere(center, 0.5, b.lambertian(albedo))
    b.add_sphere((1.2, 0.0, -1.4), 0.4, b.metal((0.8, 0.8, 0.8), 0.1))
    return b.build()


def build_scene_raised(albedo, center):
    """Sphere floated clear of the ground (1.6 radii): the shadow/AO
    contact term — a SECONDARY silhouette the warp does not cover — is
    small, so the primary-silhouette estimator should be unbiased here."""
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.6, 0.6, 0.6)))
    b.add_sphere(center, 0.5, b.lambertian(albedo))
    b.add_sphere((1.6, 0.5, -1.9), 0.4, b.metal((0.8, 0.8, 0.8), 0.1))
    return b.build()


def main():
    spp = int(sys.argv[sys.argv.index("--spp") + 1]) if "--spp" in sys.argv else 16
    n_keys = int(sys.argv[sys.argv.index("--keys") + 1]) if "--keys" in sys.argv else 16
    cfg = RenderConfig(aspect_ratio=16 / 9, image_width=64,
                       samples_per_pixel=spp, max_depth=4, vfov=60.0,
                       lookfrom=(0, 0.3, 0.6), lookat=(0, 0, -1), seed=3)
    mesh = make_mesh()
    cam = derive_camera(cfg)
    kw = dict(width=cfg.image_width, height=cfg.image_height, spp=spp,
              max_depth=4, mesh=mesh, chunk=4096)

    mk = build_scene_raised if "--raised" in sys.argv else build_scene
    t_center = (-0.1, 0.45, -1.2) if "--raised" in sys.argv else (-0.1, 0.05, -1.2)
    true_scene = mk((0.75, 0.25, 0.15), t_center)
    target = render_mean(true_scene, cam, jax.random.key(42), **kw)
    if "--at45" in sys.argv:
        # the instrumented fit's step-45 state (where the runaway begins)
        eval_scene = mk((0.755, 0.340, 0.249),
                        tuple(np.add(t_center, (0.036, 0.016, 0.14))))
    else:
        eval_scene = true_scene
    params = extract_params(eval_scene, ["sph_center", "tex_color1"])

    gcs, gas, losses = [], [], []
    for k in range(n_keys):
        loss, g = value_and_grad_loss(eval_scene, params, target, cam,
                                      jax.random.key(1000 + k), **kw)
        gcs.append(np.asarray(g["sph_center"])[1])
        gas.append(np.asarray(g["tex_color1"])[1])
        losses.append(float(loss))
    gcs = np.stack(gcs)
    gas = np.stack(gas)
    n = len(gcs)
    print(f"spp={spp} keys={n} loss={np.mean(losses):.4e}")
    print("mean g_center =", gcs.mean(0), "+/-", gcs.std(0) / np.sqrt(n))
    print("mean g_albedo =", gas.mean(0), "+/-", gas.std(0) / np.sqrt(n))

    if "--fd" in sys.argv:
        # FD of E_keys[loss] with common random numbers across +/- eps
        import dataclasses
        import jax.numpy as jnp
        from rustraytrace_tpu.diff import image_loss

        def mean_loss(sc):
            tot = 0.0
            for k in range(n_keys):
                tot += float(image_loss(sc, target, cam,
                                        jax.random.key(1000 + k), **kw))
            return tot / n_keys

        eps = 0.02
        for axis, name in [(0, "cx"), (1, "cy"), (2, "cz")]:
            ctr = np.asarray(eval_scene.sph_center).copy()
            ctr_p, ctr_m = ctr.copy(), ctr.copy()
            ctr_p[1, axis] += eps
            ctr_m[1, axis] -= eps
            lp = mean_loss(dataclasses.replace(
                eval_scene, sph_center=jnp.asarray(ctr_p)))
            lm = mean_loss(dataclasses.replace(
                eval_scene, sph_center=jnp.asarray(ctr_m)))
            print(f"FD {name}: {(lp - lm) / (2 * eps):+.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
