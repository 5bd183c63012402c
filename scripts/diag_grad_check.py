#!/usr/bin/env python
"""Compare value_and_grad_loss output between platforms / against FD.

    python scripts/diag_grad_check.py [cpu|gpu] [fd]
"""

import sys

import numpy as np


def main() -> int:
    dev = sys.argv[1] if len(sys.argv) > 1 else "gpu"
    import jax

    if dev == "cpu":
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from rustraytrace_tpu.config import RenderConfig, derive_camera
    from rustraytrace_tpu.diff import (extract_params, render_mean,
                                       value_and_grad_loss)
    from rustraytrace_tpu.parallel import make_mesh
    from rustraytrace_tpu.scene import SceneBuilder

    def build(center1=(-0.1, 0.05, -1.2), alb=(0.75, 0.25, 0.15)):
        b = SceneBuilder()
        b.add_sphere((0.0, -100.5, -1.0), 100.0,
                     b.lambertian((0.6, 0.6, 0.6)))
        b.add_sphere(center1, 0.5, b.lambertian(alb))
        b.add_sphere((1.2, 0.0, -1.4), 0.4, b.metal((0.8, 0.8, 0.8), 0.1))
        return b.build()

    cfg = RenderConfig(aspect_ratio=16 / 9, image_width=64,
                       samples_per_pixel=16, max_depth=4, vfov=60.0,
                       lookfrom=(0, 0.3, 0.6), lookat=(0, 0, -1), seed=3)
    cam = derive_camera(cfg)
    mesh = make_mesh()
    kw = dict(width=cfg.image_width, height=cfg.image_height, spp=16,
              max_depth=4, mesh=mesh, chunk=4096)

    true_scene = build()
    target = render_mean(true_scene, cam, jax.random.key(42), **kw)
    np.asarray(target)

    wrong = build(center1=(0.12, -0.1, -1.25), alb=(0.2, 0.5, 0.7))
    params = extract_params(wrong, ["sph_center", "tex_color1"])
    key = jax.random.key(1)

    loss, g = value_and_grad_loss(wrong, params, target, cam, key, **kw)
    print(f"platform={jax.devices()[0].platform} loss={float(loss):.6f}")
    print("g_center[1] =", np.asarray(g["sph_center"])[1])
    print("g_alb[1]    =", np.asarray(g["tex_color1"])[1])

    if "fd" in sys.argv:
        # central finite differences on the albedo-R and center-x entries
        from rustraytrace_tpu.diff import image_loss

        def loss_at(**delta):
            import dataclasses
            sc = wrong
            for name, (idx, eps) in delta.items():
                arr = np.asarray(getattr(sc, name)).copy()
                arr[idx] += eps
                sc = dataclasses.replace(sc, **{name: jnp.asarray(arr)})
            return float(image_loss(sc, target, cam, key, **kw))

        for name, idx in [("tex_color1", (1, 0)), ("sph_center", (1, 0)),
                          ("sph_center", (1, 2))]:
            eps = 1e-2
            lp = loss_at(**{name: (idx, eps)})
            lm = loss_at(**{name: (idx, -eps)})
            print(f"FD {name}{idx}: {(lp - lm) / (2 * eps):.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
