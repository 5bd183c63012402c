"""Inverse rendering demo — BASELINE config 4.

Recovers a sphere's ALBEDO and its full 3-D CENTER from a rendered target
image by gradient descent through the differentiable renderer (diff.py):
render a target with the true scene, perturb the parameters, run
per-parameter Adam on the MSE in linear radiance space, and GATE the exit
code on both recoveries.

Gradient classes at work:
* material/texture parameters (albedos, colors) — strong smooth interior
  gradients, recover to a few percent;
* geometry parameters (center, incl. DEPTH) — need the silhouette boundary
  term, supplied by the warped-area reparameterization (ops/warp.py,
  on by default in diff.render_mean); plain interior AD cannot see coverage
  changes and this example would not converge without it.

Run:  python examples/inverse_rendering.py [--steps 250] [--out-dir /tmp]
"""

import argparse
import dataclasses
import json
import os
import sys

import jax

# --device cpu pins the CPU backend before JAX picks a platform; gpu is
# checked after start-up and fails when there is no GPU; auto takes
# whatever platform JAX has.
def _device_arg(argv):
    """Pre-argparse scan for --device: handles '--device gpu',
    '--device=gpu' and a missing value (argparse reports that later)."""
    for i, tok in enumerate(argv):
        if tok == "--device" and i + 1 < len(argv):
            return argv[i + 1]
        if tok.startswith("--device="):
            return tok.split("=", 1)[1]
    return "auto"


if _device_arg(sys.argv) == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rustraytrace_tpu import RenderConfig, SceneBuilder
from rustraytrace_tpu.config import derive_camera
from rustraytrace_tpu.diff import fit, image_loss, render_mean
from rustraytrace_tpu.parallel import make_mesh
from rustraytrace_tpu.render import finalize_image
from rustraytrace_tpu.utils import image_io


def build_scene(albedo, center):
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.6, 0.6, 0.6)))
    b.add_sphere(center, 0.5, b.lambertian(albedo))
    b.add_sphere((1.2, 0.0, -1.4), 0.4, b.metal((0.8, 0.8, 0.8), 0.1))
    return b.build()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--out-dir", default="/tmp")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="train-state checkpoint directory; pass with "
                         "--resume to continue a killed run")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="auto",
                    choices=("auto", "cpu", "gpu"),
                    help="auto (default: whatever JAX has), cpu, or gpu "
                         "(fails without a GPU)")
    ap.add_argument("--forward", default="trace",
                    choices=("trace", "kernel"),
                    help="loss/cotangent forward per step: 'trace' (exact "
                         "split) or 'kernel' (non-differentiable render "
                         "path, decorrelated cotangent — "
                         "diff.value_and_grad_loss)")
    args = ap.parse_args()
    from rustraytrace_tpu.utils.runtime import require_gpu, setup_compile_cache

    setup_compile_cache()
    if args.device == "gpu":
        require_gpu("inverse_rendering.py")

    true_albedo = (0.75, 0.25, 0.15)
    true_center = (-0.1, 0.05, -1.2)
    cfg = RenderConfig(aspect_ratio=16 / 9, image_width=args.width,
                       samples_per_pixel=args.spp, max_depth=4, vfov=60.0,
                       lookfrom=(0, 0.3, 0.6), lookat=(0, 0, -1), seed=3)
    mesh = make_mesh()
    cam = derive_camera(cfg)
    kw = dict(width=cfg.image_width, height=cfg.image_height, spp=args.spp,
              max_depth=4, mesh=mesh, chunk=4096)

    true_scene = build_scene(true_albedo, true_center)
    target = render_mean(true_scene, cam, jax.random.key(42), **kw)

    # The perturbed sphere should OVERLAP the target on screen: the warp's
    # silhouette gradients act where the current silhouette is, so a fully
    # disjoint initialization only gets a weak shrink-away signal.
    wrong = build_scene((0.2, 0.5, 0.7), (0.12, -0.1, -1.25))
    loss0 = float(image_loss(wrong, target, cam, jax.random.key(1), **kw))

    def progress(step, loss):
        if step % 20 == 0:
            print(f"step {step:4d}  loss {loss:.3e}", flush=True)

    import optax

    # Only sphere 1's center (ALL THREE coordinates — the warped-area
    # estimator supplies silhouette gradients, so depth is recoverable from
    # apparent size) and texture 1's color are unknowns; other rows are
    # frozen (the ground/metal spheres are known).
    masks = {
        "sph_center": np.zeros_like(np.asarray(wrong.sph_center)),
        "tex_color1": np.zeros_like(np.asarray(wrong.tex_color1)),
    }
    masks["sph_center"][1, 0:3] = 1.0
    masks["tex_color1"][1] = 1.0
    masks = {k: jnp.asarray(v) for k, v in masks.items()}

    def row_mask():
        def update(updates, state, params=None):
            return {k: u * masks[k] for k, u in updates.items()}, state
        return optax.GradientTransformation(
            lambda p: optax.EmptyState(), update)

    # geometry needs a much smaller step than color: Adam's normalized
    # updates otherwise random-walk the center through the MC-noisy
    # landscape at full learning-rate speed
    opt = optax.chain(
        optax.zero_nans(),             # drop rare NaN grads (pole/tangent)
        optax.clip_by_global_norm(1.0),
        row_mask(),
        optax.multi_transform(
            {"alb": optax.adam(0.03), "ctr": optax.adam(0.004)},
            {"tex_color1": "alb", "sph_center": "ctr"}),
    )
    fitted, hist = fit(
        wrong, ["sph_center", "tex_color1"], target, cfg, steps=args.steps,
        mesh=mesh, spp=args.spp, chunk=4096, progress=progress,
        optimizer=opt, checkpoint_dir=args.checkpoint_dir,
        resume=args.resume, forward=args.forward,
    )
    loss1 = float(image_loss(fitted, target, cam, jax.random.key(1), **kw))

    rec_center = np.asarray(fitted.sph_center[1])
    rec_albedo = np.asarray(fitted.tex_color1[1])
    center_err = float(np.abs(rec_center - np.asarray(true_center)).max())
    report = {
        "loss_before": loss0, "loss_after": loss1,
        "center_true": list(true_center),
        "center_recovered": [round(float(v), 4) for v in rec_center],
        "center_err": round(center_err, 4),
        "albedo_true": list(true_albedo),
        "albedo_recovered": [round(float(v), 4) for v in rec_albedo],
        "albedo_err": round(float(np.abs(rec_albedo - np.asarray(true_albedo)).max()), 4),
    }
    print(json.dumps(report, indent=2))

    os.makedirs(args.out_dir, exist_ok=True)
    for name, sc in [("target", true_scene), ("initial", wrong),
                     ("fitted", fitted)]:
        img = render_mean(sc, cam, jax.random.key(42), **kw)
        image_io.write_image(
            finalize_image(np.asarray(img), 1),
            os.path.join(args.out_dir, f"inverse_{name}.png"))
    print(f"images written to {args.out_dir}/inverse_*.png")
    # GATE on BOTH recoveries (BASELINE config 4: "recover sphere centers
    # and albedos"): center within 0.08 world units (sphere radius 0.5),
    # albedo within 0.2 per channel.
    ok = report["albedo_err"] < 0.2 and report["center_err"] < 0.08
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
