"""Command-line renderer — the analog of the reference's ``src/main.rs``.

Reference interface (``src/main.rs:14-99``): ``[--cpu|--gpu|--cuda] <book>
[scene]``, PPM P3 on stdout, progress on stderr.  Here the backends are
execution strategies on whatever device JAX runs on, scene/book
dispatch matches the reference's (``the_next_week`` scenes 1-9 per
``the_next_week/mod.rs:68-81``), and the compile-time ``OVERRIDES`` const
(``src/config.rs:50-62``) becomes runtime flags.

Examples:
    python -m rustraytrace_tpu in_one_weekend --width 400 --spp 64 -o out.png
    python -m rustraytrace_tpu the_next_week 7 --spp 200
    python -m rustraytrace_tpu book3_cornell_box --spp 100 > image.ppm
    python -m rustraytrace_tpu book1_random_spheres --sharded --spp 512
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    from .models.scenes import SCENES

    p = argparse.ArgumentParser(
        prog="rustraytrace_tpu",
        description="differentiable path tracer in JAX "
                    "(Ray Tracing in One Weekend trilogy feature set)",
    )
    p.add_argument("scene", help="book or scene name: " + ", ".join(
        ["the_next_week"] + sorted(SCENES)))
    p.add_argument("scene_num", nargs="?", type=int, default=None,
                   help="scene number for the_next_week (1-9)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "sphere_kernel"],
                   help="execution backend (auto: the closest-hit kernel "
                        "for box-free path scenes on a GPU, else xla)")
    p.add_argument("--sharded", action="store_true",
                   help="shard pixels/spp across all visible devices")
    p.add_argument("--spp-shards", type=int, default=None,
                   help="devices on the spp mesh axis (with --sharded)")
    p.add_argument("--width", type=int, default=None, help="image width")
    p.add_argument("--spp", type=int, default=None, help="samples per pixel")
    p.add_argument("--depth", type=int, default=None, help="max bounces")
    p.add_argument("--spp-per-pass", type=int, default=None)
    p.add_argument("--chunk", type=int, default=65536,
                   help="rays per device chunk")
    p.add_argument("--seed", type=int, default=None, help="RNG seed")
    p.add_argument("-o", "--output", default=None,
                   help="output file (.png/.ppm); default: PPM P3 on stdout")
    p.add_argument("--checkpoint", default=None,
                   help="write a resumable .npz accumulation state here "
                        "after every pass")
    p.add_argument("--resume", default=None,
                   help="resume accumulation from a checkpoint .npz")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--debug-mode", choices=["gradient", "param"],
                   default=None,
                   help="plumbing sanity renders matching the reference's "
                        "compile-time DEBUG_GRADIENT / DEBUG_PARAM WGSL "
                        "switches (gpu/renderer.wgsl:48-49,258-278): "
                        "'gradient' shades each pixel with the sky gradient "
                        "of its primary ray (camera/ray-gen check), 'param' "
                        "fills a flat width/height-derived color")
    return p


def debug_render(cfg, mode: str):
    """The reference's WGSL debug modes as one-shot XLA renders.

    gradient (renderer.wgsl:258-269): center-of-pixel primary ray, sky
    gradient of its unit direction.  param (renderer.wgsl:271-277):
    constant (width/1024, height/1024, 0) fill.  Both return u8 [H,W,3]
    without gamma (the reference writes the raw accumulated color)."""
    import jax.numpy as jnp
    import numpy as np

    from .config import derive_camera

    h, w = cfg.image_height, cfg.image_width
    if mode == "param":
        color = np.clip([w / 1024.0, h / 1024.0, 0.0], 0.0, 1.0)
        img = np.broadcast_to(color, (h, w, 3))
    else:
        from .camera import generate_rays

        cam = derive_camera(cfg)
        yy, xx = np.mgrid[0:h, 0:w]
        px = jnp.asarray(xx.reshape(-1), jnp.float32)
        py = jnp.asarray(yy.reshape(-1), jnp.float32)
        # center-of-pixel, no jitter/defocus: zero draws except the 0.5
        # pixel offset handled by generate_rays' jitter argument
        draws = jnp.full((h * w, 5), 0.5, jnp.float32)
        _, d, _ = generate_rays(cam, px, py, draws, None)
        unit = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        t = 0.5 * (unit[:, 1] + 1.0)
        sky = ((1.0 - t)[:, None] * jnp.ones(3)
               + t[:, None] * jnp.asarray([0.5, 0.7, 1.0]))
        img = np.asarray(sky).reshape(h, w, 3)
    return (np.clip(img, 0.0, 0.999) * 256).astype(np.uint8)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .utils.runtime import setup_compile_cache

    setup_compile_cache()
    from . import models, render
    from .utils import image_io
    from .utils.checkpoint import load_checkpoint, save_checkpoint

    overrides = {}
    if args.width is not None:
        overrides["image_width"] = args.width
    if args.spp is not None:
        overrides["samples_per_pixel"] = args.spp
    if args.depth is not None:
        overrides["max_depth"] = args.depth
    if args.spp_per_pass is not None:
        overrides["spp_per_pass"] = args.spp_per_pass
    if args.seed is not None:
        overrides["seed"] = args.seed

    try:
        scene, cfg, integrator = models.get_scene(
            args.scene, overrides or None, args.scene_num)
    except KeyError:
        print(f"unknown scene {args.scene!r}; available: "
              + ", ".join(sorted(models.SCENES)), file=sys.stderr)
        return 2

    if args.debug_mode:
        img = debug_render(cfg, args.debug_mode)
        image_io.write_image(img, args.output)
        return 0

    accum_state = None
    if args.resume:
        accum_state = load_checkpoint(args.resume, cfg, scene)
        print(f"resumed at {accum_state['spp_done']} spp", file=sys.stderr)

    from .utils.metrics import RenderMeter

    n_pix = cfg.image_width * cfg.image_height
    meter = RenderMeter(n_pixels=n_pix).start()
    prev = {"done": accum_state["spp_done"] if accum_state else 0}

    def progress(done, total):
        # structured per-pass log line via the shared RenderMeter — the
        # analog of the reference's "pass/total (%) elapsed eta" stderr line
        # (src/gpu/mod.rs:469-480)
        meter.lap(done - prev["done"])
        prev["done"] = done
        if not args.quiet:
            eta = (total - done) * n_pix / max(meter.paths_per_sec, 1e-9)
            print(meter.json_line(pass_spp=done, total_spp=total,
                                  eta_s=round(eta, 1)),
                  file=sys.stderr, flush=True)

    def on_pass(state):
        if args.checkpoint:
            save_checkpoint(args.checkpoint, state, cfg, scene)

    render_kw = dict(integrator=integrator, progress=progress,
                     accum_state=accum_state)
    if args.sharded:
        from .parallel import make_mesh, render_image_sharded

        mesh = make_mesh(spp_shards=args.spp_shards)
        if not args.quiet:
            print(f"mesh: {dict(mesh.shape)}", file=sys.stderr)
        img, state = render_image_sharded(
            scene, cfg, mesh=mesh, chunk=args.chunk, backend=args.backend,
            on_pass=on_pass, **render_kw)
    else:
        img, state = render.render_image(scene, cfg, backend=args.backend,
                                         chunk=args.chunk, on_pass=on_pass,
                                         **render_kw)

    if args.checkpoint:
        save_checkpoint(args.checkpoint, state, cfg, scene)
    image_io.write_image(img, args.output)
    if not args.quiet:
        print(meter.json_line(done_spp=state["spp_done"]), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
