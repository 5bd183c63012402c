"""Headline benchmark: paths/sec on the Book-1 random-spheres flagship scene.

Scene: the reference's headline workload (~484-sphere random field,
``src/books/in_one_weekend/mod.rs:57-126``) at 1200x675 — BASELINE config 2.
Metric: completed pixel samples per second ("paths/s"; each sample is a full
camera path with Russian-roulette-truncated bounces, max depth 50), timed
as one ``render_pass`` ending in ``jax.block_until_ready``.

Refuses to run unless JAX's first device is a GPU.  Prints ONE JSON line on
stdout: {"metric", "value", "unit", "device"}; the card's name and power
limit and the per-rep times go to stderr.

Env knobs: BENCH_SPP (default 64), BENCH_WIDTH (default 1200),
BENCH_DEPTH (default 50), BENCH_CHUNK (default 65536), BENCH_REPEATS
(default 3), BENCH_BACKEND (default: the auto route).
"""

import json
import os
import sys


def main():
    from rustraytrace_tpu.utils.runtime import (card_info, require_gpu,
                                                setup_compile_cache)

    setup_compile_cache()
    require_gpu("bench.py")
    import jax

    from rustraytrace_tpu import models
    from rustraytrace_tpu.config import derive_camera
    from rustraytrace_tpu.render import render_pass, resolve_backend
    from rustraytrace_tpu.utils.metrics import time_best

    dev = jax.devices()[0]
    print(f"# device: {dev.device_kind} x{len(jax.devices())}; "
          f"card: {card_info()}", file=sys.stderr, flush=True)

    spp = int(os.environ.get("BENCH_SPP", "64"))
    width = int(os.environ.get("BENCH_WIDTH", "1200"))
    depth = int(os.environ.get("BENCH_DEPTH", "50"))
    chunk = int(os.environ.get("BENCH_CHUNK", "65536"))
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))

    scene, cfg, _ = models.book1_random_spheres(
        dict(image_width=width, samples_per_pixel=spp, max_depth=depth)
    )
    cam = derive_camera(cfg)
    w, h = cfg.image_width, cfg.image_height
    key = jax.random.key(0)
    backend = resolve_backend(scene, "path",
                              os.environ.get("BENCH_BACKEND") or "auto")

    def go():
        return render_pass(scene, cam, key, width=w, height=h, spp=spp,
                           max_depth=depth, integrator="path",
                           chunk=min(chunk, w * h), backend=backend)

    jax.block_until_ready(go())  # compile + first run, outside the timing

    paths = w * h * spp

    def on_rep(i, dt):
        print(f"# rep {i}: {dt:.3f}s = {paths / dt / 1e6:.3f} Mpaths/s",
              file=sys.stderr, flush=True)

    elapsed = time_best(go, repeats=repeats, on_rep=on_rep)
    print(json.dumps({
        "metric": "paths_per_sec",
        "value": paths / elapsed,
        "unit": "paths/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    print(f"# {paths} paths in {elapsed:.3f}s backend={backend} "
          f"({w}x{h} @ {spp}spp depth {depth})", file=sys.stderr)


if __name__ == "__main__":
    main()
