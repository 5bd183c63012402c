#!/usr/bin/env python
"""Per-scene throughput sweep on a GPU: one timed ``render_pass`` per case.

Usage:
    python scripts/bench_scenes.py [case ...]

Each case prints one JSON line {case, backend, paths_per_s, elapsed_s,
shape, device}.  Timing: best of 2 after a warmup run that compiles,
each rep ending in ``jax.block_until_ready``.  Refuses to run without a
GPU; the card's name and power limit go to stderr.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# case -> (model, overrides dict, integrator, spp, depth, backend)
# spp per case is the sample count of one timed pass
CASES = {
    "flagship": ("book1_random_spheres",
                 dict(image_width=1200, samples_per_pixel=128, max_depth=50),
                 "path", 128, 50, "auto"),
    "flagship_xla": ("book1_random_spheres",
                     dict(image_width=1200, samples_per_pixel=128,
                          max_depth=50),
                     "path", 128, 50, "xla"),
    "final": ("book2_final_scene",
              dict(image_width=800, samples_per_pixel=64, max_depth=40),
              "path", 64, 40, "auto"),
    "earth": ("book2_earth",
              dict(image_width=800, samples_per_pixel=1024, max_depth=50),
              "path", 1024, 50, "auto"),
    "bouncing": ("book2_bouncing_spheres",
                 dict(image_width=400, samples_per_pixel=1024, max_depth=50),
                 "path", 1024, 50, "auto"),
    "quads": ("book2_quads",
              dict(image_width=400, samples_per_pixel=8192, max_depth=10),
              "path", 8192, 10, "auto"),
    "cornell": ("book2_cornell_box",
                dict(image_width=400, samples_per_pixel=4096, max_depth=20),
                "path", 4096, 20, "auto"),
    "smoke": ("book2_cornell_smoke",
              dict(image_width=400, samples_per_pixel=4096, max_depth=50),
              "path", 4096, 50, "auto"),
    "perlin": ("book2_perlin_spheres",
               dict(image_width=400, samples_per_pixel=4096, max_depth=50),
               "path", 4096, 50, "auto"),
    "cornell_mis": ("book3_cornell_box",
                    dict(image_width=600, samples_per_pixel=1024,
                         max_depth=50),
                    "mis", 1024, 50, "auto"),
    "field10k": ("sphere_field_10k",
                 dict(image_width=1200, samples_per_pixel=64, max_depth=50),
                 "path", 64, 50, "auto"),
}


def run_case(name: str) -> dict:
    import jax

    from rustraytrace_tpu import models
    from rustraytrace_tpu.config import derive_camera
    from rustraytrace_tpu.render import render_pass, resolve_backend

    model, ov, integ, spp, depth, backend = CASES[name]
    scene, cfg, _ = getattr(models, model)(ov)

    cam = derive_camera(cfg)
    w, h = cfg.image_width, cfg.image_height
    backend = resolve_backend(scene, integ, backend)
    key = jax.random.key(0)

    def go():
        return render_pass(
            scene, cam, key, width=w, height=h, spp=spp,
            max_depth=depth, integrator=integ, chunk=min(65536, w * h),
            backend=backend)

    jax.block_until_ready(go())  # compile + first run

    from rustraytrace_tpu.utils.metrics import time_best

    elapsed = time_best(go)

    pps = w * h * spp / elapsed
    rec = {"case": name, "backend": backend,
           "paths_per_s": round(pps, 1), "elapsed_s": round(elapsed, 3),
           "shape": f"{w}x{h}@{spp}spp d{depth}",
           "device": jax.devices()[0].device_kind}
    print(json.dumps(rec), flush=True)
    return rec


def main():
    from rustraytrace_tpu.utils.runtime import (card_info, require_gpu,
                                                setup_compile_cache)

    setup_compile_cache()
    require_gpu("bench_scenes.py")
    print(f"# card: {card_info()}", file=sys.stderr, flush=True)
    cases = sys.argv[1:] or list(CASES)
    for c in cases:
        run_case(c)


if __name__ == "__main__":
    main()
