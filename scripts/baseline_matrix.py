"""BASELINE.md config matrix, run as written, on a GPU.

Runs each BASELINE config end-to-end at its stated size through the public
render_image pass loop (auto backend routing) and prints one JSON line per
config with throughput and wall time.  Config 4 is
examples/inverse_rendering.py (gated recovery; run it directly); config 5's
multi-card run is ``python chip_smoke.py --devices 4``; this script runs
config 5's scene at 4K@1000spp on one card.  Refuses to run without a GPU.

Usage:
    python scripts/baseline_matrix.py [1 2 3 5]
"""

import json
import sys
import time

import numpy as np


def run(config: int):
    import jax

    from rustraytrace_tpu import models, render

    if config == 1:
        scene, cfg, integ = models.book1_three_spheres(
            dict(image_width=400, samples_per_pixel=100, max_depth=50,
                 spp_per_pass=100))
    elif config == 2:
        scene, cfg, integ = models.book1_random_spheres(
            dict(image_width=1200, samples_per_pixel=500, max_depth=50,
                 spp_per_pass=125))
    elif config == 3:
        scene, cfg, integ = models.book2_earth(
            dict(image_width=800, samples_per_pixel=500, max_depth=50,
                 spp_per_pass=125))
    elif config == 5:
        scene, cfg, integ = models.book1_random_spheres(
            dict(image_width=3840, samples_per_pixel=1000, max_depth=50,
                 spp_per_pass=50))
        cfg = cfg.replace(aspect_ratio=16.0 / 9.0)  # 3840x2160
    else:
        raise SystemExit(f"config {config}: run examples/inverse_rendering.py")

    w, h = cfg.image_width, cfg.image_height
    backend = render.resolve_backend(scene, integ)

    def render_once():
        img, state = render.render_image(scene, cfg, integrator=integ,
                                         backend=backend)
        return img, state

    # best-of-N after one untimed call that compiles every pass shape;
    # render_image returns host arrays, so each call has finished
    repeats = 2 if w * h * cfg.samples_per_pixel <= 2e8 else 1
    img, state = render_once()
    el = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        img, state = render_once()
        dt = time.perf_counter() - t0
        el = dt if el is None else min(el, dt)
    spp = state["spp_done"]
    print(json.dumps({
        "config": config, "scene": f"{w}x{h}@{spp}spp d{cfg.max_depth}",
        "backend": backend, "device": jax.devices()[0].device_kind,
        "paths_per_s": w * h * spp / el,
        "wall_s": el,
        "mean_u8": float(np.asarray(img).mean()),
    }), flush=True)


def main():
    from rustraytrace_tpu.utils.runtime import (card_info, require_gpu,
                                                setup_compile_cache)

    setup_compile_cache()
    require_gpu("baseline_matrix.py")
    print(f"# card: {card_info()}", file=sys.stderr, flush=True)
    which = [int(a) for a in sys.argv[1:]] or [1, 2, 3, 5]
    for c in which:
        run(c)


if __name__ == "__main__":
    main()
