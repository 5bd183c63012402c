"""Smoke run of the renderer on a GPU, through its public entry points.

    python chip_smoke.py              # one card: the default phases
    python chip_smoke.py --devices 4  # four cards: the sharded path only

Default phases, in one process:

1. device: platform, device kind, the card's name and power limit;
2. flagship forward at full width: ``render.render_image`` on
   book1_random_spheres, 1200x675, depth 50, 64 spp, auto backend; image
   layout checks; a 2-spp render compared per pixel with the same render on
   the in-process CPU backend over a crop of every 4th ray chunk;
3. closest-hit kernel at real width (when auto routes to it): kernel vs
   ``ops.intersect`` on the flagship's primary rays and one bounce of
   secondaries;
4. catalog sweep: every scene of ``models.SCENES`` at catalog size, 4 spp,
   auto route; a reduced-size render compared with the CPU backend;
5. gradient step: ``diff.value_and_grad_loss`` on the inverse-rendering
   configuration vs the CPU backend, plus whether the fused
   ``jax.value_and_grad(image_loss)`` compiles on the card;
6. the GPU-marked tests (``pytest -m gpu tests/``) in this process.

``--devices 4`` runs only the four-card phase: the flagship at 3840x2160,
16 spp on a (4, 1) and a (1, 4) ('px', 'spp') mesh against a one-card
render of the same key and chunk, and one sharded ``make_train_step``
gradient on four cards against one card.

Every comparison prints its observed error beside its limit; the run
exits non-zero (and prints no result line) if any comparison failed or
any phase raised.  The last line of stdout is one JSON object:
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import json
import os
import sys
import time

FLAGSHIP_CHUNK = 65536
COMPARE_CHUNK = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


FAILED = []


def check(name: str, observed: float, limit: float, ok: bool) -> None:
    """Print a comparison beside its limit; a failure is recorded, the run
    goes on so every comparison is reported, and the process exits
    non-zero at the end."""
    log(f"  {name}: observed {observed!r} limit {limit!r} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILED.append(name)


def timed(label: str, paths: int, fn):
    t0 = time.perf_counter()
    out = fn()
    import jax

    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    log(f"  {label}: {dt:.3f} s, {paths / dt / 1e6:.4f} M paths/s")
    return out


def crop_reference(scene, cfg, integrator, cpu, *, chunk, stride, spp):
    """Radiance SUM on the CPU backend's XLA path for every ``stride``-th
    ray chunk of a ``render_image`` with this ``chunk``: the same
    (sample, chunk-start) keys as ``render.render_pass``, so each pixel
    sees the same random streams.  Returns (pixel indices, [P, 3])."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rustraytrace_tpu.config import derive_camera
    from rustraytrace_tpu.render import trace_rays

    w, h = cfg.image_width, cfg.image_height
    n_pix = w * h
    stratified = cfg.stratified
    sqrt_spp = int(np.sqrt(cfg.samples_per_pixel)) if stratified else 0
    with jax.default_device(cpu):
        cam = derive_camera(cfg)
        key = jax.random.key(cfg.seed)

        @jax.jit
        def one(start, s):
            pix = start + jnp.arange(chunk)
            px = (pix % w).astype(jnp.float32)
            py = jnp.minimum(pix // w, h - 1).astype(jnp.float32)
            kc = jax.random.fold_in(jax.random.fold_in(key, s), start)
            return trace_rays(scene, cam, kc, s, px, py,
                              max_depth=cfg.max_depth, integrator=integrator,
                              stratified=stratified, sqrt_spp=sqrt_spp,
                              backend="xla")

        starts = list(range(0, n_pix, chunk * stride))
        pix, rad = [], []
        for start in starts:
            acc = sum(one(jnp.int32(start), jnp.int32(s)) for s in range(spp))
            n = min(chunk, n_pix - start)
            pix.append(np.arange(start, start + n))
            rad.append(np.asarray(acc)[:n])
    return np.concatenate(pix), np.concatenate(rad)


def phase_device():
    import jax

    from rustraytrace_tpu.utils.runtime import card_info

    log("phase 1: device")
    dev = jax.devices()[0]
    log(f"  platform {dev.platform}, kind {dev.device_kind}, "
        f"count {len(jax.devices())}")
    log(f"  card: {card_info()}")


def phase_flagship(cpu):
    import numpy as np

    from rustraytrace_tpu import models, render

    log("phase 2: flagship forward, 1200x675 depth 50 64 spp")
    scene, cfg, integ = models.book1_random_spheres(
        dict(samples_per_pixel=64, max_depth=50))
    w, h = cfg.image_width, cfg.image_height
    backend = render.resolve_backend(scene, integ)
    log(f"  auto backend: {backend}")
    timed("compile + first 16-spp pass", w * h * 16,
          lambda: render.render_image(
              scene, cfg.replace(samples_per_pixel=16), integrator=integ,
              chunk=FLAGSHIP_CHUNK)[1]["accum"])
    img, st = timed("render_image 64 spp", w * h * 64,
                    lambda: render.render_image(scene, cfg, integrator=integ,
                                                chunk=FLAGSHIP_CHUNK))
    acc = st["accum"] / st["spp_done"]
    check("image shape", img.shape, (h, w, 3), img.shape == (h, w, 3))
    check("non-finite radiance values", int((~np.isfinite(acc)).sum()), 0,
          bool(np.isfinite(acc).all()))
    sky = acc[: h // 10].mean(axis=(0, 1))
    ground = acc[h - h // 10:].mean(axis=(0, 1))
    log(f"  sky rows mean RGB {sky.tolist()}, ground rows {ground.tolist()}")
    check("sky rows blue-dominant (B - max(R, G))",
          float(sky[2] - max(sky[0], sky[1])), 0.0,
          bool(sky[2] > max(sky[0], sky[1])))
    check("ground/sky mean ratio (lit grey ground is darker)",
          float(ground.mean() / sky.mean()), 0.6,
          bool(ground.mean() < 0.6 * sky.mean()))

    log(f"  2-spp GPU render vs CPU XLA reference, chunk {COMPARE_CHUNK}, "
        "every 4th chunk")
    cfg2 = cfg.replace(samples_per_pixel=2)
    _, st2 = render.render_image(scene, cfg2, integrator=integ,
                                 chunk=COMPARE_CHUNK)
    t0 = time.perf_counter()
    pix, ref = crop_reference(scene, cfg2, integ, cpu, chunk=COMPARE_CHUNK,
                              stride=4, spp=2)
    log(f"  CPU reference: {len(pix)} pixels in "
        f"{time.perf_counter() - t0:.1f} s")
    got = st2["accum"].reshape(-1, 3)[pix] / 2
    ref = ref / 2
    dmean = np.abs(got.mean(axis=0) - ref.mean(axis=0))
    check("per-channel image mean |GPU - CPU|", float(dmean.max()), 1e-3,
          bool(dmean.max() <= 1e-3))
    close = (np.abs(got - ref).max(axis=-1) <= 1e-2).mean()
    check("share of pixels within 1e-2", float(close), 0.99,
          bool(close >= 0.99))
    return backend


def phase_kernel():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rustraytrace_tpu import models
    from rustraytrace_tpu.camera import generate_rays
    from rustraytrace_tpu.config import derive_camera
    from rustraytrace_tpu.ops.intersect import (T_MAX, T_MIN, closest_hit,
                                                hit_spheres)
    from rustraytrace_tpu.ops.integrator import n_media
    from rustraytrace_tpu.ops.materials import gather_mat, scatter
    from rustraytrace_tpu.ops.pallas_hit import (closest_hit_spheres_pallas,
                                                kernel_hits)

    log("phase 3: closest-hit kernel vs ops.intersect at real width")
    scene, cfg, _ = models.book1_random_spheres()
    cam = derive_camera(cfg)
    w, h = cfg.image_width, cfg.image_height
    pix = jnp.arange(w * h)
    px = (pix % w).astype(jnp.float32)
    py = (pix // w).astype(jnp.float32)
    draws = jax.random.uniform(jax.random.key(11), (w * h, 5))
    o, d, tm = generate_rays(cam, px, py, draws, None)
    R = o.shape[0]
    no_media = jnp.zeros((R, n_media(scene)))  # the flagship has none
    rec = closest_hit(o, d, tm, scene, no_media)
    mat = gather_mat(scene, rec)
    sc = scatter(d, rec, mat,
                 jax.random.uniform(jax.random.key(12), (R, 3)), False)
    live = np.asarray(rec.valid & sc.scattered)
    o2 = jnp.where(rec.valid[:, None], rec.p, o)
    d2 = jnp.where(sc.scattered[:, None], sc.direction, d)
    for label, (oo, dd, sel) in {
            "primary": (o, d, np.ones(R, bool)),
            "secondary": (o2, d2, live)}.items():
        jax.block_until_ready(kernel_hits(oo, dd, tm, scene))
        t0 = time.perf_counter()
        _, i_k = jax.block_until_ready(kernel_hits(oo, dd, tm, scene))
        dt_k = time.perf_counter() - t0
        rec_k, _ = closest_hit_spheres_pallas(oo, dd, tm, scene)
        _, i_r, _ = hit_spheres(oo, dd, tm, scene, jnp.full((R,), T_MIN),
                                jnp.full((R,), T_MAX))
        rec_r = closest_hit(oo, dd, tm, scene, no_media)
        i_r = np.where(np.asarray(rec_r.valid), np.asarray(i_r), -1)[sel]
        i_k = np.asarray(i_k)[sel]
        t_r = np.asarray(rec_r.t)[sel]
        t_k = np.asarray(rec_k.t)[sel]
        log(f"  {label}: {int(sel.sum())} rays, kernel {dt_k * 1e3:.3f} ms")
        agree = i_k == i_r
        check(f"{label} winner index agreement", float(agree.mean()), 0.999,
              bool(agree.mean() >= 0.999))
        hit = agree & (i_r >= 0)
        rel = np.abs(t_k[hit] - t_r[hit]) / np.abs(t_r[hit])
        check(f"{label} max relative t difference (agreeing hits)",
              float(rel.max()), 1e-5, bool(rel.max() <= 1e-5))


def catalog_scenes():
    from rustraytrace_tpu.models.scenes import SCENES

    seen, out = set(), []
    for name, fn in SCENES.items():
        if fn not in seen:
            seen.add(fn)
            out.append(name)
    return out


def phase_catalog(cpu):
    import jax
    import numpy as np

    from rustraytrace_tpu import models, render

    log("phase 4: catalog sweep, 4 spp at catalog size")
    for name in catalog_scenes():
        scene, cfg, integ = models.get_scene(name, dict(samples_per_pixel=4))
        w, h = cfg.image_width, cfg.image_height
        backend = render.resolve_backend(scene, integ)
        t0 = time.perf_counter()
        _, st = render.render_image(scene, cfg, integrator=integ)
        dt = time.perf_counter() - t0
        acc = st["accum"] / st["spp_done"]
        log(f"  {name}: {w}x{h} depth {cfg.max_depth} {integ} "
            f"backend={backend} {dt:.2f} s (incl. compile), "
            f"{w * h * st['spp_done'] / dt / 1e6:.4f} M paths/s, "
            f"mean {acc.mean():.5f}")
        check(f"{name} non-finite values", int((~np.isfinite(acc)).sum()),
              0, bool(np.isfinite(acc).all()))

        small = cfg.replace(image_width=48)
        _, sg = render.render_image(scene, small, integrator=integ)
        with jax.default_device(cpu):
            scene_c, _, _ = models.get_scene(name, dict(samples_per_pixel=4))
            _, sc = render.render_image(scene_c, small, integrator=integ,
                                        backend="xla")
        m_g = sg["accum"].mean() / sg["spp_done"]
        m_c = sc["accum"].mean() / sc["spp_done"]
        rel = abs(m_g - m_c) / max(abs(m_c), 1e-12)
        check(f"{name} 48-wide radiance mean GPU {m_g:.6f} vs CPU "
              f"{m_c:.6f} (relative)", float(rel), 0.05, bool(rel <= 0.05))


def inverse_config():
    """The examples/inverse_rendering.py configuration."""
    from rustraytrace_tpu import RenderConfig, SceneBuilder

    def build(albedo, center):
        b = SceneBuilder()
        b.add_sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.6, 0.6, 0.6)))
        b.add_sphere(center, 0.5, b.lambertian(albedo))
        b.add_sphere((1.2, 0.0, -1.4), 0.4, b.metal((0.8, 0.8, 0.8), 0.1))
        return b.build()

    cfg = RenderConfig(aspect_ratio=16 / 9, image_width=64,
                       samples_per_pixel=16, max_depth=4, vfov=60.0,
                       lookfrom=(0, 0.3, 0.6), lookat=(0, 0, -1), seed=3)
    return build, cfg


def grad_step(devices, target=None, chunk=4096):
    """One value_and_grad_loss step of the inverse-rendering configuration
    on ``devices``; ``target`` (host array) defaults to a render of the
    true scene there.  Returns (loss, grads, target, step inputs)."""
    import jax
    import numpy as np

    from rustraytrace_tpu.config import derive_camera
    from rustraytrace_tpu.diff import (extract_params, render_mean,
                                       value_and_grad_loss)
    from rustraytrace_tpu.parallel import make_mesh

    build, cfg = inverse_config()
    with jax.default_device(devices[0]):
        mesh = make_mesh(devices)
        cam = derive_camera(cfg)
        kw = dict(width=cfg.image_width, height=cfg.image_height,
                  spp=cfg.samples_per_pixel, max_depth=cfg.max_depth,
                  mesh=mesh, chunk=chunk)
        if target is None:
            target = np.asarray(render_mean(
                build((0.75, 0.25, 0.15), (-0.1, 0.05, -1.2)), cam,
                jax.random.key(42), **kw))
        wrong = build((0.2, 0.5, 0.7), (0.12, -0.1, -1.25))
        params = extract_params(wrong, ["sph_center", "tex_color1"])
        loss, grads = value_and_grad_loss(wrong, params, target, cam,
                                          jax.random.key(1), **kw)
        return (float(loss), {k: jax.device_get(v) for k, v in grads.items()},
                target, (wrong, params, target, cam, kw))


def rel_err(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def phase_gradient(cpu):
    import jax

    from rustraytrace_tpu.diff import apply_params, image_loss

    log("phase 5: gradient step (inverse-rendering configuration)")
    # one target for both steps: it is an input of the step, rendered once
    # on the CPU
    loss_c, g_c, target, _ = grad_step([cpu])
    t0 = time.perf_counter()
    loss_g, g_g, _, (wrong, params, target, cam, kw) = grad_step(
        jax.devices()[:1], target)
    log(f"  GPU value_and_grad_loss: {time.perf_counter() - t0:.2f} s "
        "(incl. compile)")
    rl = abs(loss_g - loss_c) / abs(loss_c)
    # Same target, key and streams; the first bounce agrees to 2e-7, but
    # f32 transcendental differences between XLA:GPU and XLA:CPU flip a
    # few secondary-ray hits among ~2.4M decisions (~30 of 2304 pixels
    # move by >1e-3 on an H100), and each flipped sample moves this
    # 16-spp loss by ~3e-5 relative: the limit is 1e-3, not 1e-4.
    check(f"loss GPU {loss_g:.8e} vs CPU {loss_c:.8e} (relative)", rl, 1e-3,
          rl <= 1e-3)
    for k in sorted(g_c):
        e = rel_err(g_g[k], g_c[k])
        check(f"gradient {k} relative error", e, 1e-2, e <= 1e-2)

    def fused(p):
        return image_loss(apply_params(wrong, p), target, cam,
                          jax.random.key(1), **kw)

    try:
        jax.jit(jax.value_and_grad(fused)).lower(params).compile()
    except Exception as e:  # noqa: BLE001 — recorded, not a phase failure
        log(f"  fused jax.value_and_grad(image_loss) compiles on the card: "
            f"no ({type(e).__name__}: {str(e)[:200]})")
        return
    loss_f, g_f = jax.jit(jax.value_and_grad(fused))(params)
    log("  fused jax.value_and_grad(image_loss) compiles on the card: yes; "
        f"loss relative to the split {abs(float(loss_f) - loss_g) / abs(loss_g)!r}, "
        "max gradient relative error "
        f"{max(rel_err(g_f[k], g_g[k]) for k in g_g)!r}")


def phase_gpu_tests():
    import pytest

    log("phase 6: GPU-marked tests")
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-m", "gpu", "-q", "-p", "no:cacheprovider",
                      os.path.join(here, "tests")])
    check("pytest -m gpu exit code", int(rc), 0, int(rc) == 0)


def phase_four_cards():
    import jax
    import numpy as np

    from rustraytrace_tpu import models, render
    from rustraytrace_tpu.diff import image_loss
    from rustraytrace_tpu.parallel import make_mesh, render_image_sharded

    devs = jax.devices()
    log(f"phase 4-card: {len(devs)} devices")
    check("device count", len(devs), 4, len(devs) == 4)
    scene, cfg, integ = models.book1_random_spheres(
        dict(image_width=3840, samples_per_pixel=16, max_depth=50))
    w, h = cfg.image_width, cfg.image_height
    paths = w * h * 16
    # the chunk a 4-way pixel shard takes (parallel.render), so the chunk
    # starts and with them the random streams coincide with one card's
    per_shard = -(-w * h // 4)
    chunk = min(FLAGSHIP_CHUNK, -(-per_shard // 256) * 256)
    log(f"  flagship {w}x{h} 16 spp depth 50, chunk {chunk}")
    _, one = timed("one card render_image (incl. compile)", paths,
                   lambda: render.render_image(scene, cfg, integrator=integ,
                                               chunk=chunk))
    for shape in ((4, 1), (1, 4)):
        mesh = make_mesh(devs, spp_shards=shape[1])
        log(f"  mesh {dict(mesh.shape)}")
        fn = lambda: render_image_sharded(  # noqa: E731
            scene, cfg, mesh=mesh, integrator=integ, chunk=chunk)
        timed("sharded render (incl. compile)", paths, fn)
        _, sh = timed("sharded render (warm)", paths, fn)
        diff = float(np.abs(sh["accum"] - one["accum"]).max())
        log(f"  {shape} vs one card: bit-identical "
            f"{bool(np.array_equal(sh['accum'], one['accum']))}, "
            f"max |difference| {diff!r}")
        # (4, 1) traces the same samples with the same keys, so it is
        # bit-identical unless XLA fuses the two programs differently;
        # (1, 4) sums the samples in another order
        ok = np.allclose(sh["accum"], one["accum"], rtol=1e-5, atol=1e-5)
        check(f"{shape} max |difference| vs one card (allclose rtol 1e-5)",
              diff, 1e-5, bool(ok))

    log("  sharded train-step gradient, 4 cards vs 1")
    from rustraytrace_tpu.config import derive_camera
    from rustraytrace_tpu.diff import apply_params, make_train_step

    build, cfg_i = inverse_config()
    target = np.full((cfg_i.image_height, cfg_i.image_width, 3), 0.3,
                     np.float32)
    wrong = build((0.2, 0.5, 0.7), (0.12, -0.1, -1.25))
    names = ["sph_center", "tex_color1"]
    grads, losses = [], []
    for mesh_devs in (devs, devs[:1]):
        mesh = make_mesh(mesh_devs)
        step, params, opt_state = make_train_step(
            wrong, names, target, cfg_i, mesh=mesh, spp=4, chunk=256)
        _, _, loss = jax.jit(step)(params, opt_state, jax.random.key(0))
        kw = dict(width=cfg_i.image_width, height=cfg_i.image_height, spp=4,
                  max_depth=cfg_i.max_depth, mesh=mesh, chunk=256)
        cam = derive_camera(cfg_i)
        g = jax.jit(jax.grad(lambda p: image_loss(  # noqa: E731
            apply_params(wrong, p), target, cam, jax.random.key(0),
            **kw)))(params)
        losses.append(float(loss))
        grads.append({k: jax.device_get(v) for k, v in g.items()})
    rl = abs(losses[0] - losses[1]) / abs(losses[1])
    check("train-step loss 4 vs 1 card (relative)", rl, 1e-4, rl <= 1e-4)
    for k in names:
        e = rel_err(grads[0][k], grads[1][k])
        check(f"train-step gradient {k} 4 vs 1 card (relative)", e, 1e-4,
              e <= 1e-4)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 runs only the four-card phase")
    args = ap.parse_args()

    from rustraytrace_tpu.utils.runtime import (require_gpu,
                                                setup_compile_cache)

    setup_compile_cache()
    require_gpu("chip_smoke.py")
    import jax

    t_all = time.perf_counter()
    phase_device()
    if args.devices == 4:
        phase_four_cards()
    else:
        cpu = jax.devices("cpu")[0]
        backend = phase_flagship(cpu)
        if backend == "sphere_kernel":
            phase_kernel()
        else:
            log("phase 3: skipped (auto routes the flagship to the XLA path)")
        phase_catalog(cpu)
        phase_gradient(cpu)
        phase_gpu_tests()
    log(f"total {time.perf_counter() - t_all:.1f} s")
    if FAILED:
        log(f"FAILED: {len(FAILED)} comparison(s): " + "; ".join(FAILED))
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
