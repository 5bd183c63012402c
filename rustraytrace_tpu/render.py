"""Render orchestration: pass loop, ray chunking, accumulation, finalize.

This is the device analog of the reference's host-side pass loops: CPU rayon
scanlines (src/books/*/camera.rs:59-100), the wgpu 64-spp pass loop
(src/gpu/mod.rs:444-481), and the CUDA 256-spp pass loop
(src/cuda/mod.rs:403-432).  One jit-compiled ``render_pass`` traces
``spp_per_pass`` samples for every pixel; the host loop accumulates
(RGB-sum, sample-count) exactly like the reference's vec4 accumulation buffer
(renderer.wgsl:295-297, render_io.rs:3-31), so any pass boundary is a
checkpoint/resume point.

Rays are traced in fixed-size chunks (a ``lax.scan`` over chunk index with a
flat accumulator carry) so the [rays x primitives] intersection broadcasts
stay within the device-memory budget at 4K.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .camera import generate_rays
from .config import CameraParams, RenderConfig, derive_camera
from .ops.integrator import IntegratorOptions, n_media, trace_mis, trace_path
from .scene import Scene


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _strat_tuple(s_idx, stratified: bool, sqrt_spp: int):
    dt = jnp.float32
    if not stratified:
        return None
    # wrap into the sqrt_spp x sqrt_spp grid: spp-sharded passes can round
    # the sample count up past sqrt_spp^2, and an unwrapped s_idx would
    # place the sub-pixel stratum OUTSIDE the pixel footprint (biased
    # jitter into the neighboring row region)
    s_idx = s_idx % (sqrt_spp * sqrt_spp)
    s_i = (s_idx % sqrt_spp).astype(dt)
    s_j = (s_idx // sqrt_spp).astype(dt)
    return (s_i, s_j, float(sqrt_spp))


def trace_rays(scene: Scene, cam: CameraParams, key_sc: jax.Array,
               s_idx, px, py, *, max_depth: int, integrator: str = "path",
               stratified: bool = False, sqrt_spp: int = 0,
               backend: str = "xla") -> jnp.ndarray:
    """Trace ONE sample for a chunk of pixels; the shared inner unit of both
    the single-device pass loop and the sharded (shard_map) pass.

    key_sc: the per-(sample, chunk) key — identical streams regardless of how
    pixels/samples are sharded, so N-device renders reproduce 1-device renders.
    s_idx: absolute sample index (drives book-3 stratification).
    px, py: [chunk] pixel coordinates (float).
    Returns the radiance [chunk, 3] of this sample (box pixel filter — the
    production estimator; the differentiable path's tent-splatted variant
    is :func:`trace_rays_diff`).
    """
    dt = jnp.float32
    opts = IntegratorOptions(max_depth=max_depth, bg_mode=cam.bg_mode,
                             backend=backend)
    trace = trace_mis if integrator == "mis" else trace_path
    k_cam, k_path = jax.random.split(key_sc)
    cam_draws = jax.random.uniform(k_cam, (px.shape[0], 5), dtype=dt)
    strat = _strat_tuple(s_idx, stratified, sqrt_spp)
    o, d, time = generate_rays(cam, px, py, cam_draws, strat)
    return trace(k_path, o, d, time, scene, cam.background, opts)


def trace_rays_diff(scene: Scene, cam: CameraParams, key_sc: jax.Array,
                    s_idx, px, py, *, max_depth: int,
                    integrator: str = "path", stratified: bool = False,
                    sqrt_spp: int = 0, warp: bool = True):
    """The DIFFERENTIABLE path's inner unit: same draw layout and streams
    as :func:`trace_rays`, but primary rays go through ops/warp.py
    (``warp=True`` adds the silhouette warp; False is the value-identical
    plain forward) and the caller must tent-SPLAT each sample onto its
    2x2 pixel neighborhood (see the pixel-filter note in
    ``ops.warp.warped_primary_rays``).

    Returns (radiance*det [chunk,3], u_w [chunk,2])."""
    dt = jnp.float32
    opts = IntegratorOptions(max_depth=max_depth, bg_mode=cam.bg_mode,
                             backend="xla")
    trace = trace_mis if integrator == "mis" else trace_path
    k_cam, k_path = jax.random.split(key_sc)
    cam_draws = jax.random.uniform(k_cam, (px.shape[0], 5), dtype=dt)
    strat = _strat_tuple(s_idx, stratified, sqrt_spp)
    from .ops.warp import warped_primary_rays

    o, d, time, det, u_w = warped_primary_rays(
        scene, cam, px, py, cam_draws, strat, warp=warp)
    rad = trace(k_path, o, d, time, scene, cam.background, opts)
    return rad * det[:, None], u_w


def splat_terms(px, py, u_w, valid, width: int, height: int):
    """The tent splat of a sample at pixel (px, py) + jitter ``u_w`` as
    four (flat_pixel_index [chunk], weight [chunk]) pairs.  Out-of-image
    neighbors clamp to the border pixel (energy-preserving, slightly
    lopsided border filter); ``valid`` (0/1 float) zeroes padding lanes so
    they cannot pollute real pixels."""
    from .ops.warp import splat_weights

    ix = px.astype(jnp.int32)
    iy = py.astype(jnp.int32)
    dx, dy, w00, w10, w01, w11 = splat_weights(u_w)
    nx = jnp.clip(ix + dx, 0, width - 1)
    ny = jnp.clip(iy + dy, 0, height - 1)
    return ((iy * width + ix, w00 * valid),
            (iy * width + nx, w10 * valid),
            (ny * width + ix, w01 * valid),
            (ny * width + nx, w11 * valid))


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "integrator",
                     "chunk", "stratified", "sqrt_spp", "backend"),
)
def render_pass(scene: Scene, cam: CameraParams, key: jax.Array, *,
                width: int, height: int, spp: int, max_depth: int,
                integrator: str = "path", chunk: int = 65536,
                stratified: bool = False, sqrt_spp: int = 0,
                sample_offset: jnp.ndarray | int = 0,
                backend: str = "xla") -> jnp.ndarray:
    """Trace ``spp`` samples/pixel; returns the RGB radiance SUM [H, W, 3].

    ``sample_offset`` shifts the per-sample RNG stream (for multi-pass and
    spp-sharded accumulation); stratification indexes the sqrt_spp x sqrt_spp
    sub-pixel grid by absolute sample index (camera.rs:173-177, book 3).
    ``backend`` is a resolved name ('xla' or 'sphere_kernel'); see
    :func:`resolve_backend`.
    """
    n_pix = width * height
    n_pad = _ceil_to(n_pix, chunk)
    n_chunks = n_pad // chunk
    dt = jnp.float32

    pix = jnp.arange(n_pad, dtype=jnp.int32)
    px_all = (pix % width).astype(dt)
    py_all = jnp.minimum(pix // width, height - 1).astype(dt)

    def trace_unit(key_s, s_idx, c_idx, accum):
        start = c_idx * chunk
        px = jax.lax.dynamic_slice(px_all, (start,), (chunk,))
        py = jax.lax.dynamic_slice(py_all, (start,), (chunk,))
        # fold in the chunk's START PIXEL (not its ordinal): the stream is
        # then independent of how chunks are distributed over a mesh, so an
        # N-device render is bit-identical to a 1-device render whenever the
        # effective chunk sizes match (see parallel/render.py)
        kc = jax.random.fold_in(key_s, start)
        radiance = trace_rays(
            scene, cam, kc, s_idx, px, py, max_depth=max_depth,
            integrator=integrator, stratified=stratified, sqrt_spp=sqrt_spp,
            backend=backend,
        )
        cur = jax.lax.dynamic_slice(accum, (start, 0), (chunk, 3))
        return jax.lax.dynamic_update_slice(accum, cur + radiance, (start, 0))

    def sample_body(s, accum):
        s_idx = s + sample_offset
        key_s = jax.random.fold_in(key, s_idx)

        def chunk_body(c, acc):
            return trace_unit(key_s, s_idx, c, acc)

        return jax.lax.fori_loop(0, n_chunks, chunk_body, accum)

    accum = jnp.zeros((n_pad, 3), dt)
    accum = jax.lax.fori_loop(0, spp, sample_body, accum)
    return accum[:n_pix].reshape(height, width, 3)


def finalize_image(accum_sum: np.ndarray, spp_total: int) -> np.ndarray:
    """(sum, count) -> 8-bit image; exactly render_io.rs:8-27: non-finite -> 0,
    divide by spp, gamma-2 sqrt, clamp to 0.999, scale by 256."""
    img = np.asarray(accum_sum, np.float32)
    scale = 1.0 / spp_total if spp_total > 0 else 0.0
    img = img * scale
    img = np.where(np.isfinite(img), img, 0.0)
    img = np.sqrt(np.maximum(img, 0.0))
    return (np.clip(img, 0.0, 0.999) * 256.0).astype(np.uint8)


BACKENDS = ("xla", "sphere_kernel")
DEFAULT_SPP_PER_PASS = 16  # the AUTO batch (gpu/mod.rs:11 SPP_PER_PASS)


def resolve_backend(scene: Scene, integrator: str, backend: str = "auto") -> str:
    """'auto' picks the closest-hit kernel for box-free 'path' scenes when
    JAX's default backend is the GPU, else the XLA path; an explicit
    backend is validated and returned as is."""
    if backend == "auto":
        from .ops.pallas_hit import sphere_kernel_eligible

        if (integrator == "path" and jax.default_backend() == "gpu"
                and sphere_kernel_eligible(scene)):
            return "sphere_kernel"
        return "xla"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be 'auto' or one of {BACKENDS}; "
                         f"got {backend!r}")
    if backend == "sphere_kernel" and integrator != "path":
        raise ValueError("backend='sphere_kernel' supports integrator='path' "
                         f"only; got {integrator!r}")
    return backend


def effective_spp_per_pass(cfg: RenderConfig, spp_total: int) -> int:
    """Samples per pass for the host pass loop: ``cfg.spp_per_pass``, or
    DEFAULT_SPP_PER_PASS when it is 0 (AUTO), never more than the render
    needs.  Every pass boundary is a checkpoint/progress point."""
    base = cfg.spp_per_pass if cfg.spp_per_pass > 0 else DEFAULT_SPP_PER_PASS
    return max(1, min(spp_total, base))


def render_image(scene: Scene, cfg: RenderConfig, *, integrator: str = "path",
                 chunk: int = 65536, progress=None,
                 accum_state: Optional[dict] = None, backend: str = "auto",
                 on_pass=None):
    """Full render: host pass loop over spp mega-batches.

    Returns (image_u8 [H,W,3], accum_state dict). ``accum_state`` from a prior
    call resumes accumulation (checkpoint/resume; SURVEY.md §5).  A failing
    pass raises; nothing is retried on another backend or device.
    """
    backend = resolve_backend(scene, integrator, backend)
    cam = derive_camera(cfg)
    h, w = cfg.image_height, cfg.image_width

    stratified = cfg.stratified
    sqrt_spp = int(np.sqrt(cfg.samples_per_pixel)) if stratified else 0
    spp_total = sqrt_spp * sqrt_spp if stratified else cfg.samples_per_pixel

    if accum_state is None:
        accum = jnp.zeros((h, w, 3), jnp.float32)
        done = 0
    else:
        accum = jnp.asarray(accum_state["accum"])
        done = int(accum_state["spp_done"])

    key = jax.random.key(cfg.seed)
    chunk = min(chunk, _ceil_to(h * w, 256))
    per_pass = effective_spp_per_pass(cfg, spp_total)

    while done < spp_total:
        this = min(per_pass, spp_total - done)
        accum = accum + render_pass(
            scene, cam, key,
            width=w, height=h, spp=this, max_depth=cfg.max_depth,
            integrator=integrator, chunk=chunk,
            stratified=stratified, sqrt_spp=sqrt_spp,
            sample_offset=done, backend=backend,
        )
        done += this
        if progress is not None:
            progress(done, spp_total)
        if on_pass is not None:
            # every pass boundary is a resumable state (SURVEY.md §5)
            on_pass({"accum": accum, "spp_done": done})

    accum_np = np.asarray(accum)
    return finalize_image(accum_np, done), {"accum": accum_np, "spp_done": done}
