"""Sharded rendering over a ('px', 'spp') device mesh via ``jax.shard_map``.

Pixels are blocked across the ``px`` axis (each device owns a contiguous run
of flattened pixel indices — the scanline-block analog of the reference's
rayon rows, ``src/books/*/camera.rs:66-88``) and samples across the ``spp``
axis (the analog of the reference's sequential GPU pass loop,
``src/gpu/mod.rs:444-481``, here executed concurrently on different devices
and reduced with ``psum``).

Determinism: every (sample, chunk-of-pixels) unit derives its key as
``fold_in(fold_in(key, global_sample_idx), chunk_start_pixel)`` — the SAME
derivation as the single-device pass loop, and independent of the mesh shape —
so an N-device render is bit-identical to the 1-device render when spp is
unsharded AND both runs use the same effective chunk size (the chunk start
pixels then coincide; pass ``chunk <= ceil(n_pix / n_px_shards)`` rounded to
256 to guarantee it), and equal up to f32 summation order when spp is
sharded.

The per-sample body is built from ``lax.scan`` (not ``fori_loop``) so the
whole pass is reverse-mode differentiable; ``jax.checkpoint`` around the
per-sample body keeps backward memory at one sample's residuals (inverse
rendering, BASELINE config 4).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import CameraParams, RenderConfig, derive_camera
from ..render import finalize_image, trace_rays
from ..scene import Scene


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "integrator",
                     "chunk", "stratified", "sqrt_spp", "mesh", "remat",
                     "backend", "warp_primary"),
)
def render_pass_sharded(scene: Scene, cam: CameraParams, key: jax.Array, *,
                        width: int, height: int, spp: int, max_depth: int,
                        mesh: Mesh, integrator: str = "path",
                        chunk: int = 65536, stratified: bool = False,
                        sqrt_spp: int = 0,
                        sample_offset: jnp.ndarray | int = 0,
                        remat: bool = True,
                        backend: str = "xla",
                        warp_primary=False) -> jnp.ndarray:
    """Trace >= ``spp`` samples/pixel across the mesh.

    Returns the radiance SUM [H, W, 3] (replicated over 'spp', sharded over
    'px' until gathered).  The actual sample count traced is
    ``ceil(spp / n_spp_shards) * n_spp_shards`` — use ``spp_traced`` to
    normalize:  ``render_pass_sharded.spp_traced(spp, mesh)``.

    ``warp_primary`` selects the DIFFERENTIABLE path's estimator: samples
    go through ``trace_rays_diff`` and are tent-SPLATTED onto their 2x2
    pixel neighborhoods (see ops/warp.py's pixel-filter note) — True adds
    the silhouette warp, "tent" is the value-identical plain forward.
    Splat contributions cross pixel-shard boundaries, so the accumulator
    is a full image per shard, psum'd to a replicated result.
    """
    n_px = mesh.shape["px"]
    n_spp = mesh.shape["spp"]
    n_pix = width * height
    per_shard = -(-n_pix // n_px)
    chunk_eff = min(chunk, _ceil_to(per_shard, 256))
    n_local = _ceil_to(per_shard, chunk_eff)
    n_pad = n_local * n_px
    n_chunks = n_local // chunk_eff
    spp_local = -(-spp // n_spp)
    dt = jnp.float32

    pix = jnp.arange(n_pad, dtype=jnp.int32)

    def shard_body(scene, cam, key, pix):
        spp_idx = jax.lax.axis_index("spp")
        px_idx = jax.lax.axis_index("px")
        px_all = (pix % width).astype(dt).reshape(n_chunks, chunk_eff)
        py_all = jnp.minimum(pix // width, height - 1).astype(dt).reshape(
            n_chunks, chunk_eff
        )
        valid_all = (pix < n_pix).astype(dt).reshape(n_chunks, chunk_eff)
        # global start pixel of each local chunk (mesh-independent key basis)
        gstarts = px_idx * n_local + jnp.arange(n_chunks) * chunk_eff

        if warp_primary:
            from ..render import splat_terms, trace_rays_diff

            def one_sample(s):
                s_idx = sample_offset + spp_idx * spp_local + s

                def chunk_body(acc, args):
                    gc, px, py, v = args
                    kc = jax.random.fold_in(
                        jax.random.fold_in(key, s_idx), gc)
                    rad, u_w = trace_rays_diff(
                        scene, cam, kc, s_idx, px, py, max_depth=max_depth,
                        integrator=integrator, stratified=stratified,
                        sqrt_spp=sqrt_spp, warp=warp_primary is True)
                    for idx, w in splat_terms(px, py, u_w, v, width, height):
                        acc = acc.at[idx].add(rad * w[:, None])
                    return acc, None

                acc, _ = jax.lax.scan(
                    chunk_body, jnp.zeros((n_pix, 3), dt),
                    (gstarts, px_all, py_all, valid_all))
                return acc

            body = jax.checkpoint(one_sample) if remat else one_sample

            def sample_body(accum, s):
                return accum + body(s), None

            accum, _ = jax.lax.scan(
                sample_body, jnp.zeros((n_pix, 3), dt),
                jnp.arange(spp_local))
            return jax.lax.psum(accum, ("px", "spp"))

        def one_sample(s):
            s_idx = sample_offset + spp_idx * spp_local + s

            def chunk_body(_, args):
                gc, px, py = args
                kc = jax.random.fold_in(jax.random.fold_in(key, s_idx), gc)
                rad = trace_rays(
                    scene, cam, kc, s_idx, px, py, max_depth=max_depth,
                    integrator=integrator, stratified=stratified,
                    sqrt_spp=sqrt_spp, backend=backend,
                )
                return None, rad

            _, rads = jax.lax.scan(chunk_body, None, (gstarts, px_all, py_all))
            return rads.reshape(n_local, 3)

        body = jax.checkpoint(one_sample) if remat else one_sample

        def sample_body(accum, s):
            return accum + body(s), None

        accum, _ = jax.lax.scan(
            sample_body, jnp.zeros((n_local, 3), dt), jnp.arange(spp_local)
        )
        return jax.lax.psum(accum, "spp")

    sharded = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("px")),
        out_specs=P() if warp_primary else P("px", None),
        # The integrator's scan carries mix constants (unvarying) with traced
        # values (varying); the static VMA check can't type that, so turn it
        # off — psum placement is explicit here anyway.
        check_vma=False,
    )
    accum = sharded(scene, cam, key, pix)
    if warp_primary:
        return accum.reshape(height, width, 3)
    return accum[:n_pix].reshape(height, width, 3)


def spp_traced(spp: int, mesh: Mesh) -> int:
    """Samples actually traced per pixel by ``render_pass_sharded``."""
    n_spp = mesh.shape["spp"]
    return -(-spp // n_spp) * n_spp


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "integrator",
                     "chunk", "stratified", "sqrt_spp", "mesh", "remat",
                     "warp_primary"),
)
def render_contract_sharded(scene: Scene, cam: CameraParams, key: jax.Array,
                            ct: jnp.ndarray, *,
                            width: int, height: int, spp: int, max_depth: int,
                            mesh: Mesh, integrator: str = "path",
                            chunk: int = 65536, stratified: bool = False,
                            sqrt_spp: int = 0,
                            sample_offset: jnp.ndarray | int = 0,
                            remat: bool = True,
                            warp_primary: bool = False) -> jnp.ndarray:
    """Scalar contraction ``sum(radiance_sum * ct)`` of the SAME sample set
    ``render_pass_sharded`` traces (identical keys/streams), without ever
    materializing the radiance image: each chunk's radiance contracts
    against its ``ct`` slice immediately and the scan carries one scalar.

    It is the backward half of ``diff.value_and_grad_loss``'s two-program
    split: a grad-ONLY program of this contraction — primal dead-coded,
    cotangent ``ct`` an argument — keeps the image buffer out of the
    backward program, and ``grad(render_contract_sharded)(p, ct)`` with
    ``ct = dLoss/dimage_sum`` IS the exact loss gradient when the keys
    match the forward render that produced the loss.

    ``ct``: [H, W, 3] cotangent w.r.t. the radiance SUM (not the mean).
    ``warp_primary``: as in ``render_pass_sharded`` — truthy routes
    through ``trace_rays_diff`` and contracts each sample against the
    tent-splat gather Σ_4 w_i·ct[p_i] (the per-chunk form of the splatted
    image's contraction; ``ct`` is replicated since splats cross shard
    boundaries); True adds the silhouette warp.
    """
    n_px = mesh.shape["px"]
    n_spp = mesh.shape["spp"]
    n_pix = width * height
    per_shard = -(-n_pix // n_px)
    chunk_eff = min(chunk, _ceil_to(per_shard, 256))
    n_local = _ceil_to(per_shard, chunk_eff)
    n_pad = n_local * n_px
    n_chunks = n_local // chunk_eff
    spp_local = -(-spp // n_spp)
    dt = jnp.float32

    pix = jnp.arange(n_pad, dtype=jnp.int32)
    ct_flat = jnp.zeros((n_pad, 3), dt).at[:n_pix].set(
        ct.reshape(n_pix, 3).astype(dt))

    def shard_body(scene, cam, key, pix, ct_in):
        spp_idx = jax.lax.axis_index("spp")
        px_idx = jax.lax.axis_index("px")
        px_all = (pix % width).astype(dt).reshape(n_chunks, chunk_eff)
        py_all = jnp.minimum(pix // width, height - 1).astype(dt).reshape(
            n_chunks, chunk_eff
        )
        valid_all = (pix < n_pix).astype(dt).reshape(n_chunks, chunk_eff)
        gstarts = px_idx * n_local + jnp.arange(n_chunks) * chunk_eff
        if warp_primary:
            # ct_in is the REPLICATED padded array: full-image view for
            # the splat gathers (splats cross shard boundaries)
            ct_full = ct_in[:n_pix]
            xs = (gstarts, px_all, py_all, valid_all)
        else:
            # ct_in is the shard's own [n_local, 3] slice: contract each
            # chunk against its aligned ct rows
            ct_full = None
            xs = (gstarts, px_all, py_all,
                  ct_in.reshape(n_chunks, chunk_eff, 3))

        def one_sample(s):
            s_idx = sample_offset + spp_idx * spp_local + s

            def chunk_body(acc, args):
                if warp_primary:
                    from ..render import splat_terms, trace_rays_diff

                    gc, px, py, v = args
                    kc = jax.random.fold_in(
                        jax.random.fold_in(key, s_idx), gc)
                    rad, u_w = trace_rays_diff(
                        scene, cam, kc, s_idx, px, py, max_depth=max_depth,
                        integrator=integrator, stratified=stratified,
                        sqrt_spp=sqrt_spp, warp=warp_primary is True)
                    ct_eff = sum(
                        w[:, None] * ct_full[idx]
                        for idx, w in splat_terms(px, py, u_w, v,
                                                  width, height))
                    return acc + jnp.sum(rad * ct_eff), None
                gc, px, py, ctc = args
                kc = jax.random.fold_in(jax.random.fold_in(key, s_idx), gc)
                rad = trace_rays(
                    scene, cam, kc, s_idx, px, py, max_depth=max_depth,
                    integrator=integrator, stratified=stratified,
                    sqrt_spp=sqrt_spp, backend="xla",
                )
                return acc + jnp.sum(rad * ctc), None

            out, _ = jax.lax.scan(chunk_body, jnp.float32(0), xs)
            return out

        body = jax.checkpoint(one_sample) if remat else one_sample

        def sample_body(accum, s):
            return accum + body(s), None

        accum, _ = jax.lax.scan(
            sample_body, jnp.float32(0), jnp.arange(spp_local)
        )
        return jax.lax.psum(accum, ("px", "spp"))

    sharded = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("px"), P() if warp_primary else P("px")),
        out_specs=P(),
        check_vma=False,
    )
    return sharded(scene, cam, key, pix, ct_flat)


def render_image_sharded(scene: Scene, cfg: RenderConfig, *, mesh: Mesh,
                         integrator: str = "path", chunk: int = 65536,
                         progress=None, accum_state: Optional[dict] = None,
                         backend: str = "auto", on_pass=None,
                         assemble=None):
    """Full sharded render: host pass loop, psum'd accumulation, finalize.

    The sharded analog of ``render.render_image``; returns
    (image_u8 [H,W,3], accum_state).  ``backend`` is routed by
    ``render.resolve_backend``, so a pixel-sharded render traces exactly
    what the single-device render traces.  ``on_pass(state)`` fires at
    every pass boundary with a resumable {accum, spp_done} dict
    (checkpointing — a killed sharded run otherwise loses all progress).
    A failing pass raises.

    ``assemble(device_accum) -> np.ndarray`` materializes the final
    framebuffer; the default (plain ``np.asarray``) is correct single-host.
    Multi-host jobs must pass a cross-host gather (multihost.py does), since
    a px-sharded global array is not fully addressable on any one host.
    """
    import numpy as np

    from ..render import DEFAULT_SPP_PER_PASS, resolve_backend

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
    n_spp = mesh.shape["spp"]
    per_pass = _ceil_to(cfg.spp_per_pass or DEFAULT_SPP_PER_PASS, n_spp)

    while done < spp_total:
        this = min(per_pass, _ceil_to(spp_total - done, n_spp))
        accum = accum + render_pass_sharded(
            scene, cam, key,
            width=w, height=h, spp=this, max_depth=cfg.max_depth,
            mesh=mesh, integrator=integrator, chunk=chunk,
            stratified=stratified, sqrt_spp=sqrt_spp, sample_offset=done,
            backend=backend,
        )
        done += spp_traced(this, mesh)
        if progress is not None:
            progress(done, spp_total)
        if on_pass is not None:
            on_pass({"accum": accum, "spp_done": done})

    accum_np = np.asarray(accum) if assemble is None else assemble(accum)
    return finalize_image(accum_np, done), {"accum": accum_np, "spp_done": done}
