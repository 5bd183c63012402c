"""Differentiable rendering and inverse rendering (BASELINE config 4).

The reference has no differentiability anywhere — it is a forward renderer.
This module is the capability the JAX re-design adds for free by being
functional JAX end-to-end: the SoA ``Scene`` pytree (sphere centers, radii,
albedo/texture colors, fuzz, IOR, emission) IS the parameter vector, and the
scan-based sharded render pass (``parallel.render.render_pass_sharded``) is
reverse-mode differentiable with per-sample rematerialization.

Gradient semantics (SURVEY.md §7 "unbiased differentiability"):
* discrete sampling decisions (Russian-roulette survival, dielectric
  reflect/refract choice, light picking, RR probability) are DETACHED —
  ``stop_gradient`` inside the integrator keeps the estimator's expectation
  differentiable through the continuous factors only;
* gradients flow through hit points, normals, attenuations, Schlick, and
  texture lookups.

``fit`` runs Adam over any named subset of Scene arrays against a target
image — the "recover sphere centers/albedos/IOR from a target" benchmark.

The production loss+grad is a two-program split
(:func:`value_and_grad_loss`: a forward render, then a grad-only
contraction), and the differentiable estimator tent-SPLATS each sample
onto its 2x2 pixel
neighborhood (the warped-area boundary term is per-pixel-exact only
under a partition-of-unity filter; ops/warp.py's pixel-filter note).
``image_loss``/``render_mean`` + ``jax.grad`` remain the fused spelling
for tests, the sharded train step and the multichip dryrun.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from .config import CameraParams, RenderConfig, derive_camera
from .parallel.mesh import make_mesh
from .parallel.render import (render_contract_sharded, render_pass_sharded,
                              spp_traced)
from .scene import Scene


def render_mean(scene: Scene, cam: CameraParams, key: jax.Array, *,
                width: int, height: int, spp: int, max_depth: int,
                mesh: Mesh, integrator: str = "path",
                chunk: int = 65536,
                warp_primary: bool = True) -> jnp.ndarray:
    """Differentiable MEAN-radiance render [H, W, 3] (linear space).

    ``warp_primary`` (default ON here) enables the warped-area silhouette
    reparameterization (ops/warp.py): forward values are unchanged, but the
    backward pass gains the sphere-visibility boundary term — without it,
    sphere centers/radii have interior-only gradients and coverage changes
    are invisible to the optimizer."""
    total = spp_traced(spp, mesh)
    acc = render_pass_sharded(
        scene, cam, key, width=width, height=height, spp=spp,
        max_depth=max_depth, mesh=mesh, integrator=integrator, chunk=chunk,
        remat=True, warp_primary=warp_primary,
    )
    return acc / total


def image_loss(scene: Scene, target: jnp.ndarray, cam: CameraParams,
               key: jax.Array, **render_kw) -> jnp.ndarray:
    """Mean squared error between the linear-radiance render and target."""
    img = render_mean(scene, cam, key, **render_kw)
    return jnp.mean((img - target) ** 2)


def extract_params(scene: Scene, names: Sequence[str]) -> Dict[str, jnp.ndarray]:
    return {n: getattr(scene, n) for n in names}


def apply_params(scene: Scene, params: Dict[str, jnp.ndarray]) -> Scene:
    return dataclasses.replace(scene, **params)


@jax.jit
def _mse_and_ct(img: jnp.ndarray, target: jnp.ndarray, total_spp):
    """MSE loss and its cotangent w.r.t. the radiance SUM (img * total)."""
    diff = img - target
    loss = jnp.mean(diff * diff)
    ct = 2.0 * diff / (diff.size * total_spp)
    return loss, ct


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "integrator",
                     "chunk", "mesh", "warp_primary"),
)
def _contract_grad(scene: Scene, params, cam: CameraParams, key, ct, *,
                   width: int, height: int, spp: int, max_depth: int,
                   mesh: Mesh, integrator: str, chunk: int,
                   warp_primary: bool):
    def s_fn(p):
        return render_contract_sharded(
            apply_params(scene, p), cam, key, ct, width=width, height=height,
            spp=spp, max_depth=max_depth, mesh=mesh, integrator=integrator,
            chunk=chunk, remat=True, warp_primary=warp_primary)

    return jax.grad(s_fn)(params)


def value_and_grad_loss(scene: Scene, params: Dict[str, jnp.ndarray],
                        target: jnp.ndarray, cam: CameraParams,
                        key: jax.Array, *, width: int, height: int, spp: int,
                        max_depth: int, mesh: Mesh, integrator: str = "path",
                        chunk: int = 65536, warp_primary: bool = True,
                        forward: str = "trace",
                        ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Exact ``(image_loss, d image_loss/d params)`` as two programs.

    ``jax.value_and_grad(image_loss)`` is the natural spelling; this splits
    the step into two programs over the SAME sample set (identical fold_in
    streams):

    1. forward render (no warp — the warp is value-identical: W ≡ 0,
       det ≡ 1) → loss and the MSE cotangent ``ct = dL/d(radiance sum)``;
    2. ``grad(Σ radiance·ct)`` via :func:`render_contract_sharded`, whose
       per-chunk contraction keeps the image buffer out of the program and
       whose primal is dead — the gradient it returns equals the fused
       ``value_and_grad`` gradient exactly (first-order chain rule through
       a fixed cotangent evaluated at the same parameters).

    The split was forced by a compiler crash on the fused program on an
    earlier accelerator; on an H100 the fused program compiles and matches
    it (``chip_smoke.py``'s gradient phase), so the split is a candidate
    for removal.

    ``forward="kernel"`` runs the loss/cotangent forward on the
    non-differentiable render path instead
    (:func:`rustraytrace_tpu.render.render_pass`, auto backend) with the
    box pixel filter instead of the grad program's tent splat: the
    stochastic gradient stays a consistent descent direction for the MSE
    but is no longer the exact fused-vag gradient; use the default for FD
    validation and tests (single-device forward; the grad program stays
    sharded).
    """
    total = spp_traced(spp, mesh)
    scene_p = apply_params(scene, params)
    if forward == "kernel":
        from .render import render_pass, resolve_backend

        acc = render_pass(
            scene_p, cam, key, width=width, height=height, spp=total,
            max_depth=max_depth, integrator=integrator,
            chunk=min(chunk, width * height),
            backend=resolve_backend(scene_p, integrator))
    else:
        # "tent": same tent pixel filter (and therefore bit-identical sample
        # values) as the warped grad program, without the warp machinery
        acc = render_pass_sharded(
            scene_p, cam, key, width=width, height=height, spp=spp,
            max_depth=max_depth, mesh=mesh, integrator=integrator,
            chunk=chunk, remat=True,
            warp_primary="tent" if warp_primary else False)
    loss, ct = _mse_and_ct(acc / total, jnp.asarray(target, jnp.float32),
                           float(total))
    grads = _contract_grad(
        scene, params, cam, key, ct, width=width, height=height, spp=spp,
        max_depth=max_depth, mesh=mesh, integrator=integrator, chunk=chunk,
        warp_primary=warp_primary)
    return loss, grads


def fit(scene: Scene, param_names: Sequence[str], target: jnp.ndarray,
        cfg: RenderConfig, *, steps: int = 100, learning_rate: float = 1e-2,
        mesh: Optional[Mesh] = None, integrator: str = "path",
        spp: int = 4, chunk: int = 65536, progress=None,
        optimizer: Optional[optax.GradientTransformation] = None,
        checkpoint_dir: Optional[str] = None, checkpoint_every: int = 25,
        resume: bool = False, forward: str = "trace",
        ) -> Tuple[Scene, list]:
    """Gradient-descent recovery of scene parameters from a target image.

    Returns (fitted scene, per-step loss history). Each step uses a fresh
    RNG key (new MC sample set) — stochastic gradient descent over renders.

    ``checkpoint_dir`` (an .npz per checkpoint) persists (step, params,
    optimizer state, RNG key) every ``checkpoint_every`` steps; ``resume=True``
    restarts a killed run from it mid-optimization (the train-state analog
    of the renderer's pass-boundary .npz accumulation checkpoints).

    ``forward="kernel"`` routes each step's loss/cotangent forward through
    the non-differentiable render path (see :func:`value_and_grad_loss` —
    decorrelated but consistent gradients).
    """
    if mesh is None:
        mesh = make_mesh()
    cam = derive_camera(cfg)
    opt = optimizer if optimizer is not None else optax.adam(learning_rate)
    params = extract_params(scene, param_names)
    opt_state = opt.init(params)
    target = jnp.asarray(target, jnp.float32)

    render_kw = dict(
        width=cfg.image_width, height=cfg.image_height, spp=spp,
        max_depth=cfg.max_depth, mesh=mesh, integrator=integrator,
        chunk=chunk,
    )

    # the loss+grad is the two-program split (value_and_grad_loss); the
    # optax update is its own small jitted program
    @jax.jit
    def update_step(grads, opt_state, params):
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    def train_step(params, opt_state, key):
        loss, grads = value_and_grad_loss(
            scene, params, target, cam, key, forward=forward, **render_kw)
        params, opt_state = update_step(grads, opt_state, params)
        return params, opt_state, loss

    key = jax.random.key(cfg.seed + 1)
    step0 = 0
    if checkpoint_dir is not None and resume:
        import os

        from .utils.checkpoint import load_train_checkpoint, train_state_path

        if os.path.exists(train_state_path(checkpoint_dir)):
            step0, params, opt_state, key = load_train_checkpoint(
                checkpoint_dir, params_like=params,
                opt_state_like=opt_state)
    history = []
    for step in range(step0, steps):
        key, sub = jax.random.split(key)
        params, opt_state, loss = train_step(params, opt_state, sub)
        history.append(float(loss))
        if progress is not None:
            progress(step, history[-1])
        if (checkpoint_dir is not None
                and (step + 1) % checkpoint_every == 0):
            from .utils.checkpoint import save_train_checkpoint

            save_train_checkpoint(checkpoint_dir, step=step + 1,
                                  params=params, opt_state=opt_state,
                                  key=key)
    return apply_params(scene, params), history


def make_train_step(scene: Scene, param_names: Sequence[str],
                    target: jnp.ndarray, cfg: RenderConfig, *, mesh: Mesh,
                    integrator: str = "path", spp: int = 4,
                    learning_rate: float = 1e-2, chunk: int = 65536):
    """Build (train_step, params0, opt_state0) for external loops.

    ``train_step(params, opt_state, key) -> (params, opt_state, loss)`` is a
    single jittable update: sharded differentiable render, psum'd gradients
    (implicit in shard_map's backward), Adam update.  This is the "full
    training step" the multi-chip dry-run compiles.
    """
    cam = derive_camera(cfg)
    opt = optax.adam(learning_rate)
    params = extract_params(scene, param_names)
    opt_state = opt.init(params)
    target = jnp.asarray(target, jnp.float32)
    render_kw = dict(
        width=cfg.image_width, height=cfg.image_height, spp=spp,
        max_depth=cfg.max_depth, mesh=mesh, integrator=integrator,
        chunk=chunk,
    )

    def train_step(params, opt_state, key):
        def loss_fn(p):
            return image_loss(apply_params(scene, p), target, cam, key,
                              **render_kw)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return train_step, params, opt_state
