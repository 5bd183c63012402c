"""Warped-area reparameterization: silhouette (visibility) gradients.

Interior autodiff differentiates radiance through hit points, normals, and
attenuations, but the MOVEMENT of sphere silhouettes under parameter change
(the boundary term of the pixel integral) has zero interior gradient — a
sphere's center/radius cannot be recovered from coverage by plain AD.  This
module implements the warped-area / reparameterized-sampling estimator
(Loubet et al. 2019, Bangaru et al. 2020) specialized to sphere silhouettes:

The sub-pixel jitter u is replaced by a warp  T(u, θ) = u + W(u, θ)  with

    W = - Σ_i  k(φ̂ᵈ_i) · (φ̂_i(θ) - φ̂_i(θᵈ)) · n̂ᵈ_i ,

where φ_i(u, θ) = h² - a·c is sphere i's ray-quadric DISCRIMINANT (whose
zero set in u-space IS the silhouette), φ̂ = φ/|∇_u φ| its unit-normalized
form, n̂ = ∇_u φ/|∇_u φ| the u-space silhouette normal, k a smooth bump that
is exactly 1 on the silhouette, and superscript ᵈ marks evaluation with
stop_gradient'ed SCENE ARRAYS (u stays attached — the divergence of the warp
field needs full u-dependence).  Properties:

* value:  W ≡ 0, det(∂T/∂u) ≡ 1 — the forward render is BIT-IDENTICAL;
* derivative: at a silhouette, ∂θT equals the boundary's u-velocity
  (implicit-function theorem on φ=0), so the discontinuity of the integrand
  f(T(u)) is stationary in u and the exact change of variables
  ∫ f(T)|det ∂T/∂u| du = ∫ f du differentiates to the full gradient,
  boundary term included.  Warps at "phantom" boundaries (occluded or
  back-facing silhouettes, where f is continuous) are harmless: the change
  of variables is exact for any smooth warp.

Scope: sphere silhouettes (the parameters BASELINE config 4 asks to
recover), on PRIMARY rays only (``warped_primary_rays``, analytic
u-gradients).  SECONDARY (shadow) silhouettes are interior-only — the
residual bias is pinned by tests/test_silhouette.py::
test_secondary_silhouette_residual_bias_quantified.

A per-bounce scatter-draw warp (Bangaru et al. 2020 §5 applied to
``dir(u) = normal + unit_vector(u)``) was built and REMOVED in round 4
after FD-vs-AD validation failed.  Measured findings, for whoever retries:
(1) the scatter u-square maps the whole hemisphere, so the primary σ=0.5
bump covered ~97% of draws (silhouettes sit ~0.1-0.3 φ̂-units from a random
draw) and every lane warped with the boundary velocity — |∂θ dir| averaged
~7e3 per unit center shift; (2) pole draws (u2≈0/1) meet the unit_vector
sqrt's infinite Jacobian and NaN the whole gradient once u_w carries
θ-dependence; (3) lanes bouncing OFF a sphere see their own surface at
c0≈0, where scale≈1e-15 divisors overflow the second-order jvp (a
t_root-window gate fixes this); (4) with all of the above fixed and σ=0.02
the isolated estimator E[f·det] matched FD to 1% at 2M samples from ONE
origin, but at render level (20², 512-8192 spp, shadow-occluder scene) the
det-term variance swamped the FD=9 signal (per-seed AD swung -4..+2) —
the u-space measure distortion concentrates unbounded per-lane
contributions in an O(σ) band, and no tested σ ∈ [0.005, 0.5] converged.
A retry needs a direction-space warp with harmonic/partition-of-unity
weights, not this u-square construction.
The reference has no gradients of any kind (it is a forward renderer).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..scene import Scene

_SIGMA = 0.5  # bump width in sub-pixel (jitter) units


def splat_weights(u: jnp.ndarray):
    """Bilinear (tent-filter) splat of a jitter position u [R,2] in
    [-0.5, 0.5]^2 onto the sample's 2x2 pixel neighborhood.

    Returns (dx [R], dy [R], w00, w10, w01, w11) where (dx, dy) in
    {-1,0,+1} are the offsets of the second column/row and the four
    weights (partition of unity: they sum to exactly 1) correspond to
    offsets (0,0), (dx,0), (0,dy), (dx,dy).  Differentiable in u away
    from the measure-zero |u|=0 kinks — the θ-gradient of these weights
    through the warped jitter IS the filter-crossing term of the
    warped-area estimator (see the module/pixel-filter note in
    ``warped_primary_rays``)."""
    ax = jnp.abs(u[:, 0])
    ay = jnp.abs(u[:, 1])
    dx = jnp.where(u[:, 0] >= 0.0, 1, -1)
    dy = jnp.where(u[:, 1] >= 0.0, 1, -1)
    bx0 = 1.0 - ax
    by0 = 1.0 - ay
    return (dx, dy, bx0 * by0, ax * by0, bx0 * ay, ax * ay)


def _disc_terms(u, base, du, dv, o, time, C, V, r):
    """Discriminant and its analytic u-gradient for every (ray, sphere).

    u: [R,2] jitter; base/du/dv: ray-direction affine frame ([R,3]/[3]/[3]);
    o: [R,3] origins; time: [R]; C/V/r: sphere arrays.
    Returns (disc [R,N], gx [R,N], gy [R,N]).  Direct quadric form, the
    same as ``intersect.hit_spheres`` (oc = cc - o before any product).
    """
    d = base + u[:, 0:1] * du[None, :] + u[:, 1:2] * dv[None, :]  # [R,3]
    oc = (C[None, :, :] + time[:, None, None] * V[None, :, :]
          - o[:, None, :])  # [R,N,3]
    a = jnp.sum(d * d, axis=-1)  # [R]
    h = jnp.sum(d[:, None, :] * oc, axis=-1)  # [R,N]
    c0 = jnp.sum(oc * oc, axis=-1) - (r * r)[None, :]
    disc = h * h - a[:, None] * c0

    # analytic u-gradients: ∂d/∂u_x = du, ∂h/∂u_x = du·oc,
    # ∂a/∂u_x = 2 d·du, c0 independent of u.
    h_x = jnp.sum(du[None, None, :] * oc, axis=-1)  # [R,N]
    h_y = jnp.sum(dv[None, None, :] * oc, axis=-1)
    a_x = 2.0 * jnp.sum(d * du[None, :], axis=-1)  # [R]
    a_y = 2.0 * jnp.sum(d * dv[None, :], axis=-1)
    gx = 2.0 * h * h_x - a_x[:, None] * c0
    gy = 2.0 * h * h_y - a_y[:, None] * c0
    return disc, gx, gy


def _warp_field(u, base, du, dv, o, time, scene: Scene, scene_d: Scene):
    """W(u) [R,2]: zero-valued warp carrying the silhouette θ-derivative."""
    # attached-θ and detached-θ normalized discriminants; the DETACHED pass
    # defines the geometry of the warp field (normals, bump weights) while
    # staying fully differentiable in u
    disc_a, _, _ = _disc_terms(u, base, du, dv, o, time,
                               scene.sph_center, scene.sph_cvel,
                               scene.sph_radius)
    disc_det, gx, gy = _disc_terms(u, base, du, dv, o, time,
                                   scene_d.sph_center, scene_d.sph_cvel,
                                   scene_d.sph_radius)
    # +1e-30 keeps sqrt differentiable when the u-gradient vanishes exactly
    # (e.g. the zero-radius PADDING sphere with the camera at the origin:
    # disc == gx == gy == 0 there, and sqrt'(0)=inf would poison every
    # gradient through 0*NaN even though the mask zeroes the term's value)
    gnorm = jnp.sqrt(gx * gx + gy * gy + 1e-30)
    # normalize by the silhouette scale; soft floor keeps T smooth where the
    # u-gradient degenerates (ray through sphere center / grazing setups)
    scale = jnp.maximum(gnorm, 1e-3 * (jnp.abs(disc_det) + 1e-12))
    phi_a = disc_a / scale
    phi_d = disc_det / scale
    delta = phi_a - phi_d  # == 0 in value; ∂θ delta = ∂θ φ̂
    k = jnp.exp(-(phi_d / _SIGMA) ** 2) * scene.sph_mask[None, :]
    nx = gx / scale
    ny = gy / scale
    wx = -jnp.sum(k * delta * nx, axis=-1)  # [R]
    wy = -jnp.sum(k * delta * ny, axis=-1)
    return jnp.stack([wx, wy], axis=-1)


def warped_primary_rays(scene: Scene, cam, px, py, draws, strat=None,
                        warp: bool = True):
    """Primary rays for the DIFFERENTIABLE path: box-jittered rays, plus
    (``warp=True``) the silhouette warp applied to the jitter.

    Returns (origin [R,3], direction [R,3], time [R], det [R], u_w [R,2]):
    ``det`` (≡ 1 in value when warping) multiplies the sample's radiance,
    and ``u_w`` is the (warped — value-identical) sub-pixel jitter the
    caller must SPLAT with (``splat_weights``).

    PIXEL FILTER (round 5): the differentiable path SPLATS each sample
    onto its 2x2 pixel neighborhood with bilinear (tent) weights instead
    of binning it to its own pixel (box filter).  Why: the warped-area
    change of variables ∫ f(T(u))·det du = ∫ f du is exact per
    integration cell only up to a flux through the cell boundary, where
    the warp field W does not vanish — with box binning that adds a
    pixel-edge flux term ∮ f·(∂θW·n) to every pixel's AD gradient.  The
    flux cancels between neighbors for UNIFORM loss cotangents (sum/mean
    losses — how the round-3 validation was run) but biases any per-pixel
    loss: measured on the minimal one-sphere scene at an offset state
    (MSE vs a fixed target, 16 keys), box-filter AD captured only 60-77%
    of the lateral FD gradient and got DEPTH backwards (ad=-0.054 vs
    fd=+0.061) — which made the BASELINE-config-4 fit walk away from the
    optimum it had nearly reached (scripts/diag_grad_bias.py).  With tent
    SPLATTING the sample's image contribution Σ_p tent(s-p)·f(s) is
    CONTINUOUS in the global sample position s, so adjacent cells' flux
    integrands are identical and cancel exactly for ANY cotangent; the
    θ-gradient of the splat weights through u_w is the filter-crossing
    term, and it scales with LOCAL cotangent differences (exactly zero
    for uniform ones — a tent importance-RATIO formulation was tried
    first and its 1/tent(u) weight swung single-key sum-loss gradients by
    3x; the partition-of-unity splat replaces it).  ``warp=False`` gives
    the same rays (bit-identical values, det 1) without the warp
    machinery — the cheap forward of diff.value_and_grad_loss."""
    from .rng import in_unit_disk

    dt = draws.dtype
    if strat is None:
        ox = draws[:, 0] - 0.5
        oy = draws[:, 1] - 0.5
    else:
        s_i, s_j, sqrt_spp = strat
        recip = 1.0 / sqrt_spp
        ox = (s_i + draws[:, 0]) * recip - 0.5
        oy = (s_j + draws[:, 1]) * recip - 0.5
    u = jnp.stack([ox, oy], axis=-1)  # [R,2]

    if cam.lens_radius_gt0:
        disk = in_unit_disk(draws[:, 2], draws[:, 3])
        origin = (cam.center[None, :]
                  + disk[:, 0:1] * cam.defocus_disk_u[None, :]
                  + disk[:, 1:2] * cam.defocus_disk_v[None, :])
    else:
        origin = jnp.broadcast_to(cam.center[None, :],
                                  (px.shape[0], 3)).astype(dt)
    time = draws[:, 4]

    if not warp:
        pixel_sample = (cam.pixel00[None, :]
                        + (px + u[:, 0])[:, None] * cam.pixel_delta_u[None, :]
                        + (py + u[:, 1])[:, None] * cam.pixel_delta_v[None, :])
        return (origin, pixel_sample - origin, time, jnp.ones_like(time), u)

    base = (cam.pixel00[None, :]
            + px[:, None] * cam.pixel_delta_u[None, :]
            + py[:, None] * cam.pixel_delta_v[None, :]
            - origin)

    sg = jax.lax.stop_gradient
    import dataclasses

    scene_d = dataclasses.replace(
        scene, sph_center=sg(scene.sph_center), sph_cvel=sg(scene.sph_cvel),
        sph_radius=sg(scene.sph_radius))

    def W(uu):
        return _warp_field(uu, base, cam.pixel_delta_u, cam.pixel_delta_v,
                           sg(origin), sg(time), scene, scene_d)

    e1 = jnp.broadcast_to(jnp.asarray([1.0, 0.0], dt), u.shape)
    e2 = jnp.broadcast_to(jnp.asarray([0.0, 1.0], dt), u.shape)
    w_val, j1 = jax.jvp(W, (u,), (e1,))  # ∂W/∂u_x [R,2]
    _, j2 = jax.jvp(W, (u,), (e2,))
    det = ((1.0 + j1[:, 0]) * (1.0 + j2[:, 1]) - j1[:, 1] * j2[:, 0])

    u_w = u + w_val  # value-identical; derivative tracks the silhouette
    pixel_sample = (cam.pixel00[None, :]
                    + (px + u_w[:, 0])[:, None] * cam.pixel_delta_u[None, :]
                    + (py + u_w[:, 1])[:, None] * cam.pixel_delta_v[None, :])
    direction = pixel_sample - origin
    return origin, direction, time, det, u_w


