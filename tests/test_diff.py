"""Differentiable / inverse rendering tests (BASELINE config 4).

Finite-difference checks use common random numbers (same key on both sides of
the difference) so the MC estimator is a fixed smooth function of the
parameters almost everywhere — FD then measures the same derivative autodiff
computes, without MC-noise/FD-noise interplay (SURVEY.md §7 "hard parts").
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustraytrace_tpu import RenderConfig, SceneBuilder
from rustraytrace_tpu.config import derive_camera
from rustraytrace_tpu.diff import (
    apply_params,
    fit,
    image_loss,
    make_train_step,
    render_mean,
)
from rustraytrace_tpu.parallel import make_mesh


def _lambertian_scene(albedo=(0.7, 0.3, 0.2), center=(0.0, 0.0, -1.2)):
    b = SceneBuilder()
    ground = b.lambertian((0.5, 0.5, 0.5))
    ball = b.lambertian(albedo)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere(center, 0.5, ball)
    return b.build()


CFG = RenderConfig(aspect_ratio=2.0, image_width=24, samples_per_pixel=4,
                   max_depth=3, vfov=90.0, lookfrom=(0, 0, 0),
                   lookat=(0, 0, -1), seed=11)
KW = dict(width=24, height=12, spp=4, max_depth=3, chunk=256)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices())


def test_grad_nonzero_and_finite(mesh):
    scene = _lambertian_scene()
    cam = derive_camera(CFG)
    key = jax.random.key(0)
    target = jnp.zeros((12, 24, 3))

    grads = jax.grad(
        lambda c: image_loss(
            dataclasses.replace(scene, sph_center=c), target, cam, key,
            mesh=mesh, **KW,
        )
    )(scene.sph_center)
    g = np.asarray(grads)
    assert np.all(np.isfinite(g))
    assert np.abs(g).max() > 0


def test_fd_matches_autodiff_albedo(mesh):
    """d(loss)/d(albedo) via FD with common random numbers vs autodiff."""
    scene = _lambertian_scene()
    cam = derive_camera(CFG)
    key = jax.random.key(5)
    target = jnp.full((12, 24, 3), 0.25)

    def loss_of(tex_color1):
        return image_loss(
            dataclasses.replace(scene, tex_color1=tex_color1), target, cam,
            key, mesh=mesh, **KW,
        )

    g_auto = np.asarray(jax.grad(loss_of)(scene.tex_color1))

    eps = 1e-3
    tc = np.asarray(scene.tex_color1)
    # check the ball's red channel (texture index 1, channel 0)
    for (ti, ch) in [(1, 0), (1, 2), (0, 1)]:
        up = tc.copy(); up[ti, ch] += eps
        dn = tc.copy(); dn[ti, ch] -= eps
        fd = (float(loss_of(jnp.asarray(up))) - float(loss_of(jnp.asarray(dn)))) / (2 * eps)
        assert fd == pytest.approx(g_auto[ti, ch], rel=0.05, abs=1e-5), (ti, ch)


def test_fd_matches_autodiff_geometry(mesh):
    """Geometry gradients on a silhouette-free setup.

    Interior-derivative autodiff (no edge sampling) cannot see visibility
    discontinuities, so FD-vs-AD geometry checks must avoid silhouettes: a
    view-filling noise-textured quad moved along its normal has only smooth
    dependence (hit point -> Perlin marble albedo).
    """
    b = SceneBuilder()
    wall = b.lambertian(tex=b.noise(0.7))
    b.add_quad((-60.0, -60.0, -3.0), (120.0, 0.0, 0.0), (0.0, 120.0, 0.0), wall)
    scene = b.build()
    cam = derive_camera(CFG)
    key = jax.random.key(9)
    target = jnp.zeros((12, 24, 3))

    def loss_of(quad_q):
        return image_loss(
            dataclasses.replace(scene, quad_q=quad_q), target, cam, key,
            mesh=mesh, **KW,
        )

    g_auto = np.asarray(jax.grad(loss_of)(scene.quad_q))
    assert np.all(np.isfinite(g_auto))
    eps = 1e-4  # FD converges to AD as eps -> 0 (rel err 0.18%/1e-4 measured)
    q = np.asarray(scene.quad_q)
    up = q.copy(); up[0, 2] += eps
    dn = q.copy(); dn[0, 2] -= eps
    fd = (float(loss_of(jnp.asarray(up))) - float(loss_of(jnp.asarray(dn)))) / (2 * eps)
    assert abs(g_auto[0, 2]) > 1e-6
    assert fd == pytest.approx(g_auto[0, 2], rel=0.02, abs=1e-6)


def test_fit_recovers_albedo(mesh):
    true_scene = _lambertian_scene(albedo=(0.8, 0.2, 0.2))
    cam = derive_camera(CFG)
    key = jax.random.key(1)
    target = render_mean(true_scene, cam, key, mesh=mesh, **KW)

    wrong = dataclasses.replace(
        true_scene,
        tex_color1=true_scene.tex_color1.at[1].set(jnp.asarray([0.3, 0.6, 0.6])),
    )

    fitted, hist = fit(
        wrong, ["tex_color1"], target, CFG, steps=60, learning_rate=0.05,
        mesh=mesh, spp=4, chunk=256,
    )
    # loss history is MC-noisy (fresh key per step); assert on the recovered
    # parameter and on the common-random-numbers loss instead
    loss_wrong = float(image_loss(wrong, target, cam, key, mesh=mesh, **KW))
    loss_fit = float(image_loss(fitted, target, cam, key, mesh=mesh, **KW))
    assert loss_fit < loss_wrong * 0.25
    rec = np.asarray(fitted.tex_color1[1])
    true = np.asarray(true_scene.tex_color1[1])
    assert np.abs(rec - true).max() < 0.15


def test_make_train_step_runs(mesh):
    scene = _lambertian_scene()
    target = jnp.zeros((CFG.image_height, CFG.image_width, 3))
    step, params, opt_state = make_train_step(
        scene, ["sph_center", "tex_color1"], target, CFG, mesh=mesh,
        spp=2, chunk=256,
    )
    step = jax.jit(step)
    params, opt_state, loss = step(params, opt_state, jax.random.key(0))
    assert np.isfinite(float(loss))
    jax.block_until_ready(params)


def test_fit_checkpoint_resume(mesh, tmp_path):
    """Train-state checkpointing (.npz): a run checkpointed at step N and
    resumed produces the same parameters as the uninterrupted run (the
    optimizer state, RNG key, and step counter all round-trip)."""
    scene = _lambertian_scene(albedo=(0.3, 0.6, 0.2))
    target = jnp.zeros((CFG.image_height, CFG.image_width, 3)) + 0.25
    ckdir = str(tmp_path / "ck")
    kw = dict(steps=4, learning_rate=5e-2, mesh=mesh, spp=2, chunk=256)

    full, _ = fit(scene, ["tex_color1"], target, CFG, **kw)

    # same run, checkpointed every 2 steps, then killed after step 2 and
    # resumed: first call runs steps 0-1 (we stop it by asking steps=2)
    fit(scene, ["tex_color1"], target, CFG, checkpoint_dir=ckdir,
        checkpoint_every=2, **{**kw, "steps": 2})
    resumed, _ = fit(scene, ["tex_color1"], target, CFG,
                     checkpoint_dir=ckdir, checkpoint_every=2,
                     resume=True, **kw)

    np.testing.assert_allclose(np.asarray(resumed.tex_color1),
                               np.asarray(full.tex_color1), atol=1e-6)


def _dielectric_scene(ior=1.5):
    b = SceneBuilder()
    ground = b.lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere((0.0, 0.0, -1.2), 0.5, b.dielectric(ior))
    return b.build()


def test_attached_ratio_unbiased_toy():
    """The dielectric reflect/refract choice is a detached sampling
    decision whose probability (Schlick) depends on mat_ior; the
    attached-ratio weight p/stop_grad(p) in ops/materials.py routes the
    probability derivative through the throughput.  Verified here on a
    closed-form toy: X = A if U < p(t) else B, weighted by the same ratio
    — E[X] = p*A + (1-p)*B, dE/dt = p'(t)*(A - B).  The MC gradient mean
    must match analytically (plain detached choice gives 0)."""
    A, B = 3.0, 1.0

    def p_of(t):
        return 0.3 + 0.4 * jax.nn.sigmoid(t)  # smooth, in (0.3, 0.7)

    u = jax.random.uniform(jax.random.key(0), (200_000,))

    def est(t):
        p = p_of(t)
        choice = p > u
        sg = jax.lax.stop_gradient
        w = jnp.where(choice, p / sg(p), (1.0 - p) / sg(1.0 - p))
        return jnp.mean(jnp.where(choice, A, B) * w)

    t0 = jnp.asarray(0.3)
    g = float(jax.grad(est)(t0))
    p_prime = float(jax.grad(p_of)(t0))
    expect = p_prime * (A - B)
    assert abs(g - expect) < 0.02 * abs(expect), (g, expect)


def test_ior_gradient_points_to_truth(mesh):
    """BASELINE config 4 (IOR recovery): with the attached-ratio estimator
    the loss gradient wrt mat_ior must pull toward the true value from
    both sides (before the fix the detached estimator's bias pointed
    descent away below ~1.45 — measured convergence to ~1.65/1.01)."""
    scene = _dielectric_scene(1.5)
    cam = derive_camera(CFG)
    target = render_mean(scene, cam, jax.random.key(9), mesh=mesh,
                         **{**KW, "spp": 64})

    def g(ior, k):
        def loss_of(x):
            s = dataclasses.replace(
                scene, mat_ior=scene.mat_ior.at[1].set(x))
            return image_loss(s, target, cam, jax.random.key(k),
                              mesh=mesh, **{**KW, "spp": 32})

        return float(jax.grad(loss_of)(jnp.asarray(ior)))

    g_lo = np.mean([g(1.30, k) for k in range(4)])
    g_hi = np.mean([g(1.75, k) for k in range(4)])
    assert g_lo < 0.0 < g_hi, (g_lo, g_hi)  # descent moves toward 1.5


def test_fit_recovers_ior(mesh):
    """Recover a dielectric's index of refraction by gradient descent
    (BASELINE config 4).  The IOR loss landscape is nonconvex: there is a
    spurious basin below 1.0 (total-internal-reflection regime) separated
    by a barrier near 1.0-1.2, so recovery is tested from a perturbation
    inside the true basin — the standard regime for nonconvex inverse
    rendering."""
    true_scene = _dielectric_scene(1.5)
    cam = derive_camera(CFG)
    # CLEAN target (64 spp): a 4-spp target's fixed noise realization
    # shifts the MSE minimizer measurably at this tiny resolution
    target = render_mean(true_scene, cam, jax.random.key(9), mesh=mesh,
                         **{**KW, "spp": 64})
    start = dataclasses.replace(
        true_scene, mat_ior=true_scene.mat_ior.at[1].set(1.35))
    import optax

    # cosine-annealed Adam (the valley is flat above 1.5; a constant step
    # size leaves a persistent MC random walk) + spp=32 per step: the MSE
    # objective contains the estimator's own variance term (E[(X-t)^2] =
    # bias^2 + Var X), and the dielectric render's variance falls with
    # ior, biasing low-spp fits upward (measured: ~1.65 at spp=8)
    fitted, hist = fit(start, ["mat_ior"], target, CFG, steps=60,
                       mesh=mesh, spp=32, chunk=256,
                       optimizer=optax.adam(
                           optax.cosine_decay_schedule(1e-2, 60)))
    rec = float(np.asarray(fitted.mat_ior)[1])
    # small upward residual is expected: the MSE objective carries the
    # estimator's own Var(render)/spp term, which decreases with ior
    assert abs(rec - 1.5) < 0.1, (rec, hist[-1])


def test_value_and_grad_loss_matches_fused_vag(mesh):
    """The two-program split (value_and_grad_loss: forward for
    loss+cotangent, grad-only contraction for the gradient) must equal the
    fused jax.value_and_grad(image_loss) — same keys => same samples =>
    the chain rule through a fixed cotangent is exact, not approximate."""
    from rustraytrace_tpu.diff import extract_params, value_and_grad_loss

    scene = _lambertian_scene()
    cam = derive_camera(CFG)
    key = jax.random.key(5)
    target = render_mean(scene, cam, jax.random.key(9), mesh=mesh, **KW)

    wrong = _lambertian_scene(albedo=(0.3, 0.6, 0.4), center=(0.1, 0.05, -1.1))
    params = extract_params(wrong, ["sph_center", "tex_color1"])

    loss_s, g_s = value_and_grad_loss(wrong, params, target, cam, key,
                                      mesh=mesh, **KW)

    def fused(p):
        return image_loss(apply_params(wrong, p), target, cam, key,
                          mesh=mesh, **KW)

    loss_f, g_f = jax.value_and_grad(fused)(params)
    np.testing.assert_allclose(float(loss_s), float(loss_f), rtol=1e-6)
    for k in g_s:
        np.testing.assert_allclose(np.asarray(g_s[k]), np.asarray(g_f[k]),
                                   rtol=2e-4, atol=1e-7)


def test_value_and_grad_loss_box_pair_matches_fused(mesh):
    """warp_primary=False: the split path pairs a BOX forward with the
    box contraction — must still equal the fused interior-only vag."""
    from rustraytrace_tpu.diff import extract_params, value_and_grad_loss

    scene = _lambertian_scene()
    cam = derive_camera(CFG)
    key = jax.random.key(6)
    target = jnp.zeros((12, 24, 3), jnp.float32)
    params = extract_params(scene, ["tex_color1"])

    loss_s, g_s = value_and_grad_loss(scene, params, target, cam, key,
                                      mesh=mesh, warp_primary=False, **KW)

    def fused(p):
        img = render_mean(apply_params(scene, p), cam, key, mesh=mesh,
                          warp_primary=False, **KW)
        return jnp.mean((img - target) ** 2)

    loss_f, g_f = jax.value_and_grad(fused)(params)
    np.testing.assert_allclose(float(loss_s), float(loss_f), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g_s["tex_color1"]),
                               np.asarray(g_f["tex_color1"]),
                               rtol=2e-4, atol=1e-7)


def test_value_and_grad_loss_kernel_forward(mesh):
    """forward="kernel": the loss/cotangent forward runs on the
    non-differentiable render path (the auto route: XLA on the CPU) with
    a box filter, while the gradient contraction program is
    unchanged.  The result is deliberately NOT the exact fused gradient;
    what must hold is that the decorrelated cotangent leaves the gradient a
    consistent descent direction: finite, same scale, high cosine
    similarity against the exact split at matched spp."""
    from rustraytrace_tpu.diff import extract_params, value_and_grad_loss

    scene = _lambertian_scene()
    cam = derive_camera(CFG)
    key = jax.random.key(5)
    kw = dict(KW, spp=64)
    target = render_mean(scene, cam, jax.random.key(9), mesh=mesh, **kw)

    wrong = _lambertian_scene(albedo=(0.3, 0.6, 0.4), center=(0.1, 0.05, -1.1))
    params = extract_params(wrong, ["sph_center", "tex_color1"])

    loss_k, g_k = value_and_grad_loss(wrong, params, target, cam, key,
                                      mesh=mesh, forward="kernel", **kw)
    loss_t, g_t = value_and_grad_loss(wrong, params, target, cam, key,
                                      mesh=mesh, **kw)

    assert np.isfinite(float(loss_k))
    # same objective, different (independent) 64-sample estimate + box-vs-
    # tent filter: the loss value agrees loosely
    np.testing.assert_allclose(float(loss_k), float(loss_t), rtol=0.25)
    for k in g_k:
        a, b = np.asarray(g_k[k]).ravel(), np.asarray(g_t[k]).ravel()
        assert np.all(np.isfinite(a))
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
        assert cos > 0.9, (k, cos)
        ratio = np.linalg.norm(a) / (np.linalg.norm(b) + 1e-30)
        assert 0.5 < ratio < 2.0, (k, ratio)
