"""Path-tracing integrators as fixed-depth masked ``lax.scan`` bounce loops.

The reference's recursive ``ray_color`` (books 1/2: src/books/in_one_weekend/
camera.rs:182-209, the_next_week/camera.rs:174-201) and the GPU iterative
megakernel loop (src/gpu/renderer.wgsl:175-246) become a ``lax.scan`` over
bounce index carrying (origin, direction, time, attenuation, radiance, alive).
Dead lanes are masked, not exited, so every bounce is one fixed-shape step.

Russian roulette matches the reference exactly: kicks in at bounce >= 5 with
survival p = clamp(max channel of the running attenuation, 0.05, 0.95)
(renderer.wgsl:225-231; camera.rs:189-200 uses the per-hit albedo — we follow
the f32/GPU semantics, which use the running product).

``trace_mis`` implements book 3's NEE/MIS estimator
(the_rest_of_your_life/camera.rs:184-254): emitted + specular skip-pdf branch,
otherwise a 50/50 mixture of the light PDF (solid-angle spheres, area quads)
and the material PDF (cosine / uniform-sphere), with RR folded into the
estimator denominator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..scene import Scene, LIGHT_QUAD
from . import rng
from .intersect import closest_hit, sphere_roots, T_MIN, T_MAX
from .materials import gather_mat, scatter

_PI = 3.14159265358979

RR_START_BOUNCE = 5  # renderer.wgsl:225 / camera.rs:189
RR_P_MIN = 0.05
RR_P_MAX = 0.95


@dataclasses.dataclass(frozen=True)
class IntegratorOptions:
    max_depth: int
    bg_mode: int  # config.BG_SKY | config.BG_FLAT
    emit_front_only: bool = False  # book 3 gate
    rr_from_running_product: bool = True  # GPU semantics; book 3 uses per-hit
    # "xla" = the [R, N] reference intersect; "sphere_kernel" = the Pallas
    # (Triton) closest-hit kernel for box-free scenes (ops/pallas_hit.py)
    backend: str = "xla"


def n_media(scene: Scene) -> int:
    return scene.msph_center.shape[0] + scene.mbox_cos.shape[0]


def sky_color(d: jnp.ndarray) -> jnp.ndarray:
    """lerp((1,1,1) -> (0.5,0.7,1.0)) on unit-dir y (camera.rs:206-208)."""
    unit = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    a = 0.5 * (unit[:, 1] + 1.0)
    white = jnp.asarray([1.0, 1.0, 1.0], d.dtype)
    blue = jnp.asarray([0.5, 0.7, 1.0], d.dtype)
    return (1.0 - a)[:, None] * white + a[:, None] * blue


def _background(d, scene_bg, bg_mode):
    from ..config import BG_SKY

    if bg_mode == BG_SKY:
        return sky_color(d)
    return jnp.broadcast_to(scene_bg[None, :], d.shape)


def trace_path(key: jax.Array, o, d, time, scene: Scene, background,
               opts: IntegratorOptions) -> jnp.ndarray:
    """Books 1/2 integrator. o,d: [R,3]; time: [R]. Returns radiance [R,3]."""
    R = o.shape[0]
    dt = o.dtype
    nm = n_media(scene)

    def step(carry, bounce):
        o, d, time, atten, radiance, alive = carry
        kb = jax.random.fold_in(key, bounce)

        draws = rng.uniforms(kb, (R,), 4 + nm)
        if opts.backend == "sphere_kernel":
            from .pallas_hit import closest_hit_spheres_pallas

            rec, mat = closest_hit_spheres_pallas(
                o, d, time, scene, u_media=draws[:, 4:])
        else:
            rec = closest_hit(o, d, time, scene, draws[:, 4:])
            mat = gather_mat(scene, rec)

        # miss -> background, die (camera.rs:206-208 / the_next_week:176-179)
        bg = _background(d, background, opts.bg_mode)
        miss = alive & ~rec.valid
        radiance = radiance + jnp.where(miss[:, None], atten * bg, 0.0)

        sc = scatter(d, rec, mat, draws[:, 0:3], opts.emit_front_only)

        # emission on hit (the_next_week/camera.rs:183-197)
        radiance = radiance + jnp.where(
            (alive & rec.valid)[:, None], atten * sc.emitted, 0.0
        )

        new_alive = alive & rec.valid & sc.scattered
        new_atten = atten * sc.attenuation

        direction = sc.direction

        # Russian roulette (renderer.wgsl:225-231). The survival probability
        # is a SAMPLING decision — detached so inverse-rendering gradients
        # stay continuous (diff.py; SURVEY.md §7 differentiability).
        rr_basis = new_atten if opts.rr_from_running_product else sc.attenuation
        p = jax.lax.stop_gradient(
            jnp.clip(jnp.max(rr_basis, axis=-1), RR_P_MIN, RR_P_MAX)
        )
        do_rr = bounce >= RR_START_BOUNCE
        survive = draws[:, 3] <= p
        new_alive = new_alive & (~do_rr | survive)
        new_atten = jnp.where((do_rr & new_alive)[:, None], new_atten / p[:, None], new_atten)

        new_o = jnp.where(new_alive[:, None], rec.p, o)
        new_d = jnp.where(new_alive[:, None], direction, d)
        return (new_o, new_d, time, new_atten, radiance, new_alive), None

    init = (
        o, d, time,
        jnp.ones((R, 3), dt),
        jnp.zeros((R, 3), dt),
        jnp.ones((R,), bool),
    )
    (o, d, time, atten, radiance, alive), _ = jax.lax.scan(
        step, init, jnp.arange(opts.max_depth)
    )
    # rays still alive after max_depth contribute nothing more
    # (depth-exhaust returns black: camera.rs:183-185)
    return radiance


# ---------------------------------------------------------------------------
# Book 3: NEE / MIS
# ---------------------------------------------------------------------------


def _light_pdf_value(p, d, scene: Scene):
    """Mean over lights of per-light pdf(dir) — HittableList::pdf_value
    (the_rest_of_your_life/hittable_list.rs:60-69).

    p: [R,3] origin; d: [R,3] direction (not normalized). Returns [R].
    """
    L = scene.light_kind.shape[0]
    d_len2 = jnp.sum(d * d, axis=-1)
    d_len = jnp.sqrt(d_len2)
    total = jnp.zeros(p.shape[0], p.dtype)
    n_active = jnp.maximum(jnp.sum(scene.light_mask), 1.0)

    for l in range(L):
        is_quad = scene.light_kind[l] == LIGHT_QUAD
        # --- quad pdf (quad.rs:93-102) ---
        u = scene.light_u[l]
        v = scene.light_v[l]
        n = jnp.cross(u, v)
        nn = jnp.maximum(jnp.sum(n * n), 1e-30)
        area = jnp.sqrt(nn)
        normal = n / area
        w = n / nn
        dplane = jnp.sum(normal * scene.light_q[l])
        denom = jnp.sum(normal[None, :] * d, axis=-1)
        safe_denom = jnp.where(jnp.abs(denom) < 1e-8, 1.0, denom)
        t = (dplane - jnp.sum(normal[None, :] * p, axis=-1)) / safe_denom
        hitp = p + t[:, None] * d
        rel = hitp - scene.light_q[l][None, :]
        alpha = jnp.sum(w[None, :] * jnp.cross(rel, v[None, :]), axis=-1)
        beta = jnp.sum(w[None, :] * jnp.cross(u[None, :], rel), axis=-1)
        qhit = (
            (jnp.abs(denom) >= 1e-8) & (t >= T_MIN) & (t <= T_MAX)
            & (alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1)
        )
        cosine = jnp.abs(denom) / jnp.maximum(d_len, 1e-30)
        qpdf = jnp.where(qhit, t * t * d_len2 / jnp.maximum(cosine * area, 1e-30), 0.0)

        # --- sphere solid-angle pdf (sphere.rs:102-115) ---
        ctr = scene.light_center[l][None, None, :]
        rad = scene.light_radius[l]
        t_near, t_far, has = sphere_roots(
            p, d, jnp.broadcast_to(ctr, (p.shape[0], 1, 3)), rad[None, None]
        )
        near_ok = t_near[:, 0] > T_MIN
        root = jnp.where(near_ok, t_near[:, 0], t_far[:, 0])
        shit = has[:, 0] & (root > T_MIN) & (root < T_MAX)
        dist2 = jnp.sum((scene.light_center[l][None, :] - p) ** 2, axis=-1)
        cos_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - rad * rad / jnp.maximum(dist2, 1e-30)))
        solid_angle = 2.0 * _PI * (1.0 - cos_max)
        spdf = jnp.where(shit, 1.0 / jnp.maximum(solid_angle, 1e-30), 0.0)

        pdf_l = jnp.where(is_quad, qpdf, spdf)
        total = total + scene.light_mask[l] * pdf_l

    return total / n_active


def _light_sample(p, scene: Scene, draws):
    """Generate a direction toward a uniformly-picked light —
    HittableList::random (hittable_list.rs:71-75).

    draws: [R,3] uniforms (u_pick, u1, u2). Returns [R,3] direction.
    """
    L = scene.light_kind.shape[0]
    n_active = jnp.maximum(jnp.sum(scene.light_mask), 1.0)
    pick = jnp.minimum(
        (draws[:, 0] * n_active).astype(jnp.int32), (n_active - 1).astype(jnp.int32)
    )  # [R]; assumes active lights occupy the leading slots (builder invariant)

    u1, u2 = draws[:, 1], draws[:, 2]

    # quad sample: q + u1*u + u2*v - p (quad.rs:104-107)
    lq = scene.light_q[pick]
    lu = scene.light_u[pick]
    lv = scene.light_v[pick]
    quad_dir = lq + u1[:, None] * lu + u2[:, None] * lv - p

    # sphere cone sample (sphere.rs:117-122)
    ctr = scene.light_center[pick]
    rad = scene.light_radius[pick]
    to_center = ctr - p
    dist2 = jnp.maximum(jnp.sum(to_center * to_center, axis=-1), 1e-30)
    local = rng.to_sphere(u1, u2, rad, dist2)
    bu, bv, bw = rng.onb_from_w(to_center)
    sph_dir = rng.onb_transform(bu, bv, bw, local)

    is_quad = scene.light_kind[pick] == LIGHT_QUAD
    return jnp.where(is_quad[:, None], quad_dir, sph_dir)


def trace_mis(key: jax.Array, o, d, time, scene: Scene, background,
              opts: IntegratorOptions) -> jnp.ndarray:
    """Book 3 integrator (the_rest_of_your_life/camera.rs:184-254)."""
    R = o.shape[0]
    dt = o.dtype
    nm = n_media(scene)
    # u1,u2,u_diel,u_rr,u_choice,u_pick,ul1,ul2 + one per medium.  (Round 4
    # declared a 9th "u_mat2" column that nothing consumed — one wasted
    # threefry draw per ray*bounce; dropped round 5 and the cornell_mis
    # golden regenerated for the shifted media columns.)
    ND = 8 + nm

    def step(carry, bounce):
        o, d, time, atten, radiance, alive = carry
        kb = jax.random.fold_in(key, bounce)
        draws = rng.uniforms(kb, (R,), ND)

        rec = closest_hit(o, d, time, scene, draws[:, 8:])

        # miss -> flat background (camera.rs:189-191)
        bg = _background(d, background, opts.bg_mode)
        miss = alive & ~rec.valid
        radiance = radiance + jnp.where(miss[:, None], atten * bg, 0.0)

        mat = gather_mat(scene, rec)
        sc = scatter(d, rec, mat, draws[:, 0:3], emit_front_only=True,
                     metal_absorb=False)
        radiance = radiance + jnp.where(
            (alive & rec.valid)[:, None], atten * sc.emitted, 0.0
        )

        alive_hit = alive & rec.valid & sc.scattered

        # Russian roulette, book-3 style: p from the per-hit attenuation,
        # applied to BOTH branches (camera.rs:199-237)
        p_rr = jax.lax.stop_gradient(
            jnp.clip(jnp.max(sc.attenuation, axis=-1), RR_P_MIN, RR_P_MAX)
        )
        do_rr = bounce >= RR_START_BOUNCE
        rr_prob = jnp.where(do_rr, p_rr, 1.0)
        survive = draws[:, 3] <= rr_prob
        alive_hit = alive_hit & survive

        # --- specular branch: attenuation/rr, ray = skip_pdf_ray ---
        spec_weight = sc.attenuation / rr_prob[:, None]

        # --- diffuse branch: 50/50 mixture of light and material pdf ---
        mat_local = rng.cosine_direction(draws[:, 6], draws[:, 7])
        bu, bv, bw = rng.onb_from_w(rec.normal)
        cos_dir = rng.onb_transform(bu, bv, bw, mat_local)
        iso_dir = rng.unit_vector(draws[:, 6], draws[:, 7])
        mat_dir = jnp.where(sc.is_lambertian[:, None], cos_dir, iso_dir)

        light_dir = _light_sample(
            rec.p, scene, jnp.stack([draws[:, 5], draws[:, 6], draws[:, 7]], axis=-1)
        )

        use_light = draws[:, 4] < 0.5  # MixturePdf::generate (pdf.rs:93-99)
        diff_dir = jnp.where(use_light[:, None], light_dir, mat_dir)

        unit_diff = diff_dir / jnp.maximum(
            jnp.linalg.norm(diff_dir, axis=-1, keepdims=True), 1e-30
        )
        cos_theta = jnp.sum(rec.normal * unit_diff, axis=-1)
        cosine_pdf = jnp.maximum(cos_theta, 0.0) / _PI  # pdf.rs:41-49
        sphere_pdf = jnp.full((R,), 1.0 / (4.0 * _PI), dt)
        mat_pdf = jnp.where(sc.is_lambertian, cosine_pdf, sphere_pdf)
        light_pdf = _light_pdf_value(rec.p, diff_dir, scene)
        # The mixture density is the SAMPLING pdf — detach it (the physical
        # scattering_pdf stays differentiable), standard for reparameterized
        # MC gradient estimators.
        pdf_value = jax.lax.stop_gradient(
            0.5 * light_pdf + 0.5 * mat_pdf  # pdf.rs:88-91
        )

        # scattering_pdf == material pdf for lambertian/isotropic
        # (material.rs:63-70, 187-189)
        scattering_pdf = mat_pdf
        pdf_ok = pdf_value > 0.0
        diff_weight = (
            sc.attenuation * scattering_pdf[:, None]
            / jnp.maximum(pdf_value * rr_prob, 1e-30)[:, None]
        )

        new_dir = jnp.where(sc.specular[:, None], sc.direction, diff_dir)
        weight = jnp.where(sc.specular[:, None], spec_weight, diff_weight)
        alive_next = alive_hit & (sc.specular | pdf_ok)

        new_atten = jnp.where(alive_next[:, None], atten * weight, atten)
        new_o = jnp.where(alive_next[:, None], rec.p, o)
        new_d = jnp.where(alive_next[:, None], new_dir, d)
        return (new_o, new_d, time, new_atten, radiance, alive_next), None

    init = (
        o, d, time,
        jnp.ones((R, 3), dt),
        jnp.zeros((R, 3), dt),
        jnp.ones((R,), bool),
    )
    (o, d, time, atten, radiance, alive), _ = jax.lax.scan(
        step, init, jnp.arange(opts.max_depth)
    )
    return radiance
