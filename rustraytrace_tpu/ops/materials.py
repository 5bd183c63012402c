"""Material scattering: compute-every-branch-and-select.

The reference dispatches on a material enum per hit (``MaterialObject::scatter``,
src/books/*/material.rs).  On a wide vector machine, divergent branches serialize,
and each material's math is ~10 flops — so every material's scatter direction
is computed for every ray and the per-ray material kind selects the result,
exactly the trade the survey prescribes (SURVEY.md §7).

Semantics pinned to the reference (f32/GPU path where they differ):
* Lambertian: ``normal + random_unit_vector`` with near-zero renormalization
  guard (in_one_weekend/material.rs:29-39; renderer.wgsl:188-195).
* Metal: ``reflect(unit(d), n) + fuzz * ruv``; absorb when the scattered ray
  leaves below the surface (material.rs:53-64; renderer.wgsl:196-205).
* Dielectric: Snell + total internal reflection + Schlick with a stochastic
  reflect/refract choice (material.rs:83-102; renderer.wgsl:206-223).
* DiffuseLight: emission only; book 3 gates emission on front_face
  (the_rest_of_your_life/material.rs:154-161) — controlled by
  ``emit_front_only``.
* Isotropic: uniform sphere scatter (the_next_week/material.rs).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..scene import Scene, LAMBERTIAN, METAL, DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC
from .intersect import HitRecord
from .textures import texture_value
from . import rng


def reflect(v, n):
    return v - 2.0 * jnp.sum(v * n, axis=-1, keepdims=True) * n


def refract(uv, n, etai_over_etat):
    """vec3.rs:205-210 / renderer.wgsl:95-100."""
    cos_theta = jnp.minimum(jnp.sum(-uv * n, axis=-1, keepdims=True), 1.0)
    r_out_perp = etai_over_etat * (uv + cos_theta * n)
    # the 1e-12 floor keeps sqrt' finite at grazing/TIR boundaries where the
    # argument crosses 0 (backward-pass NaN guard; forward error <= 1e-6)
    r_out_parallel = (
        -jnp.sqrt(jnp.maximum(
            jnp.abs(1.0 - jnp.sum(r_out_perp * r_out_perp, axis=-1, keepdims=True)),
            1e-12,
        )) * n
    )
    return r_out_perp + r_out_parallel


def schlick(cosine, ref_idx):
    """material.rs:107-111."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ScatterResult:
    direction: jnp.ndarray  # [R,3] new ray direction
    attenuation: jnp.ndarray  # [R,3] albedo multiplier
    emitted: jnp.ndarray  # [R,3]
    scattered: jnp.ndarray  # [R] bool — path continues
    specular: jnp.ndarray  # [R] bool — metal/dielectric (book-3 skip_pdf)
    is_lambertian: jnp.ndarray  # [R] bool (cosine-pdf diffuse, for MIS)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MatRecord:
    """Per-ray material attributes at the hit — produced either by gathers
    from the Scene SoA (``gather_mat``, general XLA path) or directly by the
    Pallas closest-hit kernel's one-hot attribute matmul (no gathers)."""

    kind: jnp.ndarray  # [R] i32
    albedo: jnp.ndarray  # [R,3] texture-evaluated color (also the emission)
    fuzz: jnp.ndarray  # [R]
    ior: jnp.ndarray  # [R]


def gather_mat(scene: Scene, rec: HitRecord) -> MatRecord:
    """General path: gather the hit material's params and evaluate textures."""
    return MatRecord(
        kind=scene.mat_kind[rec.mat],
        albedo=texture_value(scene.mat_tex[rec.mat], rec.u, rec.v, rec.p, scene),
        fuzz=scene.mat_fuzz[rec.mat],
        ior=scene.mat_ior[rec.mat],
    )


def scatter(d_in: jnp.ndarray, rec: HitRecord, mat: MatRecord,
            draws: jnp.ndarray, emit_front_only: bool,
            metal_absorb: bool = True) -> ScatterResult:
    """Evaluate all materials for rays d_in [R,3] at hits ``rec``.

    draws: [R, 3] uniforms — (u1, u2) for the shared random unit vector,
    u_diel for the dielectric reflect/refract choice.
    metal_absorb: books 1/2 kill metal rays scattered below the surface
    (material.rs:53-64); book 3's Metal does not (the_rest_of_your_life/
    material.rs:84-96 always returns a ScatterRecord).
    """
    kind = mat.kind  # [R]
    fuzz = mat.fuzz
    ior = mat.ior
    n = rec.normal
    tex = mat.albedo

    ruv = rng.unit_vector(draws[:, 0], draws[:, 1])  # shared across materials
    unit_d = d_in / jnp.linalg.norm(d_in, axis=-1, keepdims=True)

    # Lambertian: n + ruv with degenerate-direction guard
    lam_dir = n + ruv
    lam_near_zero = jnp.sum(lam_dir * lam_dir, axis=-1) < 1e-16
    lam_dir = jnp.where(lam_near_zero[:, None], n, lam_dir)

    # Metal
    met_dir = reflect(unit_d, n) + fuzz[:, None] * ruv
    met_ok = jnp.sum(met_dir * n, axis=-1) > 0.0

    # Dielectric
    ri = jnp.where(rec.front_face, 1.0 / ior, ior)
    cos_theta = jnp.minimum(jnp.sum(-unit_d * n, axis=-1), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    cannot_refract = ri * sin_theta > 1.0
    p_reflect = jnp.where(cannot_refract, 1.0, schlick(cos_theta, ri))
    reflect_choice = p_reflect > draws[:, 2]
    die_dir = jnp.where(
        reflect_choice[:, None], reflect(unit_d, n), refract(unit_d, n, ri[:, None])
    )
    # attached-ratio weight: the reflect/refract CHOICE is a detached
    # sampling decision, so plain interior AD drops the d(Schlick)/d(ior)
    # probability term and the IOR gradient is biased (measured: descent
    # converged to ~1.65 for a true 1.5).  Multiplying each branch by
    # p_attached / stop_grad(p) leaves the value exactly 1 but routes the
    # probability derivative through the throughput — the standard
    # likelihood-ratio fix for detached discrete choices.  p==1 (TIR)
    # forces reflect, so the refract denominator is never 0.
    # p clipped INSIDE the ratio only: the value stays exactly 1 (same p
    # in numerator and stop_grad denominator) while the gradient factor
    # 1/(1-p) is bounded — unclipped, grazing hits (p -> 1) produce
    # heavy-tailed gradients that overflow f32 and NaN the optimizer
    sg = jax.lax.stop_gradient
    p_c = jnp.clip(p_reflect, 1e-3, 1.0 - 1e-3)
    die_w = jnp.where(reflect_choice,
                      p_c / sg(p_c),
                      (1.0 - p_c) / sg(1.0 - p_c))

    # Emission (DiffuseLight); book-3 front-face gate
    is_light = kind == DIFFUSE_LIGHT
    emit_gate = rec.front_face if emit_front_only else jnp.ones_like(rec.front_face)
    emitted = jnp.where((is_light & emit_gate & rec.valid)[:, None], tex, 0.0)

    is_lam = kind == LAMBERTIAN
    is_met = kind == METAL
    is_die = kind == DIELECTRIC
    is_iso = kind == ISOTROPIC

    direction = jnp.where(is_lam[:, None], lam_dir, ruv)  # isotropic default: ruv
    direction = jnp.where(is_met[:, None], met_dir, direction)
    direction = jnp.where(is_die[:, None], die_dir, direction)

    attenuation = jnp.where(is_die[:, None], die_w[:, None], tex)
    scattered = rec.valid & ~is_light
    if metal_absorb:
        scattered = scattered & (~is_met | met_ok)
    specular = is_met | is_die

    return ScatterResult(
        direction=direction,
        attenuation=attenuation,
        emitted=emitted,
        scattered=scattered,
        specular=specular,
        is_lambertian=is_lam,
    )
