"""Batched ray-primitive intersection (closest hit) over SoA scenes.

A data-parallel re-design of the reference's ``Hittable::hit`` trait dispatch
(``src/books/*/hittable.rs``): instead of per-object virtual calls, every ray
tests every primitive of a class with broadcast vector ops ([R, N] arrays
that XLA fuses into per-ray reductions), classes are merged by
running-minimum, and the winning primitive's
hit record is built with one gather per field.  This is the same brute-force
strategy as the reference's GPU megakernel (``hit_spheres``,
``src/gpu/renderer.wgsl:108-155``) generalized to quads and constant media.

Semantics pinned to the reference's f32 (GPU) path: shadow-acne epsilon
t_min = 1e-3, horizon t_max = 1e9 (renderer.wgsl:185), quadric in the
``h = dot(d, oc)`` form (sphere.rs:25-51, renderer.wgsl:122-126).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..scene import Scene

T_MIN = 1.0e-3
T_MAX = 1.0e9
_PI = 3.14159265358979

# class tags for the merged winner
CLS_NONE = 0
CLS_SPHERE = 1
CLS_QUAD = 2
CLS_MEDIUM = 3
CLS_BOX = 4


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HitRecord:
    """Per-ray hit record (reference HitRecord, the_next_week/hittable.rs:15-23)."""

    valid: jnp.ndarray  # [R] bool — any hit at all
    t: jnp.ndarray  # [R]
    p: jnp.ndarray  # [R,3]
    normal: jnp.ndarray  # [R,3] face-corrected unit normal
    front_face: jnp.ndarray  # [R] bool
    mat: jnp.ndarray  # [R] i32
    u: jnp.ndarray  # [R]
    v: jnp.ndarray  # [R]


def sphere_roots(o, d, center, radius):
    """Both quadratic roots (t_near, t_far, has_roots) for sphere batches.

    o, d: [R,3]; center: [R,N,3] or broadcastable; radius: [N] or [R,N].
    Returns [R,N] arrays. Uses the half-b form of sphere.rs:69-82.
    """
    oc = center - o[:, None, :]  # [R,N,3]
    a = jnp.sum(d * d, axis=-1)[:, None]  # [R,1]
    h = jnp.sum(d[:, None, :] * oc, axis=-1)  # [R,N]
    c = jnp.sum(oc * oc, axis=-1) - radius * radius
    disc = h * h - a * c
    has = disc > 0.0
    # double-where so the backward pass never sees sqrt'(0)=inf on missed
    # lanes (inf * 0-mask = NaN would poison inverse-rendering gradients)
    sqrtd = jnp.sqrt(jnp.where(has, disc, 1.0))
    sqrtd = jnp.where(has, sqrtd, 0.0)
    t_near = (h - sqrtd) / a
    t_far = (h + sqrtd) / a
    return t_near, t_far, has


def hit_spheres(o, d, time, scene: Scene, t_min, t_max):
    """Closest sphere hit: returns (t [R], idx [R], any [R]).

    Direct quadric form, as the reference GPU kernel writes it
    (renderer.wgsl:122-126): oc = cc - o is subtracted BEFORE any product,
    so the r=1000 ground sphere does not cancel catastrophically, and the
    whole [R, N] test is elementwise math feeding two sibling reductions
    (min and argmin over N) that XLA fuses into one pass.
    With cc = center + time*cvel:  h = d.oc,  c = |oc|^2 - r^2.
    """
    cc = (scene.sph_center[None, :, :]
          + time[:, None, None] * scene.sph_cvel[None, :, :])  # [R,N,3]
    oc = cc - o[:, None, :]
    a = jnp.sum(d * d, axis=-1)  # [R]
    h = jnp.sum(d[:, None, :] * oc, axis=-1)  # [R,N]
    r = scene.sph_radius
    c = jnp.sum(oc * oc, axis=-1) - (r * r)[None, :]
    disc = h * h - a[:, None] * c
    has = disc > 0.0
    # double-where so the backward pass never sees sqrt'(0)=inf on missed
    # lanes (inf * 0-mask = NaN would poison inverse-rendering gradients)
    sqrtd = jnp.sqrt(jnp.where(has, disc, 1.0))
    sqrtd = jnp.where(has, sqrtd, 0.0)
    inv_a = 1.0 / a[:, None]
    t_near = (h - sqrtd) * inv_a
    t_far = (h + sqrtd) * inv_a
    # near root if within (t_min, t_max), else far root (sphere.rs:83-89)
    near_ok = (t_near > t_min[:, None]) & (t_near < t_max[:, None])
    root = jnp.where(near_ok, t_near, t_far)
    ok = has & (root > t_min[:, None]) & (root < t_max[:, None])
    ok = ok & (scene.sph_mask[None, :] > 0)
    t = jnp.where(ok, root, T_MAX)
    tbest = jnp.min(t, axis=-1)
    idx = jnp.argmin(t, axis=-1).astype(jnp.int32)
    return tbest, idx, tbest < T_MAX


def hit_quads(o, d, scene: Scene, t_min, t_max):
    """Closest quad hit: (t [R], idx [R], any [R]); quad.rs:64-87."""
    w, normal, dplane, _ = scene.quad_frames()
    denom = jnp.sum(normal[None, :, :] * d[:, None, :], axis=-1)  # [R,Q]
    safe_denom = jnp.where(jnp.abs(denom) < 1e-8, 1.0, denom)
    t = (dplane[None, :] - jnp.sum(normal[None, :, :] * o[:, None, :], axis=-1)) / safe_denom
    p = o[:, None, :] + t[..., None] * d[:, None, :]  # [R,Q,3]
    rel = p - scene.quad_q[None, :, :]
    alpha = jnp.sum(w[None, :, :] * jnp.cross(rel, scene.quad_v[None, :, :]), axis=-1)
    beta = jnp.sum(w[None, :, :] * jnp.cross(scene.quad_u[None, :, :], rel), axis=-1)
    interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
    ok = (
        (jnp.abs(denom) >= 1e-8)
        & (t >= t_min[:, None])
        & (t <= t_max[:, None])
        & interior
        & (scene.quad_mask[None, :] > 0)
    )
    tq = jnp.where(ok, t, T_MAX)
    idx = jnp.argmin(tq, axis=-1)
    tbest = jnp.take_along_axis(tq, idx[:, None], axis=-1)[:, 0]
    return tbest, idx.astype(jnp.int32), jnp.any(ok, axis=-1)


def _safe_inv_dir(d):
    """Sign-preserving 1/d with zero components nudged to ±1e-20 (the IEEE
    inf-propagating slab test is exact, but the nudge keeps gradients
    finite)."""
    sgn = jnp.where(d < 0.0, -1e-20, 1e-20)
    return 1.0 / jnp.where(jnp.abs(d) < 1e-20, sgn, d)


def hit_boxes(o, d, scene: Scene, t_min, t_max):
    """Closest axis-aligned box hit: (t [R], idx [R], any [R]).

    Slab test over [R,B]; matches the reference's make_box six-quad geometry
    (quad.rs:90-113) exactly: the entry face if t_entry is in (t_min, t_max),
    else the exit face (a ray starting inside a box hits its far wall, the
    same near-root-else-far-root policy as sphere.rs:83-89 and the per-quad
    t-window test)."""
    inv = _safe_inv_dir(d)  # [R,3]
    ta = (scene.box_lo[None, :, :] - o[:, None, :]) * inv[:, None, :]
    tb = (scene.box_hi[None, :, :] - o[:, None, :]) * inv[:, None, :]
    t1 = jnp.max(jnp.minimum(ta, tb), axis=-1)  # [R,B] entry
    t2 = jnp.min(jnp.maximum(ta, tb), axis=-1)  # [R,B] exit
    near_ok = (t1 > t_min[:, None]) & (t1 < t_max[:, None])
    root = jnp.where(near_ok, t1, t2)
    ok = (
        (t1 < t2)
        & (root > t_min[:, None]) & (root < t_max[:, None])
        & (scene.box_mask[None, :] > 0)
    )
    tbx = jnp.where(ok, root, T_MAX)
    idx = jnp.argmin(tbx, axis=-1)
    tbest = jnp.take_along_axis(tbx, idx[:, None], axis=-1)[:, 0]
    return tbest, idx.astype(jnp.int32), jnp.any(ok, axis=-1)


def box_outward_normal(o, d, t, lo, hi):
    """Outward unit normal of the box face hit at parameter t.

    o,d,t: [R]/[R,3] rays; lo,hi: [R,3] the WINNING box's bounds (gathered).
    Recomputes the per-axis slab times and picks the face axis: the entry
    face is the arg-max of per-axis entry times (exit face: arg-min of exit
    times, for rays starting inside).  Identical to the quad expansion's
    outward normals (see scene._box_quads)."""
    inv = _safe_inv_dir(d)
    ta = (lo - o) * inv
    tb = (hi - o) * inv
    tn = jnp.minimum(ta, tb)  # [R,3]
    tf = jnp.maximum(ta, tb)
    t1 = jnp.max(tn, axis=-1)
    # entry hit if the chosen t equals the entry time (up to fp noise)
    is_entry = jnp.abs(t - t1) <= 1e-3 * (1.0 + jnp.abs(t1))
    # face axis: entry -> argmax of tn; exit -> argmin of tf
    axis = jnp.where(is_entry, jnp.argmax(tn, axis=-1), jnp.argmin(tf, axis=-1))
    sgn_d = jnp.where(d >= 0.0, 1.0, -1.0)  # [R,3]
    face_sign = jnp.where(is_entry, -1.0, 1.0)[:, None] * sgn_d
    return face_sign * jax.nn.one_hot(axis, 3, dtype=o.dtype)


def _medium_freeflight(t1, t2, inside_ok, neg_inv_density, dir_len, u, t_min, t_best):
    """Shared constant-medium free-flight sampling (constant_medium.rs:40-79).

    t1/t2: boundary entry/exit roots over (-inf, inf). Returns (t_hit, hit).
    """
    t1c = jnp.maximum(t1, t_min)
    t2c = jnp.minimum(t2, t_best)
    ok = inside_ok & (t1c < t2c)
    t1c = jnp.maximum(t1c, 0.0)
    distance_inside = (t2c - t1c) * dir_len
    # ln(U) with U in (0,1]; clamp to avoid log(0) = -inf * neg -> +inf (miss)
    hit_distance = neg_inv_density * jnp.log(jnp.maximum(u, 1e-12))
    ok = ok & (hit_distance <= distance_inside)
    t_hit = t1c + hit_distance / dir_len
    return jnp.where(ok, t_hit, T_MAX), ok


def hit_media(o, d, scene: Scene, t_min, t_best, u_media):
    """Stochastic constant-medium hits, processed sequentially so each medium's
    sampling window is clipped by the running closest hit, mirroring the
    reference's ordered HittableList scan (hittable_list.rs:42-54).

    u_media: [R, K+B] uniforms. Returns (t [R], mat [R], hit [R]).
    """
    R = o.shape[0]
    dir_len = jnp.linalg.norm(d, axis=-1)
    t = jnp.full((R,), T_MAX, o.dtype)
    mat = jnp.zeros((R,), jnp.int32)
    hit = jnp.zeros((R,), bool)
    t_run = t_best

    K = scene.msph_center.shape[0]
    B = scene.mbox_cos.shape[0]
    col = 0
    for k in range(K):
        center = scene.msph_center[k][None, None, :]
        radius = scene.msph_radius[k][None, None]
        t_near, t_far, has = sphere_roots(o, d, jnp.broadcast_to(center, (R, 1, 3)), radius)
        th, ok = _medium_freeflight(
            t_near[:, 0], t_far[:, 0], has[:, 0] & (scene.msph_mask[k] > 0),
            scene.msph_neg_inv_density[k], dir_len, u_media[:, col], t_min, t_run,
        )
        take = ok & (th < t_run)
        t = jnp.where(take, th, t)
        mat = jnp.where(take, scene.msph_mat[k], mat)
        hit = hit | take
        t_run = jnp.minimum(t_run, t)
        col += 1

    for b in range(B):
        # world -> local: subtract offset, rotate by -theta about Y
        # (Translate: hittable.rs:87-93; RotateY: hittable.rs:143-156)
        c, s = scene.mbox_cos[b], scene.mbox_sin[b]
        ox = c * (o[:, 0] - scene.mbox_offset[b, 0]) - s * (o[:, 2] - scene.mbox_offset[b, 2])
        oy = o[:, 1] - scene.mbox_offset[b, 1]
        oz = s * (o[:, 0] - scene.mbox_offset[b, 0]) + c * (o[:, 2] - scene.mbox_offset[b, 2])
        dx = c * d[:, 0] - s * d[:, 2]
        dy = d[:, 1]
        dz = s * d[:, 0] + c * d[:, 2]
        lo = scene.mbox_lo[b]
        hi = scene.mbox_hi[b]
        ol = jnp.stack([ox, oy, oz], axis=-1)
        dl = jnp.stack([dx, dy, dz], axis=-1)
        inv = 1.0 / dl
        ta = (lo[None, :] - ol) * inv
        tb = (hi[None, :] - ol) * inv
        t1 = jnp.max(jnp.minimum(ta, tb), axis=-1)
        t2 = jnp.min(jnp.maximum(ta, tb), axis=-1)
        inside = (t1 < t2) & (scene.mbox_mask[b] > 0)
        th, ok = _medium_freeflight(
            t1, t2, inside, scene.mbox_neg_inv_density[b],
            dir_len, u_media[:, col], t_min, t_run,
        )
        take = ok & (th < t_run)
        t = jnp.where(take, th, t)
        mat = jnp.where(take, scene.mbox_mat[b], mat)
        hit = hit | take
        t_run = jnp.minimum(t_run, t)
        col += 1

    return t, mat, hit


def refine_sphere_t(o, d, ctr, rad, t, valid):
    """One Newton step on the direct-form quadric f(t) = |o + t d - c|^2 - r^2.

    Polishes the winner's root with the direct form (oc subtraction BEFORE
    products, like the reference GPU kernel renderer.wgsl:122-126) for ~15
    per-ray flops; on the r=1000 ground sphere f32 rounding of |oc|^2 still
    bounds the root's accuracy at ~1e-4 relative for grazing rays.
    """
    oc = o + t[:, None] * d - ctr
    f = jnp.sum(oc * oc, axis=-1) - rad * rad
    fp = 2.0 * jnp.sum(d * oc, axis=-1)
    safe = valid & (jnp.abs(fp) > 1e-12)
    return jnp.where(safe, t - f / jnp.where(safe, fp, 1.0), t)


def sphere_uv(outward: jnp.ndarray):
    """Spherical UV from the outward unit normal (sphere.rs:47-53).

    arccos' is infinite at the poles and the gathered "outward" of non-sphere
    winner lanes (quads/media/miss) can land outside [-1, 1], so a plain
    arccos would emit inf/NaN in the backward pass and poison
    sph_center/sph_radius gradients.  A tiny-epsilon clip does NOT work in
    f32 (1 - 1e-12 rounds to exactly 1.0, making the guard a no-op); instead
    the double-where pattern from sphere_roots: arccos sees a safe interior
    argument, pole/out-of-range lanes get their exact forward value (0 or pi)
    with a detached-zero gradient."""
    y = jnp.clip(-outward[:, 1], -1.0, 1.0)
    safe = jnp.abs(y) < 1.0 - 1e-6
    theta = jnp.arccos(jnp.where(safe, y, 0.0))
    theta = jnp.where(safe, theta, jnp.where(y > 0.0, 0.0, _PI))
    # arctan2(0, 0) at the poles has NaN partials; forward value (0) is kept
    x, z = outward[:, 0], outward[:, 2]
    deg = (jnp.abs(x) < 1e-12) & (jnp.abs(z) < 1e-12)
    phi = jnp.arctan2(jnp.where(deg, 0.0, -z), jnp.where(deg, 1.0, x)) + _PI
    return phi / (2.0 * _PI), theta / _PI


def closest_hit(o, d, time, scene: Scene, u_media, t_min=None, t_max=None) -> HitRecord:
    """Full-scene closest hit over all primitive classes.

    o, d: [R,3]; time: [R]; u_media: [R, n_media] uniforms for free-flight
    sampling. Returns a HitRecord.
    """
    R = o.shape[0]
    dt = o.dtype
    if t_min is None:
        t_min = jnp.full((R,), T_MIN, dt)
    if t_max is None:
        t_max = jnp.full((R,), T_MAX, dt)

    has_boxes = "boxes" in scene.features

    ts, is_, anys = hit_spheres(o, d, time, scene, t_min, t_max)
    tq, iq, anyq = hit_quads(o, d, scene, t_min, t_max)

    t_geo = jnp.where(anys, ts, T_MAX)
    cls = jnp.where(anys, CLS_SPHERE, CLS_NONE)
    better_q = anyq & (tq < t_geo)
    t_geo = jnp.where(better_q, tq, t_geo)
    cls = jnp.where(better_q, CLS_QUAD, cls)

    if has_boxes:
        tbx, ib, anyb = hit_boxes(o, d, scene, t_min, t_max)
        better_b = anyb & (tbx < t_geo)
        t_geo = jnp.where(better_b, tbx, t_geo)
        cls = jnp.where(better_b, CLS_BOX, cls)
    else:
        ib = jnp.zeros((R,), jnp.int32)

    tm, mmat, anym = hit_media(o, d, scene, t_min, t_geo, u_media)
    better_m = anym & (tm < t_geo)
    t = jnp.where(better_m, tm, t_geo)
    cls = jnp.where(better_m, CLS_MEDIUM, cls)

    valid = cls != CLS_NONE

    # --- sphere record (gather winning sphere) ---
    ctr = scene.sph_center[is_] + time[:, None] * scene.sph_cvel[is_]
    rad = scene.sph_radius[is_]
    is_sphere_w = cls == CLS_SPHERE
    t = refine_sphere_t(o, d, ctr, rad, t, is_sphere_w)
    t_safe = jnp.where(valid, t, 1.0)
    p = o + t_safe[:, None] * d

    outward_s = (p - ctr) / jnp.maximum(rad, 1e-30)[:, None]
    us, vs = sphere_uv(outward_s)
    mat_s = scene.sph_mat[is_]

    # --- quad record ---
    w_all, n_all, _, _ = scene.quad_frames()
    qn = n_all[iq]
    qw = w_all[iq]
    qq = scene.quad_q[iq]
    rel = p - qq
    uq = jnp.sum(qw * jnp.cross(rel, scene.quad_v[iq]), axis=-1)
    vq = jnp.sum(qw * jnp.cross(scene.quad_u[iq], rel), axis=-1)
    mat_q = scene.quad_mat[iq]

    is_sphere = cls == CLS_SPHERE
    is_quad = cls == CLS_QUAD
    is_medium = cls == CLS_MEDIUM

    outward = jnp.where(is_sphere[:, None], outward_s, qn)
    if has_boxes:
        # --- box record: outward normal from the winning box's slab faces ---
        bn = box_outward_normal(o, d, t, scene.box_lo[ib], scene.box_hi[ib])
        is_boxw = cls == CLS_BOX
        outward = jnp.where(is_boxw[:, None], bn, outward)
    outward = jnp.where(is_medium[:, None],
                        jnp.asarray([1.0, 0.0, 0.0], dt)[None, :], outward)
    # set_face_normal (hittable.rs:48-51); media always front_face=true with
    # fixed normal (constant_medium.rs:70-78)
    front = jnp.sum(d * outward, axis=-1) < 0.0
    front = jnp.where(is_medium, True, front)
    normal = jnp.where(front[:, None], outward, -outward)

    mat = jnp.where(is_sphere, mat_s, jnp.where(is_quad, mat_q, mmat))
    u = jnp.where(is_sphere, us, jnp.where(is_quad, uq, 0.0))
    v = jnp.where(is_sphere, vs, jnp.where(is_quad, vq, 0.0))
    if has_boxes:
        # boxes carry no UVs (their textures are solid or 3-D procedural —
        # the builder bakes image-textured boxes to quads)
        mat = jnp.where(is_boxw, scene.box_mat[ib], mat)
        u = jnp.where(is_boxw, 0.0, u)
        v = jnp.where(is_boxw, 0.0, v)

    return HitRecord(valid=valid, t=t, p=p, normal=normal, front_face=front,
                     mat=mat, u=u, v=v)
