"""Closest-hit kernel for sphere/quad scenes: Pallas through Triton.

The XLA reference (:func:`ops.intersect.closest_hit`) tests every ray against
every primitive as ``[R, N]`` arrays.  This kernel keeps the per-ray running
(best_t, best_idx) in registers instead: one ray per thread, 1-D ray blocks,
and a loop over the sphere table (then the quad table) whose rows are read
as uniform scalar loads, so every warp of a block reads the same ~16 KB
table through L1 and nothing ``[R, N]``-shaped reaches device memory.

The loop body mirrors the reference GPU megakernel's ``hit_spheres``
(src/gpu/renderer.wgsl:108-155): the direct quadric form (oc = c - o
subtracted first, then products), half-b roots, near-root-else-far,
t in (1e-3, 1e9) (sphere.rs:25-51); motion blur cc = c + time*v
(the_next_week/sphere.rs:9-44) is a separate kernel variant so static
scenes do not pay for it.  Quads use the plane hit and planar-coordinate
interior test of quad.rs:59-88.

The winner's hit and material record is built outside the kernel with XLA
gathers from the winning index, and a sphere winner's t gets the same Newton
refinement as the reference path (``intersect.refine_sphere_t``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..scene import Scene
from .intersect import HitRecord, T_MIN, T_MAX, refine_sphere_t, sphere_uv

_BIG = 1.0e30
_F32 = jnp.float32
# rays per program, one per thread: 256 rays on 8 warps measured fastest
# of 128/4, 256/4, 256/8 and 512/8 on the flagship (H100, PERF.md)
BLOCK_RAYS = 256
NUM_WARPS = 8

# sphere table columns
S_CX, S_CY, S_CZ = 0, 1, 2
S_R2 = 3
S_VX, S_VY, S_VZ = 4, 5, 6
S_COLS = 8

# quad table columns
Q_QX, Q_QY, Q_QZ = 0, 1, 2
Q_UX, Q_UY, Q_UZ = 3, 4, 5
Q_VX, Q_VY, Q_VZ = 6, 7, 8
Q_NX, Q_NY, Q_NZ = 9, 10, 11  # unit normal
Q_DP = 12  # plane offset dot(n, q)
Q_WX, Q_WY, Q_WZ = 13, 14, 15  # w = n / dot(n, n)
Q_COLS = 16


def _pad_rows_pow2(tab: jnp.ndarray) -> jnp.ndarray:
    """Triton block shapes are powers of two; the padding rows are never
    read (the loops stop at the real row count)."""
    n = tab.shape[0]
    return jnp.pad(tab, ((0, pl.next_power_of_2(n) - n), (0, 0)))


def pack_sphere_table(scene: Scene) -> jnp.ndarray:
    """[N, 8] f32 table; masked rows get r^2 = -BIG (can never hit:
    c = |oc|^2 - r^2 becomes +BIG => disc < 0 for every ray)."""
    C = scene.sph_center
    tab = jnp.zeros((C.shape[0], S_COLS), _F32)
    tab = tab.at[:, S_CX:S_CZ + 1].set(C)
    r = scene.sph_radius
    tab = tab.at[:, S_R2].set(jnp.where(scene.sph_mask > 0, r * r, -_BIG))
    return tab.at[:, S_VX:S_VZ + 1].set(scene.sph_cvel)


def pack_quad_table(scene: Scene) -> jnp.ndarray:
    """[Q, 16] f32 table; masked quads get a zero normal (|denom| < 1e-8
    rejects them for every ray)."""
    q, u, v = scene.quad_q, scene.quad_u, scene.quad_v
    n = jnp.cross(u, v)
    nn = jnp.maximum(jnp.sum(n * n, axis=-1, keepdims=True), 1e-30)
    normal = jnp.where((scene.quad_mask > 0)[:, None], n / jnp.sqrt(nn), 0.0)
    tab = jnp.zeros((q.shape[0], Q_COLS), _F32)
    tab = tab.at[:, Q_QX:Q_QZ + 1].set(q)
    tab = tab.at[:, Q_UX:Q_UZ + 1].set(u)
    tab = tab.at[:, Q_VX:Q_VZ + 1].set(v)
    tab = tab.at[:, Q_NX:Q_NZ + 1].set(normal)
    tab = tab.at[:, Q_DP].set(jnp.sum(normal * q, axis=-1))
    return tab.at[:, Q_WX:Q_WZ + 1].set(n / nn)


def _make_kernel(n_spheres: int, n_quads: int, moving: bool):
    def kernel(sph_ref, quad_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref,
               dz_ref, tm_ref, t_ref, idx_ref):
        ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
        dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
        a = dx * dx + dy * dy + dz * dz
        inv_a = 1.0 / a
        tm = tm_ref[...] if moving else None

        def body(s, carry):
            best_t, best_i = carry
            cx = sph_ref[s, S_CX]
            cy = sph_ref[s, S_CY]
            cz = sph_ref[s, S_CZ]
            r2 = sph_ref[s, S_R2]
            if moving:
                cx = cx + tm * sph_ref[s, S_VX]
                cy = cy + tm * sph_ref[s, S_VY]
                cz = cz + tm * sph_ref[s, S_VZ]
            ocx = cx - ox
            ocy = cy - oy
            ocz = cz - oz
            h = dx * ocx + dy * ocy + dz * ocz
            c = ocx * ocx + ocy * ocy + ocz * ocz - r2
            disc = h * h - a * c
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            tn = (h - sq) * inv_a
            tf = (h + sq) * inv_a
            root = jnp.where((tn > T_MIN) & (tn < T_MAX), tn, tf)
            take = ((disc > 0.0) & (root > T_MIN) & (root < T_MAX)
                    & (root < best_t))
            return jnp.where(take, root, best_t), jnp.where(take, s, best_i)

        init = (jnp.full((BLOCK_RAYS,), _BIG, _F32),
                jnp.full((BLOCK_RAYS,), -1, jnp.int32))
        best = jax.lax.fori_loop(0, n_spheres, body, init)

        def qbody(qi, carry):
            # winner index encoded as n_spheres + qi
            best_t, best_i = carry
            nqx = quad_ref[qi, Q_NX]
            nqy = quad_ref[qi, Q_NY]
            nqz = quad_ref[qi, Q_NZ]
            denom = dx * nqx + dy * nqy + dz * nqz
            safe = jnp.where(jnp.abs(denom) < 1e-8, 1.0, denom)
            tq = (quad_ref[qi, Q_DP] - (ox * nqx + oy * nqy + oz * nqz)) / safe
            relx = ox + tq * dx - quad_ref[qi, Q_QX]
            rely = oy + tq * dy - quad_ref[qi, Q_QY]
            relz = oz + tq * dz - quad_ref[qi, Q_QZ]
            ux, uy, uz = quad_ref[qi, Q_UX], quad_ref[qi, Q_UY], quad_ref[qi, Q_UZ]
            vx, vy, vz = quad_ref[qi, Q_VX], quad_ref[qi, Q_VY], quad_ref[qi, Q_VZ]
            wx, wy, wz = quad_ref[qi, Q_WX], quad_ref[qi, Q_WY], quad_ref[qi, Q_WZ]
            alpha = (wx * (rely * vz - relz * vy)
                     + wy * (relz * vx - relx * vz)
                     + wz * (relx * vy - rely * vx))
            beta = (wx * (uy * relz - uz * rely)
                    + wy * (uz * relx - ux * relz)
                    + wz * (ux * rely - uy * relx))
            take = ((jnp.abs(denom) >= 1e-8)
                    & (tq > T_MIN) & (tq < T_MAX)
                    & (alpha >= 0.0) & (alpha <= 1.0)
                    & (beta >= 0.0) & (beta <= 1.0)
                    & (tq < best_t))
            return (jnp.where(take, tq, best_t),
                    jnp.where(take, n_spheres + qi, best_i))

        if n_quads:
            best = jax.lax.fori_loop(0, n_quads, qbody, best)
        best_t, best_i = best
        t_ref[...] = jnp.where(best_i >= 0, best_t, T_MAX)
        idx_ref[...] = best_i

    return kernel


@functools.partial(jax.jit, static_argnames=(
    "n_spheres", "n_quads", "moving", "interpret"))
def _closest_hit_raw(sph_tab, quad_tab, ox, oy, oz, dx, dy, dz, tm, *,
                     n_spheres: int, n_quads: int, moving: bool,
                     interpret: bool):
    """Ray components are [R] with R a multiple of BLOCK_RAYS; returns
    (t [R], idx [R])."""
    ray_spec = pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,))
    return pl.pallas_call(
        _make_kernel(n_spheres, n_quads, moving),
        out_shape=(jax.ShapeDtypeStruct(ox.shape, _F32),
                   jax.ShapeDtypeStruct(ox.shape, jnp.int32)),
        grid=(ox.shape[0] // BLOCK_RAYS,),
        in_specs=[pl.BlockSpec(sph_tab.shape, lambda i: (0, 0)),
                  pl.BlockSpec(quad_tab.shape, lambda i: (0, 0))]
        + [ray_spec] * 7,
        out_specs=(ray_spec, ray_spec),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="closest_hit_spheres",
    )(sph_tab, quad_tab, ox, oy, oz, dx, dy, dz, tm)


def sphere_kernel_eligible(scene: Scene) -> bool:
    """Spheres and quads resolve in the kernel, constant media with the XLA
    free-flight sampler after it, textures outside it; box primitives have
    no kernel loop and take the XLA path."""
    return "boxes" not in scene.features


def kernel_hits(o, d, time, scene: Scene, *, interpret: bool = False):
    """Raw kernel result for [R] rays: (t [R], idx [R]); idx < S is a
    sphere, idx >= S the quad idx - S, -1 a miss (t = T_MAX).  Pads R to
    a multiple of BLOCK_RAYS; padding lanes get d = (0, 0, 1) so |d|^2
    stays nonzero."""
    R = o.shape[0]
    Rpad = -(-R // BLOCK_RAYS) * BLOCK_RAYS

    def lanes(x):
        return jnp.pad(x, (0, Rpad - R)) if Rpad != R else x

    dpad = jnp.pad(d, ((0, Rpad - R), (0, 0)))
    if Rpad != R:
        dpad = dpad.at[R:, 2].set(1.0)
    has_quads = "quads" in scene.features
    quad_tab = (pack_quad_table(scene) if has_quads
                else jnp.zeros((1, Q_COLS), _F32))
    t, idx = _closest_hit_raw(
        _pad_rows_pow2(pack_sphere_table(scene)), _pad_rows_pow2(quad_tab),
        lanes(o[:, 0]), lanes(o[:, 1]), lanes(o[:, 2]),
        dpad[:, 0], dpad[:, 1], dpad[:, 2], lanes(time),
        n_spheres=scene.sph_center.shape[0],
        n_quads=quad_tab.shape[0] if has_quads else 0,
        moving="motion" in scene.features, interpret=interpret)
    return t[:R], idx[:R]


def closest_hit_spheres_pallas(o, d, time, scene: Scene, *, u_media=None,
                               interpret: bool = False):
    """Full closest hit + material attributes for a box-free scene.

    Spheres and quads resolve in the kernel (:func:`kernel_hits`); constant
    media are composed on top with the XLA free-flight sampler (needs
    ``u_media`` [R, n_media] uniforms when the scene has media, matching
    intersect.closest_hit); records, materials and textures are assembled
    with XLA gathers.  ``interpret=True`` runs the kernel in the Pallas
    interpreter (CPU tests).  Returns (HitRecord, MatRecord).
    """
    from .intersect import hit_media
    from .materials import MatRecord
    from .textures import texture_value

    R = o.shape[0]
    has_quads = "quads" in scene.features
    S = scene.sph_center.shape[0]
    t, idx = kernel_hits(o, d, time, scene, interpret=interpret)
    hit = idx >= 0
    is_quad = idx >= S
    iw = jnp.where(hit & ~is_quad, idx, 0)
    qw = jnp.where(is_quad, idx - S, 0)

    # --- sphere record ---
    ctr = scene.sph_center[iw] + time[:, None] * scene.sph_cvel[iw]
    rad = scene.sph_radius[iw]
    t = refine_sphere_t(o, d, ctr, rad, t, hit & ~is_quad)
    p = o + jnp.where(hit, t, 1.0)[:, None] * d
    outward_s = (p - ctr) / jnp.maximum(rad, 1e-30)[:, None]
    us, vs = sphere_uv(outward_s)
    mat_s = scene.sph_mat[iw]

    # --- quad record (quad.rs:64-87 planar coords) ---
    if has_quads:
        w_all, n_all, _, _ = scene.quad_frames()
        rel = p - scene.quad_q[qw]
        uq = jnp.sum(w_all[qw] * jnp.cross(rel, scene.quad_v[qw]), axis=-1)
        vq = jnp.sum(w_all[qw] * jnp.cross(scene.quad_u[qw], rel), axis=-1)
        outward = jnp.where(is_quad[:, None], n_all[qw], outward_s)
        u = jnp.where(is_quad, uq, us)
        v = jnp.where(is_quad, vq, vs)
        mat_id = jnp.where(is_quad, scene.quad_mat[qw], mat_s)
    else:
        outward = outward_s
        u, v = us, vs
        mat_id = mat_s

    front = jnp.sum(d * outward, axis=-1) < 0.0
    t_full = jnp.where(hit, t, T_MAX)

    # --- constant media composed on the geometry-closest hit ---
    if "media" in scene.features:
        assert u_media is not None, "media scenes need u_media draws"
        tm_, mmat, anym = hit_media(
            o, d, scene, jnp.full((R,), T_MIN, o.dtype), t_full, u_media)
        better = anym & (tm_ < t_full)
        t_full = jnp.where(better, tm_, t_full)
        hit = hit | better
        p = jnp.where(better[:, None], o + t_full[:, None] * d, p)
        outward = jnp.where(better[:, None],
                            jnp.asarray([1.0, 0.0, 0.0], o.dtype)[None, :],
                            outward)
        front = jnp.where(better, True, front)
        mat_id = jnp.where(better, mmat, mat_id)
        u = jnp.where(better, 0.0, u)
        v = jnp.where(better, 0.0, v)

    normal = jnp.where(front[:, None], outward, -outward)
    rec = HitRecord(valid=hit, t=t_full, p=p, normal=normal,
                    front_face=front, mat=mat_id, u=u, v=v)
    mat = MatRecord(
        kind=scene.mat_kind[mat_id],
        albedo=texture_value(scene.mat_tex[mat_id], u, v, p, scene),
        fuzz=scene.mat_fuzz[mat_id],
        ior=scene.mat_ior[mat_id],
    )
    return rec, mat
