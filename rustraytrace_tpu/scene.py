"""Scene representation: flat SoA pytrees of device arrays.

The reference keeps scenes as an ``Arc<HittableObject>`` object graph
(``src/books/*/hittable.rs:45-85``) on CPU and lowers the Book-1 scene to flat
SoA buffers for the GPU (``SphereGpu``/``MaterialGpu``/``CameraUniform``,
``src/gpu/mod.rs:29-42,124-301``).  This build generalizes the GPU path:
EVERY scene — all primitive classes, materials, textures, lights — is compiled
host-side into one ``Scene`` pytree of jnp arrays.  This pytree is also the
differentiable parameter vector (sphere centers/radii, quad frames, albedos,
fuzz, IOR, emission) for inverse rendering.

Instance transforms (Translate / RotateY, ``src/books/the_next_week/
hittable.rs:65-170``) are BAKED at build time: a rotated+translated quad is
just another quad; a transformed constant-medium box keeps (rotation, offset)
so the world->local ray transform happens in the kernel with two muls — there
is no object graph at render time.

Constant media (``src/books/the_next_week/constant_medium.rs``) get their own
primitive classes (medium spheres, medium oriented boxes) because their hit
test needs entry/exit intervals, not closest-hit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Material kinds — same integer coding idea as MaterialGpu.kind
# (src/gpu/mod.rs:35-42: 0 lambertian, 1 metal, 2 dielectric), extended for
# books 2/3 (DiffuseLight, Isotropic; src/books/the_rest_of_your_life/
# material.rs:195-202).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3
ISOTROPIC = 4

# Texture kinds (src/books/the_next_week/texture.rs:128-133).
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3

# Light-sampling geometry kinds (book 3 NEE targets).
LIGHT_QUAD = 0
LIGHT_SPHERE = 1

_PERLIN_POINT_COUNT = 256
_PERLIN_SEED = 0x5EED_1234  # deterministic, like the GPU scene seed gpu/mod.rs:199


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Scene:
    """All scene data as device arrays. Shapes are static per scene."""

    # -- spheres (closest-hit surfaces); motion blur via center velocity,
    #    reference stores the moving center as a Ray (the_next_week/sphere.rs:9-44)
    sph_center: jnp.ndarray  # [S,3] f32 (center at time 0)
    sph_cvel: jnp.ndarray  # [S,3] f32 (center2 - center1; zeros if static)
    sph_radius: jnp.ndarray  # [S] f32
    sph_mat: jnp.ndarray  # [S] i32
    sph_mask: jnp.ndarray  # [S] f32 (1 active / 0 padding)

    # -- quads (the_next_week/quad.rs); frame q,u,v with precomputed
    #    w = n/dot(n,n), unit normal, plane offset d, area = |n|
    quad_q: jnp.ndarray  # [Q,3]
    quad_u: jnp.ndarray  # [Q,3]
    quad_v: jnp.ndarray  # [Q,3]
    quad_mat: jnp.ndarray  # [Q] i32
    quad_mask: jnp.ndarray  # [Q] f32

    # -- axis-aligned boxes as FIRST-CLASS primitives.  The reference's
    #    make_box expands every box into 6 quads (quad.rs:90-113); keeping
    #    unrotated boxes whole makes the hit test one slab test instead of
    #    six plane+interior tests — 400 slab tests replace the 2400 quad
    #    tests of book2_final_scene's ground (the_next_week/mod.rs:510-528).
    #    Rotated or image-textured boxes still bake to quads (boxes carry no
    #    UVs; checker/noise texture on 3-D p, so those are exact).
    box_lo: jnp.ndarray  # [B2,3]
    box_hi: jnp.ndarray  # [B2,3]
    box_mat: jnp.ndarray  # [B2] i32
    box_mask: jnp.ndarray  # [B2] f32

    # -- constant-medium spheres (boundary sphere + isotropic phase)
    msph_center: jnp.ndarray  # [K,3]
    msph_radius: jnp.ndarray  # [K]
    msph_neg_inv_density: jnp.ndarray  # [K]
    msph_mat: jnp.ndarray  # [K] i32
    msph_mask: jnp.ndarray  # [K] f32

    # -- constant-medium oriented boxes: world->local is
    #    p_local = R_y(-theta) @ (p - offset); box is [lo, hi] in local space
    mbox_cos: jnp.ndarray  # [B]
    mbox_sin: jnp.ndarray  # [B]
    mbox_offset: jnp.ndarray  # [B,3]
    mbox_lo: jnp.ndarray  # [B,3]
    mbox_hi: jnp.ndarray  # [B,3]
    mbox_neg_inv_density: jnp.ndarray  # [B]
    mbox_mat: jnp.ndarray  # [B] i32
    mbox_mask: jnp.ndarray  # [B] f32

    # -- materials SoA (MaterialGpu analog, src/gpu/mod.rs:35-42)
    mat_kind: jnp.ndarray  # [M] i32
    mat_tex: jnp.ndarray  # [M] i32 (albedo/emission texture index)
    mat_fuzz: jnp.ndarray  # [M] f32
    mat_ior: jnp.ndarray  # [M] f32

    # -- textures SoA (texture.rs:128-168). color1 = solid color / checker
    #    even; color2 = checker odd.
    tex_kind: jnp.ndarray  # [T] i32
    tex_color1: jnp.ndarray  # [T,3]
    tex_color2: jnp.ndarray  # [T,3]
    tex_inv_scale: jnp.ndarray  # [T] (checker; texture.rs:51)
    tex_noise_scale: jnp.ndarray  # [T] (marble; texture.rs:117-126)
    tex_image: jnp.ndarray  # [T] i32 index into images

    # -- image textures, stacked (only earthmap.jpg in the reference)
    images: jnp.ndarray  # [NI, IH, IW, 3] f32 in [0,1]
    image_hw: jnp.ndarray  # [NI, 2] i32 actual (h, w)

    # -- Perlin lattice (perlin.rs:12-23), built once host-side with a
    #    fixed seed so renders are reproducible (the reference CPU build is
    #    entropy-seeded and thus NOT reproducible; we follow the GPU path's
    #    fixed-seed stance, gpu/mod.rs:199)
    perlin_randvec: jnp.ndarray  # [256,3] f32
    perlin_perm: jnp.ndarray  # [3,256] i32

    # -- NEE light list (book 3): standalone geometry params, kind-tagged
    light_kind: jnp.ndarray  # [L] i32
    light_q: jnp.ndarray  # [L,3] quad corner
    light_u: jnp.ndarray  # [L,3]
    light_v: jnp.ndarray  # [L,3]
    light_center: jnp.ndarray  # [L,3] sphere center
    light_radius: jnp.ndarray  # [L]
    light_mask: jnp.ndarray  # [L] f32

    # -- static feature flags (pytree metadata, not traced): lets the
    #    integrator skip whole texture kinds / media / quads entirely at
    #    trace time (e.g. Book-1 sphere scenes pay nothing for Perlin)
    features: Tuple[str, ...] = dataclasses.field(
        default=(), metadata=dict(static=True)
    )

    # ---- derived quad quantities (computed, not stored, so autodiff
    #      flows from quad_q/u/v) ----
    def quad_frames(self):
        """Return (w, unit normal, d, area) from q,u,v — quad.rs:23-43."""
        n = jnp.cross(self.quad_u, self.quad_v)
        nn = jnp.sum(n * n, axis=-1, keepdims=True)
        w = n / jnp.maximum(nn, 1e-30)
        area = jnp.sqrt(jnp.maximum(nn[..., 0], 0.0))
        normal = n / jnp.maximum(jnp.sqrt(nn), 1e-30)
        d = jnp.sum(normal * self.quad_q, axis=-1)
        return w, normal, d, area

    @property
    def n_lights(self) -> int:
        return self.light_kind.shape[0]


def _make_perlin(rng: np.random.Generator):
    randvec = rng.uniform(-1.0, 1.0, size=(_PERLIN_POINT_COUNT, 3))
    randvec /= np.linalg.norm(randvec, axis=-1, keepdims=True)
    perms = np.stack(
        [rng.permutation(_PERLIN_POINT_COUNT) for _ in range(3)]
    ).astype(np.int32)
    return randvec.astype(np.float32), perms


class SceneBuilder:
    """Host-side scene compiler: object-level API -> SoA ``Scene`` pytree.

    Role-equivalent to the reference's GPU scene compiler
    (``build_in_one_weekend_scene``, src/gpu/mod.rs:124-301) but covering the
    full trilogy feature set.
    """

    def __init__(self):
        self._spheres: List[Tuple[np.ndarray, np.ndarray, float, int]] = []
        self._quads: List[Tuple[np.ndarray, np.ndarray, np.ndarray, int]] = []
        self._boxes: List[Tuple[np.ndarray, np.ndarray, int]] = []
        self._msph: List[Tuple[np.ndarray, float, float, int]] = []
        self._mbox: List[Tuple[float, float, np.ndarray, np.ndarray, np.ndarray, float, int]] = []
        self._mat: List[Tuple[int, int, float, float]] = []
        self._tex: List[Tuple[int, np.ndarray, np.ndarray, float, float, int]] = []
        self._images: List[np.ndarray] = []
        self._lights: List[dict] = []

    # ---- textures ----
    def solid(self, color) -> int:
        return self._add_tex(TEX_SOLID, color, (0, 0, 0), 0.0, 0.0, 0)

    def checker(self, scale: float, c_even, c_odd) -> int:
        return self._add_tex(TEX_CHECKER, c_even, c_odd, 1.0 / scale, 0.0, 0)

    def image_texture(self, image: np.ndarray) -> int:
        """image: [h,w,3] float in [0,1] (decoded host-side)."""
        self._images.append(np.asarray(image, dtype=np.float32))
        return self._add_tex(TEX_IMAGE, (0, 0, 0), (0, 0, 0), 0.0, 0.0, len(self._images) - 1)

    def noise(self, scale: float) -> int:
        return self._add_tex(TEX_NOISE, (0, 0, 0), (0, 0, 0), 0.0, scale, 0)

    def _add_tex(self, kind, c1, c2, inv_scale, noise_scale, image_id) -> int:
        self._tex.append(
            (kind, np.asarray(c1, np.float64), np.asarray(c2, np.float64),
             float(inv_scale), float(noise_scale), int(image_id))
        )
        return len(self._tex) - 1

    # ---- materials ----
    def lambertian(self, albedo=None, tex: Optional[int] = None) -> int:
        return self._add_mat(LAMBERTIAN, self._tex_of(albedo, tex), 0.0, 1.0)

    def metal(self, albedo, fuzz: float) -> int:
        return self._add_mat(METAL, self.solid(albedo), min(fuzz, 1.0), 1.0)

    def dielectric(self, ior: float) -> int:
        return self._add_mat(DIELECTRIC, self.solid((1.0, 1.0, 1.0)), 0.0, ior)

    def diffuse_light(self, emit=None, tex: Optional[int] = None) -> int:
        return self._add_mat(DIFFUSE_LIGHT, self._tex_of(emit, tex), 0.0, 1.0)

    def isotropic(self, albedo=None, tex: Optional[int] = None) -> int:
        return self._add_mat(ISOTROPIC, self._tex_of(albedo, tex), 0.0, 1.0)

    def _tex_of(self, color, tex: Optional[int]) -> int:
        if tex is not None:
            return tex
        return self.solid(color)

    def _add_mat(self, kind, tex, fuzz, ior) -> int:
        self._mat.append((kind, tex, fuzz, ior))
        return len(self._mat) - 1

    # ---- geometry ----
    def add_sphere(self, center, radius: float, mat: int, center2=None):
        c = np.asarray(center, np.float64)
        vel = (np.asarray(center2, np.float64) - c) if center2 is not None else np.zeros(3)
        self._spheres.append((c, vel, float(radius), int(mat)))

    def add_quad(self, q, u, v, mat: int):
        self._quads.append(
            (np.asarray(q, np.float64), np.asarray(u, np.float64),
             np.asarray(v, np.float64), int(mat))
        )

    def add_box(self, a, b, mat: int, rotate_y_deg: float = 0.0,
                translate=(0, 0, 0), as_quads: bool = False):
        """Box per the reference's make_box (quad.rs:90-113) with RotateY /
        Translate instancing baked in.

        Unrotated boxes whose material isn't image-textured stay whole as a
        box PRIMITIVE (one slab test; boxes carry no UVs, and checker/noise
        evaluate on the 3-D hit point so the semantics are identical to the
        six-quad expansion).  Rotated or image-textured boxes bake to 6 quads.
        ``as_quads=True`` forces the quad expansion (equivalence testing)."""
        needs_uv = self._tex[self._mat[mat][1]][0] == TEX_IMAGE
        if rotate_y_deg == 0.0 and not needs_uv and not as_quads:
            lo = np.minimum(np.asarray(a, np.float64), np.asarray(b, np.float64))
            hi = np.maximum(np.asarray(a, np.float64), np.asarray(b, np.float64))
            off = np.asarray(translate, np.float64)
            self._boxes.append((lo + off, hi + off, int(mat)))
            return
        for q, u, v in _box_quads(a, b):
            q, u, v = _bake_instance(q, u, v, rotate_y_deg, translate)
            self.add_quad(q, u, v, mat)

    def add_medium_sphere(self, center, radius: float, density: float, mat: int):
        self._msph.append(
            (np.asarray(center, np.float64), float(radius), -1.0 / density, int(mat))
        )

    def add_medium_box(self, a, b, density: float, mat: int,
                       rotate_y_deg: float = 0.0, translate=(0, 0, 0)):
        rad = np.radians(rotate_y_deg)
        lo = np.minimum(np.asarray(a, np.float64), np.asarray(b, np.float64))
        hi = np.maximum(np.asarray(a, np.float64), np.asarray(b, np.float64))
        self._mbox.append(
            (np.cos(rad), np.sin(rad), np.asarray(translate, np.float64),
             lo, hi, -1.0 / density, int(mat))
        )

    # ---- NEE light targets (book 3 "lights" list with EmptyMaterial,
    #      the_rest_of_your_life/mod.rs:128-140) ----
    def add_light_quad(self, q, u, v):
        self._lights.append(dict(kind=LIGHT_QUAD, q=np.asarray(q, np.float64),
                                 u=np.asarray(u, np.float64), v=np.asarray(v, np.float64)))

    def add_light_sphere(self, center, radius: float):
        self._lights.append(dict(kind=LIGHT_SPHERE, center=np.asarray(center, np.float64),
                                 radius=float(radius)))

    # ---- compile ----
    def build(self, dtype=jnp.float32) -> Scene:
        f = np.float32

        def stack(items, extract, width=None, pad=1):
            n = max(len(items), 1)
            n = -(-n // pad) * pad
            if items:
                arr = np.stack([extract(i) for i in items]).astype(np.float64)
            else:
                arr = np.zeros((0,) if width is None else (0, width))
            if width is None and arr.ndim == 1:
                return _pad_rows(arr, n)
            if arr.ndim == 1:
                arr = arr.reshape(len(items), -1) if items else np.zeros((0, width))
            return _pad_rows(arr, n)

        S = max(len(self._spheres), 1)
        sph_center = stack(self._spheres, lambda s: s[0], 3)
        sph_cvel = stack(self._spheres, lambda s: s[1], 3)
        sph_radius = stack(self._spheres, lambda s: s[2])
        sph_mat = stack(self._spheres, lambda s: s[3]).astype(np.int32)
        sph_mask = _pad_rows(np.ones(len(self._spheres)), S)

        Q = max(len(self._quads), 1)
        quad_q = stack(self._quads, lambda s: s[0], 3)
        quad_u = stack(self._quads, lambda s: s[1], 3)
        quad_v = stack(self._quads, lambda s: s[2], 3)
        quad_mat = stack(self._quads, lambda s: s[3]).astype(np.int32)
        quad_mask = _pad_rows(np.ones(len(self._quads)), Q)
        # padding quads must not be degenerate (w = n/|n|^2 divides by 0)
        if len(self._quads) < Q:
            quad_u[len(self._quads):, 0] = 1.0
            quad_v[len(self._quads):, 1] = 1.0
            quad_q[len(self._quads):, 2] = 1e8

        B2 = max(len(self._boxes), 1)
        box_lo = stack(self._boxes, lambda s: s[0], 3)
        box_hi = stack(self._boxes, lambda s: s[1], 3)
        box_mat = stack(self._boxes, lambda s: s[2]).astype(np.int32)
        box_mask = _pad_rows(np.ones(len(self._boxes)), B2)
        # padding boxes: lo > hi never passes the slab test
        if len(self._boxes) < B2:
            box_lo[len(self._boxes):] = 1.0
            box_hi[len(self._boxes):] = 0.0

        K = max(len(self._msph), 1)
        msph_center = stack(self._msph, lambda s: s[0], 3)
        msph_radius = stack(self._msph, lambda s: s[1])
        msph_nid = stack(self._msph, lambda s: s[2])
        msph_mat = stack(self._msph, lambda s: s[3]).astype(np.int32)
        msph_mask = _pad_rows(np.ones(len(self._msph)), K)

        B = max(len(self._mbox), 1)
        mbox_cos = stack(self._mbox, lambda s: s[0])
        mbox_sin = stack(self._mbox, lambda s: s[1])
        mbox_offset = stack(self._mbox, lambda s: s[2], 3)
        mbox_lo = stack(self._mbox, lambda s: s[3], 3)
        mbox_hi = stack(self._mbox, lambda s: s[4], 3)
        mbox_nid = stack(self._mbox, lambda s: s[5])
        mbox_mat = stack(self._mbox, lambda s: s[6]).astype(np.int32)
        mbox_mask = _pad_rows(np.ones(len(self._mbox)), B)
        if len(self._mbox) < B:
            mbox_cos[len(self._mbox):] = 1.0
            mbox_hi[len(self._mbox):] = 1.0

        if not self._mat:
            self.lambertian((0.5, 0.5, 0.5))
        mat_kind = np.asarray([m[0] for m in self._mat], np.int32)
        mat_tex = np.asarray([m[1] for m in self._mat], np.int32)
        mat_fuzz = np.asarray([m[2] for m in self._mat], np.float64)
        mat_ior = np.asarray([m[3] for m in self._mat], np.float64)

        tex_kind = np.asarray([t[0] for t in self._tex], np.int32)
        tex_color1 = np.stack([t[1] for t in self._tex])
        tex_color2 = np.stack([t[2] for t in self._tex])
        tex_inv_scale = np.asarray([t[3] for t in self._tex], np.float64)
        tex_noise_scale = np.asarray([t[4] for t in self._tex], np.float64)
        tex_image = np.asarray([t[5] for t in self._tex], np.int32)

        if self._images:
            ih = max(im.shape[0] for im in self._images)
            iw = max(im.shape[1] for im in self._images)
            images = np.zeros((len(self._images), ih, iw, 3), np.float32)
            image_hw = np.zeros((len(self._images), 2), np.int32)
            for i, im in enumerate(self._images):
                images[i, : im.shape[0], : im.shape[1]] = im
                image_hw[i] = (im.shape[0], im.shape[1])
        else:
            images = np.zeros((1, 1, 1, 3), np.float32)
            image_hw = np.ones((1, 2), np.int32)

        randvec, perm = _make_perlin(np.random.default_rng(_PERLIN_SEED))

        L = max(len(self._lights), 1)
        light_kind = np.zeros(L, np.int32)
        light_q = np.zeros((L, 3))
        light_u = np.zeros((L, 3))
        light_v = np.zeros((L, 3))
        light_center = np.zeros((L, 3))
        light_radius = np.ones(L)
        light_mask = np.zeros(L)
        light_u[:, 0] = 1.0
        light_v[:, 1] = 1.0
        for i, lt in enumerate(self._lights):
            light_kind[i] = lt["kind"]
            light_mask[i] = 1.0
            if lt["kind"] == LIGHT_QUAD:
                light_q[i], light_u[i], light_v[i] = lt["q"], lt["u"], lt["v"]
            else:
                light_center[i], light_radius[i] = lt["center"], lt["radius"]
        # _light_sample's uniform pick indexes [0, n_active): active lights
        # MUST occupy the leading slots (integrator.py), which this packing
        # guarantees by construction — assert it so a future packer that
        # breaks the invariant fails here, not as a silent sampling bias
        n_act = int(light_mask.sum())
        assert (light_mask[:n_act] == 1.0).all() and (
            light_mask[n_act:] == 0.0).all(), "active lights must lead"

        def dev(x, dt=dtype):
            return jnp.asarray(x, dtype=dt)

        features = []
        kinds = set(tex_kind.tolist())
        if TEX_CHECKER in kinds:
            features.append("checker")
        if TEX_IMAGE in kinds:
            features.append("image")
        if TEX_NOISE in kinds:
            features.append("noise")
        if self._msph or self._mbox:
            features.append("media")
        if self._quads:
            features.append("quads")
        if self._boxes:
            features.append("boxes")
        if any(np.any(s[1] != 0.0) for s in self._spheres):
            features.append("motion")

        return Scene(
            features=tuple(features),
            sph_center=dev(sph_center), sph_cvel=dev(sph_cvel),
            sph_radius=dev(sph_radius), sph_mat=dev(sph_mat, jnp.int32),
            sph_mask=dev(sph_mask),
            quad_q=dev(quad_q), quad_u=dev(quad_u), quad_v=dev(quad_v),
            quad_mat=dev(quad_mat, jnp.int32), quad_mask=dev(quad_mask),
            box_lo=dev(box_lo), box_hi=dev(box_hi),
            box_mat=dev(box_mat, jnp.int32), box_mask=dev(box_mask),
            msph_center=dev(msph_center), msph_radius=dev(msph_radius),
            msph_neg_inv_density=dev(msph_nid),
            msph_mat=dev(msph_mat, jnp.int32), msph_mask=dev(msph_mask),
            mbox_cos=dev(mbox_cos), mbox_sin=dev(mbox_sin),
            mbox_offset=dev(mbox_offset), mbox_lo=dev(mbox_lo),
            mbox_hi=dev(mbox_hi), mbox_neg_inv_density=dev(mbox_nid),
            mbox_mat=dev(mbox_mat, jnp.int32), mbox_mask=dev(mbox_mask),
            mat_kind=dev(mat_kind, jnp.int32), mat_tex=dev(mat_tex, jnp.int32),
            mat_fuzz=dev(mat_fuzz), mat_ior=dev(mat_ior),
            tex_kind=dev(tex_kind, jnp.int32), tex_color1=dev(tex_color1),
            tex_color2=dev(tex_color2), tex_inv_scale=dev(tex_inv_scale),
            tex_noise_scale=dev(tex_noise_scale),
            tex_image=dev(tex_image, jnp.int32),
            images=dev(images.astype(f)), image_hw=dev(image_hw, jnp.int32),
            perlin_randvec=dev(randvec), perlin_perm=dev(perm, jnp.int32),
            light_kind=dev(light_kind, jnp.int32), light_q=dev(light_q),
            light_u=dev(light_u), light_v=dev(light_v),
            light_center=dev(light_center), light_radius=dev(light_radius),
            light_mask=dev(light_mask),
        )


def _box_quads(a, b) -> Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Six quads of an axis-aligned box; ordering per quad.rs:112-134."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mn = np.minimum(a, b)
    mx = np.maximum(a, b)
    dx = np.array([mx[0] - mn[0], 0.0, 0.0])
    dy = np.array([0.0, mx[1] - mn[1], 0.0])
    dz = np.array([0.0, 0.0, mx[2] - mn[2]])
    return [
        (np.array([mn[0], mn[1], mx[2]]), dx, dy),
        (np.array([mx[0], mn[1], mx[2]]), -dz, dy),
        (np.array([mx[0], mn[1], mn[2]]), -dx, dy),
        (np.array([mn[0], mn[1], mn[2]]), dz, dy),
        (np.array([mn[0], mx[1], mx[2]]), dx, -dz),
        (np.array([mn[0], mn[1], mn[2]]), dx, dz),
    ]


def _bake_instance(q, u, v, rotate_y_deg: float, translate):
    """Apply the reference's RotateY-then-Translate to a quad's frame.

    The reference rotates the RAY into object space (hittable.rs:143-156);
    baking the inverse rotation into the geometry is equivalent for quads.
    Rotating a point by +theta about Y: x' = c*x + s*z; z' = -s*x + c*z
    (the object->world map in hittable.rs:160-170).
    """
    rad = np.radians(rotate_y_deg)
    c, s = np.cos(rad), np.sin(rad)

    def rot_point(p):
        return np.array([c * p[0] + s * p[2], p[1], -s * p[0] + c * p[2]])

    q = rot_point(q) + np.asarray(translate, np.float64)
    return q, rot_point(u), rot_point(v)
