"""Closest-hit kernel (Pallas, Triton route) vs the XLA reference path.

Runs the kernel in the Pallas interpreter on the CPU test backend; the same
kernel compiles through Triton on the GPU (tests/test_gpu.py and
chip_smoke.py's closest-hit phase).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustraytrace_tpu import models
from rustraytrace_tpu.ops.integrator import n_media
from rustraytrace_tpu.ops.intersect import T_MAX, closest_hit
from rustraytrace_tpu.ops.materials import gather_mat
from rustraytrace_tpu.ops.pallas_hit import (
    closest_hit_spheres_pallas,
    kernel_hits,
    sphere_kernel_eligible,
)

# every box-free catalog scene (the kernel covers spheres + quads)
KERNEL_SCENES = [
    "book1_three_spheres", "book1_random_spheres", "book2_bouncing_spheres",
    "book2_checkered_spheres", "book2_earth", "book2_perlin_spheres",
    "book2_quads", "book2_simple_light", "book2_cornell_smoke",
]


def _scene(name, moving):
    scene, cfg, _ = getattr(models, name)(dict(image_width=16))
    if moving and "motion" not in scene.features:
        vel = jax.random.uniform(jax.random.key(5), scene.sph_cvel.shape,
                                 minval=-0.3, maxval=0.3)
        scene = dataclasses.replace(
            scene, sph_cvel=vel, features=scene.features + ("motion",))
    return scene, cfg


def _rays(cfg, n, key=0):
    """Rays from around the camera toward the look-at region, so a large
    share hit something in every scene."""
    k = jax.random.split(jax.random.key(key), 4)
    eye = jnp.asarray(cfg.lookfrom, jnp.float32)
    at = jnp.asarray(cfg.lookat, jnp.float32)
    span = 0.3 * jnp.linalg.norm(at - eye) + 1.0
    o = eye + jax.random.uniform(k[0], (n, 3), minval=-1.0, maxval=1.0) * (
        0.05 * span)
    target = at + jax.random.uniform(k[1], (n, 3), minval=-1.0,
                                     maxval=1.0) * span
    d = target - o
    d = jnp.where((jax.random.uniform(k[2], (n,)) < 0.2)[:, None],
                  jax.random.normal(k[3], (n, 3)), d)
    return o, d, jax.random.uniform(jax.random.key(key + 9), (n,))


@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
@pytest.mark.parametrize("name", KERNEL_SCENES)
def test_kernel_matches_xla_closest_hit(name, moving):
    scene, cfg = _scene(name, moving)
    assert sphere_kernel_eligible(scene)
    n = 1024
    o, d, time = _rays(cfg, n)
    um = jax.random.uniform(jax.random.key(3), (n, n_media(scene)))
    rec_ref = closest_hit(o, d, time, scene, um)
    mat_ref = gather_mat(scene, rec_ref)
    rec_k, mat_k = closest_hit_spheres_pallas(o, d, time, scene, u_media=um,
                                              interpret=True)

    valid_ref = np.asarray(rec_ref.valid)
    valid_k = np.asarray(rec_k.valid)
    assert valid_ref.mean() > 0.05  # the comparison exercises hits
    assert (valid_ref == valid_k).mean() > 0.99
    hits = valid_ref & valid_k
    t_ref = np.asarray(rec_ref.t)[hits]
    t_k = np.asarray(rec_k.t)[hits]
    # near-tangent / near-tie rays may resolve differently under the two
    # f32 evaluation orders; the rest agree to f32 quadric precision
    agree = np.abs(t_ref - t_k) <= 1e-3 * (1.0 + np.abs(t_ref))
    assert agree.mean() > 0.97, agree.mean()

    def on_agree(ref_val, k_val):
        return np.asarray(ref_val)[hits][agree], np.asarray(k_val)[hits][agree]

    np.testing.assert_array_equal(*on_agree(rec_ref.mat, rec_k.mat))
    np.testing.assert_array_equal(*on_agree(rec_ref.front_face,
                                            rec_k.front_face))
    np.testing.assert_array_equal(*on_agree(mat_ref.kind, mat_k.kind))
    n_ref, n_k = on_agree(rec_ref.normal, rec_k.normal)
    assert (np.abs(n_ref - n_k).max(axis=-1) < 5e-3).mean() > 0.99
    # checker parity flips when the two hit points straddle a lattice cell
    # boundary, and marble noise is steep in p — texture values follow the
    # f32 hit-point difference, so bound the rate of large deviations
    a_ref, a_k = on_agree(mat_ref.albedo, mat_k.albedo)
    assert (np.abs(a_ref - a_k).max(axis=-1) < 1e-2).mean() > 0.98


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4097])
def test_wrapper_padding(n):
    """R is padded to the ray block and cropped back: shapes and results
    match the unpadded reference at every residue."""
    scene, cfg = _scene("book1_three_spheres", False)
    o, d, time = _rays(cfg, n, key=n)
    t, idx = kernel_hits(o, d, time, scene, interpret=True)
    assert t.shape == (n,) and idx.shape == (n,)
    assert t.dtype == jnp.float32 and idx.dtype == jnp.int32
    rec = closest_hit(o, d, time, scene, jnp.zeros((n, n_media(scene))))
    valid = np.asarray(rec.valid)
    assert ((np.asarray(idx) >= 0) == valid).mean() > 0.99
    miss = np.asarray(idx) < 0
    np.testing.assert_array_equal(np.asarray(t)[miss], T_MAX)


def test_quad_index_encoding():
    """Quad winners come back as n_spheres + quad index."""
    from rustraytrace_tpu.scene import SceneBuilder

    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -10.0), 1.0, b.lambertian((0.5,) * 3))
    b.add_quad((-1, -1, -3), (2, 0, 0), (0, 2, 0), b.lambertian((0.5,) * 3))
    scene = b.build()
    o = jnp.zeros((3, 3))
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 5.0, -1.0], [0.0, 0.0, 1.0]])
    t, idx = kernel_hits(o, d, jnp.zeros(3), scene, interpret=True)
    S = scene.sph_center.shape[0]
    assert int(idx[0]) == S  # the quad at z=-3 occludes the sphere
    np.testing.assert_allclose(float(t[0]), 3.0, rtol=1e-6)
    assert int(idx[1]) == -1 and int(idx[2]) == -1


def test_eligibility():
    """Box primitives have no kernel loop; rotated boxes are built as quads
    and stay eligible."""
    for name in KERNEL_SCENES + ["book2_cornell_box", "book3_cornell_box"]:
        scene, _, _ = getattr(models, name)(dict(image_width=16))
        assert sphere_kernel_eligible(scene), name
    final, _, _ = models.book2_final_scene(dict(image_width=16))
    assert "boxes" in final.features
    assert not sphere_kernel_eligible(final)
