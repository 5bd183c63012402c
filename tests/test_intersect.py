"""Intersection unit tests against hand-computed quadric/plane solutions
(reference formulas: sphere.rs:69-95, quad.rs:64-87, aabb.rs:52-84)."""

import jax.numpy as jnp
import numpy as np

from rustraytrace_tpu.ops.intersect import closest_hit, hit_quads, hit_spheres
from rustraytrace_tpu.scene import SceneBuilder


def _scene_one_sphere(center=(0, 0, -2), r=0.5):
    b = SceneBuilder()
    b.add_sphere(center, r, b.lambertian((0.5, 0.5, 0.5)))
    return b.build()


def _rays(*rows):
    o = jnp.asarray([r[0] for r in rows], jnp.float32)
    d = jnp.asarray([r[1] for r in rows], jnp.float32)
    t = jnp.zeros(len(rows), jnp.float32)
    return o, d, t


def test_sphere_hit_head_on():
    s = _scene_one_sphere()
    o, d, t = _rays(((0, 0, 0), (0, 0, -1)))
    tmin = jnp.full(1, 1e-3)
    tmax = jnp.full(1, 1e9)
    tb, idx, any_ = hit_spheres(o, d, t, s, tmin, tmax)
    assert bool(any_[0])
    np.testing.assert_allclose(float(tb[0]), 1.5, rtol=1e-6)


def test_sphere_inside_hit_far_root():
    s = _scene_one_sphere(center=(0, 0, 0), r=2.0)
    o, d, t = _rays(((0, 0, 0), (0, 0, -1)))
    tb, _, any_ = hit_spheres(o, d, t, s, jnp.full(1, 1e-3), jnp.full(1, 1e9))
    assert bool(any_[0])
    np.testing.assert_allclose(float(tb[0]), 2.0, rtol=1e-6)


def test_sphere_miss():
    s = _scene_one_sphere()
    o, d, t = _rays(((0, 0, 0), (0, 1, 0)))
    _, _, any_ = hit_spheres(o, d, t, s, jnp.full(1, 1e-3), jnp.full(1, 1e9))
    assert not bool(any_[0])


def test_unnormalized_direction_scales_t():
    s = _scene_one_sphere()
    o, d, t = _rays(((0, 0, 0), (0, 0, -3)))
    tb, _, any_ = hit_spheres(o, d, t, s, jnp.full(1, 1e-3), jnp.full(1, 1e9))
    np.testing.assert_allclose(float(tb[0]), 0.5, rtol=1e-6)


def test_moving_sphere_center_lerp():
    b = SceneBuilder()
    b.add_sphere((0, 0, -2), 0.5, b.lambertian((0.5,) * 3), center2=(0, 2, -2))
    s = b.build()
    o = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 2.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    t = jnp.asarray([0.0, 1.0])  # at time 1 the center is at (0,2,-2)
    tb, _, any_ = hit_spheres(o, d, t, s, jnp.full(2, 1e-3), jnp.full(2, 1e9))
    assert bool(any_[0]) and bool(any_[1])
    np.testing.assert_allclose(np.asarray(tb), [1.5, 1.5], rtol=1e-6)


def test_quad_hit_and_uv():
    b = SceneBuilder()
    b.add_quad((-1, -1, -3), (2, 0, 0), (0, 2, 0), b.lambertian((0.5,) * 3))
    s = b.build()
    o = jnp.asarray([[0.5, 0.5, 0.0], [3.0, 3.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    t = jnp.zeros(2)
    tb, idx, any_ = hit_quads(o, d, s, jnp.full(2, 1e-3), jnp.full(2, 1e9))
    assert bool(any_[0]) and not bool(any_[1])
    np.testing.assert_allclose(float(tb[0]), 3.0, rtol=1e-6)

    rec = closest_hit(o, d, t, s, jnp.zeros((2, 2)))
    assert bool(rec.valid[0]) and not bool(rec.valid[1])
    # planar coords: p=(0.5,0.5,-3) rel q=(-1,-1): alpha=1.5/2, beta=1.5/2
    np.testing.assert_allclose(float(rec.u[0]), 0.75, rtol=1e-5)
    np.testing.assert_allclose(float(rec.v[0]), 0.75, rtol=1e-5)
    # face normal flipped toward the ray (+z)
    np.testing.assert_allclose(np.asarray(rec.normal[0]), [0, 0, 1], atol=1e-6)
    assert bool(rec.front_face[0])


def test_closest_hit_picks_nearest_class():
    b = SceneBuilder()
    b.add_sphere((0, 0, -5), 1.0, b.lambertian((0.5,) * 3))
    b.add_quad((-1, -1, -2), (2, 0, 0), (0, 2, 0), b.metal((0.9,) * 3, 0.0))
    s = b.build()
    o, d, t = _rays(((0, 0, 0), (0, 0, -1)))
    rec = closest_hit(o, d, t, s, jnp.zeros((1, 2)))
    np.testing.assert_allclose(float(rec.t[0]), 2.0, rtol=1e-6)  # quad wins
    assert int(s.mat_kind[int(rec.mat[0])]) == 1  # metal


def test_sphere_uv_poles_and_equator():
    from rustraytrace_tpu.ops.intersect import sphere_uv

    outward = jnp.asarray([
        [0.0, 1.0, 0.0],   # north pole: v=1
        [0.0, -1.0, 0.0],  # south pole: v=0
        [1.0, 0.0, 0.0],   # +x: u=0.5, v=0.5 (sphere.rs:47-53 convention)
        [-1.0, 0.0, 0.0],  # -x: u=0 or 1
    ])
    u, v = sphere_uv(outward)
    np.testing.assert_allclose(float(v[0]), 1.0, atol=1e-6)
    np.testing.assert_allclose(float(v[1]), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(u[2]), 0.5, atol=1e-6)
    np.testing.assert_allclose(float(v[2]), 0.5, atol=1e-6)
    assert abs(float(u[3]) - 1.0) < 1e-5 or abs(float(u[3])) < 1e-5


def test_medium_sphere_statistics():
    """Free-flight sampling: P(scatter before exit) = 1 - exp(-rho * L)
    for a chord of length L (constant_medium.rs:59-67)."""
    import jax

    b = SceneBuilder()
    density = 0.3
    b.add_medium_sphere((0, 0, -5), 1.0, density, b.isotropic((1.0,) * 3))
    s = b.build()
    n = 20000
    o = jnp.zeros((n, 3))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
    t = jnp.zeros(n)
    u = jax.random.uniform(jax.random.key(1), (n, 2))
    rec = closest_hit(o, d, t, s, u)
    p_hit = float(jnp.mean(rec.valid))
    expect = 1.0 - np.exp(-density * 2.0)  # chord length 2
    assert abs(p_hit - expect) < 0.02
    # hit points are inside the chord
    tvals = np.asarray(rec.t)[np.asarray(rec.valid)]
    assert tvals.min() >= 4.0 - 1e-3 and tvals.max() <= 6.0 + 1e-3


def test_medium_box_rotated():
    """Rotated medium box: ray through the center must see the same chord as
    an unrotated box seen along its diagonal axis frame."""
    import jax

    b = SceneBuilder()
    b.add_medium_box((-1, -1, -1), (1, 1, 1), 5.0, b.isotropic((1.0,) * 3),
                     rotate_y_deg=45.0, translate=(0, 0, -5))
    s = b.build()
    n = 4000
    o = jnp.zeros((n, 3))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
    t = jnp.zeros(n)
    u = jax.random.uniform(jax.random.key(2), (n, 2))
    rec = closest_hit(o, d, t, s, u)
    # dense medium: nearly every ray scatters inside; entry at z=-5+sqrt(2)
    assert float(jnp.mean(rec.valid)) > 0.99
    tvals = np.asarray(rec.t)[np.asarray(rec.valid)]
    assert tvals.min() >= 5.0 - np.sqrt(2.0) - 1e-2
    assert tvals.max() <= 5.0 + np.sqrt(2.0) + 1e-2


def _root64(o, d, tm, scene, idx):
    """Float64 near-else-far root of sphere ``idx`` per ray."""
    f8 = np.float64
    o, d = np.asarray(o, f8), np.asarray(d, f8)
    c = (np.asarray(scene.sph_center, f8)[idx]
         + np.asarray(tm, f8)[:, None] * np.asarray(scene.sph_cvel, f8)[idx])
    r = np.asarray(scene.sph_radius, f8)[idx]
    oc = c - o
    a = (d * d).sum(-1)
    h = (d * oc).sum(-1)
    sq = np.sqrt(np.maximum(h * h - a * ((oc * oc).sum(-1) - r * r), 0.0))
    tn = (h - sq) / a
    return np.where(tn > 1e-3, tn, (h + sq) / a)


import pytest  # noqa: E402


@pytest.mark.parametrize("name", ["book1_three_spheres",
                                  "book1_random_spheres",
                                  "book2_bouncing_spheres",
                                  "book2_perlin_spheres"])
def test_direct_form_matches_float64(name):
    """hit_spheres' direct quadric (oc = cc - o before any product) against
    a float64 solve of the same winner: f32 accurate away from the large
    grounds' |oc|^2 - r^2 cancellation, and within 1e-3 on them."""
    import jax

    from rustraytrace_tpu import models

    scene, cfg, _ = getattr(models, name)(dict(image_width=16))
    n = 2048
    k = jax.random.split(jax.random.key(4), 3)
    eye = jnp.asarray(cfg.lookfrom, jnp.float32)
    o = eye + jax.random.normal(k[0], (n, 3)) * 0.1
    d = (jnp.asarray(cfg.lookat, jnp.float32)
         + jax.random.normal(k[1], (n, 3)) * 3.0 - o)
    tm = jax.random.uniform(k[2], (n,))
    t, idx, hit = hit_spheres(o, d, tm, scene, jnp.full(n, 1e-3),
                              jnp.full(n, 1e9))
    hit = np.asarray(hit)
    assert hit.mean() > 0.3
    idx = np.asarray(idx)[hit]
    t64 = _root64(np.asarray(o)[hit], np.asarray(d)[hit],
                  np.asarray(tm)[hit], scene, idx)
    rel = np.abs(np.asarray(t)[hit] - t64) / t64
    big = np.asarray(scene.sph_radius)[idx] >= 100.0
    if (~big).any():
        assert rel[~big].max() < 1e-4, rel[~big].max()
        assert np.median(rel[~big]) < 1e-5
    if big.any():
        assert rel[big].max() < 1e-3, rel[big].max()
