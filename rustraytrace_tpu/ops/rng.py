"""Counter-based sampling primitives.

The reference uses per-thread stateful RNG on CPU (thread-local SmallRng,
``src/books/*/rtweekend.rs:9-11``) and hash-seeded xorshift32 on GPU
(``src/gpu/renderer.wgsl:51-75``).  Neither suits batched vector code; here every draw comes
from ``jax.random`` threefry keys folded over (pass, bounce) so renders are
reproducible and shard-invariant.

Direction sampling uses the closed forms the reference's GPU kernels already
use (``renderer.wgsl:78-89``) rather than the CPU path's rejection loops
(``src/books/*/vec3.rs:172-189``): rejection is branch-hostile on a vector
unit, the closed forms are exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TWO_PI = 6.283185307179586


def uniforms(key: jax.Array, shape, n: int) -> jnp.ndarray:
    """Draw ``n`` independent uniform [0,1) arrays of ``shape``: [..., n]."""
    return jax.random.uniform(key, tuple(shape) + (n,), dtype=jnp.float32)


def unit_vector(u1: jnp.ndarray, u2: jnp.ndarray) -> jnp.ndarray:
    """Uniform direction on S^2 from two uniforms; renderer.wgsl:78-83 form."""
    a = u1 * TWO_PI
    z = u2 * 2.0 - 1.0
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([r * jnp.cos(a), r * jnp.sin(a), z], axis=-1)


def in_unit_disk(u1: jnp.ndarray, u2: jnp.ndarray) -> jnp.ndarray:
    """Uniform point in the unit disk (2 coords); renderer.wgsl:85-89 form."""
    r = jnp.sqrt(u1)
    theta = u2 * TWO_PI
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def cosine_direction(u1: jnp.ndarray, u2: jnp.ndarray) -> jnp.ndarray:
    """Cosine-weighted hemisphere direction in local (z-up) frame.

    Reference: ``src/books/the_rest_of_your_life/vec3.rs:212-221``
    (random_cosine_direction).
    """
    phi = TWO_PI * u1
    sqrt_u2 = jnp.sqrt(u2)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - u2))
    return jnp.stack([jnp.cos(phi) * sqrt_u2, jnp.sin(phi) * sqrt_u2, z], axis=-1)


def to_sphere(u1: jnp.ndarray, u2: jnp.ndarray, radius, distance_squared) -> jnp.ndarray:
    """Direction toward a sphere subtending a cone, in local (z-toward) frame.

    Reference: ``src/books/the_rest_of_your_life/sphere.rs:55-65``
    (random_to_sphere).
    """
    z = 1.0 + u2 * (jnp.sqrt(jnp.maximum(0.0, 1.0 - radius * radius / distance_squared)) - 1.0)
    phi = TWO_PI * u1
    s = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([jnp.cos(phi) * s, jnp.sin(phi) * s, z], axis=-1)


def onb_from_w(n: jnp.ndarray):
    """Orthonormal basis (u, v, w) with w = normalize(n).

    Branch-free form of ``src/books/the_rest_of_your_life/onb.rs:8-18``:
    pick helper axis by |w.x| > 0.9 via select.
    Input [..., 3]; returns three [..., 3] arrays.
    """
    w = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    use_y = jnp.abs(w[..., 0:1]) > 0.9
    a = jnp.where(
        use_y,
        jnp.asarray([0.0, 1.0, 0.0], dtype=w.dtype),
        jnp.asarray([1.0, 0.0, 0.0], dtype=w.dtype),
    )
    v = jnp.cross(w, a)
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    u = jnp.cross(w, v)
    return u, v, w


def onb_transform(u, v, w, local: jnp.ndarray) -> jnp.ndarray:
    """local -> world: l.x*u + l.y*v + l.z*w (onb.rs:32-34)."""
    return (
        local[..., 0:1] * u + local[..., 1:2] * v + local[..., 2:3] * w
    )
