"""Perlin noise: vectorized lattice gathers.

Reference: ``src/books/the_next_week/perlin.rs`` — 256-entry random unit
vector lattice, three xor-combined permutation tables, trilinear
Hermite-smoothed interpolation (perlin.rs:25-98), and 7-octave turbulence
(perlin.rs:50-62).  Tables are built host-side with a fixed seed (see
``scene._make_perlin``); evaluation is 8 gathers over a 256-entry table per
point from a table small enough to stay in cache.
"""

from __future__ import annotations

import jax.numpy as jnp


def noise(p: jnp.ndarray, randvec: jnp.ndarray, perm: jnp.ndarray) -> jnp.ndarray:
    """Perlin noise for points p [R,3] -> [R] in [-1, 1]."""
    fl = jnp.floor(p)
    uvw = p - fl
    ijk = fl.astype(jnp.int32)

    # Hermite cubic smoothing (perlin.rs:80-82)
    s = uvw * uvw * (3.0 - 2.0 * uvw)

    accum = jnp.zeros(p.shape[:-1], p.dtype)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                idx = (
                    perm[0, (ijk[..., 0] + di) & 255]
                    ^ perm[1, (ijk[..., 1] + dj) & 255]
                    ^ perm[2, (ijk[..., 2] + dk) & 255]
                )
                c = randvec[idx]  # [R,3]
                weight = jnp.stack(
                    [uvw[..., 0] - di, uvw[..., 1] - dj, uvw[..., 2] - dk], axis=-1
                )
                wx = di * s[..., 0] + (1 - di) * (1.0 - s[..., 0])
                wy = dj * s[..., 1] + (1 - dj) * (1.0 - s[..., 1])
                wz = dk * s[..., 2] + (1 - dk) * (1.0 - s[..., 2])
                accum = accum + wx * wy * wz * jnp.sum(c * weight, axis=-1)
    return accum


def turb(p: jnp.ndarray, randvec: jnp.ndarray, perm: jnp.ndarray, depth: int = 7) -> jnp.ndarray:
    """|sum_i 0.5^i * noise(2^i p)| (perlin.rs:50-62)."""
    accum = jnp.zeros(p.shape[:-1], p.dtype)
    temp_p = p
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * noise(temp_p, randvec, perm)
        weight *= 0.5
        temp_p = temp_p * 2.0
    return jnp.abs(accum)
