"""Batched direction sampling ops.

JAX equivalents of the reference's per-thread helpers
(reference src/trace.metal:200-233).  All functions are vectorized
over a leading batch dimension; vectors are [..., 3] float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PI = jnp.float32(jnp.pi)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def normalize(v, eps=0.0):
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(n, jnp.float32(1e-30) if eps == 0.0 else eps)


def orthonormal(n):
    """Tangent frame (x, y) for unit normal n (trace.metal:200-211).

    Picks the cardinal axis with the smallest |n| component, projects it
    orthogonal to n.
    """
    an = jnp.abs(n)
    axis = jnp.argmin(an, axis=-1)
    v = jax.nn.one_hot(axis, 3, dtype=n.dtype)
    x = normalize(v - dot(v, n)[..., None] * n)
    y = normalize(jnp.cross(n, x))
    return x, y


def random_hemisphere_cosine(x_axis, y_axis, z_axis, rand):
    """Cosine-weighted hemisphere direction (trace.metal:213-217).

    rand: [..., 2] uniforms.
    """
    theta = jnp.arccos(jnp.sqrt(rand[..., 0]))
    phi = 2.0 * PI * rand[..., 1]
    st, ct = jnp.sin(theta), jnp.cos(theta)
    d = (
        (st * jnp.cos(phi))[..., None] * x_axis
        + (st * jnp.sin(phi))[..., None] * y_axis
        + ct[..., None] * z_axis
    )
    return normalize(d)


def random_hemisphere_uniform(x_axis, y_axis, z_axis, rand):
    """Uniform hemisphere direction (trace.metal:219-224)."""
    z = rand[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * rand[..., 1]
    d = (
        (r * jnp.cos(phi))[..., None] * x_axis
        + (r * jnp.sin(phi))[..., None] * y_axis
        + z[..., None] * z_axis
    )
    return normalize(d)


def ggx_sample(n, rand, alpha):
    """Sample a GGX microfacet half-vector around normal n
    (trace.metal:226-233).  alpha broadcastable scalar/[...]."""
    x, y = orthonormal(n)
    theta = 2.0 * PI * rand[..., 0]
    r2 = rand[..., 1]
    phi = jnp.arctan(alpha * jnp.sqrt(r2) / jnp.sqrt(jnp.maximum(1.0 - r2, 1e-30)))
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    m = (
        (sp * jnp.cos(theta))[..., None] * x
        + (sp * jnp.sin(theta))[..., None] * y
        + cp[..., None] * n
    )
    return normalize(m)


def sample_triangle_uniform(v0, v1, v2, rand):
    """Uniform barycentric point on a triangle (trace.metal:1091-1100).

    Matches the reference convention: P = u*v0 + v*v1 + w*v2 with
    (u, v) folded into the unit triangle and w = 1-u-v.
    """
    u = rand[..., 0]
    v = rand[..., 1]
    flip = (u + v) > 1.0
    u = jnp.where(flip, 1.0 - u, u)
    v = jnp.where(flip, 1.0 - v, v)
    w = 1.0 - u - v
    return u[..., None] * v0 + v[..., None] * v1 + w[..., None] * v2
