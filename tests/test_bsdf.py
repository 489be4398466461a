import jax
import jax.numpy as jnp
import numpy as np

from clive2.ops import bsdf
from clive2.ops.sampling import (
    dot,
    ggx_sample,
    orthonormal,
    random_hemisphere_cosine,
    random_hemisphere_uniform,
)


def unit(v):
    return v / np.linalg.norm(v)


def test_orthonormal_frames(rng):
    n = rng.normal(size=(64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    x, y = orthonormal(jnp.asarray(n))
    x, y = np.asarray(x), np.asarray(y)
    np.testing.assert_allclose((x * n).sum(1), 0, atol=1e-5)
    np.testing.assert_allclose((y * n).sum(1), 0, atol=1e-5)
    np.testing.assert_allclose((x * y).sum(1), 0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(x, axis=1), 1, atol=1e-5)


def test_fresnel_limits():
    n = jnp.array([[0.0, 0.0, 1.0]])
    # normal incidence air->glass: ((n1-n2)/(n1+n2))^2 = 0.04
    i = jnp.array([[0.0, 0.0, 1.0]])
    f = bsdf.fresnel(i, n, jnp.array([1.0]), jnp.array([1.5]))
    np.testing.assert_allclose(float(f[0]), 0.04, atol=1e-4)
    # grazing incidence -> 1
    g = jnp.array([[1.0, 0.0, 1e-4]])
    g = g / jnp.linalg.norm(g)
    f2 = bsdf.fresnel(g, n, jnp.array([1.0]), jnp.array([1.5]))
    assert float(f2[0]) > 0.98
    # total internal reflection glass->air beyond critical angle (~41.8 deg)
    tir = jnp.array([unit(np.array([0.9, 0, 0.45]))], dtype=jnp.float32)
    f3 = bsdf.fresnel(tir, n, jnp.array([1.5]), jnp.array([1.0]))
    np.testing.assert_allclose(float(f3[0]), 1.0)


def test_ggx_d_normalization():
    """Integral of D(m) cos(theta) over the hemisphere must be ~1."""
    alpha = 0.3
    n = jnp.array([[0.0, 0.0, 1.0]])
    n_theta, n_phi = 256, 64
    th = (np.arange(n_theta) + 0.5) * (np.pi / 2) / n_theta
    ph = (np.arange(n_phi) + 0.5) * (2 * np.pi) / n_phi
    T, P = np.meshgrid(th, ph, indexing="ij")
    m = np.stack(
        [np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)], axis=-1
    ).reshape(-1, 3)
    d = np.asarray(bsdf.ggx_d(jnp.asarray(m, jnp.float32), n, jnp.float32(alpha)))
    integrand = d * np.cos(T).ravel() * np.sin(T).ravel()
    total = integrand.sum() * (np.pi / 2 / n_theta) * (2 * np.pi / n_phi)
    np.testing.assert_allclose(total, 1.0, rtol=2e-2)


def test_ggx_sample_matches_d(rng):
    """chi^2-style check: GGX-sampled half vectors follow D(m)|cos|."""
    alpha = 0.5
    n = jnp.array([0.0, 0.0, 1.0])
    key = jax.random.key(0)
    u = jax.random.uniform(key, (200_000, 2))
    m = np.asarray(ggx_sample(jnp.broadcast_to(n, (200_000, 3)), u, alpha))
    cos_t = m[:, 2]
    # analytic CDF of GGX theta: cos2 = (1-u)/(1+u(a^2-1)) — check quantiles
    qs = np.quantile(cos_t, [0.1, 0.5, 0.9])
    for q, cq in zip([0.1, 0.5, 0.9], qs):
        u_ = 1 - q  # P(cos > cq) region
        cos2 = (1 - u_) / (1 + u_ * (alpha**2 - 1))
        np.testing.assert_allclose(cq, np.sqrt(cos2), atol=5e-3)


def test_hemisphere_cosine_pdf(rng):
    key = jax.random.key(1)
    u = jax.random.uniform(key, (100_000, 2))
    z = jnp.array([0.0, 0.0, 1.0])
    x = jnp.array([1.0, 0.0, 0.0])
    y = jnp.array([0.0, 1.0, 0.0])
    d = np.asarray(
        random_hemisphere_cosine(
            jnp.broadcast_to(x, (100_000, 3)),
            jnp.broadcast_to(y, (100_000, 3)),
            jnp.broadcast_to(z, (100_000, 3)),
            u,
        )
    )
    assert (d[:, 2] > -1e-6).all()
    # E[cos theta] for cosine-weighted = 2/3
    np.testing.assert_allclose(d[:, 2].mean(), 2 / 3, atol=5e-3)


def test_hemisphere_uniform_pdf(rng):
    key = jax.random.key(2)
    u = jax.random.uniform(key, (100_000, 2))
    z = jnp.array([0.0, 0.0, 1.0])
    x = jnp.array([1.0, 0.0, 0.0])
    y = jnp.array([0.0, 1.0, 0.0])
    d = np.asarray(
        random_hemisphere_uniform(
            jnp.broadcast_to(x, (100_000, 3)),
            jnp.broadcast_to(y, (100_000, 3)),
            jnp.broadcast_to(z, (100_000, 3)),
            u,
        )
    )
    # E[cos theta] for uniform hemisphere = 1/2
    np.testing.assert_allclose(d[:, 2].mean(), 0.5, atol=5e-3)


def test_specular_reflection_law():
    n = jnp.array([[0.0, 0.0, 1.0]])
    wi = jnp.asarray([unit(np.array([0.3, -0.2, 0.9]))], dtype=jnp.float32)
    wo = bsdf.specular_reflection(wi, n)
    # angle of incidence == angle of reflection, tangential flip
    np.testing.assert_allclose(float(dot(wo, n)[0]), float(dot(wi, n)[0]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(wo)[0, :2], -np.asarray(wi)[0, :2], atol=1e-6)


def test_snell_law_transmission():
    n = jnp.array([[0.0, 0.0, 1.0]])
    wi = jnp.asarray([unit(np.array([0.5, 0.0, 0.8]))], dtype=jnp.float32)
    ni, no = jnp.array([1.0]), jnp.array([1.5])
    wo = bsdf.ggx_transmit_direction(wi, n, ni, no)
    sin_i = float(jnp.linalg.norm(wi[0, :2]))
    sin_t = float(jnp.linalg.norm(wo[0, :2]))
    np.testing.assert_allclose(1.0 * sin_i, 1.5 * sin_t, rtol=1e-5)
    assert float(wo[0, 2]) < 0  # transmitted to the other side


def test_reflect_jacobian():
    m = jnp.array([[0.0, 0.0, 1.0]])
    o = jnp.asarray([unit(np.array([0.0, 0.6, 0.8]))], dtype=jnp.float32)
    j = bsdf.reflect_jacobian(m, o)
    np.testing.assert_allclose(float(j[0]), 1.0 / (4 * 0.8), rtol=1e-5)


def test_diffuse_bounce_pdfs():
    key = jax.random.key(3)
    u = jax.random.uniform(key, (1024, 2))
    n = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (1024, 3))
    wi = jnp.broadcast_to(jnp.asarray(unit(np.array([0.0, 0.5, 0.8]))), (1024, 3))
    wo, f, c_p, l_p = bsdf.diffuse_bounce(wi, n, True, u)
    # camera direction: forward pdf is cos(wo)/pi, reverse is cos(wi)/pi
    np.testing.assert_allclose(
        np.asarray(c_p), np.abs(np.asarray(dot(n, wo))) / np.pi, rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(l_p), np.abs(np.asarray(dot(n, wi))) / np.pi, rtol=1e-5
    )
    np.testing.assert_allclose(np.asarray(f), np.asarray(c_p), rtol=1e-5)
    # swapped roles when tracing from the light
    _, _, c_p2, l_p2 = bsdf.diffuse_bounce(wi, n, False, u)
    np.testing.assert_allclose(np.asarray(c_p2), np.asarray(l_p), rtol=1e-5)


def test_mirror_reflect_bounce_energy():
    """alpha=0 reflect bounce: f = F / |i.m| reduces to Fresnel delta."""
    n = jnp.array([[0.0, 0.0, 1.0]])
    m = n
    wi = jnp.asarray([unit(np.array([0.0, 0.0, 1.0]))], dtype=jnp.float32)
    wo, f, c_p, l_p = bsdf.reflect_bounce(
        wi, n, m, jnp.array([1.0]), jnp.array([1.5]), jnp.array([0.0]), True
    )
    np.testing.assert_allclose(np.asarray(wo), np.asarray(wi), atol=1e-6)
    # D=1 delta convention, G=1, F=0.04 at normal incidence -> f = 0.01
    np.testing.assert_allclose(float(f[0]), 0.04 / 4, atol=1e-4)
