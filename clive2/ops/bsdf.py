"""GGX microfacet BSDF suite with BDPT dual-pdf bookkeeping.

Batched JAX equivalents of the reference device functions at
reference src/trace.metal:235-379: exact dielectric Fresnel
(de Grève formulation), Smith GGX masking-shadowing, GGX NDF, half-vector
measure Jacobians, full Walter-style microfacet BRDF/BTDF, and the three
"bounce" routines that also return **both** directional pdfs:

    c_p — pdf of the camera-direction edge
    l_p — pdf of the light-direction edge

These dual pdfs drive the balance-heuristic MIS chain in the BDPT connector
(integrator/connect.py).  All functions are elementwise over a leading batch
dim; directions point *away* from the surface vertex.
"""

from __future__ import annotations

import jax.numpy as jnp

from .sampling import (
    PI,
    dot,
    normalize,
    orthonormal,
    random_hemisphere_cosine,
)


def specular_reflection(i, m):
    """Mirror i about m (trace.metal:235-237)."""
    return normalize(2.0 * dot(i, m)[..., None] * m - i)


def reflect_half_direction(i, o):
    return normalize(i + o)


def ggx_transmit_direction(i, m, ni, no):
    """Snell refraction of i through microfacet m (trace.metal:243-248)."""
    cos_i = dot(i, m)
    eta = ni / no
    cos_t = jnp.sqrt(jnp.maximum(1.0 + eta * eta * (cos_i * cos_i - 1.0), 0.0))
    return normalize((eta * cos_i - cos_t)[..., None] * m - eta[..., None] * i)


def transmit_half_direction(i, o, ni, no):
    """Half vector of a refraction event (trace.metal:250-252)."""
    return normalize(no[..., None] * o + ni[..., None] * i)


def fresnel(i, m, ni, nt):
    """Exact dielectric Fresnel, TIR -> 1 (trace.metal:254-264)."""
    cos_i = jnp.abs(dot(i, m))
    eta = ni / nt
    sin_t2 = eta * eta * (1.0 - cos_i * cos_i)
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin_t2, 0.0))
    r_par = (nt * cos_i - ni * cos_t) / (nt * cos_i + ni * cos_t)
    r_perp = (ni * cos_i - nt * cos_t) / (ni * cos_i + nt * cos_t)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return jnp.where(sin_t2 >= 1.0, jnp.float32(1.0), f)


def ggx_g1(v, m, alpha):
    """Smith G1 (trace.metal:266-271)."""
    mv = dot(m, v)
    sin2 = 1.0 - mv * mv
    tan2 = sin2 / jnp.maximum(mv * mv, 1e-30)
    return 2.0 / (1.0 + jnp.sqrt(1.0 + alpha * alpha * tan2))


def ggx_g(i, o, m, n, alpha):
    """Smith masking-shadowing with sidedness checks (trace.metal:273-277)."""
    g = ggx_g1(i, m, alpha) * ggx_g1(o, m, alpha)
    ok = (dot(i, m) * dot(i, n) > 0.0) & (dot(o, m) * dot(o, n) > 0.0)
    return jnp.where(ok, g, 0.0)


def ggx_d(m, n, alpha):
    """GGX NDF; alpha == 0 uses the delta convention D = 1
    (trace.metal:279-288)."""
    a2 = alpha * alpha
    c = dot(m, n)
    denom = c * c * (a2 - 1.0) + 1.0
    d = a2 / (PI * denom * denom)
    return jnp.where(alpha == 0.0, jnp.float32(1.0), d)


def reflect_jacobian(m, o):
    """dωh/dωo for reflection (trace.metal:290-292)."""
    return 1.0 / (4.0 * jnp.abs(dot(m, o)) + 1e-30)


def transmit_jacobian(i, o, m, ni, no):
    """dωh/dωo for refraction (trace.metal:294-301).

    ``m`` is accepted for call-site parity but the half vector is recomputed
    from (i, o, ni, no), as in the reference.
    """
    h = transmit_half_direction(i, o, ni, no)
    cos_i = dot(i, h)
    cos_o = dot(o, h)
    num = no * no * jnp.abs(cos_o)
    den = (ni * cos_i + no * cos_o) ** 2
    return num / jnp.maximum(den, 1e-30)


def ggx_brdf_reflect(i, o, m, n, ni, no, alpha):
    """Microfacet reflection BRDF (trace.metal:303-309)."""
    d = ggx_d(m, n, alpha)
    g = ggx_g(i, o, m, n, alpha)
    f = fresnel(i, m, ni, no)
    return (d * g * f) / (4.0 * jnp.abs(dot(i, m)) + 1e-30)


def ggx_brdf_transmit(i, o, m, n, ni, no, alpha):
    """Microfacet transmission BTDF (trace.metal:311-328).

    D, G, F are evaluated at the SAMPLED microfacet normal ``m`` exactly
    as the reference does (trace.metal:313-316) — NOT at the recomputed
    half vector ``h``, which comes out anti-parallel to m (the unnegated
    Walter convention trace.metal:250-252) and would trip GGX_G's
    sidedness check, silently zeroing every transmission event.  (That
    was a real round-2 bug, caught by the glass-furnace oracle in
    tests/test_furnace.py; D, F and the |dot| products are h/-h
    symmetric, so the G check is the only difference.)  ``h`` still
    supplies the im/om measure terms, as in the reference.
    """
    h = transmit_half_direction(i, o, ni, no)
    d = ggx_d(m, n, alpha)
    g = ggx_g(i, o, m, n, alpha)
    f = fresnel(i, m, ni, no)
    im = dot(i, h)
    om = dot(o, h)
    i_n = dot(i, n)
    o_n = dot(o, n)
    coeff = (im * om) / jnp.where(jnp.abs(i_n * o_n) > 1e-30, i_n * o_n, 1e-30)
    num = no * no * d * g * (1.0 - f)
    den = (ni * im + no * om) ** 2
    return coeff * num / jnp.maximum(den, 1e-30)


def interpolate_normal(n0, n1, n2, u, v):
    """Barycentric smooth shading normal (trace.metal:330-332)."""
    w = (1.0 - u - v)[..., None]
    return normalize(n0 * w + n1 * u[..., None] + n2 * v[..., None])


# --------------------------------------------------------------------------
# bounce routines: sample wo, return (wo, f, c_p, l_p)
# --------------------------------------------------------------------------

def diffuse_bounce(wi, n, from_camera: bool, rand):
    """Cosine-weighted Lambert bounce (trace.metal:334-346)."""
    x, y = orthonormal(n)
    wo = random_hemisphere_cosine(x, y, n, rand)
    f = jnp.abs(dot(n, wo)) / PI
    fwd = jnp.abs(dot(n, wo)) / PI
    rev = jnp.abs(dot(n, wi)) / PI
    if from_camera:
        return wo, f, fwd, rev
    return wo, f, rev, fwd


def reflect_bounce(wi, n, m, ni, no, alpha, from_camera: bool):
    """GGX reflection bounce (trace.metal:348-362)."""
    wo = specular_reflection(wi, m)
    f = ggx_brdf_reflect(wi, wo, m, n, ni, no, alpha)
    pf = fresnel(wi, m, ni, no)
    pm = jnp.abs(dot(m, n)) * ggx_d(m, n, alpha)
    fwd = pf * pm * reflect_jacobian(m, wo)
    rev = pf * pm * reflect_jacobian(m, wi)
    if from_camera:
        return wo, f, fwd, rev
    return wo, f, rev, fwd


def transmit_bounce(wi, n, m, ni, no, alpha, from_camera: bool):
    """GGX transmission bounce (trace.metal:364-379).

    Weight convention: in this codebase (as in the reference) the sampled
    branch's throughput multiplier is f / branch_pdf with no separate
    cosine — the reflect f is pre-divided by 4|i.m| (trace.metal:303-309)
    precisely so f/p equals Walter's weight |i.h| G / (|i.n| |h.n|)
    (Walter et al. 2007, eq. 41).  The reference's transmit f (the
    standard Walter BTDF) lacks the matching |o.n| factor, making every
    refraction's weight 1/cos(o) too large — a measurable energy
    inflation (the glass-furnace oracle in tests/test_furnace.py reads
    +2% global / +20% at grazing).  The corrected estimator multiplies f
    by |o.n| so f/p hits the Walter weight exactly; CLIVE2_REFERENCE_MIS=1
    keeps the reference's inflated value verbatim.
    """
    from ..constants import REFERENCE_MIS

    wo = ggx_transmit_direction(wi, m, ni, no)
    f = ggx_brdf_transmit(wi, wo, m, n, ni, no, alpha)
    if not REFERENCE_MIS:
        f = f * jnp.abs(dot(wo, n))
    pf = 1.0 - fresnel(wi, m, ni, no)
    pm = jnp.abs(dot(m, n)) * ggx_d(m, n, alpha)
    fwd = pf * pm * transmit_jacobian(wi, wo, m, ni, no)
    rev = pf * pm * transmit_jacobian(wo, wi, -m, no, ni)
    if from_camera:
        return wo, f, fwd, rev
    return wo, f, rev, fwd
