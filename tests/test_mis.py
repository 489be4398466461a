"""MIS-chain equivalence: the precomputed fast path must match the direct
transcription of trace.metal:693-776 on arbitrary path data."""

import jax.numpy as jnp
import numpy as np
import pytest

from clive2.integrator import connect as C
from clive2.materials import default_materials

D = 6
N = 257


def random_paths(rng):
    def path():
        v = dict(
            origin=rng.normal(size=(D, N, 3)).astype(np.float32) * 3,
            direction=rng.normal(size=(D, N, 3)).astype(np.float32),
            normal=rng.normal(size=(D, N, 3)).astype(np.float32),
            l_importance=rng.uniform(0.01, 2, size=(D, N)).astype(np.float32),
            c_importance=rng.uniform(0.01, 2, size=(D, N)).astype(np.float32),
            tot_importance=rng.uniform(0.01, 2, size=(D, N)).astype(np.float32),
            material=rng.integers(0, 8, size=(D, N)).astype(np.int32),
        )
        for k in ("direction", "normal"):
            v[k] /= np.linalg.norm(v[k], axis=-1, keepdims=True)
        return {kk: jnp.asarray(vv) for kk, vv in v.items()}

    return path(), path()


@pytest.mark.parametrize("t,s", [(2, 0), (3, 0), (6, 0), (2, 1), (2, 3),
                                 (4, 2), (6, 6), (2, 6)])
def test_fast_matches_oracle(rng, t, s):
    CV, LV = random_paths(rng)
    mat = {k: jnp.asarray(v) for k, v in default_materials().to_pytree().items()}
    cv = C._vstatic(CV, t - 1)
    lv = C._vstatic(LV, s - 1) if s else None

    w_ref, ps_ref, ok_ref = C._mis_weight(t, s, CV, LV, cv, lv, mat)

    pre = C.precompute_mis(CV, LV, mat, D)
    light_tot = jnp.ones_like(cv["tot_importance"]) if s == 0 else lv["tot_importance"]
    p_s = cv["tot_importance"] * light_tot
    if s >= 1:
        delta = cv["origin"] - lv["origin"]
        dx = jnp.maximum(jnp.sum(delta * delta, axis=-1), 1e-30)
    else:
        dx = None
    w_fast, ps_fast, ok_fast = C._mis_weight_fast(t, s, pre, p_s, Dx=dx)

    np.testing.assert_array_equal(np.asarray(ok_ref), np.asarray(ok_fast))
    np.testing.assert_allclose(np.asarray(ps_ref), np.asarray(ps_fast), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(w_ref), np.asarray(w_fast), rtol=2e-4, atol=1e-6
    )


def test_fast_matches_oracle_t1(rng):
    """t=1 synthetic camera vertex variant."""
    t, s = 1, 3
    CV, LV = random_paths(rng)
    mat = {k: jnp.asarray(v) for k, v in default_materials().to_pytree().items()}
    lv = C._vstatic(LV, s - 1)

    # synthetic vertex like _strategy_t1 builds it
    base = C._vstatic(CV, 0)
    cv = dict(base)
    cv["origin"] = lv["origin"] + 2.0
    cv["direction"] = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (N, 1))
    cv["normal"] = jnp.tile(jnp.asarray([[0.0, 0.6, 0.8]]), (N, 1))
    cv["material"] = jnp.full((N,), 7, dtype=jnp.int32)
    cv["tot_importance"] = jnp.ones((N,), dtype=jnp.float32)

    w_ref, ps_ref, ok_ref = C._mis_weight(t, s, CV, LV, cv, lv, mat,
                                          cv_synthetic=cv)

    pre = C.precompute_mis(CV, LV, mat, D)
    p_s = cv["tot_importance"] * lv["tot_importance"]
    delta = cv["origin"] - lv["origin"]
    dx = jnp.maximum(jnp.sum(delta * delta, axis=-1), 1e-30)
    w_synth = jnp.abs(jnp.sum(cv["direction"] * cv["normal"], axis=-1))
    spec_synth = jnp.broadcast_to(mat["type"][7] > 0, w_synth.shape)
    w_fast, ps_fast, ok_fast = C._mis_weight_fast(
        t, s, pre, p_s, Dx=dx, w_synth=w_synth, spec_synth=spec_synth
    )

    np.testing.assert_array_equal(np.asarray(ok_ref), np.asarray(ok_fast))
    np.testing.assert_allclose(
        np.asarray(w_ref), np.asarray(w_fast), rtol=2e-4, atol=1e-6
    )