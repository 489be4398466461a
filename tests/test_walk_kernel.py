"""The per-ray Pallas walk kernel outside the traversal matrix: it lowers
for CUDA (Triton IR) here on the CPU, ``traverse_bvh`` picks it only on
CUDA, and — on a card — the compiled kernel matches the oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clive2.bvh import build_bvh
from clive2.bvh.build import leaf_tables
from clive2.geometry import TriangleSoup
from clive2.ops.intersect import (
    intersect_bvh,
    pack_gather_walk,
    traverse_bvh,
    unpack_gather_walk,
)
from clive2.ops.walk_kernel import intersect_bvh_kernel

TRITON_CALL = "__gpu$xla.gpu.triton"


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    base = rng.uniform(-3, 3, (600, 1, 3))
    soup = TriangleSoup.from_vertices(base + rng.uniform(-.3, .3,
                                                         (600, 3, 3)))
    bvh = build_bvh(soup, use_native=False)
    arrays = {k: jnp.asarray(v) for k, v in
              pack_gather_walk(bvh, leaf_tables(bvh, soup)).items()}
    n = 777
    o = jnp.asarray(rng.uniform(-4, 4, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True),
                    jnp.float32)
    active = jnp.asarray(rng.random(n) < 0.8)
    t_max = jnp.asarray(rng.uniform(1, 8, n), jnp.float32)
    return arrays, o, d, active, t_max


def _export_cuda(fn, *args):
    return jax.export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            TRITON_CALL)])(*args).mlir_module()


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_lowers_to_triton_for_cuda(case, any_hit):
    arrays, o, d, active, t_max = case
    text = _export_cuda(lambda o, d, a, t: intersect_bvh_kernel(
        o, d, arrays, active=a, t_max=t, any_hit=any_hit),
        o, d, active, t_max)
    assert TRITON_CALL in text
    assert "name = \"bvh_walk\"" in text or "bvh_walk" in text


def test_traverse_bvh_picks_kernel_only_on_cuda(case):
    arrays, o, d, active, t_max = case

    def f(o, d, a, t):
        return traverse_bvh(o, d, arrays, active=a, t_max=t)

    assert TRITON_CALL in _export_cuda(f, o, d, active, t_max)
    cpu_hlo = jax.jit(f).lower(o, d, active, t_max).as_text()
    assert TRITON_CALL not in cpu_hlo


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_compiled_kernel_matches_oracle(gpu, case, any_hit):
    arrays, o, d, active, t_max = case
    oi, ot, _, _ = (np.asarray(x) for x in intersect_bvh(
        o, d, unpack_gather_walk(arrays), active=active, t_max=t_max))
    ki, kt, _, _ = (np.asarray(x) for x in intersect_bvh_kernel(
        o, d, arrays, active=active, t_max=t_max, any_hit=any_hit))
    act = np.asarray(active)
    if any_hit:
        assert ((ki >= 0) == (oi >= 0))[act].mean() >= 0.998
    else:
        assert (ki == oi)[act].mean() >= 0.998
        hit = act & (ki == oi) & (oi >= 0)
        np.testing.assert_allclose(kt[hit], ot[hit], rtol=1e-5)


@pytest.mark.parametrize("n", [8 * 96, 777])
@pytest.mark.parametrize("any_hit", [False, True])
def test_tile_sharded_kernel_matches_unsharded(case, any_hit, n):
    """Under a mesh the kernel runs per device in shard_map (GSPMD does not
    partition a Pallas call): the 8 virtual CPU devices each walk their
    own rays against replicated tables, with the same answers.  777 rays
    do not divide by 8: the wrapper pads with inactive rays."""
    import functools

    from jax.sharding import Mesh

    from clive2.ops.intersect import _tile_sharded

    arrays, o, d, active, t_max = case
    o, d, active, t_max = o[:n], d[:n], active[:n], t_max[:n]
    kern = functools.partial(intersect_bvh_kernel, interpret=True)
    mesh = Mesh(np.array(jax.devices()[:8]), ("tiles",))
    got = jax.jit(_tile_sharded(mesh, kern, arrays, any_hit))(
        o, d, active, t_max)
    want = kern(o, d, arrays, active=active, t_max=t_max, any_hit=any_hit)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
