"""Material-sorting A/B (VERDICT r1 #7 / SURVEY §2.3 EP row).

The north star suggests "material sorting instead of branching" for the
shade/bounce stage.  On a VPU the alternative to sorting is masked
evaluation of ALL lobes + select (what trace.py:_select_bounce does).
Sorting can only win back the cost DIFFERENCE between all-lobes and the
cheapest lobe — this script measures that bound directly:

  all_lobes   — diffuse + GGX reflect + GGX transmit + selects (production)
  diffuse     — diffuse only (the floor a perfect sort could reach for a
                100%-diffuse wavefront)
  reflect     — GGX reflect only (floor for a 100%-glass wavefront)

If (all_lobes - floor) per sample is negligible against the sample time,
sorting has no headroom regardless of implementation; the measured numbers
go in the commit message / ROADMAP.

Usage: python scripts/shade_ab.py [n_rays] [reps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from clive2.integrator.trace import _select_bounce
from clive2.ops import bsdf
from clive2.ops.sampling import ggx_sample, normalize


def make_inputs(n, key):
    ks = jax.random.split(key, 6)
    nrm = normalize(jax.random.normal(ks[0], (n, 3)))
    wi = normalize(jax.random.normal(ks[1], (n, 3)))
    wi = jnp.where(jnp.sum(wi * nrm, -1, keepdims=True) < 0, -wi, wi)
    roll_a = jax.random.uniform(ks[2], (n, 2))
    roll_b = jax.random.uniform(ks[3], (n, 2))
    roll_c = jax.random.uniform(ks[4], (n,))
    mat_type = jax.random.randint(ks[5], (n,), 0, 3)
    alpha = jnp.full((n,), 0.2)
    ni = jnp.ones((n,))
    no = jnp.full((n,), 1.5)
    return dict(nrm=nrm, wi=wi, roll_a=roll_a, roll_b=roll_b, roll_c=roll_c,
                mat_type=mat_type, alpha=alpha, ni=ni, no=no)


def all_lobes(x):
    m = ggx_sample(x["nrm"], x["roll_a"], x["alpha"])
    fres = bsdf.fresnel(x["wi"], m, x["ni"], x["no"])
    diffuse = bsdf.diffuse_bounce(x["wi"], x["nrm"], True, x["roll_b"])
    reflect = bsdf.reflect_bounce(x["wi"], x["nrm"], m, x["ni"], x["no"],
                                  x["alpha"], True)
    transmit = bsdf.transmit_bounce(x["wi"], x["nrm"], m, x["ni"], x["no"],
                                    x["alpha"], True)
    return _select_bounce(x["mat_type"], x["roll_c"], fres, diffuse,
                          reflect, transmit)


def diffuse_only(x):
    return bsdf.diffuse_bounce(x["wi"], x["nrm"], True, x["roll_b"])


def reflect_only(x):
    m = ggx_sample(x["nrm"], x["roll_a"], x["alpha"])
    return bsdf.reflect_bounce(x["wi"], x["nrm"], m, x["ni"], x["no"],
                               x["alpha"], True)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2 * 512 * 512
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    x = make_inputs(n, jax.random.key(0))
    x = jax.tree.map(jax.block_until_ready, x)

    for name, fn in (("all_lobes", all_lobes), ("diffuse", diffuse_only),
                     ("reflect", reflect_only)):
        f = jax.jit(fn)
        out = f(x)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(x)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        print(f"{name:10s} {dt*1e3:7.3f} ms for {n/1e6:.2f}M rays "
              f"(x6 depths = {6*dt*1e3:.2f} ms/sample)")


if __name__ == "__main__":
    main()
