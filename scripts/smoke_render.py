"""End-to-end smoke render through the public API: Cornell box -> PNG."""
import os
import sys
import time

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

import clive2 as c2

size = int(next((a.split("=")[1] for a in sys.argv if a.startswith("--size=")), 64))
spp = int(next((a.split("=")[1] for a in sys.argv if a.startswith("--spp=")), 2))

t0 = time.time()
scene = c2.create_scene_from_preset("empty", pixel_width=size, pixel_height=size)
print(f"scene: {scene.n_triangles} tris, {scene.n_nodes} nodes, "
      f"built in {scene.build_seconds:.2f}s")

r = c2.Renderer(scene, seed=7)
t1 = time.time()
r.run_sample()
r.block()
print(f"first sample (incl. compile): {time.time() - t1:.1f}s")
t2 = time.time()
for _ in range(spp - 1):
    r.run_sample()
r.block()
if spp > 1:
    print(f"steady-state: {(time.time() - t2) / (spp - 1):.2f}s/sample")

raw = r.raw_image
print("raw image stats: min %.4f mean %.4f max %.4f, nonzero %.1f%%" % (
    raw.min(), raw.mean(), raw.max(), 100 * (raw.sum(axis=2) > 0).mean()))
uni = r.raw_unidirectional
print("unidirectional:  min %.4f mean %.4f max %.4f, nonzero %.1f%%" % (
    uni.min(), uni.mean(), uni.max(), 100 * (uni.sum(axis=2) > 0).mean()))

img = r.image  # BGR uint8
from clive2.apps.render import save_png  # noqa: E402

save_png("output/smoke_bdpt.png", img)
save_png("output/smoke_uni.png", r.unidirectional_image)
print("wrote output/smoke_bdpt.png, output/smoke_uni.png")
print(f"total {time.time() - t0:.1f}s")
