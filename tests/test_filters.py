import jax
import jax.numpy as jnp
import numpy as np

from clive2.camera import Camera
from clive2.ops.filters import filter_weights, finalize_samples


def make_cam(w=8, h=6):
    cam = Camera(
        center=np.zeros(3),
        direction=np.array([0, 0, -1.0]),
        pixel_width=w,
        pixel_height=h,
        phys_width=w / h,
        phys_height=1.0,
    )
    return cam.to_pytree(), w, h


def pixel_positions(cam, w, h, jitter):
    """Sensor positions at pixel centers + jitter (matches ray-gen math)."""
    idx = np.arange(w * h)
    px, py = idx % w, idx // w
    xn = (px + jitter - 0.5 * w) / w
    yn = (py + jitter - 0.5 * h) / h
    pos = (
        cam["center"][None]
        + (xn * cam["phys_width"])[:, None] * np.asarray(cam["dx"])[None]
        + (yn * cam["phys_height"])[:, None] * np.asarray(cam["dy"])[None]
    )
    return jnp.asarray(pos, jnp.float32), jnp.asarray(idx, jnp.int32)


def test_weights_normalized_and_centered():
    cam, w, h = make_cam()
    pos, idx = pixel_positions(cam, w, h, jitter=0.5)  # exact pixel centers
    wts = np.asarray(filter_weights(pos, idx, cam, w, h))
    sums = wts.sum(axis=(1, 2))
    np.testing.assert_allclose(sums, 1.0, atol=1e-5)
    # center weight is the largest for a centered sample
    assert (wts[:, 1, 1] >= wts.reshape(len(wts), -1).max(1) - 1e-6).all()


def test_weights_zero_out_of_bounds():
    cam, w, h = make_cam()
    pos, idx = pixel_positions(cam, w, h, jitter=0.5)
    wts = np.asarray(filter_weights(pos, idx, cam, w, h)).reshape(h, w, 3, 3)
    # pixel (0,0): neighbors at x-1 or y-1 are out of bounds -> zero
    assert (wts[0, 0, 0, :] == 0).all()
    assert (wts[0, 0, :, 0] == 0).all()
    assert wts[0, 0].sum() > 0.999


def test_finalize_conserves_energy():
    cam, w, h = make_cam()
    key = jax.random.key(0)
    pos, idx = pixel_positions(
        cam, w, h, jitter=np.asarray(jax.random.uniform(key, (w * h,)))
    )
    wts = filter_weights(pos, idx, cam, w, h)
    contrib = jax.random.uniform(jax.random.key(1), (w * h, 3))
    cws = jax.random.uniform(jax.random.key(2), (w * h,))
    img, wimg = finalize_samples(contrib, wts, cws, w, h)
    # normalized weights redistribute but never create/destroy energy
    np.testing.assert_allclose(
        float(img.sum()), float(contrib.sum()), rtol=1e-5
    )
    np.testing.assert_allclose(float(wimg.sum()), float(cws.sum()), rtol=1e-5)


def test_finalize_identity_for_delta_weights():
    """All weight on the center cell -> finalize is the identity."""
    cam, w, h = make_cam()
    n = w * h
    wts = jnp.zeros((n, 3, 3)).at[:, 1, 1].set(1.0)
    contrib = jnp.arange(n * 3, dtype=jnp.float32).reshape(n, 3)
    img, _ = finalize_samples(contrib, wts, jnp.ones(n), w, h)
    np.testing.assert_allclose(
        np.asarray(img).reshape(n, 3), np.asarray(contrib), rtol=1e-6
    )
