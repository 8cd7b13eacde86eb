"""The XLA gather and deposit against their float64 numpy references.

``subpixal_tpu.testing.sample_image_reference`` and
``drizzle_deposit_reference`` are plain float64 implementations of the
same semantics; ``chip_smoke.py`` holds the device ops to them at real
widths on the card. Here they are checked on the CPU at small sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from subpixal_tpu.ops.drizzle import DRIZZLE_KERNELS, drizzle_deposit
from subpixal_tpu.ops.interp import INTERP_OFFSETS, sample_image
from subpixal_tpu.testing import (drizzle_deposit_reference,
                                  sample_image_reference)


def _pixmap(H, W, ang=0.3, sc=1.0, tx=3.3, ty=2.7):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    c, s = np.cos(np.deg2rad(ang)), np.sin(np.deg2rad(ang))
    return ((sc * (c * xx - s * yy) + tx).astype(np.float32),
            (sc * (s * xx + c * yy) + ty).astype(np.float32))


# --------------------------------------------------------------------- #
# gather
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("interp", sorted(INTERP_OFFSETS))
def test_sample_image_matches_reference(interp):
    rng = np.random.default_rng(0)
    img = rng.random((64, 80)).astype(np.float32)
    x = rng.uniform(-4, 84, (600,)).astype(np.float32)
    y = rng.uniform(-4, 68, (600,)).astype(np.float32)
    v, ok = sample_image(jnp.asarray(img), x, y, interp=interp, fill=-3.0)
    vr, okr = sample_image_reference(img, x, y, interp, fill=-3.0)
    np.testing.assert_array_equal(np.asarray(ok), okr)
    # f32 weights and products: ~3e-7 seen
    np.testing.assert_allclose(np.asarray(v, np.float64), vr, atol=2e-6)


def test_sample_image_fill_and_validity():
    """Samples whose footprint leaves the image are ``fill`` and flagged
    invalid; a footprint that just fits is valid."""
    img = np.arange(20 * 30, dtype=np.float32).reshape(20, 30)
    # poly5 taps are floor(x) - 2 .. floor(x) + 3
    x = np.array([2.0, 1.99, 26.5, 27.0, 10.0, 10.0], np.float32)
    y = np.array([5.0, 5.0, 5.0, 5.0, 2.0, 17.01], np.float32)
    v, ok = sample_image(jnp.asarray(img), x, y, interp="poly5",
                         fill=-9.0)
    vr, okr = sample_image_reference(img, x, y, "poly5", fill=-9.0)
    np.testing.assert_array_equal(np.asarray(ok),
                                  [True, False, True, False, True, False])
    np.testing.assert_array_equal(np.asarray(ok), okr)
    assert np.all(np.asarray(v)[~np.asarray(ok)] == -9.0)
    # Lagrange interpolation reproduces a linear ramp exactly
    np.testing.assert_allclose(np.asarray(v)[0], 5 * 30 + 2.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(v, np.float64), vr, atol=1e-3)


def test_sample_image_small_image():
    """An image barely wider than the tap footprint: only the positions
    whose 6-tap window fits are valid, and they match the reference."""
    rng = np.random.default_rng(1)
    img = rng.random((6, 7)).astype(np.float32)
    gy, gx = np.mgrid[0:6:0.25, 0:7:0.25]
    x = gx.ravel().astype(np.float32)
    y = gy.ravel().astype(np.float32)
    v, ok = sample_image(jnp.asarray(img), x, y, interp="poly5")
    vr, okr = sample_image_reference(img, x, y, "poly5")
    np.testing.assert_array_equal(np.asarray(ok), okr)
    assert 0 < okr.sum() < okr.size
    np.testing.assert_allclose(np.asarray(v, np.float64), vr, atol=2e-6)


# --------------------------------------------------------------------- #
# deposit
# --------------------------------------------------------------------- #

GEOMETRIES = {
    # slightly rotated frame onto a same-scale grid
    "rotated": dict(pixfrac=1.0, pscale_ratio=1.0, sc=1.0, out=(70, 60)),
    # input pixels twice the output pixel size, shrunk droplets
    "pscale2": dict(pixfrac=0.8, pscale_ratio=2.0, sc=2.0, out=(140, 120)),
}


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("kernel", DRIZZLE_KERNELS)
def test_drizzle_deposit_matches_reference(kernel, geom):
    g = GEOMETRIES[geom]
    rng = np.random.default_rng(2)
    data = rng.random((60, 50)).astype(np.float32)
    wht = rng.uniform(0.5, 1.5, (60, 50)).astype(np.float32)
    wht[7, 9] = 0.0  # zero-weight pixels deposit nothing
    gx, gy = _pixmap(60, 50, sc=g["sc"])
    kw = dict(pixfrac=g["pixfrac"], pscale_ratio=g["pscale_ratio"],
              kernel=kernel)
    s, w = drizzle_deposit(data, wht, gx, gy, g["out"], **kw)
    sr, wr = drizzle_deposit_reference(data, wht, gx, gy, g["out"], **kw)
    # f32 weights at |x| < 120 px: ~1e-5 relative at worst (7e-6 seen)
    for got, ref in ((s, sr), (w, wr)):
        err = np.abs(np.asarray(got, np.float64) - ref).max()
        assert err <= 3e-5 * np.abs(ref).max(), (kernel, geom, err)


def test_drizzle_deposit_conserves_flux():
    """Square kernel, pixfrac 1, every droplet inside the grid: the
    deposits redistribute each pixel's weight and flux without loss."""
    rng = np.random.default_rng(3)
    data = rng.random((40, 30)).astype(np.float32)
    wht = rng.uniform(0.5, 2.0, (40, 30)).astype(np.float32)
    gx, gy = _pixmap(40, 30, ang=1.0, tx=5.4, ty=4.6)
    s, w = drizzle_deposit(data, wht, gx, gy, (52, 44))
    np.testing.assert_allclose(float(np.asarray(w, np.float64).sum()),
                               float(wht.astype(np.float64).sum()),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(np.asarray(s, np.float64).sum()),
        float((wht.astype(np.float64) * data).sum()), rtol=1e-5)


def test_drizzle_deposit_off_grid():
    """Droplets landing off the output grid are dropped, exactly as the
    reference drops them."""
    rng = np.random.default_rng(4)
    data = rng.random((30, 30)).astype(np.float32)
    gx, gy = _pixmap(30, 30, tx=-12.3, ty=-8.6)  # half off the grid
    s, w = drizzle_deposit(data, None, gx, gy, (24, 24))
    sr, wr = drizzle_deposit_reference(data, None, gx, gy, (24, 24))
    assert 0 < float(np.asarray(w).sum()) < 30 * 30 - 1
    np.testing.assert_allclose(np.asarray(w, np.float64), wr, atol=2e-5)
    np.testing.assert_allclose(np.asarray(s, np.float64), sr, atol=2e-5)


def test_drizzle_deposit_finer_grid():
    """Drizzling onto a 2x finer grid: each input pixel covers 2x2
    output cells, whose weights sum to the pixel's weight."""
    rng = np.random.default_rng(5)
    data = rng.random((20, 20)).astype(np.float32)
    yy, xx = np.mgrid[0:20, 0:20].astype(np.float32)
    gx, gy = 2 * xx + 4.5, 2 * yy + 4.5  # droplet edges on cell edges
    s, w = drizzle_deposit(data, None, gx, gy, (50, 50), pscale_ratio=2.0)
    sr, wr = drizzle_deposit_reference(data, None, gx, gy, (50, 50),
                                       pscale_ratio=2.0)
    w = np.asarray(w)
    np.testing.assert_allclose(w[4:44, 4:44], 0.25, atol=1e-6)
    np.testing.assert_allclose(float(w.sum()), 400.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(s, np.float64), sr, atol=1e-6)
    np.testing.assert_allclose(np.asarray(s)[4:6, 4:6], data[0, 0] / 4,
                               rtol=1e-6)
