"""Multi-device tests on the 8-device virtual CPU mesh (SURVEY §4 item 4).

Asserts the sharded paths are numerically identical (up to reduction
order) to the single-device paths — config 5's joint-fit collective path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from subpixal_tpu.ops.correlate import find_displacement
from subpixal_tpu.ops.fit import iter_linear_fit
from subpixal_tpu.parallel import (
    make_mesh,
    pad_to_multiple,
    sharded_find_displacement,
    sharded_measure_and_fit,
)


def gauss_pairs(B=24, h=48, w=48, seed=0):
    rng = np.random.default_rng(seed)
    dxs = rng.uniform(-0.5, 0.5, B)
    dys = rng.uniform(-0.5, 0.5, B)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    refs, imgs = [], []
    for i in range(B):
        refs.append(np.exp(-((xx - w/2)**2 + (yy - h/2)**2) / (2*4.0)))
        imgs.append(np.exp(-((xx - w/2 - dxs[i])**2
                             + (yy - h/2 - dys[i])**2) / (2*4.0)))
    return (jnp.asarray(np.stack(refs), jnp.float32),
            jnp.asarray(np.stack(imgs), jnp.float32), dxs, dys)


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8, (
        "conftest must force 8 virtual CPU devices")


def test_pad_to_multiple():
    a = jnp.ones((10, 3))
    p, pad = pad_to_multiple(a, 8)
    assert p.shape == (16, 3) and pad == 6
    p2, pad2 = pad_to_multiple(jnp.ones((16, 3)), 8)
    assert pad2 == 0 and p2.shape == (16, 3)


def test_sharded_displacement_matches_single_device():
    refs, imgs, dxs, dys = gauss_pairs(B=21)  # not divisible by 8
    d1 = find_displacement(refs, imgs, cc_type="NCC", fit_type="gaussian")
    mesh = make_mesh()
    d8 = sharded_find_displacement(refs, imgs, mesh=mesh, cc_type="NCC",
                                   fit_type="gaussian")
    np.testing.assert_allclose(np.asarray(d8.dx), np.asarray(d1.dx),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(d8.dy), np.asarray(d1.dy),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(d8.dx), dxs, atol=2e-3)


def test_sharded_fit_matches_single_device():
    """psum-reduced sigma-clipped fit == local fit on the gathered data."""
    rng = np.random.default_rng(3)
    B = 40
    refs, imgs, dxs, dys = gauss_pairs(B=B, seed=3)
    xy = rng.uniform(100, 900, (B, 2)).astype(np.float32)
    w = np.ones(B, np.float32)
    mask = np.ones(refs.shape, np.float32)

    mesh = make_mesh()
    d, fit = sharded_measure_and_fit(
        refs, imgs, mask, xy, w, mesh=mesh,
        fit_type="gaussian", fitgeom="shift", nclip=3,
    )
    # single-device oracle with identical inputs
    d1 = find_displacement(refs, imgs, cc_type="NCC", fit_type="gaussian",
                           ref_mask=mask, img_mask=mask)
    uv = xy + np.stack([np.asarray(d1.dx), np.asarray(d1.dy)], 1)
    f1 = iter_linear_fit(jnp.asarray(uv), jnp.asarray(xy),
                         jnp.asarray(w * np.asarray(d1.fit_ok)),
                         fitgeom="shift", nclip=3)
    # up to f32 reduction order (psum vs local sum): ~1e-4 px
    np.testing.assert_allclose(np.asarray(fit.shift), np.asarray(f1.shift),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(fit.rmse), np.asarray(f1.rmse),
                               atol=2e-4)
    assert int(fit.nmatches) == int(f1.nmatches)
    # the planted common shift is ~mean of (dxs, dys), fit recovers -it
    np.testing.assert_allclose(-np.asarray(fit.shift)[0], dxs.mean(),
                               atol=5e-3)


def test_sharded_fit_clips_outliers_globally():
    rng = np.random.default_rng(5)
    B = 64
    refs, imgs, dxs, dys = gauss_pairs(B=B, seed=5)
    # corrupt 6 measurements by replacing their image with a far shift
    imgs = np.array(imgs)  # writable copy
    bad = rng.choice(B, 6, replace=False)
    for b in bad:
        imgs[b] = np.roll(imgs[b], 5, axis=1)
    xy = rng.uniform(100, 900, (B, 2)).astype(np.float32)
    mesh = make_mesh()
    d, fit = sharded_measure_and_fit(
        jnp.asarray(refs), jnp.asarray(imgs), np.ones(refs.shape, np.float32),
        xy, np.ones(B, np.float32), mesh=mesh,
        fit_type="gaussian", fitgeom="shift", nclip=5, sigma=3.0,
    )
    w = np.asarray(fit.weights)
    assert np.all(w[bad] == 0.0), "corrupted points survived global clip"
    assert int(fit.nmatches) >= B - 10

def test_sharded_displacement_packed_path(monkeypatch):
    """The opt-in PACKED displacement pipeline runs INSIDE
    shard_map (mesh-mode align measurement) — force it on CPU and pin
    parity with the batch-major sharded path (layout-only difference:
    f32 summation order)."""
    monkeypatch.setenv("SUBPIXAL_TPU_PACKED", "force")
    refs, imgs, dxs, dys = gauss_pairs(B=21, seed=7)  # padded per shard
    mesh = make_mesh()
    dp = sharded_find_displacement(refs, imgs, mesh=mesh, cc_type="NCC",
                                   fit_type="gaussian")
    monkeypatch.setenv("SUBPIXAL_TPU_PACKED", "0")
    db = sharded_find_displacement(refs, imgs, mesh=mesh, cc_type="NCC",
                                   fit_type="gaussian")
    np.testing.assert_allclose(np.asarray(dp.dx), np.asarray(db.dx),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(dp.dy), np.asarray(db.dy),
                               atol=2e-5)
    np.testing.assert_array_equal(np.asarray(dp.fit_ok),
                                  np.asarray(db.fit_ok))
    np.testing.assert_allclose(np.asarray(dp.dx), dxs, atol=2e-3)
