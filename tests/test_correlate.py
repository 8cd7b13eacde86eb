"""Tests for subpixal_tpu.ops.correlate.

Covers SURVEY §4 items 1–2 and BASELINE configs 1–3:
- single 64x64 Gaussian-star pair with known 0.3-pix shift (config 1);
- NCC gain/offset invariance;
- batched random subpixel shifts with an RMSE bound (property test);
- 5-100x Fourier upsampling <0.01-pix precision (config 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from subpixal_tpu.ops.correlate import cross_correlate, find_displacement


def gauss_star(h, w, x0, y0, sigma=2.0, amp=1.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    return amp * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * sigma**2))


def shifted_pair(h=64, w=64, dx=0.3, dy=0.0, sigma=2.0, noise=0.0, seed=0):
    """ref with a star at center; img with the star shifted by (dx, dy)."""
    rng = np.random.default_rng(seed)
    ref = gauss_star(h, w, w / 2, h / 2, sigma)
    img = gauss_star(h, w, w / 2 + dx, h / 2 + dy, sigma)
    if noise:
        ref = ref + rng.normal(0, noise, ref.shape)
        img = img + rng.normal(0, noise, img.shape)
    return jnp.asarray(ref, jnp.float32), jnp.asarray(img, jnp.float32)


def test_config1_single_pair_64x64_knownshift():
    """BASELINE config 1: 64x64 Gaussian star, 0.3-pix shift, ≤ a few mpix."""
    ref, img = shifted_pair(dx=0.3, dy=0.0)
    d = find_displacement(ref, img, cc_type="NCC", fit_type="gaussian")
    assert abs(float(d.dx) - 0.3) < 1e-3
    assert abs(float(d.dy) - 0.0) < 1e-3
    assert bool(d.fit_ok)


def test_integer_shift_exact():
    ref, img = shifted_pair(dx=5.0, dy=-3.0)
    # a 5-px shift is outside the default 'fitbox' search window
    d = find_displacement(ref, img, cc_type="CC", peak_search_box=None)
    assert abs(float(d.dx) - 5.0) < 1e-2
    assert abs(float(d.dy) + 3.0) < 1e-2


def test_ncc_gain_offset_invariance():
    ref, img = shifted_pair(dx=0.25, dy=-0.4)
    d0 = find_displacement(ref, img, cc_type="NCC")
    d1 = find_displacement(ref, 7.5 * img + 3.0, cc_type="NCC")
    assert abs(float(d0.dx) - float(d1.dx)) < 1e-5
    assert abs(float(d0.dy) - float(d1.dy)) < 1e-5
    # peak of NCC of a matching pair is ~ the correlation coefficient
    assert 0.8 < float(d1.peak) <= 1.05


def test_batched_random_subpixel_shifts_rmse():
    """Property test: random shifts in (-0.5, 0.5), modest noise, mpix RMSE."""
    rng = np.random.default_rng(42)
    B = 64
    dxs = rng.uniform(-0.5, 0.5, B)
    dys = rng.uniform(-0.5, 0.5, B)
    refs, imgs = [], []
    for i in range(B):
        r, m = shifted_pair(dx=dxs[i], dy=dys[i], noise=1e-3, seed=i)
        refs.append(r)
        imgs.append(m)
    refs = jnp.stack(refs)
    imgs = jnp.stack(imgs)
    d = find_displacement(refs, imgs, cc_type="NCC", fit_type="gaussian")
    ex = np.asarray(d.dx) - dxs
    ey = np.asarray(d.dy) - dys
    rmse = np.sqrt(np.mean(ex**2 + ey**2))
    assert rmse < 2e-3, f"shift RMSE {rmse*1e3:.2f} mpix"


@pytest.mark.parametrize("usfac", [5, 10, 50, 100])
def test_config3_upsampled_precision(usfac):
    """BASELINE config 3: Fourier-domain upsampled correlation <0.01 pix."""
    rng = np.random.default_rng(7)
    B = 16
    dxs = rng.uniform(-0.5, 0.5, B)
    dys = rng.uniform(-0.5, 0.5, B)
    refs, imgs = [], []
    for i in range(B):
        r, m = shifted_pair(dx=dxs[i], dy=dys[i], sigma=1.5, seed=100 + i)
        refs.append(r)
        imgs.append(m)
    d = find_displacement(
        jnp.stack(refs), jnp.stack(imgs), cc_type="NCC",
        usfac=usfac, fit_type="gaussian",
    )
    ex = np.asarray(d.dx) - dxs
    ey = np.asarray(d.dy) - dys
    err = np.sqrt(ex**2 + ey**2)
    assert err.max() < 0.01, f"max upsampled err {err.max():.4f} pix"


def test_upsampled_large_coarse_shift():
    """Upsampling must compose correctly with a large integer part."""
    ref, img = shifted_pair(dx=11.3, dy=-7.25, sigma=2.5)
    d = find_displacement(ref, img, cc_type="NCC", usfac=10,
                          fit_type="gaussian", peak_search_box=None)
    assert abs(float(d.dx) - 11.3) < 0.01
    assert abs(float(d.dy) + 7.25) < 0.01


def test_cross_correlate_surface_peak_position():
    ref, img = shifted_pair(dx=4.0, dy=2.0)
    cc = cross_correlate(ref, img, cc_type="CC")
    py, px = np.unravel_index(int(jnp.argmax(cc)), cc.shape)
    assert px - 32 == 4
    assert py - 32 == 2


def test_mask_aware_ncc():
    """A corrupted corner outside the mask must not bias the measurement."""
    ref, img = shifted_pair(dx=0.3, dy=0.2)
    img_bad = np.asarray(img).copy()
    img_bad[:8, :8] = 100.0
    mask = np.ones(img_bad.shape, bool)
    mask[:8, :8] = False
    d = find_displacement(
        ref, jnp.asarray(img_bad), cc_type="NCC",
        img_mask=jnp.asarray(mask), fit_type="gaussian",
    )
    assert abs(float(d.dx) - 0.3) < 5e-3
    assert abs(float(d.dy) - 0.2) < 5e-3


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        find_displacement(jnp.zeros((32, 32)), jnp.zeros((64, 64)))


def _alias_pair(h=64, w=64, dx=0.3, dy=-0.2, noise=0.03, seed=3):
    """Low-SNR pair where a FAR alias peak beats the true near-zero peak
    globally: the faint common source is at the center, but each frame
    carries a different bright contaminant whose cross-term correlates
    strongest at a large lag."""
    rng = np.random.default_rng(seed)
    ref = gauss_star(h, w, 32, 32, amp=1.0)
    ref = ref + gauss_star(h, w, 10, 12, amp=6.0)          # contaminant A
    img = gauss_star(h, w, 32 + dx, 32 + dy, amp=1.0)
    img = img + gauss_star(h, w, 52, 47, amp=6.0)          # contaminant B
    ref = ref + rng.normal(0, noise, (h, w))
    img = img + rng.normal(0, noise, (h, w))
    return jnp.asarray(ref, jnp.float32), jnp.asarray(img, jnp.float32)


@pytest.mark.parametrize("usfac", [1, 8])
def test_peak_search_box_rejects_far_alias(usfac):
    """VERDICT r1 item 3: a far alias peak wins the global argmax, but the
    'fitbox'-confined search recovers the planted near-zero shift
    (reference find_peak(peak_search_box='fitbox') semantics)."""
    dx, dy = 0.3, -0.2
    ref, img = _alias_pair(dx=dx, dy=dy)
    # global search: the bright-contaminant cross-term wins at large lag
    d_glob = find_displacement(ref, img, cc_type="NCC", usfac=usfac,
                               peak_search_box=None)
    assert np.hypot(float(d_glob.dx) - dx, float(d_glob.dy) - dy) > 5.0
    # confined search: the true near-zero peak is the only candidate
    d_box = find_displacement(ref, img, cc_type="NCC", usfac=usfac,
                              peak_search_box="fitbox")
    assert abs(float(d_box.dx) - dx) < 0.1
    assert abs(float(d_box.dy) - dy) < 0.1
    # 'fitbox' is the DEFAULT (reference parity, round-3): omitting the
    # kwarg must behave like the confined search
    d_def = find_displacement(ref, img, cc_type="NCC", usfac=usfac)
    assert abs(float(d_def.dx) - float(d_box.dx)) < 1e-6
    assert abs(float(d_def.dy) - float(d_box.dy)) < 1e-6


def test_peak_search_box_int_and_tuple_forms():
    ref, img = shifted_pair(dx=1.3, dy=-0.75)
    for psb in (9, (32 - 4, 32 + 5, 32 - 4, 32 + 5), "all", None):
        d = find_displacement(ref, img, peak_search_box=psb, usfac=4)
        assert abs(float(d.dx) - 1.3) < 0.02, psb
        assert abs(float(d.dy) + 0.75) < 0.02, psb


def test_normalize_search_box_forms():
    from subpixal_tpu.ops.peaks import normalize_search_box

    assert normalize_search_box(None, 64, 64, 5) is None
    assert normalize_search_box("all", 64, 64, 5) is None
    assert normalize_search_box("fitbox", 64, 64, 5) == (30, 35, 30, 35)
    assert normalize_search_box(9, 64, 64, 5) == (28, 37, 28, 37)
    assert normalize_search_box((1, 2, 3, 4), 64, 64, 5) == (1, 2, 3, 4)
    # oversized boxes clamp to the surface
    assert normalize_search_box(200, 16, 16, 5) == (0, 16, 0, 16)


class TestMatmulDFT:
    """The opt-in matmul-DFT transforms must agree with jnp.fft (the
    default path) to float32 round-off."""

    def test_rfft2_matmul_matches_fft(self):
        from subpixal_tpu.ops.correlate import _rfft2_matmul

        rng = np.random.default_rng(0)
        for H, W in ((64, 64), (32, 48), (24, 24), (16, 128)):
            x = jnp.asarray(rng.normal(size=(7, H, W)).astype(np.float32))
            Yr, Yi = _rfft2_matmul(x)
            F = np.fft.rfft2(np.asarray(x, np.float64))
            scale = max(1.0, np.abs(F).max())
            assert np.abs(np.asarray(Yr) - F.real).max() / scale < 2e-6
            assert np.abs(np.asarray(Yi) - F.imag).max() / scale < 2e-6

    def test_irfft2_matmul_matches_fft(self):
        from subpixal_tpu.ops.correlate import _irfft2_matmul

        rng = np.random.default_rng(1)
        for H, W in ((64, 64), (32, 48), (17, 24)):
            x = rng.normal(size=(5, H, W))
            G = np.fft.rfft2(x)
            got = np.asarray(_irfft2_matmul(
                jnp.asarray(G.real, jnp.float32),
                jnp.asarray(G.imag, jnp.float32), (H, W)))
            scale = max(1.0, np.abs(x).max())
            assert np.abs(got - x).max() / scale < 5e-6

    def test_cross_spectrum_path_equivalence(self):
        """Force the matmul path on CPU and compare the full displacement
        against the FFT path."""
        import subpixal_tpu.ops.correlate as C

        rng = np.random.default_rng(2)
        B, h, w = 16, 48, 48
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        dx = rng.uniform(-0.5, 0.5, B)[:, None, None]
        dy = rng.uniform(-0.5, 0.5, B)[:, None, None]
        ref = np.broadcast_to(np.exp(-((xx - w/2)**2 + (yy - h/2)**2) / 8.0),
                              (B, h, w)).astype(np.float32)
        img = np.exp(-((xx - w/2 - dx)**2 + (yy - h/2 - dy)**2) / 8.0
                     ).astype(np.float32)
        d_fft = C.find_displacement(ref, img, cc_type="NCC", usfac=8,
                                    fit_type="gaussian")
        orig = C._use_matmul_dft
        C._use_matmul_dft = lambda H, W: True
        try:
            d_mm = C.find_displacement(ref, img, cc_type="NCC", usfac=8,
                                       fit_type="gaussian")
        finally:
            C._use_matmul_dft = orig
        assert np.abs(np.asarray(d_mm.dx) - np.asarray(d_fft.dx)).max() < 1e-4
        assert np.abs(np.asarray(d_mm.dy) - np.asarray(d_fft.dy)).max() < 1e-4


class TestSpectralNCC:
    """The mask-free NCC cross-spectrum is computed entirely in the
    Fourier domain (DC-bin zeroing + Parseval scale) — must match the
    explicit spatial normalize to f32 rounding."""

    def test_matches_spatial_normalize(self):
        import jax.numpy as jnp
        import subpixal_tpu.ops.correlate as C

        rng = np.random.default_rng(7)
        B, h, w = 8, 32, 32
        ref = rng.normal(50.0, 9.0, (B, h, w)).astype(np.float32)
        img = rng.normal(-3.0, 2.5, (B, h, w)).astype(np.float32)
        for cc_type in ("NCC", "ZNCC"):
            G_fast = np.asarray(C._cross_spectrum(
                jnp.asarray(ref), jnp.asarray(img), cc_type, None, None))
            r = C._normalize(jnp.asarray(ref), None, cc_type)
            i = C._normalize(jnp.asarray(img), None, cc_type)
            G_ref = np.asarray(jnp.fft.rfft2(i) * np.conj(jnp.fft.rfft2(r)))
            scale = max(1.0, np.abs(G_ref).max())
            # 5e-5: DFT-ing the RAW data leaves mean-cancellation f32
            # rounding (~eps * mean * n per bin) the spatial path avoids
            # by subtracting the mean first; ~1e-5 relative at mean/sigma
            # ~ 6 — far below the <0.01-pix displacement target
            assert np.abs(G_fast - G_ref).max() / scale < 5e-5

    def test_gain_offset_invariance_and_peak(self):
        import subpixal_tpu.ops.correlate as C

        rng = np.random.default_rng(3)
        h = w = 48
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        base = np.exp(-((xx - 24.0)**2 + (yy - 23.6)**2) / 6.0)
        ref = base.astype(np.float32)
        img = (250.0 * np.exp(-((xx - 24.4)**2 + (yy - 23.6)**2) / 6.0)
               + 77.0).astype(np.float32)
        d = C.find_displacement(ref, img, cc_type="NCC", usfac=10,
                                fit_type="gaussian")
        assert abs(float(d.dx) - 0.4) < 0.02
        assert abs(float(d.dy)) < 0.02


class TestPackedPath:
    """The batch-minor lane-packed pipeline (``ops.correlate_packed``) must
    match the batch-major path bit-for-intent on its whole dispatch
    envelope: unmasked NCC/ZNCC, windowed coarse search, both fit types,
    squeeze semantics, and fallback positions where the fit fails."""

    @staticmethod
    def _scene(B=24, h=64, w=48, seed=11, noise=1e-3):
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        dx = rng.uniform(-1.5, 1.5, B)
        dy = rng.uniform(-1.5, 1.5, B)
        ref = np.exp(-((xx[None] - w / 2) ** 2 + (yy[None] - h / 2) ** 2)
                     / 8.0) + rng.normal(0, noise, (B, h, w))
        img = np.exp(-((xx[None] - w / 2 - dx[:, None, None]) ** 2
                       + (yy[None] - h / 2 - dy[:, None, None]) ** 2)
                     / 8.0) + rng.normal(0, noise, (B, h, w))
        return (jnp.asarray(ref, jnp.float32), jnp.asarray(img, jnp.float32),
                dx, dy)

    @pytest.mark.parametrize("cc_type", ["NCC", "ZNCC"])
    @pytest.mark.parametrize("fit_type", ["gaussian", "quadratic"])
    def test_parity_vs_batch_major(self, monkeypatch, cc_type, fit_type):
        ref, img, dx, dy = self._scene()
        monkeypatch.setenv("SUBPIXAL_TPU_PACKED", "0")
        d0 = find_displacement(ref, img, cc_type=cc_type, usfac=10,
                               fit_type=fit_type)
        monkeypatch.setenv("SUBPIXAL_TPU_PACKED", "force")
        d1 = find_displacement(ref, img, cc_type=cc_type, usfac=10,
                               fit_type=fit_type)
        assert np.abs(np.asarray(d0.dx) - np.asarray(d1.dx)).max() < 1e-4
        assert np.abs(np.asarray(d0.dy) - np.asarray(d1.dy)).max() < 1e-4
        pk0, pk1 = np.asarray(d0.peak), np.asarray(d1.peak)
        assert np.abs(pk0 - pk1).max() / max(1e-9, np.abs(pk0).max()) < 1e-4
        assert np.array_equal(np.asarray(d0.fit_ok), np.asarray(d1.fit_ok))
        # and both recover the planted shifts
        ex = np.asarray(d1.dx) - dx
        ey = np.asarray(d1.dy) - dy
        assert np.sqrt(np.mean(ex**2 + ey**2)) < 5e-3

    def test_packed_squeeze_single_pair(self, monkeypatch):
        monkeypatch.setenv("SUBPIXAL_TPU_PACKED", "force")
        ref, img = shifted_pair(dx=0.3, dy=-0.2)
        d = find_displacement(ref, img, cc_type="NCC", usfac=10,
                              fit_type="gaussian")
        assert np.ndim(np.asarray(d.dx)) == 0
        assert abs(float(d.dx) - 0.3) < 1e-3
        assert abs(float(d.dy) + 0.2) < 1e-3
        assert bool(d.fit_ok)

    def test_packed_masked_accuracy(self, monkeypatch):
        """Masked calls take the packed path (spatial pre-normalize) and
        still recover the planted shift."""
        monkeypatch.setenv("SUBPIXAL_TPU_PACKED", "force")
        ref, img = shifted_pair(dx=0.25, dy=0.1)
        msk = jnp.ones(ref.shape, bool)
        d = find_displacement(ref, img, cc_type="NCC", usfac=10,
                              ref_mask=msk, img_mask=msk)
        assert abs(float(d.dx) - 0.25) < 2e-3

    @pytest.mark.parametrize("cc_type", ["NCC", "CC"])
    def test_masked_and_cc_parity(self, monkeypatch, cc_type):
        """Masked (and plain-CC) calls now take the packed path via a
        spatial pre-normalize — must match batch-major bit-for-intent."""
        ref, img, _, _ = self._scene(B=12)
        rng = np.random.default_rng(5)
        msk = jnp.asarray(rng.random(ref.shape) > 0.07)
        kw = dict(cc_type=cc_type, usfac=10, fit_type="gaussian",
                  ref_mask=msk, img_mask=msk)
        monkeypatch.setenv("SUBPIXAL_TPU_PACKED", "0")
        d0 = find_displacement(ref, img, **kw)
        monkeypatch.setenv("SUBPIXAL_TPU_PACKED", "force")
        d1 = find_displacement(ref, img, **kw)
        assert np.abs(np.asarray(d0.dx) - np.asarray(d1.dx)).max() < 1e-4
        assert np.abs(np.asarray(d0.dy) - np.asarray(d1.dy)).max() < 1e-4
        pk0, pk1 = np.asarray(d0.peak), np.asarray(d1.peak)
        assert np.abs(pk0 - pk1).max() / max(1e-9, np.abs(pk0).max()) < 1e-4
        assert np.array_equal(np.asarray(d0.fit_ok), np.asarray(d1.fit_ok))
