"""Integration tests for align_images (BASELINE configs 4 & 5 on CPU).

Simulate dithered exposures of one star field, plant WCS errors (shifts /
small affines), run the full iterative align loop, and assert the planted
errors are recovered to ~mpix level.
"""

import numpy as np
import pytest

from subpixal_tpu.align import AlignConfig, align_images
from subpixal_tpu.resample import Drizzle, Exposure
from subpixal_tpu.wcs.wcs import TanWCS


SCALE_AS = 0.05  # arcsec/pix


def make_wcs(crpix, scale=SCALE_AS, rot=0.0, crval=(150.0, 2.0)):
    s = scale / 3600.0
    th = np.deg2rad(rot)
    cd = s * np.array([[-np.cos(th), np.sin(th)], [np.sin(th), np.cos(th)]])
    return TanWCS(crpix=np.asarray(crpix, float), crval=np.asarray(crval, float),
                  cd=cd)


def render(wcs, sky_xy_ref, ref_wcs, shape, amp=200.0, sig=1.8, noise=0.5,
           seed=0):
    """Render stars (given as positions in a reference WCS frame) into an
    exposure with WCS ``wcs``."""
    rng = np.random.default_rng(seed)
    H, W = shape
    img = rng.normal(0, noise, shape).astype(np.float64)
    ra, dec = ref_wcs.pixel_to_world(sky_xy_ref[:, 0], sky_xy_ref[:, 1])
    xs, ys = wcs.world_to_pixel(ra, dec)
    yy, xx = np.mgrid[0:H, 0:W]
    for x0, y0 in zip(xs, ys):
        if -10 < x0 < W + 10 and -10 < y0 < H + 10:
            img += amp * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                                / (2 * sig**2))
    return img.astype(np.float32)


def star_positions(n=30, lo=30, hi=220, seed=1, min_sep=18.0):
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n:
        p = rng.uniform(lo, hi, 2)
        if all(np.hypot(*(p - q)) > min_sep for q in pts):
            pts.append(p)
    return np.asarray(pts)


def planted_scene(n_exp=3, shape=(256, 256), shift_err=None, seed=1):
    """Build exposures whose TRUE WCS differs from the catalogued one by a
    planted per-exposure shift (in exposure pixels)."""
    ref_frame = make_wcs((128, 128))
    stars = star_positions(seed=seed)
    rng = np.random.default_rng(seed + 10)
    exps, true_shifts = [], []
    for e in range(n_exp):
        # dither pattern ~ +-6 px
        dith = rng.uniform(-6, 6, 2)
        true_wcs = make_wcs((128 + dith[0], 128 + dith[1]))
        if shift_err is None:
            err = rng.uniform(-1.5, 1.5, 2) if e > 0 else np.zeros(2)
        else:
            err = np.asarray(shift_err[e], float)
        # data rendered with the TRUE wcs; header carries a WRONG wcs
        data = render(true_wcs, stars, ref_frame, shape, seed=100 + e)
        wrong_wcs = make_wcs((128 + dith[0] + err[0], 128 + dith[1] + err[1]))
        exps.append(Exposure(data, wrong_wcs, name=f"e{e}"))
        true_shifts.append(err)
    return exps, np.asarray(true_shifts), ref_frame, stars


def test_config4_shift_alignment_converges():
    """BASELINE config 4: planted per-exposure WCS shift errors must be
    recovered by the iterative loop (relative alignment, mpix-level)."""
    err = np.array([(0.0, 0.0), (1.2, -0.7), (-0.9, 0.5)])
    exps, true_shift, ref_frame, stars = planted_scene(
        n_exp=3, shift_err=err)
    res = align_images(
        resample=Drizzle(exps, pixfrac=1.0),
        fitgeom="shift", max_iterations=8, eps_shift=0.004,
        usfac=1, fit_type="gaussian", min_sources=5,
    )
    assert res.converged, "align loop did not converge"
    # the fitted correction t equals +err in the ref frame here (J ~ I);
    # alignment is relative, so compare shifts relative to exposure 0
    rel = res.shifts - res.shifts[0]
    rel_true = err - err[0]
    resid = np.abs(rel - rel_true).max()
    assert resid < 0.01, f"relative shift error {resid*1e3:.2f} mpix"


def test_config4_affine_alignment():
    """Plant a small rotation error; 'rscale' fit must recover it."""
    exps, _, ref_frame, stars = planted_scene(
        n_exp=2, shift_err=[(0, 0), (0.8, -0.6)])
    # additionally rotate exposure 1's header WCS by 0.05 deg
    w = exps[1].wcs
    th = np.deg2rad(0.05)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    exps[1] = Exposure(exps[1].data, w.replace(cd=R @ w.cd), name=exps[1].name)
    res = align_images(
        resample=Drizzle(exps, pixfrac=1.0),
        fitgeom="rscale", max_iterations=10, eps_shift=0.004,
        fit_type="gaussian", min_sources=5,
    )
    assert res.converged
    # relative rotation between the two corrections must be ~0.05 deg
    Mrel = res.matrices[1] @ np.linalg.inv(res.matrices[0])
    ang = np.rad2deg(np.arctan2(Mrel[1, 0], Mrel[0, 0]))
    assert abs(abs(ang) - 0.05) < 0.005, f"rotation not recovered: {ang}"
    # relative scale ~1
    s = np.sqrt(abs(np.linalg.det(Mrel)))
    assert abs(s - 1.0) < 2e-4


def test_history_and_records():
    exps, _, _, _ = planted_scene(n_exp=2, shift_err=[(0, 0), (0.5, 0.5)])
    res = align_images(
        resample=Drizzle(exps), fitgeom="shift", max_iterations=3,
        eps_shift=1e-6, history="all", fit_type="gaussian", min_sources=5,
    )
    assert len(res.history) == res.n_iterations
    rec = res.history[0][1]
    assert rec.name == "e1"
    assert rec.nmatches > 5
    js = rec.to_json()
    assert "rmse" in js
    res2 = align_images(
        resample=Drizzle(exps), fitgeom="shift", max_iterations=3,
        eps_shift=1e-6, history="last", fit_type="gaussian", min_sources=5,
    )
    assert len(res2.history) == 1


def test_too_few_sources_raises():
    rng = np.random.default_rng(0)
    data = rng.normal(0, 1, (64, 64)).astype(np.float32)  # no sources
    exps = [Exposure(data, make_wcs((32, 32)), name="e0")]
    with pytest.raises(ValueError):
        align_images(resample=Drizzle(exps), min_sources=3)


def test_wcsupdate_otf_matches_batch():
    """'otf' (update-as-you-go) mode recovers the same planted shifts as
    'batch' (reference wcsupdate semantics, SURVEY §3.1)."""
    err = np.array([(0.0, 0.0), (1.1, -0.6), (-0.8, 0.4)])
    exps, _, _, _ = planted_scene(n_exp=3, shift_err=err)
    res = align_images(
        resample=Drizzle(exps, pixfrac=1.0),
        fitgeom="shift", wcsupdate="otf", max_iterations=8,
        eps_shift=0.004, usfac=1, fit_type="gaussian", min_sources=5,
    )
    assert res.converged
    rel = res.shifts - res.shifts[0]
    rel_true = err - err[0]
    resid = np.abs(rel - rel_true).max()
    assert resid < 0.01, f"otf relative shift error {resid*1e3:.2f} mpix"


def test_result_observability_fields():
    """AlignResult exposes setup timings and per-iteration wall times."""
    exps, _, _, _ = planted_scene(n_exp=2, shift_err=[(0, 0), (0.5, -0.4)])
    res = align_images(
        resample=Drizzle(exps), fitgeom="shift", max_iterations=2,
        eps_shift=0.0, usfac=1, min_sources=5,
    )
    assert res.setup_s > 0
    assert set(res.setup_breakdown) >= {
        "resample_execute", "catalog", "primary_cutouts",
        "frame_pixmaps", "cutout_pixmaps", "device_stage",
            "stage_args"}
    assert all(recs[0].iter_s > 0 for recs in res.history)


def test_device_loop_matches_host_loop():
    """The on-device while_loop fixed point gives the same corrections
    and history as the host loop."""
    err = np.array([(0.0, 0.0), (0.9, -0.5)])
    exps, _, _, _ = planted_scene(n_exp=2, shift_err=err)

    def run(device_loop):
        es = [Exposure(e.data.copy(), e.wcs.copy(), name=e.name)
              for e in exps]
        return align_images(
            resample=Drizzle(es), fitgeom="shift", max_iterations=6,
            eps_shift=0.004, usfac=1, fit_type="gaussian", min_sources=5,
            device_loop=device_loop,
        )

    r_dev = run(True)
    r_host = run(False)
    assert r_dev.converged == r_host.converged
    assert r_dev.n_iterations == r_host.n_iterations
    np.testing.assert_allclose(r_dev.shifts, r_host.shifts, atol=1e-5)
    np.testing.assert_allclose(r_dev.matrices, r_host.matrices, atol=1e-7)
    assert len(r_dev.history) == len(r_host.history)
    for recs_d, recs_h in zip(r_dev.history, r_host.history):
        for d, h in zip(recs_d, recs_h):
            assert d.nmatches == h.nmatches
            np.testing.assert_allclose(d.shift, h.shift, atol=1e-5)


def test_align_precombine_stages():
    """match_sky / static_mask / reject_cr stages run from the main API
    and leave the caller's Exposure objects untouched."""
    exps, _, _, _ = planted_scene(n_exp=3, shift_err=[(0, 0), (0.8, -0.5),
                                                      (-0.4, 0.6)])
    for e, off in zip(exps, (0.5, -0.2, 0.9)):
        e.data = e.data + np.float32(off)  # sky offsets
    before = [e.data.copy() for e in exps]
    res = align_images(
        resample=Drizzle(exps), fitgeom="shift", max_iterations=6,
        eps_shift=0.004, usfac=1, fit_type="gaussian", min_sources=5,
        match_sky=True, static_mask=True, reject_cr=True,
    )
    assert res.converged
    for e, b in zip(exps, before):
        np.testing.assert_array_equal(e.data, b)  # inputs untouched


def test_align_with_sip_distortion():
    """Exposures with SIP distortion (the HST FLT case): planted WCS
    shift errors are recovered through the distorted pixmaps/Jacobians."""
    ps = SCALE_AS / 3600.0
    a = np.zeros((3, 3)); a[2, 0] = 4e-7; a[0, 2] = -3e-7; a[1, 1] = 2e-7
    b = np.zeros((3, 3)); b[2, 0] = -2e-7; b[0, 2] = 3e-7

    def sip_wcs(crpix):
        return TanWCS(crpix=np.asarray(crpix, float),
                      crval=np.array([150.0, 2.0]),
                      cd=np.array([[-ps, 0.0], [0.0, ps]]), a=a, b=b)

    ref_frame = make_wcs((128, 128))
    stars = star_positions(seed=4)
    rng = np.random.default_rng(5)
    err = np.array([(0.0, 0.0), (1.0, -0.6)])
    exps = []
    for e in range(2):
        dith = rng.uniform(-4, 4, 2)
        true_wcs = sip_wcs((128 + dith[0], 128 + dith[1]))
        data = render(true_wcs, stars, ref_frame, (256, 256), seed=50 + e)
        wrong = sip_wcs((128 + dith[0] + err[e][0],
                         128 + dith[1] + err[e][1]))
        exps.append(Exposure(data, wrong, name=f"s{e}"))
    res = align_images(
        resample=Drizzle(exps), fitgeom="shift", max_iterations=8,
        eps_shift=0.004, usfac=1, fit_type="gaussian", min_sources=5,
    )
    assert res.converged
    rel = res.shifts - res.shifts[0]
    rel_true = err - err[0]
    resid = np.abs(rel - rel_true).max()
    assert resid < 0.02, f"SIP relative shift error {resid*1e3:.1f} mpix"


def test_oversized_footprint_truncation_reported():
    """VERDICT r1 item 9: a source whose segmentation footprint exceeds
    even the BUCKET cap must be REPORTED (warning + record), and the
    alignment must still converge using the centered crop. Since round
    5 every path buckets (batch/mesh/spatial/otf), so the bucket cap
    floor is monkeypatched down to force the beyond-cap fallback."""
    import subpixal_tpu.align as A

    err = np.array([(0.0, 0.0), (0.9, -0.4)])
    exps, _, ref_frame, stars = planted_scene(n_exp=2, shift_err=err)
    # plant one very extended bright source in every exposure (same sky
    # position, so it is a legitimate alignment source too)
    for e, exp in enumerate(exps):
        ra, dec = ref_frame.pixel_to_world(60.0, 190.0)
        x0, y0 = exp.wcs.world_to_pixel(ra, dec)
        yy, xx = np.mgrid[0:exp.data.shape[0], 0:exp.data.shape[1]]
        exp.data = exp.data + (400.0 * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * 8.0 ** 2))
        ).astype(np.float32)
    cap0 = A._BIG_CAP_FLOOR
    A._BIG_CAP_FLOOR = 16   # cap = max(16, 2*16) = 32 < the ~51 px giant
    try:
        with pytest.warns(UserWarning, match="footprint"):
            res = align_images(
                resample=Drizzle(exps, pixfrac=1.0),
                fitgeom="shift", max_iterations=8, eps_shift=0.004,
                fit_type="gaussian", min_sources=5, max_cut_size=16,
                # uniform weights: flux weighting would let the
                # (blended) giant dominate the fit — a property of the
                # scene, not of the truncation under test
                use_weights=False,
            )
    finally:
        A._BIG_CAP_FLOOR = cap0
    assert res.truncated_sources, "oversized footprint not recorded"
    rel = res.shifts - res.shifts[0]
    rel_true = err - err[0]
    assert np.abs(rel - rel_true).max() < 0.02


def test_otf_oversized_footprint_bucket():
    """Round 5: the oversized-footprint bucket also runs under
    ``wcsupdate='otf'`` — the giant is measured whole per otf step, no
    warning, no truncation record, accuracy unchanged."""
    import warnings

    err = np.array([(0.0, 0.0), (0.9, -0.4)])
    exps, _, ref_frame, stars = planted_scene(n_exp=2, shift_err=err)
    for e, exp in enumerate(exps):
        ra, dec = ref_frame.pixel_to_world(60.0, 190.0)
        x0, y0 = exp.wcs.world_to_pixel(ra, dec)
        yy, xx = np.mgrid[0:exp.data.shape[0], 0:exp.data.shape[1]]
        exp.data = exp.data + (400.0 * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * 8.0 ** 2))
        ).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the footprint warn must NOT fire
        res = align_images(
            resample=Drizzle(exps, pixfrac=1.0),
            fitgeom="shift", max_iterations=8, eps_shift=0.004,
            fit_type="gaussian", min_sources=5, max_cut_size=48,
            wcsupdate="otf", use_weights=False,
        )
    assert res.truncated_sources == [], res.truncated_sources
    assert "big_bucket_stage" in res.setup_breakdown
    rel = res.shifts - res.shifts[0]
    rel_true = err - err[0]
    assert np.abs(rel - rel_true).max() < 0.02


def test_oversized_footprint_bucket_measures_whole():
    """VERDICT r3 task 4: on the (default) batch path the same
    oversized source is RE-measured whole in the second static-shape
    bucket — no truncation record, no warning, accuracy unchanged."""
    import warnings

    err = np.array([(0.0, 0.0), (0.9, -0.4)])
    exps, _, ref_frame, stars = planted_scene(n_exp=2, shift_err=err)
    for e, exp in enumerate(exps):
        ra, dec = ref_frame.pixel_to_world(60.0, 190.0)
        x0, y0 = exp.wcs.world_to_pixel(ra, dec)
        yy, xx = np.mgrid[0:exp.data.shape[0], 0:exp.data.shape[1]]
        exp.data = exp.data + (400.0 * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * 8.0 ** 2))
        ).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the footprint warn must NOT fire
        res = align_images(
            resample=Drizzle(exps, pixfrac=1.0),
            fitgeom="shift", max_iterations=8, eps_shift=0.004,
            fit_type="gaussian", min_sources=5, max_cut_size=48,
            use_weights=False,
        )
    assert res.truncated_sources == [], res.truncated_sources
    rel = res.shifts - res.shifts[0]
    rel_true = err - err[0]
    assert np.abs(rel - rel_true).max() < 0.02


def test_align_without_segmentation():
    """A catalog that carries no segmentation image must still measure
    (the device seg mask used to come out all-False, zeroing every
    correlation while the run reported success)."""
    from subpixal_tpu.catalogs import ImageSourceCatalog

    exps, true_shifts, ref_frame, stars = planted_scene(
        n_exp=2, shift_err=np.array([(0.0, 0.0), (1.1, -0.7)]))
    drz = Drizzle(list(exps))
    drz.execute()

    class BareCatalog:
        segmentation = None

        def __init__(self, tab):
            self.catalog = tab

    ref_cat = ImageSourceCatalog(np.asarray(drz.output_sci))
    bare = BareCatalog(ref_cat.catalog)
    res = align_images(bare, drz, fitgeom="shift", max_iterations=4,
                       usfac=4, fit_type="gaussian", min_sources=3)
    nm = [r.nmatches for r in res.history[-1]]
    assert all(n >= 3 for n in nm), nm
    # the planted relative error must be recovered despite no seg mask
    sh = np.asarray(res.shifts)
    assert np.isfinite(sh).all()
    rel = np.hypot(*(sh[1] - sh[0]))
    assert abs(rel - np.hypot(1.1, 0.7)) < 0.1, sh


def test_zero_weight_frame_keeps_identity():
    """A frame whose sources are all unmeasurable must keep its WCS
    (the degenerate moment solve used to return the ZERO matrix and the
    loop still reported convergence)."""
    exps, *_ = planted_scene(n_exp=3)
    exps = list(exps)
    # frame 1 carries no measurable signal at all: a constant plane
    # (every correlation surface is flat -> peak<=0 -> weight 0)
    bad = np.zeros(exps[1].data.shape, np.float32)
    exps[1] = Exposure(bad, exps[1].wcs, name=exps[1].name)
    res = align_images(exposures=exps, fitgeom="general",
                       max_iterations=2, usfac=4, fit_type="gaussian",
                       min_sources=3)
    M1 = np.asarray(res.matrices[1])
    assert np.allclose(M1, np.eye(2), atol=1e-3), M1
    assert np.linalg.det(M1) > 0.5  # never the zero matrix


def test_testing_simulate_stack_roundtrip():
    """The public synthetic-scene helper produces alignable stacks and
    pairwise_shift_errors scores the recovery."""
    from subpixal_tpu.testing import pairwise_shift_errors, simulate_stack

    exps, planted = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12,
                                   seed=5)
    res = align_images(exposures=exps, fitgeom="shift", max_iterations=3,
                       usfac=4, fit_type="gaussian", min_sources=3)
    assert pairwise_shift_errors(res.shifts, planted) < 0.02


def test_plural_catalogs_union():
    """Reference parity (SURVEY §3.1 `for catalog in catalogs`): a LIST of
    catalogs contributes the union of its sources — a second catalog must
    not be silently dropped (VERDICT r2 missing #1)."""
    from subpixal_tpu.catalogs import ImageSourceCatalog

    err = np.array([(0.0, 0.0), (1.0, -0.6)])
    exps, _, _, _ = planted_scene(n_exp=2, shift_err=err)
    drz = Drizzle(list(exps))
    drz.execute()
    sci = np.asarray(drz.output_sci)
    W = sci.shape[1]
    # two catalogs of the same reference image selecting DISJOINT halves
    c_left = ImageSourceCatalog(sci)
    c_left.set_filters(("x", "<", W / 2))
    c_right = ImageSourceCatalog(sci)
    c_right.set_filters((("x", ">=", W / 2)))
    n_left, n_right = len(c_left.catalog), len(c_right.catalog)
    assert n_left >= 3 and n_right >= 3, (n_left, n_right)

    res_one = align_images([c_left], drz, fitgeom="shift",
                           max_iterations=4, usfac=4,
                           fit_type="gaussian", min_sources=3)
    res_both = align_images([c_left, c_right], drz, fitgeom="shift",
                            max_iterations=4, usfac=4,
                            fit_type="gaussian", min_sources=3)
    nm_one = res_one.history[-1][0].nmatches
    nm_both = res_both.history[-1][0].nmatches
    assert nm_both > nm_one, (nm_one, nm_both)
    assert nm_both >= 0.8 * (n_left + n_right), (nm_both, n_left, n_right)
    # both runs still recover the planted relative shift
    for res in (res_one, res_both):
        rel = res.shifts - res.shifts[0]
        assert np.abs(rel[1] - (err[1] - err[0])).max() < 0.02, rel


def test_cutout_pixmaps_device_matches_host():
    """cutout_pixmaps='device' (f32 on-device geometry, the GPU default)
    must agree with the exact float64 host path to well under a mpix on
    a 256² scene (round-3 setup-time work, VERDICT r2 weak #2)."""
    err = np.array([(0.0, 0.0), (1.2, -0.7), (-0.9, 0.5)])
    exps, _, _, _ = planted_scene(n_exp=3, shift_err=err)

    def run(mode):
        es = [Exposure(e.data.copy(), e.wcs.copy(), name=e.name)
              for e in exps]
        return align_images(
            resample=Drizzle(es, pixfrac=1.0), fitgeom="shift",
            max_iterations=8, eps_shift=0.004, usfac=1,
            fit_type="gaussian", min_sources=5, cutout_pixmaps=mode)

    r_host = run("host")
    r_dev = run("device")
    assert r_dev.converged and r_host.converged
    np.testing.assert_allclose(r_dev.shifts, r_host.shifts, atol=2e-4)
    np.testing.assert_allclose(r_dev.matrices, r_host.matrices, atol=1e-5)
    # and both recover the planted relative shifts
    for res in (r_dev, r_host):
        rel = res.shifts - res.shifts[0]
        rel_true = err - err[0]
        assert np.abs(rel - rel_true).max() < 0.01


def test_cutout_pixmaps_device_with_sip():
    """Device cutout pixmaps must honor SIP distortion (the Jacobians
    come from f64 host evaluations; the grids from the f32 device
    composition)."""
    from subpixal_tpu.blot import (compute_cutout_pixmaps_device,
                                   compute_pixmap)

    exps, _, ref_frame, stars = planted_scene(n_exp=1, shift_err=[(0, 0)])
    w = exps[0].wcs
    a = np.zeros((3, 3)); b = np.zeros((3, 3))
    a[2, 0] = 4e-6; a[0, 2] = -2.5e-6; b[1, 1] = 3e-6
    wsip = w.replace(a=a, b=b)
    blc = np.array([[40.0, 60.0], [120.0, 90.0], [200.0, 30.0]])
    px_d, py_d = compute_cutout_pixmaps_device(wsip, ref_frame, blc,
                                               (32, 32))
    for i, (x0, y0) in enumerate(blc):
        px_h, py_h = compute_pixmap(wsip, ref_frame, (32, 32),
                                    blc=(int(y0), int(x0)))
        assert np.abs(np.asarray(px_d[i]) - px_h).max() < 5e-4
        assert np.abs(np.asarray(py_d[i]) - py_h).max() < 5e-4


def test_device_catalog_align_matches_host():
    """`device_catalog='device'` (device source finding, no-fetch setup)
    must reproduce the host-finder align result (catalogs/device.py)."""
    from subpixal_tpu.testing import pairwise_shift_errors, simulate_stack

    shifts = {}
    for mode in ("host", "device"):
        exps, planted = simulate_stack(n_exp=4, shape=(256, 256),
                                       n_stars=25, seed=7)
        res = align_images(exposures=exps, nclip=1, device_catalog=mode)
        sh = np.asarray(res.shifts)
        assert pairwise_shift_errors(sh, planted) < 5e-3
        shifts[mode] = sh
    # 3 mpix: the peaks finder measures windowed footprints (bbox capped
    # at `window`), so cutout geometry differs slightly from the host
    # finder's exact component bboxes — both recover planted to <5 mpix
    assert np.abs(shifts["host"] - shifts["device"]).max() < 3e-3


def test_device_resident_exposures_align():
    """Device-resident Exposures (jax-array .data, zero H2D staging)
    align end-to-end and reproduce the host-data scene's planted
    shifts (testing.simulate_stack(device=True))."""
    import jax

    from subpixal_tpu.testing import pairwise_shift_errors, simulate_stack

    exps, planted = simulate_stack(n_exp=3, shape=(256, 256), n_stars=20,
                                   seed=5, device=True)
    assert isinstance(exps[0].data, jax.Array)
    res = align_images(exposures=exps, fitgeom="shift", max_iterations=3,
                       usfac=8, fit_type="gaussian")
    assert pairwise_shift_errors(np.asarray(res.shifts), planted) < 5e-3
    # planted draws must be identical to the host-mode scene's
    _, planted_h = simulate_stack(n_exp=3, shape=(256, 256), n_stars=20,
                                  seed=5)
    assert planted == planted_h


def test_catalog_knobs_forwarded():
    """AlignConfig catalog_* knobs reach the default finder: a raised
    nsigma threshold finds fewer sources, errors loudly under
    min_sources."""
    import pytest as _pytest

    from subpixal_tpu.testing import simulate_stack

    exps, _ = simulate_stack(n_exp=3, shape=(256, 256), n_stars=8, seed=9)
    # absurd threshold: nothing detectable -> min_sources failure
    with _pytest.raises(ValueError, match="sources"):
        align_images(exposures=exps, catalog_nsigma=1e6, max_iterations=1)
    res = align_images(exposures=exps, catalog_nsigma=3.0,
                       max_iterations=1)
    assert res.n_iterations >= 1


def test_align_with_lookup_table_distortion():
    """Exposures whose WCS carries NPOL-style lookup-table distortion on
    top of SIP (the stwcs HST chain, VERDICT r3 missing #1): planted
    WCS shift errors are recovered through the table-distorted
    pixmaps end to end."""
    from subpixal_tpu.wcs.wcs import DistGrid

    ps = SCALE_AS / 3600.0
    a = np.zeros((3, 3)); a[2, 0] = 4e-7; a[0, 2] = -3e-7
    b = np.zeros((3, 3)); b[2, 0] = -2e-7; b[0, 2] = 3e-7
    gy, gx = np.mgrid[0:8, 0:8] / 7.0
    cpdis = DistGrid(
        data_x=0.08 * np.sin(2.3 * np.pi * gx) * np.cos(1.4 * np.pi * gy),
        data_y=0.08 * np.cos(1.9 * np.pi * gx + 0.4) * np.sin(2.1 * np.pi * gy),
        crpix=(0.0, 0.0), crval=(0.0, 0.0), cdelt=(256 / 7, 256 / 7))

    def tab_wcs(crpix):
        return TanWCS(crpix=np.asarray(crpix, float),
                      crval=np.array([150.0, 2.0]),
                      cd=np.array([[-ps, 0.0], [0.0, ps]]), a=a, b=b,
                      cpdis=cpdis)

    ref_frame = make_wcs((128, 128))
    stars = star_positions(seed=4)
    rng = np.random.default_rng(5)
    err = np.array([(0.0, 0.0), (0.8, -0.5)])
    exps = []
    for e in range(2):
        dith = rng.uniform(-4, 4, 2)
        true_wcs = tab_wcs((128 + dith[0], 128 + dith[1]))
        data = render(true_wcs, stars, ref_frame, (256, 256), seed=50 + e)
        wrong = tab_wcs((128 + dith[0] + err[e][0],
                         128 + dith[1] + err[e][1]))
        exps.append(Exposure(data, wrong, name=f"s{e}"))
    res = align_images(
        resample=Drizzle(exps), fitgeom="shift", max_iterations=8,
        eps_shift=0.004, usfac=1, fit_type="gaussian", min_sources=5,
    )
    assert res.converged
    rel = res.shifts - res.shifts[0]
    rel_true = err - err[0]
    resid = np.abs(rel - rel_true).max()
    assert resid < 0.02, f"table relative shift error {resid*1e3:.1f} mpix"


def test_aot_loop_warm_start(tmp_path, monkeypatch):
    """The exported device loop round-trips: a 'fresh process'
    (simulated by clearing the in-process caches) loads the serialized
    module instead of retracing, and produces identical results.
    (VERDICT r3 task 2: warm-start latency.)"""
    from subpixal_tpu import align as A

    monkeypatch.setenv("SUBPIXAL_TPU_AOT_LOOP", "1")
    monkeypatch.setenv("SUBPIXAL_TPU_AOT_DIR", str(tmp_path))

    def scene():
        stars = star_positions(seed=4)
        ref_frame = make_wcs((128, 128))
        rng = np.random.default_rng(5)
        err = np.array([(0.0, 0.0), (0.6, -0.4)])
        exps = []
        for e in range(2):
            dith = rng.uniform(-4, 4, 2)
            true_wcs = make_wcs((128 + dith[0], 128 + dith[1]))
            data = render(true_wcs, stars, ref_frame, (256, 256),
                          seed=50 + e)
            wrong = make_wcs((128 + dith[0] + err[e][0],
                              128 + dith[1] + err[e][1]))
            exps.append(Exposure(data, wrong, name=f"s{e}"))
        return exps

    kw = dict(fitgeom="shift", max_iterations=3, usfac=4,
              fit_type="gaussian", min_sources=5, device_loop=True)
    res1 = align_images(exposures=scene(), **kw)
    assert "loop_aot_save" in res1.setup_breakdown, res1.setup_breakdown
    # CPU saves the jax.export module; accelerators the executable
    # pickle (align._aot_use_serialized)
    assert (list(tmp_path.glob("*.jaxexp"))
            or list(tmp_path.glob("*.jaxexe"))), "no loop blob on disk"

    # simulate a fresh process: drop every in-process cache
    A._LOOP_CACHE.clear()
    A._STEP_CACHE.clear()
    A._AOT_COMPILED.clear()
    res2 = align_images(exposures=scene(), **kw)
    assert "loop_aot_load" in res2.setup_breakdown, res2.setup_breakdown
    np.testing.assert_allclose(np.asarray(res2.shifts),
                               np.asarray(res1.shifts), atol=1e-6)
