"""Device source detection: stats, threshold, CCL, moments — no fetch.

Reference parity: the detection semantics mirror
:func:`subpixal_tpu.catalogs.find_sources` (the SExtractor-replacement
stage, SURVEY §2 #6/§2a — reference `subpixal/catalogs.py ·
SExImageCatalog`): threshold = median + nsigma*std from sigma-clipped
statistics, 8-connected component labeling, ``area >= npixels``
filtering, flux moments measured on ``image - threshold``.

Rationale: the host finder needs the drizzled mosaic ON HOST — a 64 MB
device->host fetch at 4k^2 plus a host pass over every pixel. This
module keeps the mosaic device-resident: statistics run on a single device sort + prefix sums,
labeling is a `lax.while_loop` of neighbor-min + pointer-jumping steps
(O(log diameter) iterations), and per-source moments are `segment_sum`
reductions into a static ``max_sources`` table. Only the KB-class
catalog table ever crosses to host; the segmentation plane STAYS on
device for the align loop's mask sampling.

Two detection methods (``find_sources_device(method=...)``):

``'peaks'`` (default) — the device-first path. Detection is local-maxima
based: threshold -> minarea prefilter (integral-image box count) ->
local-max mask -> ``top_k`` by brightness -> per-peak windowed flood
fill + dense moments on ``(B, win, win)`` batches. No full-resolution
gathers, scatters or segment reductions ever run (the CCL path needs
~20 of them). Sources are returned brightest-first, so a ``max_sources`` cap
drops the FAINTEST sources — the ``'ccl'`` cap drops by image position.
Peaks connected to a strictly brighter in-window pixel are merged into
the brighter peak's source (dedup), so isolated sources match the CCL
component exactly; maxima further apart than ``window`` split into
separate rows (window-scale deblending).

``'ccl'`` — exact connected-component topology: `lax.while_loop`
neighbor-min + pointer-jumping labeling and ``segment_sum`` moment
tables. Matches the host finder's component semantics bit-for-bit but
costs seconds at mosaic scale; use it when exact SExtractor-like
component areas of arbitrarily large sources matter.

``'peaks'`` also runs the SExtractor-style multi-threshold deblender
IN-WINDOW (round 4): the host ladder (DEBLEND_NTHRESH exponential
levels between threshold and component peak) is scanned per candidate
window, and a merged peak becomes its own source at the lowest level
where its flood region separates from every other in-component local
maximum with > DEBLEND_MINCONT of the component flux on both sides —
measured on that separated region.

Host parity status (round 5): deblended children's skirt pixels are
assigned by EUCLIDEAN NEAREST SEED exactly like the host/SExtractor
(this candidate's seed is its separated core's flux-weighted centroid;
the other children's seeds are their 3x3-refined local maxima —
measured 0.07 px crowded-pair centroid agreement, was ~0.5 px under
the round-4 geodesic growth), and a source whose bbox touches its
measurement window ESCALATES the window (doubling, capped at
min(H, W, 256)) until the footprint measures whole — bbox/area/flux
match the host finder exactly on big isolated sources. Remaining
deviations: beyond-cap footprints still truncate, deblending is
window-scale, and the other-children seed proxy is the refined peak
rather than the host's core centroid; ``'ccl'`` does not deblend.
Crowded-field users who need exact host semantics force the host
finder (``AlignConfig.device_catalog='host'``) — see docs/parity.md.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import ImageCatalog, Table

__all__ = ["sigma_clipped_stats_device", "label_components_device",
           "find_sources_device", "DeviceSourceCatalog"]


@functools.partial(jax.jit, static_argnames=("sigma", "maxiters"))
def sigma_clipped_stats_device(data, sigma: float = 3.0,
                               maxiters: int = 5):
    """(mean, median, std) with iterative sigma clipping, on device.

    Same fixed point as the host :func:`~subpixal_tpu.catalogs.
    sigma_clipped_stats`, computed without fetching ``data``: the clip
    keeps a VALUE interval, so on the sorted array every iteration's
    kept set is a contiguous slice — one O(n log n) sort plus prefix
    sums replace ``maxiters`` full passes, and each iteration is two
    binary searches.
    """
    x = jnp.ravel(data).astype(jnp.float32)
    finite = jnp.isfinite(x)
    n_tot = x.shape[0]
    m = jnp.sum(finite.astype(jnp.int32))          # finite count
    s = jnp.sort(jnp.where(finite, x, jnp.inf))    # finite first
    # prefix sums of MEDIAN-CENTERED values: f32 cumsums over 10^7+
    # elements would otherwise lose the (sum-difference) statistics to
    # cancellation when the background level is large
    med0 = s[jnp.maximum(m // 2, 0)]
    sz = jnp.where(jnp.isfinite(s), s - med0, 0.0)
    c1 = jnp.cumsum(sz)
    c2 = jnp.cumsum(sz * sz)

    def seg_stats(lo, hi):
        cnt = jnp.maximum(hi - lo, 1)
        s1 = c1[hi - 1] - jnp.where(lo > 0, c1[lo - 1], 0.0)
        s2 = c2[hi - 1] - jnp.where(lo > 0, c2[lo - 1], 0.0)
        mean_c = s1 / cnt
        var = jnp.maximum(s2 / cnt - mean_c * mean_c, 0.0)
        # np.median parity: average the two middle order statistics
        med = 0.5 * (s[lo + (cnt - 1) // 2] + s[lo + cnt // 2])
        return ((med0 + mean_c).astype(jnp.float32), med,
                jnp.sqrt(var).astype(jnp.float32))

    lo = jnp.int32(0)
    hi = m
    for _ in range(maxiters):
        _, med, std = seg_stats(lo, hi)
        lo = jnp.searchsorted(s, med - sigma * std, side="left"
                              ).astype(jnp.int32)
        hi = jnp.minimum(
            jnp.searchsorted(s, med + sigma * std, side="right"
                             ).astype(jnp.int32), m)
        hi = jnp.maximum(hi, lo + 1)
    mean, med, std = seg_stats(lo, hi)
    del n_tot
    return mean, med, std


def _shift_min(a, dy, dx, fill):
    """``a`` shifted by (dy, dx) with ``fill`` padding (static shifts)."""
    H, W = a.shape
    out = a
    if dy:
        pad = jnp.full((abs(dy), W), fill, a.dtype)
        out = (jnp.concatenate([pad, out[:-dy]], 0) if dy > 0
               else jnp.concatenate([out[-dy:], pad], 0))
    if dx:
        pad = jnp.full((H, abs(dx)), fill, a.dtype)
        out = (jnp.concatenate([pad, out[:, :-dx]], 1) if dx > 0
               else jnp.concatenate([out[:, -dx:], pad], 1))
    return out


@functools.partial(jax.jit, static_argnames=("connectivity", "max_iters"))
def label_components_device(det, connectivity: int = 8,
                            max_iters: int = 64):
    """Connected-component labels of a boolean mask, on device.

    Returns an int32 (H, W) plane whose foreground value is the flat
    index of the component's ROOT pixel (its row-major minimum) and
    ``H*W`` on background. Algorithm: each `lax.while_loop` iteration
    takes the neighborhood minimum (4- or 8-connected) and then
    pointer-jumps twice (``lab <- lab[lab]``), so convergence needs
    O(log diameter) iterations; the loop exits on a device-side
    fixed-point test — no host round trip.
    """
    H, W = det.shape
    BIG = jnp.int32(H * W)
    idx = jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)
    lab0 = jnp.where(det, idx, BIG)
    offs = ([(0, 1), (0, -1), (1, 0), (-1, 0)] if connectivity == 4 else
            [(0, 1), (0, -1), (1, 0), (-1, 0),
             (1, 1), (1, -1), (-1, 1), (-1, -1)])

    def jump(f):
        tgt = jnp.where(f < BIG, f, 0)
        return jnp.where(f < BIG, jnp.take(f, tgt), BIG)

    def body(state):
        lab, _, it = state
        m = lab
        for dy, dx in offs:
            m = jnp.minimum(m, _shift_min(lab, dy, dx, BIG))
        m = jnp.where(det, m, BIG)
        f = jump(jump(m.ravel())).reshape(H, W)
        return f, jnp.any(f != lab), it + 1

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    lab, _, _ = jax.lax.while_loop(
        cond, body, (lab0, jnp.bool_(True), jnp.int32(0)))
    return lab


@functools.partial(
    jax.jit, static_argnames=("connectivity", "max_sources", "max_iters"))
def _find_sources_core(img, threshold, *, connectivity, max_sources,
                       max_iters=64):
    """Device detection program: threshold -> CCL -> dense ids -> moments.

    Returns (seg_id_plane int32 (H, W), table dict of (max_sources+1,)
    per-id arrays, n_components, n_overflow). Table row ``i`` describes
    source id ``i`` (row 0 = background, unused).
    """
    H, W = img.shape
    finite = jnp.isfinite(img)
    det = finite & (img > threshold)
    lab = label_components_device(det, connectivity=connectivity,
                                  max_iters=max_iters)
    flat_lab = lab.ravel()
    idx = jnp.arange(H * W, dtype=jnp.int32)
    is_root = det.ravel() & (flat_lab == idx)
    dense = jnp.cumsum(is_root.astype(jnp.int32))   # root -> 1..K
    n_comp = dense[-1]
    ids = jnp.where(det.ravel(),
                    jnp.take(dense, jnp.where(flat_lab < H * W,
                                              flat_lab, 0)),
                    0)
    n_overflow = jnp.maximum(n_comp - max_sources, 0)
    ids = jnp.where(ids <= max_sources, ids, 0)     # cap: drop overflow
    K = max_sources + 1

    data = jnp.where(det, img - threshold, 0.0).astype(jnp.float32).ravel()
    xs = (idx % W).astype(jnp.float32)
    ys = (idx // W).astype(jnp.float32)
    one = det.ravel().astype(jnp.float32)
    area = jax.ops.segment_sum(one, ids, num_segments=K)
    flux = jax.ops.segment_sum(data, ids, num_segments=K)
    sx = jax.ops.segment_sum(data * xs, ids, num_segments=K)
    sy = jax.ops.segment_sum(data * ys, ids, num_segments=K)
    peak = jax.ops.segment_max(jnp.where(det.ravel(), data, -jnp.inf),
                               ids, num_segments=K)
    big = jnp.float32(H * W)
    xmin = jax.ops.segment_min(jnp.where(det.ravel(), xs, big), ids,
                               num_segments=K)
    ymin = jax.ops.segment_min(jnp.where(det.ravel(), ys, big), ids,
                               num_segments=K)
    xmax = jax.ops.segment_max(jnp.where(det.ravel(), xs, -1.0), ids,
                               num_segments=K)
    ymax = jax.ops.segment_max(jnp.where(det.ravel(), ys, -1.0), ids,
                               num_segments=K)
    safe = jnp.where(flux > 0, flux, 1.0)
    table = dict(area=area, flux=flux, cx=sx / safe, cy=sy / safe,
                 peak=peak, xmin=xmin, xmax=xmax, ymin=ymin, ymax=ymax)
    return lab, ids.reshape(H, W), table, n_comp, n_overflow


@functools.partial(jax.jit, static_argnames=())
def _apply_keep(seg, keep_lut):
    """Zero rejected ids in the segmentation plane (LUT gather)."""
    return jnp.where(jnp.take(keep_lut, seg), seg, 0)


def _shift3(a, dy, dx, fill):
    """(B, h, w) batch shifted by (dy, dx) over the window axes with
    ``fill`` padding (NOT roll: wraparound would connect a window's
    opposite edges during the flood fill)."""
    B, h, w = a.shape
    out = a
    if dy:
        pad = jnp.full((B, abs(dy), w), fill, a.dtype)
        out = (jnp.concatenate([pad, out[:, :-dy]], 1) if dy > 0
               else jnp.concatenate([out[:, -dy:], pad], 1))
    if dx:
        pad = jnp.full((B, h, abs(dx)), fill, a.dtype)
        out = (jnp.concatenate([pad, out[:, :, :-dx]], 2) if dx > 0
               else jnp.concatenate([out[:, :, -dx:], pad], 2))
    return out


#: raster-order-earlier / -later neighbor offsets: a local maximum is
#: STRICTLY above its raster-earlier neighbors and >= the later ones, so
#: a flat plateau yields exactly ONE peak (its raster-first pixel)
_EARLIER = ((-1, -1), (-1, 0), (-1, 1), (0, -1))
_LATER = ((0, 1), (1, -1), (1, 0), (1, 1))


def _candidate_mask(img, threshold, npixels):
    """Local-maxima candidate mask (threshold + minarea prefilter) —
    the EXACT candidate set of `_find_sources_peaks_core`, shared with
    the cheap counting program (`_count_candidates`)."""
    H, W = img.shape
    finite = jnp.isfinite(img)
    x = jnp.where(finite, img, -jnp.inf)
    det = finite & (img > threshold)

    def nb(a, dy, dx, fill):
        # value at (i+dy, j+dx); _shift_min moves content by (+dy, +dx)
        return _shift_min(a, -dy, -dx, fill)

    # minarea prefilter: a connected component of area >= npixels that
    # contains pixel p has >= min(npixels, r+1) det pixels within
    # Chebyshev radius r of p (path argument), so with r = npixels - 1
    # the box count >= npixels is NECESSARY for the component test —
    # no false rejects; false accepts fall to the exact area filter.
    r = npixels - 1
    if r > 0:
        dp = jnp.pad(det.astype(jnp.int32), r)
        ii = jnp.pad(jnp.cumsum(jnp.cumsum(dp, 0), 1), ((1, 0), (1, 0)))
        s = 2 * r + 1
        box = (ii[s:s + H, s:s + W] - ii[:H, s:s + W]
               - ii[s:s + H, :W] + ii[:H, :W])
        pk = det & (box >= npixels)
    else:
        pk = det
    for dy, dx in _EARLIER:
        pk = pk & (x > nb(x, dy, dx, -jnp.inf))
    for dy, dx in _LATER:
        pk = pk & (x >= nb(x, dy, dx, -jnp.inf))
    return pk


@functools.partial(jax.jit, static_argnames=("nsigma", "npixels"))
def _count_candidates_auto(img, *, nsigma, npixels):
    """(candidate count, derived threshold) — stage A of the two-stage
    finder: the KB-class result sizes stage B's static candidate batch
    (round 5; a 60-star 1024² scene previously ran the full deblend
    machinery over 8192 static slots — 542 ms of device time and a
    multi-minute 4k compile for ~60 real candidates)."""
    _, med, std = sigma_clipped_stats_device(img)
    thr = (med + jnp.float32(nsigma) * std).astype(jnp.float32)
    pk = _candidate_mask(img, thr, npixels)
    return jnp.sum(pk.astype(jnp.int32)), thr


@functools.partial(jax.jit, static_argnames=("npixels",))
def _count_candidates(img, threshold, *, npixels):
    pk = _candidate_mask(img, threshold, npixels)
    return jnp.sum(pk.astype(jnp.int32))


@functools.partial(
    jax.jit, static_argnames=("nsigma", "max_sources", "npixels",
                              "window", "deblend_nthresh",
                              "deblend_cont"))
def _find_sources_peaks_fused(img, *, nsigma, max_sources, npixels,
                              window, deblend_nthresh=32,
                              deblend_cont=0.005):
    """Threshold + detection as ONE program: the sigma-clipped stats
    (sort + prefix sums) feed the peaks finder without surfacing on
    host. The split path (stats program → eager ``med + nsigma*std``
    → peaks program) pays 3+ dispatches and a scalar fetch per
    call."""
    _, med, std = sigma_clipped_stats_device(img)
    thr = (med + jnp.float32(nsigma) * std).astype(jnp.float32)
    seg, packed, n_cand = _find_sources_peaks_core(
        img, thr, max_sources=max_sources, npixels=npixels,
        window=window, deblend_nthresh=deblend_nthresh,
        deblend_cont=deblend_cont)
    return seg, packed, n_cand, thr


@functools.partial(
    jax.jit, static_argnames=("max_sources", "npixels", "window",
                              "deblend_nthresh", "deblend_cont"))
def _find_sources_peaks_core(img, threshold, *, max_sources, npixels,
                             window, deblend_nthresh=32,
                             deblend_cont=0.005):
    """Device detection program, peaks method (module docstring).

    Returns ``(seg_rank int32 (H, W), packed f32 (13, max_sources),
    n_cand int32)``. ``seg_rank`` holds 1-based brightness ranks
    (1 = brightest, 0 = background); ``packed`` rows are keep, area,
    flux, cx, cy, peak, xmin, xmax, ymin, ymax, n_cand, peak_y,
    peak_x — one array so
    the host fetches the whole table in a single transfer.
    """
    H, W = img.shape
    B, win = max_sources, window
    finite = jnp.isfinite(img)
    x = jnp.where(finite, img, -jnp.inf)
    det = finite & (img > threshold)
    pk = _candidate_mask(img, threshold, npixels)
    n_cand = jnp.sum(pk.astype(jnp.int32))

    # brightest-first candidate selection (ONE top_k, ~40 ms at 16.7M)
    score = jnp.where(pk, x, -jnp.inf).ravel()
    vals, flat = jax.lax.top_k(score, B)
    valid = vals > -jnp.inf
    py = (flat // W).astype(jnp.int32)
    px = (flat % W).astype(jnp.int32)
    y0 = jnp.clip(py - win // 2, 0, max(H - win, 0))
    x0 = jnp.clip(px - win // 2, 0, max(W - win, 0))

    # ONE batched window gather; det / local-max recompute from it
    ar = jnp.arange(win, dtype=jnp.int32)
    rows = y0[:, None] + ar[None, :]                     # (B, win)
    cols = x0[:, None] + ar[None, :]
    wimg = img[rows[:, :, None], cols[:, None, :]]       # (B, win, win)
    wfin = jnp.isfinite(wimg)
    wdet = wfin & (wimg > threshold)
    wx = jnp.where(wfin, wimg, -jnp.inf)

    # flood fill (8-connected) from the peak over the in-window det mask
    seed = ((ar[None, :, None] == (py - y0)[:, None, None])
            & (ar[None, None, :] == (px - x0)[:, None, None]))
    grow0 = seed & wdet

    def _dilate(g):
        d = g
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    d = d | _shift3(g, dy, dx, False)
        return d & wdet

    # dilate to CONVERGENCE, not a fixed step count: a fixed `win`
    # steps under-fills concave components whose geodesic radius
    # exceeds win (U-shapes, spiral arms), silently truncating
    # area/flux; convergence is exact for any in-window shape and
    # typically needs only ~source-radius iterations
    def ff_body(state):
        g, _ = state
        d = _dilate(g)
        return d, jnp.any(d != g)

    grow, _ = jax.lax.while_loop(lambda s: s[1], ff_body,
                                 (grow0, jnp.bool_(True)))

    # dedup prep: a peak whose component (within the window) contains
    # a strictly brighter pixel belongs to that brighter bump's source
    # (unless multi-threshold deblending below separates it);
    # equal-valued twin peaks keep only the raster-first one. Local
    # maxima are RECOMPUTED in-window (border-pixel misclassification
    # only matters for exact-equal values >win/2 apart — negligible).
    own = vals[:, None, None]
    brighter = jnp.any(grow & (wx > own), axis=(1, 2))
    wpk = wdet
    for dy, dx in _EARLIER:
        wpk = wpk & (wx > _shift3(wx, -dy, -dx, -jnp.inf))
    for dy, dx in _LATER:
        wpk = wpk & (wx >= _shift3(wx, -dy, -dx, -jnp.inf))
    wflat = (rows[:, :, None] * W + cols[:, None, :])
    eq_twin = jnp.any(grow & wpk & (wx == own)
                      & (wflat < flat[:, None, None]), axis=(1, 2))

    # --- window-scale multi-threshold deblending --------------------- #
    # Host `catalogs._deblend` semantics (SExtractor DEBLEND_NTHRESH /
    # DEBLEND_MINCONT), vectorized over the candidate windows: scan the
    # host's exponential threshold ladder between the detection
    # threshold and the COMPONENT peak; a merged candidate becomes a
    # separate source at the lowest level where its own flood region
    # (a) contains no other in-component local maximum and (b) both it
    # and the rest of the component carry > deblend_cont of the
    # component's total flux. Survivors are measured on that separated
    # region; a candidate that never separates keeps the reference
    # behavior (merged into the brighter peak / keeps the full
    # component when brightest).
    base_flux = jnp.sum(jnp.where(grow, wimg - threshold, 0.0),
                        axis=(1, 2))
    found = jnp.zeros((B,), bool)
    region = grow
    if deblend_nthresh > 1 and deblend_cont < 1.0:
        oth_core = jnp.zeros_like(grow)
        others = grow & wpk & (wflat != flat[:, None, None])
        comp_peak = jnp.max(jnp.where(grow, wx, -jnp.inf), axis=(1, 2))
        tot_safe = jnp.where(base_flux > 0, base_flux, 1.0)
        K = int(deblend_nthresh)
        for k in range(1, K):
            s_k = k / K
            frac_k = float(np.expm1(4.0 * s_k) / np.expm1(4.0))
            # geometric ladder for positive thresholds (SExtractor),
            # additive-exponential otherwise (host `_deblend` parity)
            ratio = jnp.where(threshold > 0,
                              comp_peak / jnp.where(threshold > 0,
                                                    threshold, 1.0),
                              1.0)
            lev = jnp.where(
                threshold > 0,
                threshold * jnp.power(jnp.maximum(ratio, 1e-20), s_k),
                threshold + (comp_peak - threshold) * frac_k)
            mask_k = grow & (wx > lev[:, None, None])
            g = seed & mask_k

            def db_body(state, mask_k=mask_k):
                gg, _ = state
                d = gg
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        if dy or dx:
                            d = d | _shift3(gg, dy, dx, False)
                d = d & mask_k
                return d, jnp.any(d != gg)

            R, _ = jax.lax.while_loop(lambda st: st[1], db_body,
                                      (g, jnp.bool_(True)))
            sep = ~jnp.any(R & others, axis=(1, 2)) & jnp.any(
                R, axis=(1, 2))
            f_self = jnp.sum(jnp.where(R, wimg - threshold, 0.0),
                             axis=(1, 2)) / tot_safe
            f_other = jnp.sum(
                jnp.where(mask_k & ~R, wimg - threshold, 0.0),
                axis=(1, 2)) / tot_safe
            ok = sep & (f_self > deblend_cont) & (f_other > deblend_cont)
            new = ok & ~found
            region = jnp.where(new[:, None, None], R, region)
            oth_core = jnp.where(new[:, None, None], mask_k & ~R,
                                 oth_core)
            found = found | ok

        # euclidean nearest-seed skirt assignment (host/SExtractor
        # parity, round 5 — replaces the lockstep geodesic growth whose
        # contested one-pixel ring went to neither child, docs/parity.md
        # #6): EVERY component pixel joins the child whose seed is
        # nearest. This candidate's seed is its separated core's
        # flux-weighted centroid (exactly the host's child seed); the
        # other children's seeds are the other in-component local
        # maxima above the split level, refined by a 3x3 flux-weighted
        # centroid (in-window proxies for their core centroids).
        rf = ar.astype(jnp.float32)
        rowy = rf[None, :, None] + jnp.zeros((1, 1, win), jnp.float32)
        colx = rf[None, None, :] + jnp.zeros((1, win, 1), jnp.float32)
        selfw = jnp.where(region, wimg - threshold, 0.0)
        sf = jnp.sum(selfw, axis=(1, 2))
        sf = jnp.where(sf > 0, sf, 1.0)
        scy = jnp.sum(selfw * rowy, axis=(1, 2)) / sf
        scx = jnp.sum(selfw * colx, axis=(1, 2)) / sf
        d2self = ((rowy - scy[:, None, None]) ** 2
                  + (colx - scx[:, None, None]) ** 2)
        oseed = others & oth_core
        w3 = jnp.where(wdet, wimg - threshold, 0.0)
        ny3 = w3 * rowy
        nx3 = w3 * colx
        s3, sy3, sx3 = w3, ny3, nx3
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    s3 = s3 + _shift3(w3, dy, dx, 0.0)
                    sy3 = sy3 + _shift3(ny3, dy, dx, 0.0)
                    sx3 = sx3 + _shift3(nx3, dy, dx, 0.0)
        s3s = jnp.where(s3 > 0, s3, 1.0)
        # up to S other seeds per window (brightest first; >S other
        # children in one window would need a pathological field) ->
        # d2other = min over the explicit seed list. top_k keeps the
        # work at S*(B, win, win) instead of a jump-flood's ~40 passes
        # (which compiled minutes-slow on the CPU test rig).
        S = 8
        INF = jnp.float32(1e9)
        osc = jnp.where(oseed, wx, -jnp.inf).reshape(oseed.shape[0], -1)
        ovals, oflat = jax.lax.top_k(osc, S)              # (B, S)
        ohas = ovals > -jnp.inf
        oy = (oflat // win)
        ox = (oflat % win)
        gat = lambda a: a.reshape(a.shape[0], -1)[
            jnp.arange(a.shape[0])[:, None], oflat]       # (B, S)
        seedy = jnp.where(ohas, gat(sy3 / s3s), 0.0)
        seedx = jnp.where(ohas, gat(sx3 / s3s), 0.0)
        del oy, ox
        d2o = jnp.min(jnp.where(
            ohas[:, None, None, :],
            (rowy[..., None] - seedy[:, None, None, :]) ** 2
            + (colx[..., None] - seedx[:, None, None, :]) ** 2,
            INF), axis=-1)
        region = jnp.where(found[:, None, None],
                           grow & (d2self <= d2o), region)

    data = jnp.where(region, wimg - threshold, 0.0).astype(jnp.float32)
    absy = rows[:, :, None].astype(jnp.float32) + jnp.zeros((1, 1, win))
    absx = cols[:, None, :].astype(jnp.float32) + jnp.zeros((1, win, 1))
    area = jnp.sum(region, axis=(1, 2)).astype(jnp.float32)
    flux = jnp.sum(data, axis=(1, 2))
    safe = jnp.where(flux > 0, flux, 1.0)
    cx = jnp.sum(data * absx, axis=(1, 2)) / safe
    cy = jnp.sum(data * absy, axis=(1, 2)) / safe
    big = jnp.float32(H * W)
    xmin = jnp.min(jnp.where(region, absx, big), axis=(1, 2))
    ymin = jnp.min(jnp.where(region, absy, big), axis=(1, 2))
    xmax = jnp.max(jnp.where(region, absx, -1.0), axis=(1, 2))
    ymax = jnp.max(jnp.where(region, absy, -1.0), axis=(1, 2))
    peakv = vals - threshold

    keep = valid & (area >= npixels) & (~brighter | found) & ~eq_twin

    # segmentation plane: scatter 1-based brightness ranks over each
    # source's final region (full component, or the separated deblend
    # region), brighter (smaller rank) wins overlaps — a windowed
    # scatter-min, the only full-plane scatter in the program
    rank = jnp.arange(1, B + 1, dtype=jnp.int32)
    BIGI = jnp.int32(B + 2)
    upd = jnp.where(region & keep[:, None, None], rank[:, None, None],
                    BIGI)
    seg = jnp.full((H, W), BIGI, jnp.int32)
    seg = seg.at[rows[:, :, None].astype(jnp.int32),
                 cols[:, None, :].astype(jnp.int32)].min(upd)
    seg = jnp.where(seg == BIGI, 0, seg)

    # truncation signature (row 13): the measured bbox TOUCHES its
    # window border — the footprint may continue outside. Drives the
    # callers' window escalation (VERDICT r4 task 5); computed HERE
    # because only the device knows each candidate's window origin.
    y0f = y0.astype(jnp.float32)
    x0f = x0.astype(jnp.float32)
    touch = ((xmin <= x0f) | (xmax >= x0f + win - 1)
             | (ymin <= y0f) | (ymax >= y0f + win - 1))
    packed = jnp.stack([
        keep.astype(jnp.float32), area, flux, cx, cy, peakv,
        xmin, xmax, ymin, ymax,
        jnp.full((B,), n_cand, jnp.float32),
        py.astype(jnp.float32), px.astype(jnp.float32),
        touch.astype(jnp.float32),
    ])
    return seg, packed, n_cand


@functools.partial(jax.jit, static_argnames=())
def _remap_ranks(seg, lut):
    """rank plane -> catalog-id plane (0 stays background)."""
    return jnp.take(lut, seg)


def _peaks_dims(shape, max_sources, window):
    """Static (B, win) actually compiled for an (H, W) image."""
    H, W = shape
    return int(min(max_sources, H * W)), max(2, min(window, H, W))


def _peaks_executables(shape, *, nsigma: float, npixels: int,
                       window: int, max_sources: int,
                       deblend_nthresh: int, deblend_cont: float,
                       want_fused: bool = True):
    """(fused, peaks, remap) compiled executables for an (H, W) image,
    served from the serialized-executable cache (:mod:`..aot`) — a
    warm process deserializes them instead of compiling. ``fused`` computes the sigma-clip threshold in the
    same program (used when the caller passes no explicit threshold);
    ``peaks`` takes an explicit threshold. Entries are None when
    lowering fails (the caller then calls the plain jit functions)."""
    from ..aot import get_executable

    H, W = shape
    B, win = _peaks_dims(shape, max_sources, window)
    img = jax.ShapeDtypeStruct((H, W), jnp.float32)
    thr = jax.ShapeDtypeStruct((), jnp.float32)
    core_statics = dict(max_sources=B, npixels=npixels, window=win,
                        deblend_nthresh=deblend_nthresh,
                        deblend_cont=deblend_cont)
    fused = None
    if want_fused:
        fused = get_executable(
            "cat_find", _find_sources_peaks_fused, (img,),
            statics=dict(nsigma=float(nsigma), **core_statics))
    peaks = get_executable("cat_peaks", _find_sources_peaks_core,
                           (img, thr), statics=core_statics)
    remap = get_executable(
        "cat_remap", _remap_ranks,
        (jax.ShapeDtypeStruct((H, W), jnp.int32),
         jax.ShapeDtypeStruct((B + 1,), jnp.int32)))
    return fused, peaks, remap


def warm_compile(shape, *, nsigma: float = 3.0, npixels: int = 5,
                 window: int = 32, max_sources: int = 8192,
                 deblend_nthresh: int = 32,
                 deblend_cont: float = 0.005) -> None:
    """AOT-compile the peaks-finder programs for an (H, W) image.

    The align driver warms these for the drizzle output shape before
    ``resample.execute()``, so its setup breakdown reports the compile
    apart from the detection run. Programs come from the
    serialized-executable cache (:func:`_peaks_executables`): warm
    processes skip the compile entirely.
    """
    from ..aot import get_executable

    B_full, _ = _peaks_dims(shape, max_sources, window)
    if B_full > 256:
        # two-stage flow (find_sources_device): warm the counting
        # program and the LIKELY stage-B buckets — never the
        # max_sources-sized monolith (its compile was the multi-minute
        # cold cost this flow exists to avoid)
        H, W = shape
        img = jax.ShapeDtypeStruct((H, W), jnp.float32)
        get_executable("cat_count", _count_candidates_auto, (img,),
                       statics=dict(nsigma=float(nsigma),
                                    npixels=int(npixels)))
        for b in (128, 256):
            _peaks_executables(shape, nsigma=nsigma, npixels=npixels,
                               window=window, max_sources=b,
                               deblend_nthresh=deblend_nthresh,
                               deblend_cont=deblend_cont,
                               want_fused=False)
    else:
        _peaks_executables(shape, nsigma=nsigma, npixels=npixels,
                           window=window, max_sources=max_sources,
                           deblend_nthresh=deblend_nthresh,
                           deblend_cont=deblend_cont)


def find_sources_device(image, threshold: float | None = None,
                        nsigma: float = 3.0, npixels: int = 5,
                        connectivity: int = 8,
                        max_sources: int = 8192,
                        method: str = "auto", window: int = 32,
                        deblend_nthresh: int = 32,
                        deblend_cont: float = 0.005):
    """Device analogue of :func:`subpixal_tpu.catalogs.find_sources`
    (multi-threshold deblending runs IN-WINDOW for the 'peaks' method —
    module docstring; ``deblend_nthresh=1`` disables).

    Returns (Table, seg_id_plane) where the Table (host, KB-class) has
    the host finder's columns and ``seg_id_plane`` is a DEVICE int32
    (H, W) plane with catalog ``id`` values (0 = background).

    ``method``: ``'peaks'`` (default via ``'auto'``) — brightest-first
    windowed measurement, ~10x faster at mosaic scale; ``'ccl'`` —
    exact component topology (module docstring). With ``'peaks'`` the
    table rows are ordered brightest-first and a ``max_sources``
    overflow drops the faintest candidates.
    """
    if method not in ("auto", "peaks", "ccl"):
        raise ValueError(
            f"method must be 'auto'|'peaks'|'ccl', got {method!r}")
    img = jnp.asarray(image, jnp.float32)
    if threshold is None and method == "ccl":
        _, med, std = sigma_clipped_stats_device(img)
        threshold = med + nsigma * std

    if method != "ccl":
        from ..aot import get_executable

        H, W = img.shape
        B, win = _peaks_dims((H, W), max_sources, window)
        if B > 256:
            # two-stage candidate sizing (round 5): a cheap counting
            # program fetches (n_cand, threshold) — KB-class sync —
            # and stage B runs with its static batch bucketed to the
            # ACTUAL candidate count instead of max_sources. A 60-star
            # 1024² scene drops the deblend machinery from 8192 to 128
            # slots (542 -> ~20 ms device; the 4k finder's multi-minute
            # cold compile shrinks the same way). Exact-identical
            # results: stage B sees every candidate (B_eff >= n_cand)
            # at the same threshold.
            if threshold is None:
                stA = dict(nsigma=float(nsigma), npixels=int(npixels))
                cexe = get_executable("cat_count",
                                      _count_candidates_auto, (img,),
                                      statics=stA)
                cnt, thr_d = (cexe(img) if cexe is not None
                              else _count_candidates_auto(img, **stA))
                n_est, thr_v = jax.device_get((cnt, thr_d))
                threshold = float(thr_v)
            else:
                stA = dict(npixels=int(npixels))
                thr_j = jnp.asarray(threshold, jnp.float32)
                cexe = get_executable("cat_count_thr",
                                      _count_candidates, (img, thr_j),
                                      statics=stA)
                cnt = (cexe(img, thr_j) if cexe is not None
                       else _count_candidates(img, thr_j, **stA))
                n_est = int(jax.device_get(cnt))
            b_eff = 128
            while b_eff < n_est + 8:
                b_eff *= 2
            if b_eff < B:
                max_sources = b_eff
                B, win = _peaks_dims((H, W), max_sources, window)
        exes = _peaks_executables(
            img.shape, nsigma=float(nsigma), npixels=npixels,
            window=window, max_sources=max_sources,
            deblend_nthresh=int(deblend_nthresh),
            deblend_cont=float(deblend_cont),
            want_fused=threshold is None)
        if threshold is None:
            # ONE program: sigma-clip threshold + detection (no stats
            # dispatch, no eager threshold math, no scalar fetch)
            if exes[0] is not None:
                seg_rank, packed, _, _thr = exes[0](img)
            else:
                seg_rank, packed, _, _thr = _find_sources_peaks_fused(
                    img, nsigma=float(nsigma), max_sources=B,
                    npixels=npixels, window=win,
                    deblend_nthresh=int(deblend_nthresh),
                    deblend_cont=float(deblend_cont))
        else:
            thr = jnp.asarray(threshold, jnp.float32)
            if exes[1] is not None:
                seg_rank, packed, _ = exes[1](img, thr)
            else:
                seg_rank, packed, _ = _find_sources_peaks_core(
                    img, thr, max_sources=B, npixels=npixels,
                    window=win, deblend_nthresh=int(deblend_nthresh),
                    deblend_cont=float(deblend_cont))
        from ..utils import fetch_to_host

        arr = fetch_to_host(packed)     # ONE device->host table fetch
        keep = arr[0] > 0
        n_cand = int(arr[10, 0])
        if n_cand > B:
            import warnings

            warnings.warn(
                f"device source finder capped at {B} sources; the "
                f"{n_cand - B} FAINTEST candidates were dropped — "
                "raise max_sources to keep them", stacklevel=2)
        sl = np.nonzero(keep)[0]
        # big-source window escalation (VERDICT r4 task 5): a kept
        # source whose bbox fills its measurement window was truncated
        # by it — re-run the finder with the window doubled (threshold
        # identical: an explicit value is reused, a derived one is
        # recomputed from the same deterministic program) until every
        # footprint fits or the window reaches min(H, W, 256)
        if len(sl):
            # device-computed truncation flag (packed row 13): the
            # bbox touched its window border, so the footprint may
            # continue outside — a footprint that merely approaches
            # the window size but stays inside measures whole and
            # does not trigger a catalog-perturbing escalation
            touch = arr[13][sl] > 0
            win_cap = min(H, W, 256)
            if touch.any() and win < win_cap:
                # the escalated pass re-detects at the SAME threshold,
                # so the candidate count is already known — cap its
                # static batch at that count (rounded for shape reuse)
                # instead of max_sources: a (8192, 64, 64) deblend
                # program where 40 candidates exist is pure compile
                # waste (measured 7x CPU-suite slowdown without this)
                b2 = min(max_sources,
                         max(64, -(-(n_cand + 8) // 64) * 64))
                return find_sources_device(
                    image, threshold=threshold, nsigma=nsigma,
                    npixels=npixels, connectivity=connectivity,
                    max_sources=b2, method=method,
                    window=min(2 * win, win_cap),
                    deblend_nthresh=deblend_nthresh,
                    deblend_cont=deblend_cont)
        ids = np.arange(1, len(sl) + 1, dtype=np.int32)
        cat = Table({
            "id": ids,
            "x": arr[3][sl].astype(np.float64),
            "y": arr[4][sl].astype(np.float64),
            "flux": arr[2][sl].astype(np.float64),
            "area": arr[1][sl].astype(np.int64),
            "peak": arr[5][sl],
            "xmin": arr[6][sl].astype(np.int64),
            "xmax": arr[7][sl].astype(np.int64),
            "ymin": arr[8][sl].astype(np.int64),
            "ymax": arr[9][sl].astype(np.int64),
        })
        # rank plane -> dense id plane (kept ranks only)
        lut = np.zeros(B + 1, np.int32)
        lut[sl + 1] = ids
        lut_j = jnp.asarray(lut)
        seg = (exes[2](seg_rank, lut_j) if exes[2] is not None
               else _remap_ranks(seg_rank, lut_j))
        return cat, seg

    _, seg, table, n_comp, n_overflow = _find_sources_core(
        img, jnp.asarray(threshold, jnp.float32),
        connectivity=connectivity, max_sources=max_sources)
    # KB-class table fetch (device->host); the (H, W) plane stays put.
    # One batched fetch: device_get issues every column's D2H copy
    # async then blocks once.
    host = jax.device_get(table)
    n_comp = int(n_comp)
    n_over = int(n_overflow)
    if n_over:
        import warnings

        warnings.warn(
            f"device source finder capped at {max_sources} sources "
            f"({n_over} dropped); raise max_sources", stacklevel=2)
    n = min(n_comp, max_sources)
    keep = host["area"][1:n + 1] >= npixels
    ids = np.nonzero(keep)[0].astype(np.int32) + 1
    sl = ids  # table rows are id-indexed
    cat = Table({
        "id": ids,
        "x": host["cx"][sl],
        "y": host["cy"][sl],
        "flux": host["flux"][sl].astype(np.float64),
        "area": host["area"][sl].astype(np.int64),
        "peak": host["peak"][sl],
        "xmin": host["xmin"][sl].astype(np.int64),
        "xmax": host["xmax"][sl].astype(np.int64),
        "ymin": host["ymin"][sl].astype(np.int64),
        "ymax": host["ymax"][sl].astype(np.int64),
    })
    if not keep.all() or n < n_comp:
        keep_lut = np.zeros(max_sources + 1, bool)
        keep_lut[ids] = True
        seg = _apply_keep(seg, jnp.asarray(keep_lut))
    return cat, seg


class DeviceSourceCatalog(ImageCatalog):
    """`ImageCatalog` whose finder runs on device; the segmentation
    plane stays device-resident (``segmentation_device``).

    Drop-in for :class:`~subpixal_tpu.catalogs.ImageSourceCatalog` on
    the align driver's default path (``catalogs=None``) when the
    drizzled reference is already on device. ``.segmentation`` fetches
    to host lazily ONLY if asked (a full-mosaic transfer — prefer
    ``segmentation_device``).
    """

    def __init__(self, image, threshold: float | None = None,
                 nsigma: float = 3.0, npixels: int = 5,
                 connectivity: int = 8, max_sources: int = 8192,
                 method: str = "auto", window: int = 32):
        super().__init__()
        self._image = image
        self.threshold = threshold
        self.nsigma = nsigma
        self.npixels = npixels
        self.connectivity = connectivity
        self.max_sources = max_sources
        self.method = method
        self.window = window
        self.segmentation_device = None

    def execute(self) -> None:
        cat, seg = find_sources_device(
            self._image, threshold=self.threshold, nsigma=self.nsigma,
            npixels=self.npixels, connectivity=self.connectivity,
            max_sources=self.max_sources, method=self.method,
            window=self.window)
        self._rawcat = cat
        self.segmentation_device = seg
        self._seg_host = None  # invalidate the memoized host view

    @property
    def segmentation(self):  # host np view, on demand only
        if getattr(self, "_seg_host", None) is not None:
            return self._seg_host
        if self.segmentation_device is None and self._rawcat is None:
            self.execute()
        if self.segmentation_device is None:
            return None
        from ..utils import fetch_to_host

        # memoize: each fetch is a full-mosaic d2h (64 MB at 4k^2)
        self._seg_host = fetch_to_host(self.segmentation_device)
        return self._seg_host

    @segmentation.setter
    def segmentation(self, value):  # base-class __init__ compatibility
        self._seg_host = value
