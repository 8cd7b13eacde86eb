"""Blot: resample a (drizzled) reference image onto an exposure's frame.

Capability parity with the reference's ``subpixal/blot.py · blot_cutout``
(mechanism: ``drizzlepac.ablot.do_blot`` → C ``cdriz.tblot``; SURVEY.md
§2 #8, §3.1). Blotting lets the align loop compare like-with-like: the
combined reference is interpolated onto the SAME distorted pixel grid as
each exposure cutout, so the pair can be cross-correlated pixel-for-pixel.

Device-first design: the WCS composition (exposure pixel → sky → reference
pixel) produces a *pixmap*; sampling the reference at the pixmap is a
static-footprint separable gather (:mod:`subpixal_tpu.ops.interp`) that
runs batched on device. Pixmaps are evaluated in float64 numpy on host by
default (SURVEY §7 "WCS distortion on device": grids are small and
evaluated once per iteration) — or on device when handed JAX arrays.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .ops.interp import sample_image
from .wcs.wcs import TanWCS

__all__ = ["compute_pixmap", "compute_pixmap_device",
           "compute_cutout_pixmaps_device", "blot_image", "blot_cutout"]


_PIXMAP_CACHE: dict = {}
_PIXMAP_CACHE_MAX = 16
# entries are full-frame float64 pairs (268 MB each at 4k^2) — bound
# the cache by BYTES, not only count, so large scenes cannot pin GBs
_PIXMAP_CACHE_BYTES = 512 * 1024 * 1024


def _grid_cache_key(g):
    if g is None:
        return None
    return (None if g.data_x is None else g.data_x.tobytes(),
            None if g.data_y is None else g.data_y.tobytes(),
            g.crpix, g.crval, g.cdelt)


def _wcs_cache_key(w: TanWCS):
    return (w.crpix.tobytes(), w.crval.tobytes(), w.cd.tobytes(),
            *(None if getattr(w, f) is None else getattr(w, f).tobytes()
              for f in ("a", "b", "ap", "bp")),
            _grid_cache_key(w.cpdis), _grid_cache_key(w.d2im))


def compute_pixmap(
    from_wcs: TanWCS,
    to_wcs: TanWCS,
    shape: tuple[int, int],
    blc: tuple[int, int] = (0, 0),
) -> tuple[np.ndarray, np.ndarray]:
    """Map every pixel of a ``shape`` grid in ``from_wcs``'s frame (offset
    by ``blc`` = (y0, x0)) to pixel coordinates in ``to_wcs``'s frame.

    The composition goes pixel -> tangent (linear CD + SIP), then an
    **exact 3x3 homography** between the two gnomonic tangent planes
    (:func:`subpixal_tpu.wcs.wcs.tangent_homography` — no per-pixel
    spherical trig), then tangent -> pixel. Returns float64 arrays
    (x_to, y_to) of shape ``shape``.

    Results are memoized on the WCS parameters (LRU, 16 entries): the
    align setup and the Drizzle deposits request the SAME full-frame
    pixmaps back-to-back, and on this rig host f64 math runs on a single
    throttled CPU — the cache halves setup time. The returned arrays are
    read-only; ``copy()`` before mutating.
    """
    from .wcs.wcs import tangent_homography

    key = (_wcs_cache_key(from_wcs), _wcs_cache_key(to_wcs),
           tuple(shape), tuple(blc))
    hit = _PIXMAP_CACHE.get(key)
    if hit is not None:
        _PIXMAP_CACHE[key] = _PIXMAP_CACHE.pop(key)  # refresh LRU order
        return hit

    h, w = shape
    y0, x0 = blc
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    xi, eta = from_wcs.pixel_to_tangent(xx + x0, yy + y0)  # degrees
    M = tangent_homography(from_wcs.crval, to_wcs.crval)
    d2r = np.pi / 180.0
    x = xi * d2r
    y = eta * d2r
    w0 = M[0, 0] + M[0, 1] * x + M[0, 2] * y
    w1 = M[1, 0] + M[1, 1] * x + M[1, 2] * y
    w2 = M[2, 0] + M[2, 1] * x + M[2, 2] * y
    xi2 = (w1 / w0) / d2r
    eta2 = (w2 / w0) / d2r
    xt, yt = to_wcs.tangent_to_pixel(xi2, eta2)
    xt = np.asarray(xt)
    yt = np.asarray(yt)
    xt.setflags(write=False)
    yt.setflags(write=False)
    new_bytes = xt.nbytes + yt.nbytes
    total = sum(a.nbytes + b.nbytes for a, b in _PIXMAP_CACHE.values())
    while _PIXMAP_CACHE and (
            len(_PIXMAP_CACHE) >= _PIXMAP_CACHE_MAX
            or total + new_bytes > _PIXMAP_CACHE_BYTES):
        a, b = _PIXMAP_CACHE.pop(next(iter(_PIXMAP_CACHE)))  # oldest
        total -= a.nbytes + b.nbytes
    if new_bytes <= _PIXMAP_CACHE_BYTES:
        _PIXMAP_CACHE[key] = (xt, yt)
    return xt, yt


#: frames with at least this many pixels evaluate their DRIZZLE pixmaps
#: on device in float32 (host float64 trig costs ~13 s per 4k^2 frame
#: on one CPU; the f32 grid is mpix-accurate, far below the deposit
#: kernel's sensitivity). On the GPU the threshold drops to 256² — the
#: host f64 path costs ~0.8 s per 1024² frame on one CPU core and
#: dominated align setup; measurement-critical CUTOUT geometry is controlled separately
#: (``AlignConfig.cutout_pixmaps``).
DEVICE_PIXMAP_MIN_PIXELS = 2048 * 2048
DEVICE_PIXMAP_MIN_PIXELS_ACCEL = 256 * 256


def device_pixmap_min_pixels() -> int:
    """Backend-dependent threshold above which drizzle pixmaps are
    evaluated on device."""
    from .backend import on_gpu

    return (DEVICE_PIXMAP_MIN_PIXELS_ACCEL if on_gpu()
            else DEVICE_PIXMAP_MIN_PIXELS)


def _poly2d_j(C, u, v):
    """Σ_ij C[i, j] u^i v^j on device (static coefficient shape)."""
    n = C.shape[0]
    up = [jnp.ones_like(u)]
    vp = [jnp.ones_like(v)]
    for _ in range(n - 1):
        up.append(up[-1] * u)
        vp.append(vp[-1] * v)
    acc = jnp.float32(0.0)
    for i in range(n):
        for j in range(n):
            acc = acc + C[i, j] * (up[i] * vp[j])
    return acc


def _grid_sample_j(grid, meta, x, y):
    """Bilinear lookup-table sample on device (DistGrid semantics).

    ``meta`` rows: (crpix, crval, cdelt) per axis — see
    :class:`subpixal_tpu.wcs.wcs.DistGrid`. Static grid shape; clamped
    at the edges; pure gather + FMA, jit/vmap-safe.
    """
    gh, gw = grid.shape
    gx = (x - meta[1, 0]) / meta[2, 0] + meta[0, 0]
    gy = (y - meta[1, 1]) / meta[2, 1] + meta[0, 1]
    gx = jnp.clip(gx, 0.0, gw - 1.0)
    gy = jnp.clip(gy, 0.0, gh - 1.0)
    ix = jnp.clip(jnp.floor(gx), 0, max(gw - 2, 0)).astype(jnp.int32)
    iy = jnp.clip(jnp.floor(gy), 0, max(gh - 2, 0)).astype(jnp.int32)
    fx = gx - ix
    fy = gy - iy
    ix1 = jnp.minimum(ix + 1, gw - 1)
    iy1 = jnp.minimum(iy + 1, gh - 1)
    v00 = grid[iy, ix]
    v01 = grid[iy, ix1]
    v10 = grid[iy1, ix]
    v11 = grid[iy1, ix1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _pixmap_compose(u, v, cd1, A, B_, M, icd2, AP2, BP2, A2, B2,
                    tab1, tab2, crpix1, crpix2, *,
                    sip_mode, sip2_mode, tab_modes=(False,) * 4):
    """The shared WCS composition on (broadcastable) crpix-relative
    coordinate arrays: (d2im → forward SIP + cpdis) → tangent → exact
    3x3 tangent-plane homography → inverse tangent (inverse SIP /
    Picard over the total correction incl. lookup tables). Returns
    crpix2-relative coordinates of the same broadcast shape.

    ``tab1``/``tab2`` are 6-tuples (d2im_x, d2im_y, d2im_meta,
    cpdis_x, cpdis_y, cpdis_meta) of grid arrays + metas (placeholders
    when the static ``tab_modes`` = (d2im1, cpdis1, d2im2, cpdis2)
    flags say absent).
    """
    d2im1_on, cpdis1_on, d2im2_on, cpdis2_on = tab_modes

    def fwd_offsets(uu, vv, cd_a, cd_b, tab, d2im_on, cpdis_on, crpix):
        """host TanWCS._focal_offsets on crpix-relative coords."""
        if d2im_on:
            x = uu + crpix[0]
            y = vv + crpix[1]
            uu = uu + _grid_sample_j(tab[0], tab[2], x, y)
            vv = vv + _grid_sample_j(tab[1], tab[2], x, y)
        du = dv = None
        if cd_a is not None:
            du = _poly2d_j(cd_a, uu, vv)
            dv = _poly2d_j(cd_b, uu, vv)
        if cpdis_on:
            x = uu + crpix[0]
            y = vv + crpix[1]
            cdx = _grid_sample_j(tab[3], tab[5], x, y)
            cdy = _grid_sample_j(tab[4], tab[5], x, y)
            du = cdx if du is None else du + cdx
            dv = cdy if dv is None else dv + cdy
        if du is not None:
            uu, vv = uu + du, vv + dv
        return uu, vv

    u, v = fwd_offsets(u, v, A if sip_mode else None,
                       B_ if sip_mode else None, tab1,
                       d2im1_on, cpdis1_on, crpix1)
    d2r = jnp.float32(np.pi / 180.0)
    x = (cd1[0, 0] * u + cd1[0, 1] * v) * d2r
    y = (cd1[1, 0] * u + cd1[1, 1] * v) * d2r
    w0 = M[0, 0] + M[0, 1] * x + M[0, 2] * y
    xi2 = (M[1, 0] + M[1, 1] * x + M[1, 2] * y) / w0 / d2r
    eta2 = (M[2, 0] + M[2, 1] * x + M[2, 2] * y) / w0 / d2r
    up = icd2[0, 0] * xi2 + icd2[0, 1] * eta2
    vp = icd2[1, 0] * xi2 + icd2[1, 1] * eta2
    tab2_on = d2im2_on or cpdis2_on
    if sip2_mode == "inverse" and not tab2_on:
        u2 = up + _poly2d_j(AP2, up, vp)
        v2 = vp + _poly2d_j(BP2, up, vp)
    elif sip2_mode in ("newton", "inverse") or tab2_on:
        # fixed-trip Picard over the TOTAL forward correction (SIP +
        # tables), seeded by AP/BP when available — mirrors
        # TanWCS.tangent_to_pixel
        if sip2_mode == "inverse":
            u2 = up + _poly2d_j(AP2, up, vp)
            v2 = vp + _poly2d_j(BP2, up, vp)
        else:
            u2, v2 = up, vp
        sip2_on = sip2_mode == "newton"
        for _ in range(3):
            fu, fv = fwd_offsets(u2, v2, A2 if sip2_on else None,
                                 B2 if sip2_on else None, tab2,
                                 d2im2_on, cpdis2_on, crpix2)
            u2 = u2 - (fu - up)
            v2 = v2 - (fv - vp)
    else:
        u2, v2 = up, vp
    return u2, v2


@functools.partial(
    jax.jit, static_argnames=("shape", "sip_mode", "sip2_mode",
                              "tab_modes"))
def _pixmap_device_core(crpix1, cd1, A, B_, M, icd2, AP2, BP2, A2, B2,
                        crpix2, *tabs_blc, shape, sip_mode, sip2_mode,
                        tab_modes=(False,) * 4):
    """One jitted program; cached per (shape, SIP/table configuration)."""
    *tabs, blc = tabs_blc
    tab1, tab2 = (tuple(tabs[:6]), tuple(tabs[6:12])) if tabs else (
        (None,) * 6, (None,) * 6)
    h, w = shape
    yy = (jnp.arange(h, dtype=jnp.float32)[:, None]
          + blc[0].astype(jnp.float32))
    xx = (jnp.arange(w, dtype=jnp.float32)[None, :]
          + blc[1].astype(jnp.float32))
    u = xx - crpix1[0]
    v = yy - crpix1[1]
    u2, v2 = _pixmap_compose(u, v, cd1, A, B_, M, icd2, AP2, BP2, A2, B2,
                             tab1, tab2, crpix1, crpix2,
                             sip_mode=sip_mode, sip2_mode=sip2_mode,
                             tab_modes=tab_modes)
    return (jnp.broadcast_to(u2 + crpix2[0], shape),
            jnp.broadcast_to(v2 + crpix2[1], shape))


@functools.partial(
    jax.jit, static_argnames=("shape", "sip_mode", "sip2_mode",
                              "tab_modes"))
def _cutout_pixmaps_device_core(crpix1, cd1, A, B_, M, icd2, AP2, BP2,
                                A2, B2, crpix2, *tabs_blc, shape,
                                sip_mode, sip2_mode,
                                tab_modes=(False,) * 4):
    """Batched per-cutout pixmaps: ``blc`` is (N, 2) float32 (x0, y0)
    cutout origins; returns (N, h, w) coordinate pairs."""
    *tabs, blc = tabs_blc
    tab1, tab2 = (tuple(tabs[:6]), tuple(tabs[6:12])) if tabs else (
        (None,) * 6, (None,) * 6)
    h, w = shape
    yy = jnp.arange(h, dtype=jnp.float32)[None, :, None]
    xx = jnp.arange(w, dtype=jnp.float32)[None, None, :]
    u = xx + blc[:, 0, None, None] - crpix1[0]
    v = yy + blc[:, 1, None, None] - crpix1[1]
    u2, v2 = _pixmap_compose(u, v, cd1, A, B_, M, icd2, AP2, BP2, A2, B2,
                             tab1, tab2, crpix1, crpix2,
                             sip_mode=sip_mode, sip2_mode=sip2_mode,
                             tab_modes=tab_modes)
    N = blc.shape[0]
    return (jnp.broadcast_to(u2 + crpix2[0], (N, h, w)),
            jnp.broadcast_to(v2 + crpix2[1], (N, h, w)))


@functools.partial(
    jax.jit, static_argnames=("shape", "sip_mode", "sip2_mode",
                              "tab_modes"))
def _cutout_pixmaps_stack_core(params, blc, *, shape, sip_mode,
                               sip2_mode, tab_modes=(False,) * 4):
    """vmap of :func:`_cutout_pixmaps_device_core` over a leading
    exposure axis: params are (E, ...)-stacked, blc is (E, N, 2).
    Returns (E, N, h, w) pairs — ONE dispatch for the whole stack."""
    def one(p, b):
        return _cutout_pixmaps_device_core(
            *p, b, shape=shape, sip_mode=sip_mode, sip2_mode=sip2_mode,
            tab_modes=tab_modes)

    return jax.vmap(one)(params, blc)


def _stacked_wcs_params(wcs_list, to_wcs):
    """(E, ...)-stacked f32 param pack when every WCS shares one SIP
    configuration (and coefficient shapes) — else None (fall back to
    per-frame programs)."""
    packs = [_device_wcs_params(w, to_wcs) for w in wcs_list]
    modes = {(s1, s2) for _, s1, s2 in packs}
    shapes = {tuple(p.shape for p in pk) for pk, _, _ in packs}
    if len(modes) != 1 or len(shapes) != 1:
        return None, None, None
    sip_mode, sip2_cfg = modes.pop()
    stacked = tuple(jnp.stack([pk[i] for pk, _, _ in packs])
                    for i in range(len(packs[0][0])))
    return stacked, sip_mode, sip2_cfg


def compute_cutout_pixmaps_device_stack(wcs_list, to_wcs, blc, shape):
    """:func:`compute_cutout_pixmaps_device` for a whole exposure stack
    in ONE device program instead of one per frame. ``blc`` is (E, N, 2); returns (E, N, h, w)
    pairs, or None when the WCSs mix SIP configurations (caller falls
    back to per-frame calls)."""
    stacked, sip_mode, sip2_cfg = _stacked_wcs_params(wcs_list, to_wcs)
    if stacked is None:
        return None
    sip2_mode, tab_modes = sip2_cfg
    blc_j = jnp.asarray(np.asarray(blc, np.float32))
    statics = dict(shape=tuple(shape), sip_mode=sip_mode,
                   sip2_mode=sip2_mode, tab_modes=tab_modes)
    from .aot import get_executable

    exe = get_executable("cutout_pixmaps_stack",
                         _cutout_pixmaps_stack_core,
                         (stacked, blc_j), statics=statics)
    if exe is not None:
        return exe(stacked, blc_j)
    return _cutout_pixmaps_stack_core(stacked, blc_j, **statics)


@functools.partial(
    jax.jit, static_argnames=("shape", "sip_mode", "sip2_mode",
                              "tab_modes"))
def _pixmap_stack_core(params, *, shape, sip_mode, sip2_mode,
                       tab_modes=(False,) * 4):
    zero = jnp.zeros((2,), jnp.float32)

    def one(p):
        return _pixmap_device_core(*p, zero, shape=shape,
                                   sip_mode=sip_mode,
                                   sip2_mode=sip2_mode,
                                   tab_modes=tab_modes)

    return jax.vmap(one)(params)


def compute_pixmap_device_stack(wcs_list, to_wcs, shape):
    """:func:`compute_pixmap_device` for a whole same-shape exposure
    stack in ONE device program. Returns (E, H, W) pairs or None when
    the WCSs mix SIP configurations."""
    stacked, sip_mode, sip2_cfg = _stacked_wcs_params(wcs_list, to_wcs)
    if stacked is None:
        return None
    sip2_mode, tab_modes = sip2_cfg
    return _pixmap_stack_core(stacked, shape=tuple(shape),
                              sip_mode=sip_mode, sip2_mode=sip2_mode,
                              tab_modes=tab_modes)


def _grid_params(w: TanWCS):
    """(6 f32 arrays, (d2im_on, cpdis_on)) table pack for one WCS."""
    f32 = lambda a: jnp.asarray(np.asarray(a), jnp.float32)  # noqa: E731
    z1 = f32(np.zeros((1, 1), np.float32))
    zm = f32(np.zeros((3, 2), np.float32))
    out, flags = [], []
    for g in (w.d2im, w.cpdis):
        if g is None:
            out += [z1, z1, zm]
            flags.append(False)
        else:
            meta = f32(np.array([g.crpix, g.crval, g.cdelt], np.float64))
            gx = z1 if g.data_x is None else f32(g.data_x)
            gy = z1 if g.data_y is None else f32(g.data_y)
            out += [gx, gy, meta]
            flags.append(True)
    return out, tuple(flags)


def _device_wcs_params(from_wcs: TanWCS, to_wcs: TanWCS):
    """f32 parameter pack + static SIP/table modes for the device
    pixmap cores. Returns (params, sip_mode, (sip2_mode, tab_modes))
    — the third element is the static inverse/table configuration.

    When ``to_wcs`` carries lookup tables, the inverse runs the Picard
    loop over the total correction with the FORWARD SIP (sip2_mode
    'newton') even if AP/BP exist — mirroring
    ``TanWCS.tangent_to_pixel`` up to the AP/BP seeding (f32 device
    grids are mpix-class; the seed difference is far below that).
    """
    from .wcs.wcs import tangent_homography

    f32 = lambda a: jnp.asarray(np.asarray(a), jnp.float32)  # noqa: E731
    z1 = np.zeros((1, 1), np.float32)
    sip_mode = from_wcs.a is not None
    tabs1, flags1 = _grid_params(from_wcs)
    tabs2, flags2 = _grid_params(to_wcs)
    to_tables = any(flags2)
    if to_wcs.a is None:
        sip2_mode = "none"
    elif to_wcs.ap is not None and not to_tables:
        sip2_mode = "inverse"
    else:
        sip2_mode = "newton"
    M = tangent_homography(from_wcs.crval, to_wcs.crval)
    params = (
        f32(from_wcs.crpix), f32(from_wcs.cd),
        f32(from_wcs.a if sip_mode else z1),
        f32(from_wcs.b if sip_mode else z1),
        f32(M), f32(np.linalg.inv(to_wcs.cd)),
        f32(to_wcs.ap if sip2_mode == "inverse" else z1),
        f32(to_wcs.bp if sip2_mode == "inverse" else z1),
        f32(to_wcs.a if sip2_mode == "newton" else z1),
        f32(to_wcs.b if sip2_mode == "newton" else z1),
        f32(to_wcs.crpix),
        *tabs1, *tabs2,
    )
    return params, sip_mode, (sip2_mode, flags1 + flags2)


def compute_pixmap_device(
    from_wcs: TanWCS,
    to_wcs: TanWCS,
    shape: tuple[int, int],
    blc: tuple[int, int] = (0, 0),
):
    """:func:`compute_pixmap` evaluated ON DEVICE in float32.

    Same composition (pixel -> tangent incl. SIP -> exact 3x3 tangent
    homography -> pixel), as ONE jitted program whose WCS parameters are
    dynamic array inputs — a single compilation (per shape / SIP order)
    serves every WCS. Accuracy vs the float64 host path is mpix-class
    (float32 ulp at 4096 px is ~0.5 mpix) — ample for drizzle DEPOSIT
    grids, whose kernels are smooth at that scale; see
    :func:`compute_cutout_pixmaps_device` for the measurement-geometry
    accuracy discussion. Returns float32 jax arrays.
    """
    params, sip_mode, (sip2_mode, tab_modes) = _device_wcs_params(
        from_wcs, to_wcs)
    return _pixmap_device_core(
        *params, jnp.asarray(np.asarray(blc, np.float32)),
        shape=tuple(shape), sip_mode=sip_mode, sip2_mode=sip2_mode,
        tab_modes=tab_modes)


def compute_cutout_pixmaps_device(
    from_wcs: TanWCS,
    to_wcs: TanWCS,
    blc,
    shape: tuple[int, int],
):
    """Batched per-cutout pixmaps evaluated ON DEVICE in float32.

    ``blc`` is an (N, 2) array of per-cutout (x0, y0) origins in
    ``from_wcs``'s pixel frame; returns (N, h, w) float32 coordinate
    pairs into ``to_wcs``'s frame — the align loop's per-source blot
    geometry, built without the host float64 grid evaluation that
    dominated setup time (VERDICT r2 weak #2: ~0.8 s/Mpix on one CPU vs
    ~ms on device).

    Accuracy: the float32 composition carries ~5 ulp of the output
    coordinate (≈0.3 mpix at a 1k reference frame, ≈1.2 mpix at 4k),
    smooth and common-mode across each 64 px cutout — it perturbs a
    source's measured position by far less than the fit's statistical
    noise floor. Jacobians are NOT derived from these f32 grids (central
    differences would amplify the rounding); the align setup computes
    them from float64 host WCS evaluations at the N cutout centers.
    Pass ``AlignConfig(cutout_pixmaps='host')`` for the exact float64
    geometry.
    """
    params, sip_mode, (sip2_mode, tab_modes) = _device_wcs_params(
        from_wcs, to_wcs)
    blc_j = jnp.asarray(np.asarray(blc, np.float32))
    return _cutout_pixmaps_device_core(
        *params, blc_j, shape=tuple(shape), sip_mode=sip_mode,
        sip2_mode=sip2_mode, tab_modes=tab_modes)


def blot_image(
    ref_data,
    pixmap_x,
    pixmap_y,
    interp: str = "poly5",
    expout: float = 1.0,
    fill: float = 0.0,
    sinscl: float = 1.0,
):
    """Sample ``ref_data`` at pixmap coordinates (device gather).

    ``expout`` rescales output flux for exposure-time units and
    ``sinscl`` scales the sinc interpolant (parity with ``do_blot``'s
    expout/sinscl handling). Returns (blotted, valid_mask).
    """
    vals, valid = sample_image(
        jnp.asarray(ref_data, jnp.float32),
        jnp.asarray(pixmap_x, jnp.float32),
        jnp.asarray(pixmap_y, jnp.float32),
        interp=interp,
        fill=fill,
        sinscl=sinscl,
    )
    if expout != 1.0:
        vals = vals * jnp.float32(expout)
    return vals, valid


def blot_cutout(source_cutout, image_cutout, interp: str = "poly5",
                expout: float | None = None, sinscl: float = 1.0):
    """Blot a reference-frame cutout onto an exposure cutout's grid.

    Parity: reference ``blot.blot_cutout(source_cutout, image,
    interp='poly5', sinscl=1.0)``. Both arguments are
    :class:`subpixal_tpu.cutout.Cutout` objects; the source
    (primary/reference) cutout's data is interpolated onto the image
    cutout's pixel grid using their WCSs. Returns a new Cutout in the
    image cutout's frame.

    ``expout``: output exposure-time scaling (``do_blot``'s expout).
    When None it is DERIVED from the units: a rate-units source blotted
    onto a counts-units image cutout is multiplied by the image's
    exptime so the pair is unit-consistent (and vice versa divided).
    ``sinscl`` scales the sinc interpolant's kernel width (only used by
    ``interp='sinc'``).
    """
    from .cutout import Cutout  # local import to avoid cycle

    px, py = compute_pixmap(
        image_cutout.wcs, source_cutout.wcs,
        image_cutout.data.shape, blc=(0, 0),
    )
    if expout is None:
        src_u = getattr(source_cutout, "data_units", "rate")
        img_u = getattr(image_cutout, "data_units", "rate")
        if src_u == "rate" and img_u == "counts":
            scale = float(image_cutout.exptime)
        elif src_u == "counts" and img_u == "rate":
            scale = 1.0 / max(float(source_cutout.exptime), 1e-30)
        elif src_u == "counts" and img_u == "counts":
            # counts -> counts still rescales when the exptimes differ
            # (a 100 s reference blotted onto a 300 s exposure must be
            # 3x brighter to compare amplitude-consistently)
            scale = (float(image_cutout.exptime)
                     / max(float(source_cutout.exptime), 1e-30))
        else:
            scale = 1.0
        out_units = img_u
    else:
        scale = float(expout)
        out_units = source_cutout.data_units
    vals, valid = blot_image(source_cutout.data, px, py, interp=interp,
                             expout=scale, sinscl=sinscl)
    return Cutout(
        data=np.asarray(vals),
        wcs=image_cutout.wcs.copy(),
        blc=image_cutout.blc,
        src_pos=image_cutout.src_pos,
        mask=np.asarray(valid) & np.asarray(image_cutout.mask, bool),
        exptime=image_cutout.exptime,
        data_units=out_units,
    )
