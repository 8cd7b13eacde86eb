"""Batched FFT cross-correlation and subpixel displacement.

Capability parity with the reference's ``subpixal/cc.py · find_displacement``
(see SURVEY.md §2 #4, §3.4): plain (``'CC'``) and normalized (``'NCC'`` /
``'ZNCC'``) FFT cross-correlation of cutout pairs, optional Fourier-domain
(matrix-DFT) upsampling of the correlation peak region for sub-pixel
precision (Guizar-Sicairos & Fienup style), and a quadratic/Gaussian
surface peak fit.

Device-first redesign (not a port):

* everything is **batched** over a leading cutout axis — one ``rfft2`` /
  ``irfft2`` pair processes the whole catalog of cutouts at once;
* the Fourier upsampling is expressed as shared-operand **matmuls over
  the whole batch** (``K2y @ G @ K2xᵀ``), which XLA hands to the matrix
  units;
* upsampling kernel phases are computed with an exact integer-mod split
  (integer coarse shift handled in int32 modular arithmetic, fractional
  offsets kept small) so float32 is sufficient for <0.01-pix precision
  — accelerators have no fast float64;
* masked NCC statistics use fixed shapes and validity masks instead of
  data-dependent trimming.

Sign convention
---------------
``find_displacement(ref, img)`` returns ``(dx, dy)`` such that ``img`` is
``ref`` **shifted by** ``(dx, dy)``: ``img[y, x] ≈ ref[y - dy, x - dx]``.
Applying the correction ``-(dx, dy)`` to ``img``'s coordinates aligns it to
``ref`` (the same convention the reference feeds into its linear fit).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .peaks import find_peak, normalize_search_box

__all__ = ["cross_correlate", "find_displacement", "Displacement"]

_P = jax.lax.Precision.HIGHEST
import os as _os

#: forward matmul-DFT precision (the opt-in matmul-DFT and packed
#: paths only). HIGHEST: on the H100 the forward DFTs at HIGH measured
#: 0.2472 mpix RMS vs the f64 reference on the 500x64² workload —
#: outside the 0.1 mpix gate — and 0.011-0.012 mpix at HIGHEST
#: (PERF.md). Override with SUBPIXAL_TPU_FWD_PRECISION=high|default
#: (read at import).
_P_FWD = {
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}.get(_os.environ.get("SUBPIXAL_TPU_FWD_PRECISION", "").lower(),
      jax.lax.Precision.HIGHEST)


def _fwd_einsum(pattern: str, C, X):
    """Forward-DFT contraction at the configured precision."""
    return jnp.einsum(pattern, C, X, precision=_P_FWD)


#: read-out contraction precision (upsampled window / windowed coarse
#: lags). HIGHEST (full float32) is the default: these matmuls set the
#: final sub-pixel precision (<0.01-pix target). Override with
#: SUBPIXAL_TPU_READOUT_PRECISION=high|default (read at trace time).
_P_READOUT = {
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}.get(_os.environ.get("SUBPIXAL_TPU_READOUT_PRECISION", "").lower(),
      jax.lax.Precision.HIGHEST)

#: COARSE windowed-surface precision. The windowed coarse lags feed ONLY
#: an integer argmax — a relative surface error of eps cannot flip the
#: argmax between lags unless two lag values agree to ~eps of the
#: surface scale, in which case they straddle the true peak and either
#: choice keeps the true peak inside the ±(nwin/2)/usfac upsampled
#: window (a flip to a FAR lag needs a far value within eps of the
#: peak — a near-flat surface no precision tier measures meaningfully).
#: The argument holds for any eps far below the peak contrast: bf16
#: (eps ≈ 2^-8) and, a fortiori, TF32 (eps ≈ 2^-11, what DEFAULT gives a
#: float32 product on the H100). ``chip_smoke.py``'s displacement gate
#: (rmse vs the f64 reference < 0.1 mpix) checks it on the card. The
#: subpixel read-out (_P_READOUT) stays HIGHEST; this knob only affects
#: which integer lag the refinement window is centered on. Override
#: with SUBPIXAL_TPU_COARSE_PRECISION=high|highest (read at trace time).
_P_COARSE = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
}.get(_os.environ.get("SUBPIXAL_TPU_COARSE_PRECISION", "").lower(),
      jax.lax.Precision.DEFAULT)


class Displacement(NamedTuple):
    """Batched displacement measurement.

    dx, dy : (B,) float32 — shift of ``img`` relative to ``ref`` (pixels).
    peak : (B,) float32 — correlation peak value (≈ correlation coefficient
        for NCC inputs).
    fit_ok : (B,) bool — subpixel fit succeeded (False = integer fallback).
    """

    dx: jax.Array
    dy: jax.Array
    peak: jax.Array
    fit_ok: jax.Array


def _atleast_batched(a):
    return (a[None], True) if a.ndim == 2 else (a, False)


def _normalize(a: jax.Array, mask: jax.Array | None, cc_type: str) -> jax.Array:
    """Prepare one side of the correlation according to ``cc_type``.

    'CC'   : raw data (masked pixels zeroed).
    'NCC'/'ZNCC' : subtract masked mean, scale by masked std and sqrt(N) so
        that the correlation peak of identical cutouts is ~1. Zero-filled
        outside the mask. Matches the reference's normalized correlation
        semantics (gain/offset invariant) with mask-aware statistics
        (SURVEY.md §7 "Fixed shapes under jit").
    """
    a = a.astype(jnp.float32)
    if mask is None:
        m = jnp.ones_like(a)
    else:
        m = jnp.broadcast_to(mask, a.shape).astype(jnp.float32)
    a = a * m
    if cc_type == "CC":
        return a
    if cc_type in ("NCC", "ZNCC"):
        n = jnp.maximum(jnp.sum(m, axis=(-2, -1), keepdims=True), 1.0)
        mean = jnp.sum(a, axis=(-2, -1), keepdims=True) / n
        d = (a - mean) * m
        var = jnp.sum(d * d, axis=(-2, -1), keepdims=True) / n
        sigma = jnp.sqrt(jnp.maximum(var, 1e-20))
        return d / (sigma * jnp.sqrt(n))
    raise ValueError(f"unknown cc_type: {cc_type!r} (expected 'CC'|'NCC'|'ZNCC')")


# --------------------------------------------------------------------- #
# matmul-DFT transforms (opt-in: SUBPIXAL_TPU_FFT=matmul)
#
# At cutout sizes the batched rfft2/irfft2 can be evaluated as real
# matmul passes against precomputed cos/sin matrices (agreement with
# jnp.fft is ~1e-6 relative at HIGHEST). On the GPU the default is
# cuFFT (jnp.fft); PERF.md holds the H100 timings of both. The matmul
# form only applies up to max(H, W) <= _MATMUL_DFT_MAX.
# --------------------------------------------------------------------- #

_MATMUL_DFT_MAX = 128


@functools.lru_cache(maxsize=8)
def _dft_consts(H: int, W: int):
    import numpy as np

    Wr = W // 2 + 1
    k = np.arange(Wr)[:, None]
    n = np.arange(W)[None, :]
    ang = 2.0 * np.pi * k * n / W
    CW = np.cos(ang)                     # (Wr, W): forward real part
    SW = -np.sin(ang)                    # forward imag part (e^{-i...})
    g = np.arange(H)[:, None]
    hh = np.arange(H)[None, :]
    angH = 2.0 * np.pi * g * hh / H
    CH = np.cos(angH)
    SH = -np.sin(angH)
    # inverse: hermitian weights fold the missing half-spectrum
    wk = np.full((Wr, 1), 2.0)
    wk[0] = 1.0
    if W % 2 == 0:
        wk[-1] = 1.0
    CWi = (np.cos(ang) * wk) / W         # (Wr, W), e^{+i...}
    SWi = (np.sin(ang) * wk) / W
    CHi = np.cos(angH) / H
    SHi = np.sin(angH) / H
    # only the STACKED re/im matrices are consumed: one matmul produces
    # both parts (halves the matmul count)
    CWS = np.concatenate([CW, SW], 0)    # (2Wr, W): forward W-pass
    CHS = np.concatenate([CH, SH], 0)    # (2H, H): forward H-pass
    CHSi = np.concatenate([CHi, SHi], 0)   # inverse H-pass
    CWSi = np.concatenate([CWi, -SWi], 0)  # (2Wr, W): real-output pass
    # cache NUMPY constants: jnp arrays materialized during a trace are
    # tracer-bound and must not be memoized across traces
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return tuple(map(f32, (CWS, CHS, CHSi, CWSi, CH, SH, CH + SH)))


def _use_matmul_dft(H: int, W: int) -> bool:
    """Whether (H, W) transforms take the matmul-DFT path: only under
    ``SUBPIXAL_TPU_FFT=matmul`` and up to :data:`_MATMUL_DFT_MAX`.

    The variable is consulted at TRACE time: the choice is baked into
    each jit / persistent-cache entry, so set it BEFORE the first
    displacement call for a given shape — toggling it mid-process does
    not retrace already-compiled shapes.
    """
    import os

    return (os.environ.get("SUBPIXAL_TPU_FFT", "").lower() == "matmul"
            and max(H, W) <= _MATMUL_DFT_MAX)


def _rfft2_matmul(x: jax.Array):
    """Batched rfft2 as matmul passes; returns (re, im).

    W-pass: one real matmul against [CW; SW] gives [Xr | Xi] along the
    last axis (real input, already minimal). H-pass: the complex product
    (CH + iSH) @ (Xr + iXi) via the KARATSUBA 3-multiply split::

        P1 = CH @ Xr;  P2 = SH @ Xi;  P3 = (CH + SH) @ (Xr + Xi)
        Yr = P1 - P2;  Yi = P3 - P1 - P2

    — 3/4 the MAC count of the stacked [CH; SH] @ [Xr | Xi] form
    (405 vs 540 MFLOP logical at 500x64^2). The extra combines are
    elementwise and fuse into the consumers. Exact arithmetic identical;
    f32 rounding differs by ~1 ulp-class terms.
    """
    H, W = x.shape[-2:]
    Wr = W // 2 + 1
    consts = _dft_consts(H, W)
    CWS, CH, SH, CHpS = consts[0], consts[4], consts[5], consts[6]
    X = _fwd_einsum("kw,...hw->...hk", CWS, x)               # [Xr|Xi]
    Xr, Xi = X[..., :Wr], X[..., Wr:]
    P1 = _fwd_einsum("gh,...hk->...gk", CH, Xr)
    P2 = _fwd_einsum("gh,...hk->...gk", SH, Xi)
    P3 = _fwd_einsum("gh,...hk->...gk", CHpS, Xr + Xi)
    return P1 - P2, P3 - P1 - P2


def _irfft2_matmul(Gr: jax.Array, Gi: jax.Array, s: tuple[int, int]):
    """Batched irfft2 of an rfft half-spectrum as two stacked passes."""
    H, W = s
    Wr = W // 2 + 1
    CHSi, CWSi = _dft_consts(H, W)[2:4]
    G = jnp.concatenate([Gr, Gi], axis=-1)                  # (..., H, 2Wr)
    Q = jnp.einsum("gh,...hk->...gk", CHSi, G, precision=_P)
    Zr = Q[..., :H, :Wr] - Q[..., H:, Wr:]   # CHi@Gr - SHi@Gi
    Zi = Q[..., :H, Wr:] + Q[..., H:, :Wr]   # CHi@Gi + SHi@Gr
    # final W-pass: real output only -> stacked [CWi; -SWi] over k
    ZZ = jnp.concatenate([Zr, Zi], axis=-1)                 # (..., H, 2Wr)
    return jnp.einsum("...hk,kw->...hw", ZZ, CWSi, precision=_P)


def _irfft2(G: jax.Array, s: tuple[int, int]) -> jax.Array:
    if _use_matmul_dft(*s):
        return _irfft2_matmul(jnp.real(G), jnp.imag(G), s)
    return jnp.fft.irfft2(G, s=s)


def _rfft2_parts(x: jax.Array):
    """(re, im) rfft2 via the matmul-DFT when gated on, else jnp.fft."""
    if _use_matmul_dft(*x.shape[-2:]):
        return _rfft2_matmul(x)
    F = jnp.fft.rfft2(x)
    return jnp.real(F), jnp.imag(F)


def _spectral_ncc_product(ref, img):
    """Unmasked-NCC cross-spectrum computed ENTIRELY in the Fourier domain.

    For mask-free NCC/ZNCC the spatial normalize stage is algebraically
    redundant: subtracting the mean only zeroes the DC bin (the spectrum
    of ``a - mean(a)`` equals that of ``a`` away from (0, 0)), and the
    per-side scale ``1/(sigma*sqrt(n))`` follows from Parseval on the
    DC-free half-spectrum power ``P = sum_k w_k |X_k|^2 - X_00^2``
    (``w_k`` the hermitian fold weights): ``sigma*sqrt(n) = sqrt(P/n)``.
    So the raw cutouts go STRAIGHT into the forward matmul-DFT and the
    whole normalize stage — two extra passes over the cutout batch —
    disappears. Matches :func:`_normalize`'s semantics exactly in exact
    arithmetic (reference parity: `subpixal/cc.py · build_cc_image`
    normalized correlation).
    """
    H, W = ref.shape[-2:]
    n = float(H * W)
    Rr, Ri = _rfft2_parts(ref.astype(jnp.float32))
    Ir, Ii = _rfft2_parts(img.astype(jnp.float32))
    wk = _hermitian_weights(W)

    def dc_free_power(Xr, Xi):
        p = jnp.sum(wk * (Xr * Xr + Xi * Xi), axis=(-2, -1))
        return p - Xr[..., 0, 0] ** 2      # X_00 is real for real input

    # 1/(sigma*sqrt(n)) per side, combined; rsqrt'd separately so huge-
    # amplitude cutouts cannot overflow the f32 product of powers
    scale = (n * jax.lax.rsqrt(jnp.maximum(dc_free_power(Rr, Ri), 1e-20))
             * jax.lax.rsqrt(jnp.maximum(dc_free_power(Ir, Ii), 1e-20)))
    scale = scale[..., None, None]
    Gr = (Ir * Rr + Ii * Ri) * scale
    Gi = (Ii * Rr - Ir * Ri) * scale
    # both sides' means subtracted => the DC bin vanishes (Gi_00 already
    # is 0: both imaginary parts are 0 at DC)
    Gr = Gr.at[..., 0, 0].set(0.0)
    return jax.lax.complex(Gr, Gi)


def _cross_spectrum(ref, img, cc_type, ref_mask, img_mask):
    """G = fft2(img) * conj(fft2(ref)) for normalized inputs, via rfft2.

    Mask-free NCC/ZNCC takes the spectral-normalization path
    (:func:`_spectral_ncc_product`) — no spatial normalize pass at all.
    """
    if (cc_type in ("NCC", "ZNCC") and ref_mask is None
            and img_mask is None):
        return _spectral_ncc_product(ref, img)
    r = _normalize(ref, ref_mask, cc_type)
    i = _normalize(img, img_mask, cc_type)
    if _use_matmul_dft(*r.shape[-2:]):
        Rr, Ri = _rfft2_matmul(r)
        Ir, Ii = _rfft2_matmul(i)
        # (Ir + i Ii) * conj(Rr + i Ri)
        return jax.lax.complex(Ir * Rr + Ii * Ri, Ii * Rr - Ir * Ri)
    Fr = jnp.fft.rfft2(r)
    Fi = jnp.fft.rfft2(i)
    return Fi * jnp.conj(Fr)


def cross_correlate(
    ref: jax.Array,
    img: jax.Array,
    cc_type: str = "NCC",
    ref_mask: jax.Array | None = None,
    img_mask: jax.Array | None = None,
    shift_output: bool = True,
) -> jax.Array:
    """Circular cross-correlation surface(s) of ``img`` against ``ref``.

    Input arrays are ``(B, H, W)`` (or ``(H, W)``). The returned surface is
    fftshifted by default so a zero shift peaks at ``(H//2, W//2)`` and the
    displacement of a peak at ``(py, px)`` is ``(px - W//2, py - H//2)``.
    """
    ref_b, squeeze = _atleast_batched(ref)
    img_b, _ = _atleast_batched(img)
    G = _cross_spectrum(ref_b, img_b, cc_type, ref_mask, img_mask)
    cc = _irfft2(G, s=tuple(ref_b.shape[-2:]))
    if shift_output:
        cc = jnp.fft.fftshift(cc, axes=(-2, -1))
    return cc[0] if squeeze else cc


def _us_dft_kernel(s0: jax.Array, tfrac: jax.Array, nfreq: int, period: int):
    """Complex DFT kernel ``K[b, i, u] = exp(+2πi f_u (s0_b + tfrac_i) / P)``.

    ``s0`` is integer (B,), ``tfrac`` (n,) has small magnitude, ``f_u`` are
    the signed FFT frequencies of an axis of length ``period`` (only the
    first ``nfreq`` entries — supports rfft half-spectra).

    Precision: the integer part of the phase is reduced with exact int32
    modular arithmetic ((f_u * s0) mod P) so float32 only ever sees phases
    of a few cycles; this is what makes float32 viable at 10x
    upsampling (<0.01-pix target, BASELINE config 3).
    """
    f = jnp.fft.fftfreq(period) * period  # signed freqs, float
    f = jnp.round(f).astype(jnp.int32)[:nfreq]  # (U,)
    # exact integer phase (in cycles, mod 1): ((f*s0) mod P) / P
    int_ph = jnp.mod(f[None, :] * s0[:, None].astype(jnp.int32), period)
    int_ph = int_ph.astype(jnp.float32) / period  # (B, U)
    frac_ph = (f.astype(jnp.float32)[None, :] / period) * tfrac[:, None]  # (n, U)
    phase = int_ph[:, None, :] + frac_ph[None, :, :]  # (B, n, U)
    ang = (2.0 * jnp.pi) * (phase - jnp.round(phase))
    return jax.lax.complex(jnp.cos(ang), jnp.sin(ang))


def _us_phase_diag(s0: jax.Array, nfreq: int, period: int) -> jax.Array:
    """Per-cutout diagonal phase ``D[b, u] = exp(+2πi f_u s0_b / P)`` —
    :func:`_us_dft_kernel` at zero fractional offset (one shared int32
    modular-reduction implementation for the numerics-critical phases).
    """
    return _us_dft_kernel(s0, jnp.zeros((1,), jnp.float32), nfreq,
                          period)[:, 0, :]


def _hermitian_weights(W: int) -> jax.Array:
    """(Wr,) fold weights: the missing half-spectrum columns are the
    conjugates of columns 1..W-Wr (with the u axis reversed), and their
    contribution to the REAL correlation equals the real part of the
    half-spectrum term — so weighting the interior columns by 2 (the
    v=0 and, for even W, the Nyquist column are self-conjugate) makes
    any ``Re{Ky @ G_half ⊙ w @ Kxᵀ}`` contraction exact without ever
    materializing the full spectrum (same identity the irfft2 constants
    in :func:`_dft_consts` use)."""
    Wr = W // 2 + 1
    wv = np.full((Wr,), 2.0, np.float32)
    wv[0] = 1.0
    if W % 2 == 0:
        wv[-1] = 1.0
    return jnp.asarray(wv)


def _upsampled_correlation(
    G: jax.Array,
    s0y: jax.Array,
    s0x: jax.Array,
    usfac: int,
    nwin: int,
    H: int,
    W: int,
):
    """Matrix-DFT upsampled correlation window around integer shift (s0y, s0x).

    G : (B, H, Wr) rfft2 cross-spectrum (Wr = W//2+1). Returns the real
    upsampled surface (B, nwin, nwin) sampled at positions
    ``s0 + (i - nwin//2)/usfac`` along each axis, plus those offsets.

    Batched implementation: the naive form is two *per-cutout* complex
    matmuls ``kr_b @ G_b @ kc_b`` — B tiny (nwin, H)×(H, W) products that
    fill the matrix units badly. But the DFT kernel factors exactly::

        kr_b[i, u] = exp(2πi f_u (s0y_b + t_i)/H)
                   = K2y[i, u] · Dy_b[u]

    — a batch-INDEPENDENT window kernel times a per-cutout diagonal
    phase. So the whole batch reduces to one elementwise phase twist of
    the spectrum plus two matmuls with *shared* small operands, which XLA
    fuses into two large contractions over the flattened batch::

        C = Re{ K2y @ (Dy_b ⊙ G ⊙ w_v ⊙ Dx_b) @ K2xᵀ }

    (~20× less device time than the per-cutout-matmul form at B=500),
    operating directly on the HALF spectrum via the hermitian fold
    weights ``w_v`` (:func:`_hermitian_weights`) — the round-2 version
    materialized the full (B, H, W) spectrum with flip/roll first,
    doubling both the contraction width and the HBM traffic.
    """
    Wr = G.shape[-1]
    tf = (jnp.arange(nwin, dtype=jnp.float32) - nwin // 2) / usfac
    zero = jnp.zeros((1,), jnp.int32)
    K2y = _us_dft_kernel(zero, tf, H, H)[0]    # (nwin, H), batch-free
    K2x = _us_dft_kernel(zero, tf, Wr, W)[0]   # (nwin, Wr)
    Dy = _us_phase_diag(s0y, H, H)             # (B, H)
    Dx = _us_phase_diag(s0x, Wr, W)            # (B, Wr)

    # per-cutout integer-shift phase twist + fold weights (elementwise)
    Gd = G * Dy[:, :, None] * (Dx * _hermitian_weights(W))[:, None, :]

    # two shared-operand contractions over the whole batch.
    # Precision.HIGHEST: full f32 accumulation — these matmuls set the
    # upsampled-correlation subpixel precision (<0.01 pix target).
    # Stage 1 is the complex product K2y @ Gd via the Karatsuba
    # 3-multiply split (3/4 the MACs of the 4 real block products a
    # complex einsum lowers to); stage 2 is written in explicit real
    # arithmetic: only Re(C) is consumed, so its imaginary half (which
    # a complex einsum would also compute) is never formed.
    P = _P_READOUT
    Kyr, Kyi = jnp.real(K2y), jnp.imag(K2y)
    Gdr, Gdi = jnp.real(Gd), jnp.imag(Gd)
    P1 = jnp.einsum("iu,buv->biv", Kyr, Gdr, precision=P)
    P2 = jnp.einsum("iu,buv->biv", Kyi, Gdi, precision=P)
    P3 = jnp.einsum("iu,buv->biv", Kyr + Kyi, Gdr + Gdi, precision=P)
    C = (jnp.einsum("jv,biv->bij", jnp.real(K2x), P1 - P2, precision=P)
         - jnp.einsum("jv,biv->bij", jnp.imag(K2x), P3 - P1 - P2,
                      precision=P))
    off_y = s0y.astype(jnp.float32) - (nwin // 2) / usfac
    off_x = s0x.astype(jnp.float32) - (nwin // 2) / usfac
    return C / (H * W), off_y, off_x


#: largest search-window side evaluated via the windowed matrix-DFT
#: instead of the full inverse transform (the coarse argmax with the
#: default 'fitbox' confinement needs only a handful of lags, so the
#: full irfft2 — the displacement pipeline's single largest stage,
#: ~35% measured — is skipped entirely)
_WINDOWED_COARSE_MAX = 17


def _windowed_coarse_surface(G, bounds, H: int, W: int):
    """Correlation values at the integer lags inside ``bounds`` only.

    ``bounds`` = (r0, r1, c0, c1) on the fftshifted surface. Returns
    (C, lag_y0, lag_x0, ny, nx): C is (B, ny, nx) with
    ``C[b, i, j] = cc[b, lag_y0 + i, lag_x0 + j]`` in signed-lag space —
    a direct half-spectrum matrix-DFT (hermitian fold), evaluating
    ny·nx lags instead of the full H·W inverse transform.
    """
    r0, r1, c0, c1 = bounds
    ny, nx = r1 - r0, c1 - c0
    lag_y0 = r0 - H // 2
    lag_x0 = c0 - W // 2
    Wr = G.shape[-1]
    zero = jnp.zeros((1,), jnp.int32)
    ty = jnp.arange(ny, dtype=jnp.float32) + lag_y0
    tx = jnp.arange(nx, dtype=jnp.float32) + lag_x0
    Ky = _us_dft_kernel(zero, ty, H, H)[0]    # (ny, H)
    Kx = _us_dft_kernel(zero, tx, Wr, W)[0]   # (nx, Wr)
    Gw = G * _hermitian_weights(W)[None, None, :]
    # _P_COARSE (HIGH by default): this surface feeds only the integer
    # argmax — see the _P_COARSE note. Stage 1 via the Karatsuba
    # 3-multiply split, stage 2 real-only (as in _upsampled_correlation).
    P = _P_COARSE
    Kyr, Kyi = jnp.real(Ky), jnp.imag(Ky)
    Gwr, Gwi = jnp.real(Gw), jnp.imag(Gw)
    P1 = jnp.einsum("iu,buv->biv", Kyr, Gwr, precision=P)
    P2 = jnp.einsum("iu,buv->biv", Kyi, Gwi, precision=P)
    P3 = jnp.einsum("iu,buv->biv", Kyr + Kyi, Gwr + Gwi, precision=P)
    C = (jnp.einsum("jv,biv->bij", jnp.real(Kx), P1 - P2, precision=P)
         - jnp.einsum("jv,biv->bij", jnp.imag(Kx), P3 - P1 - P2,
                      precision=P))
    return C / (H * W), lag_y0, lag_x0, ny, nx


def find_displacement(
    ref: jax.Array,
    img: jax.Array,
    cc_type: str = "NCC",
    usfac: int = 1,
    peak_fit_box: int = 5,
    fit_type: str = "quadratic",
    ref_mask: jax.Array | None = None,
    img_mask: jax.Array | None = None,
    peak_search_box="fitbox",
) -> Displacement:
    """Measure the subpixel displacement of ``img`` relative to ``ref``.

    Parity: reference ``subpixal/cc.py · find_displacement`` (SURVEY §3.4).
    Batched: ``ref``/``img`` are ``(B, H, W)`` (or a single ``(H, W)`` pair).

    Parameters
    ----------
    cc_type : 'CC' | 'NCC' | 'ZNCC'
    usfac : int
        Fourier upsampling factor. 1 = subpixel precision from the
        quadratic/Gaussian peak fit alone; >1 adds a matrix-DFT upsampled
        refinement pass around the coarse peak (BASELINE config 3 uses 10).
    peak_fit_box, fit_type
        Passed to :func:`subpixal_tpu.ops.peaks.find_peak`.
    ref_mask, img_mask
        Optional validity masks (True = valid), e.g. segmentation masks
        (reference ``combine_seg_mask=True`` behavior) or cutout padding.
    peak_search_box : None | 'all' | 'fitbox' | int | (r0, r1, c0, c1)
        Confine the COARSE argmax on the centered correlation surface
        (reference ``find_peak(peak_search_box='fitbox')`` semantics,
        SURVEY §2 #5): 'fitbox' searches only a ``peak_fit_box``-sized
        window around ZERO lag, so a far alias/noise peak cannot outvote
        the true near-zero peak on low-SNR cutouts. An int gives the
        window side in pixels of lag; a 4-tuple gives explicit (row,
        col) bounds on the fftshifted surface. The DEFAULT is 'fitbox'
        (reference parity): shifts larger than ~``peak_fit_box/2`` px
        are outside the search window — pass ``None``/``'all'`` (or an
        int window) to measure large displacements.

    Returns
    -------
    Displacement(dx, dy, peak, fit_ok) — see the module sign convention.
    """
    ref_b, squeeze = _atleast_batched(ref)
    img_b, _ = _atleast_batched(img)
    if ref_b.shape != img_b.shape:
        raise ValueError(
            f"ref and img must have the same shape, got {ref_b.shape} vs {img_b.shape}"
        )
    B, H, W = ref_b.shape

    if usfac > 1:
        bounds = normalize_search_box(peak_search_box, H, W, peak_fit_box)
        # Window: cover ±0.5 coarse pixels (= usfac upsampled px) + the
        # fit box, rounded up to a multiple of 8 (aligned tiles).
        # Coverage proof:
        # the true peak lies within usfac/2 upsampled px of the window
        # center and the fit box needs peak_fit_box//2 more;
        # (nwin-1)/2 >= (usfac + peak_fit_box + 1 - 1)/2 covers both.
        nwin = -(-(int(usfac) + int(peak_fit_box) + 1) // 8) * 8
        windowed = (bounds is not None
                    and bounds[1] - bounds[0] <= _WINDOWED_COARSE_MAX
                    and bounds[3] - bounds[2] <= _WINDOWED_COARSE_MAX)
        # batch-minor packed pipeline (deferred NCC scale, stacked
        # readouts — opt-in, SUBPIXAL_TPU_PACKED; parity <2e-5 px with
        # the path below;
        # see :mod:`subpixal_tpu.ops.correlate_packed`). Covers masked
        # and CC calls via a spatial pre-normalize (the align loop always
        # passes masks).
        if windowed:
            from .correlate_packed import find_displacement_packed, use_packed

            if use_packed():
                dx, dy, value, fit_ok = find_displacement_packed(
                    ref_b, img_b, cc_type, int(usfac), int(peak_fit_box),
                    fit_type, bounds, nwin,
                    ref_mask=ref_mask, img_mask=img_mask)
                res = Displacement(dx=dx, dy=dy, peak=value, fit_ok=fit_ok)
                if squeeze:
                    res = Displacement(*(r[0] for r in res))
                return res

    G = _cross_spectrum(ref_b, img_b, cc_type, ref_mask, img_mask)

    if usfac <= 1:
        cc_s = jnp.fft.fftshift(_irfft2(G, s=(H, W)), axes=(-2, -1))
        pk = find_peak(cc_s, peak_fit_box=peak_fit_box, fit_type=fit_type,
                       peak_search_box=peak_search_box)
        dx = pk.x - W // 2
        dy = pk.y - H // 2
        res = Displacement(dx=dx, dy=dy, peak=pk.value, fit_ok=pk.fit_ok)
    else:
        # Coarse integer shift (optionally confined to the search box
        # around zero lag). With a SMALL search window — the 'fitbox'
        # default — the handful of needed lags is evaluated directly
        # from the half-spectrum (windowed matrix-DFT): the full
        # irfft2 + fftshift + whole-surface argmax, the pipeline's
        # single largest stage, is skipped entirely. (`bounds` /
        # `windowed` / `nwin` computed once above, shared with the
        # packed-path gate so the two paths cannot drift.)
        if windowed:
            Cc, ly0, lx0, ny, nx = _windowed_coarse_surface(
                G, bounds, H, W)
            flat = jnp.argmax(Cc.reshape(B, -1), axis=-1)
            s0y = (flat // nx).astype(jnp.int32) + ly0
            s0x = (flat % nx).astype(jnp.int32) + lx0
        else:
            cc_s = jnp.fft.fftshift(_irfft2(G, s=(H, W)), axes=(-2, -1))
            search = cc_s
            if bounds is not None:
                r0, r1, c0, c1 = bounds
                rows = jnp.arange(H)[None, :, None]
                cols = jnp.arange(W)[None, None, :]
                inside = ((rows >= r0) & (rows < r1)
                          & (cols >= c0) & (cols < c1))
                search = jnp.where(inside, search, -jnp.inf)
            flat = jnp.argmax(search.reshape(B, -1), axis=-1)
            s0y = (flat // W).astype(jnp.int32) - H // 2
            s0x = (flat % W).astype(jnp.int32) - W // 2
        C, off_y, off_x = _upsampled_correlation(G, s0y, s0x, int(usfac), nwin, H, W)
        pk = find_peak(C, peak_fit_box=peak_fit_box, fit_type=fit_type)
        dx = off_x + pk.x / usfac
        dy = off_y + pk.y / usfac
        res = Displacement(dx=dx, dy=dy, peak=pk.value, fit_ok=pk.fit_ok)

    if squeeze:
        res = Displacement(*(r[0] for r in res))
    return res
