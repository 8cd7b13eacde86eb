"""Batch-minor ("packed") displacement pipeline — opt-in layout variant.

Same measurement as :func:`subpixal_tpu.ops.correlate.find_displacement`
(reference parity: `subpixal/cc.py · find_displacement`, SURVEY.md §3.4)
for the hot configuration — unmasked NCC/ZNCC, ``usfac > 1``, window-
confined coarse search — rebuilt around three layout ideas:

1. **Batch-minor layout.** Every (H, Wr)-shaped spectral intermediate
   keeps the cutout batch as the MINOR axis — ``(H, Wr, B)`` instead of
   ``(B, H, Wr)`` — so the vector lanes run over the (large) batch
   instead of the short Wr=33 axis.
2. **Stacked-matrix 4-mult readouts.** The static real/imag window
   matrices are stacked ``[Kyr; Kyi]``, doubling the M dimension per
   matmul and replacing the Karatsuba 3-mult complex split (whose third
   operand ``Gr+Gi`` costs an extra pass over a batch-sized array) with
   two single-read einsums. Only static matrices are stacked:
   concatenating *data* operands would materialize a batch-sized copy.
3. **Deferred normalization.** The spectral-NCC scale is a positive
   per-cutout scalar and the DC bin a per-cutout offset; both commute
   with every linear stage downstream. The packed path never scales the
   (H, Wr, B) spectra: the scale multiplies the final peak VALUE only
   (positions, fit_ok, and the argmax are scale-invariant — for the
   Gaussian fit the log-surface is box-max-normalized, for the
   quadratic fit the position is a coefficient ratio), and the DC bin
   is subtracted from the tiny (nwin, nwin, B) window (at zero
   frequency every phase factor is 1, so its contribution to the real
   readout is exactly ``Re G[0,0]``). The coarse argmax skips even the
   subtraction: a per-cutout constant offset cannot move an argmax.

The forward transform is the matmul-DFT of
:func:`subpixal_tpu.ops.correlate._rfft2_matmul` in its W-pass-first
Karatsuba form.

Numerics: this path differs from the batch-major one only by f32
summation order inside identical-precision einsums; parity is <2e-6 px
on displacement and <1e-5 relative on the peak value. Off by default;
``SUBPIXAL_TPU_PACKED=force`` (or ``1``) enables it — read at trace
time like ``SUBPIXAL_TPU_FFT``. PERF.md holds its H100 timing.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .correlate import _P_COARSE, _P_READOUT, _dft_consts, _fwd_einsum
from .peaks import _power_tables, _solve_spd_small

__all__ = ["find_displacement_packed", "use_packed"]


def use_packed() -> bool:
    """Whether the packed displacement path is enabled (trace-time
    gate): only under ``SUBPIXAL_TPU_PACKED=force|1|on``."""
    return os.environ.get("SUBPIXAL_TPU_PACKED", "").lower() in (
        "force", "1", "on", "true")


# --------------------------------------------------------------------- #
# static window constants (numpy — cached across traces)
# --------------------------------------------------------------------- #


def _phase_tables(t, nfreq: int, period: int):
    """cos/sin of ``2π f_u t_i / period`` (f64 phase, f32 output)."""
    f = np.round(np.fft.fftfreq(period) * period).astype(np.int64)[:nfreq]
    ph = np.asarray(t, np.float64)[:, None] * f[None, :] / period
    ang = 2.0 * np.pi * (ph - np.round(ph))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _fold_weights_np(W: int) -> np.ndarray:
    """Hermitian half-spectrum fold weights (see ``_hermitian_weights``)."""
    Wr = W // 2 + 1
    wv = np.full((Wr,), 2.0, np.float32)
    wv[0] = 1.0
    if W % 2 == 0:
        wv[-1] = 1.0
    return wv


@functools.lru_cache(maxsize=32)
def _window_consts(H: int, W: int, bounds, usfac: int, nwin: int):
    """Static readout matrices for one (shape, window) signature.

    Returns numpy arrays (jnp conversion happens per trace):
      Kyc  : (2*ny, H)  stacked [re; im] coarse row kernel
      Kxcw : (2, nx, Wr) coarse column kernel, fold weights folded in
      Ky2  : (2*nwin, H) stacked upsampled row kernel
      Kx2w : (2, nwin, Wr) upsampled column kernel, fold weights folded
    """
    Wr = W // 2 + 1
    wv = _fold_weights_np(W)
    r0, r1, c0, c1 = bounds
    ny, nx = r1 - r0, c1 - c0
    lag_y0, lag_x0 = r0 - H // 2, c0 - W // 2
    kyr, kyi = _phase_tables(np.arange(ny) + lag_y0, H, H)
    kxr, kxi = _phase_tables(np.arange(nx) + lag_x0, Wr, W)
    Kyc = np.concatenate([kyr, kyi], axis=0)
    Kxcw = np.stack([kxr * wv, kxi * wv], axis=0)
    tf = (np.arange(nwin) - nwin // 2) / usfac
    k2yr, k2yi = _phase_tables(tf, H, H)
    k2xr, k2xi = _phase_tables(tf, Wr, W)
    Ky2 = np.concatenate([k2yr, k2yi], axis=0)
    Kx2w = np.stack([k2xr * wv, k2xi * wv], axis=0)
    return Kyc, Kxcw, Ky2, Kx2w, (lag_y0, lag_x0, ny, nx)


# --------------------------------------------------------------------- #
# packed pipeline stages
# --------------------------------------------------------------------- #


def _fwd_packed(x: jax.Array):
    """Batched rfft2 → packed (H, Wr, B) re/im, W-pass-first Karatsuba.

    The exact arithmetic of ``correlate._rfft2_matmul`` with the output
    axes permuted at the einsum level (no transpose op is ever emitted:
    stage 1 writes batch-minor directly).
    """
    _, H, W = x.shape
    Wr = W // 2 + 1
    consts = _dft_consts(H, W)
    CWS, CH, SH, CHpS = (jnp.asarray(consts[0]), jnp.asarray(consts[4]),
                         jnp.asarray(consts[5]), jnp.asarray(consts[6]))
    X1 = _fwd_einsum("kw,bhw->hkb", CWS, x)               # (H, 2Wr, B)
    Xr, Xi = X1[:, :Wr, :], X1[:, Wr:, :]
    P1 = _fwd_einsum("gh,hkb->gkb", CH, Xr)
    P2 = _fwd_einsum("gh,hkb->gkb", SH, Xi)
    P3 = _fwd_einsum("gh,hkb->gkb", CHpS, Xr + Xi)
    return P1 - P2, P3 - P1 - P2


def _dc_free_power(Xr, Xi, wv):
    """Per-cutout DC-free half-spectrum power (Parseval NCC norm)."""
    p = jnp.sum(wv[None, :, None] * (Xr * Xr + Xi * Xi), axis=(0, 1))
    return p - Xr[0, 0, :] ** 2


def _spatial_power(x):
    """``n·Σx² − (Σx)²`` per cutout — equals :func:`_dc_free_power` of
    its spectrum by Parseval, without touching the spectrum arrays."""
    n = float(x.shape[-2] * x.shape[-1])
    sx = jnp.sum(x, axis=(-2, -1))
    sxx = jnp.sum(x * x, axis=(-2, -1))
    return n * sxx - sx * sx


def _readout_stacked(Gr, Gi, Kystack, Kxr, Kxi, nrows: int, P):
    """``Re{Ky @ G @ Kxᵀ}`` via two single-read stacked-matrix einsums.

    Kystack is ``[Kyr; Kyi]`` (2·nrows, H); the second stage consumes the
    recombined complex rows. Returns (nrows, nx, B).
    """
    Sr = jnp.einsum("iu,uvb->ivb", Kystack, Gr, precision=P)
    Si = jnp.einsum("iu,uvb->ivb", Kystack, Gi, precision=P)
    Ar = Sr[:nrows] - Si[nrows:]       # Re(Ky @ G)
    Ai = Si[:nrows] + Sr[nrows:]       # Im(Ky @ G)
    return (jnp.einsum("jv,ivb->ijb", Kxr, Ar, precision=P)
            - jnp.einsum("jv,ivb->ijb", Kxi, Ai, precision=P))


def _phase_diag_packed(s0: jax.Array, nfreq: int, period: int):
    """Packed per-cutout phase diagonal ``exp(2πi f_u s0_b / P)`` → (U, B).

    Exact int32 modular phase reduction (same numerics rationale as
    ``correlate._us_phase_diag``).
    """
    f = jnp.round(jnp.fft.fftfreq(period) * period).astype(jnp.int32)[:nfreq]
    int_ph = jnp.mod(f[:, None] * s0[None, :].astype(jnp.int32), period)
    ang = (2.0 * jnp.pi / period) * int_ph.astype(jnp.float32)
    return jnp.cos(ang), jnp.sin(ang)


def _find_peak_packed(C, k: int, fit_type: str):
    """``peaks.find_peak`` (mask=None, search=None) on packed (n, m, B).

    Same moments/solve/fallback semantics as the batch-major
    :func:`subpixal_tpu.ops.peaks.find_peak`, with every reduction
    running over packed lanes. Returns (x, y, value, fit_ok).
    """
    n, m, B = C.shape
    dt = C.dtype
    P = jax.lax.Precision.HIGHEST
    flat = jnp.argmax(C.reshape(n * m, B), axis=0)
    iy = (flat // m).astype(jnp.int32)
    ix = (flat % m).astype(jnp.int32)
    peak_val = jnp.max(C, axis=(0, 1))

    half = k // 2
    r0 = jnp.clip(iy - half, 0, n - k)
    c0 = jnp.clip(ix - half, 0, m - k)
    TR = jnp.asarray(_power_tables(n, k), dt)          # (ns, 5n)
    TC = TR if m == n else jnp.asarray(_power_tables(m, k), dt)
    oh_r = (jnp.arange(n - k + 1)[:, None] == r0[None, :]).astype(dt)
    oh_c = (jnp.arange(m - k + 1)[:, None] == c0[None, :]).astype(dt)
    RY = jnp.einsum("sq,sb->qb", TR, oh_r, precision=P).reshape(5, n, B)
    CX = jnp.einsum("sq,sb->qb", TC, oh_c, precision=P).reshape(5, m, B)
    boxmask = (RY[0, :, None, :] > 0) & (CX[0, None, :, :] > 0)
    finite = jnp.isfinite(C)
    safe = jnp.where(finite, C, 0.0)

    if fit_type == "gaussian":
        vals = jnp.where(boxmask & finite, C, -jnp.inf)
        bmax = jnp.max(vals, axis=(0, 1))
        scale = jnp.maximum(bmax, 1e-30)[None, None, :]
        ratio = safe / scale
        z = jnp.log(jnp.clip(ratio, 1e-8, None))
        w = boxmask.astype(dt) * jnp.clip(ratio, 0.0, 1.0)
    elif fit_type == "quadratic":
        z = C
        w = boxmask.astype(dt)
    else:
        raise ValueError(f"unknown fit_type: {fit_type!r}")

    bad = jnp.any(jnp.where(boxmask & (w > 0), ~finite, False), axis=(0, 1))
    w = jnp.where(finite, w, 0.0)
    z = jnp.where(finite & (w > 0), z, 0.0)

    wz = w * z
    Tw = jnp.sum(w[None] * RY[:, :, None, :], axis=1)          # (5, m, B)
    Twz = jnp.sum(wz[None] * RY[:3, :, None, :], axis=1)       # (3, m, B)
    Mw = jnp.sum(Tw[:, None] * CX[None], axis=2)               # (5, 5, B)
    Mwz = jnp.sum(Twz[:, None] * CX[None, :3], axis=2)         # (3, 3, B)

    pows = ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2))
    ata = jnp.stack(
        [jnp.stack([Mw[py_i + py_j, px_i + px_j]
                    for (px_j, py_j) in pows], axis=-1)
         for (px_i, py_i) in pows], axis=-2)                   # (B, 6, 6)
    atz = jnp.stack([Mwz[py, px] for (px, py) in pows], axis=-1)
    ata = ata + 1e-8 * jnp.eye(6, dtype=dt)[None]
    coef = _solve_spd_small(ata, atz)
    c0c, c1, c2, c3, c4, c5 = [coef[:, i] for i in range(6)]

    det = 4.0 * c3 * c5 - c4 * c4
    safe_det = jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
    px = (-2.0 * c5 * c1 + c4 * c2) / safe_det
    py = (c4 * c1 - 2.0 * c3 * c2) / safe_det
    halfc = (k - 1) / 2.0
    is_max = (det > 0) & (c3 < 0)
    inside = (jnp.abs(px) <= halfc + 0.5) & (jnp.abs(py) <= halfc + 0.5)
    fit_ok = (is_max & inside & jnp.isfinite(px) & jnp.isfinite(py)
              & jnp.isfinite(peak_val) & ~bad)
    x_fit = c0.astype(dt) + halfc + px
    y_fit = r0.astype(dt) + halfc + py
    v_fit = (c0c + c1 * px + c2 * py + c3 * px * px
             + c4 * px * py + c5 * py * py)
    if fit_type == "gaussian":
        v_fit = jnp.exp(v_fit) * scale[0, 0, :]
    x = jnp.where(fit_ok, x_fit, ix.astype(dt))
    y = jnp.where(fit_ok, y_fit, iy.astype(dt))
    value = jnp.where(fit_ok, v_fit, peak_val)
    return x, y, value, fit_ok


def find_displacement_packed(
    ref_b: jax.Array,
    img_b: jax.Array,
    cc_type: str,
    usfac: int,
    peak_fit_box: int,
    fit_type: str,
    bounds: tuple[int, int, int, int],
    nwin: int,
    ref_mask: jax.Array | None = None,
    img_mask: jax.Array | None = None,
):
    """Packed-layout displacement core (see module docstring for scope).

    Inputs are (B, H, W) cutouts; ``bounds`` the static coarse search
    window, ``nwin`` the upsampled window side. Returns raw
    ``(dx, dy, peak, fit_ok)`` arrays (the caller wraps/squeezes).

    Masked NCC/ZNCC and plain CC run the spatial ``_normalize`` first
    (one elementwise pass, fused by XLA into the stage-1 matmul operand)
    instead of the deferred-scale spectral form: after mask-aware mean
    subtraction the spectra are DC-free by construction (``Σd == 0``)
    and the 1/(σ√n) scales are already applied, so no deferred
    correction is needed. Parity with the batch-major masked path is
    layout-only (f32 summation order).
    """
    B, H, W = ref_b.shape
    Wr = W // 2 + 1
    n = float(H * W)
    Kyc, Kxcw, Ky2, Kx2w, geom = _window_consts(
        H, W, tuple(bounds), int(usfac), int(nwin))
    lag_y0, lag_x0, ny, nx = geom
    Kyc, Kxcw, Ky2, Kx2w = map(jnp.asarray, (Kyc, Kxcw, Ky2, Kx2w))

    if ref_mask is not None or img_mask is not None or cc_type == "CC":
        from .correlate import _normalize

        Rr, Ri = _fwd_packed(_normalize(ref_b, ref_mask, cc_type))
        Ir, Ii = _fwd_packed(_normalize(img_b, img_mask, cc_type))
        scale = None
    else:
        rf = ref_b.astype(jnp.float32)
        im = img_b.astype(jnp.float32)
        Rr, Ri = _fwd_packed(rf)
        Ir, Ii = _fwd_packed(im)
        # deferred NCC scale (per-cutout scalar; applied to the peak
        # value only — see module docstring item 3), computed in the
        # SPATIAL domain via Parseval (DC-free half-spectrum power
        # == n·Σx² − (Σx)²): a spectral-domain power reduction would
        # make the per-input spectra multi-consumer (dots + reduce),
        # blocking XLA from fusing the Karatsuba combine straight into
        # the cross-spectrum and add a pass over the spectra
        scale = (n * jax.lax.rsqrt(jnp.maximum(_spatial_power(rf), 1e-20))
                 * jax.lax.rsqrt(jnp.maximum(_spatial_power(im), 1e-20)))
    # cross-spectrum G = F(img) * conj(F(ref)) (unscaled iff deferred)
    Gr = Ir * Rr + Ii * Ri
    Gi = Ii * Rr - Ir * Ri
    g00 = Gr[0, 0, :] if scale is not None else None  # DC bin (imag = 0)

    # coarse integer lags: argmax is invariant to the positive scale AND
    # the DC offset, so the windowed surface is used completely raw
    Cc = _readout_stacked(Gr, Gi, Kyc, Kxcw[0], Kxcw[1], ny, _P_COARSE)
    flat = jnp.argmax(Cc.reshape(ny * nx, B), axis=0)
    s0y = (flat // nx).astype(jnp.int32) + lag_y0
    s0x = (flat % nx).astype(jnp.int32) + lag_x0

    # upsampled window: per-cutout integer-shift phase twist (packed).
    # The twist is separable (row diag × column diag), so the FULL
    # twisted spectrum never materializes: the ROW twist rides the row
    # contraction's operands as broadcast elementwise (XLA fuses it
    # into the matmul load — single consumer each), and the COLUMN
    # twist lands on the (nwin, Wr, B) post-contraction intermediate,
    # H/nwin = 4× smaller. It is kept for the smaller op graph: the
    # Gr/Gi re-reads it adds offset the materializations it removes.
    Dyr, Dyi = _phase_diag_packed(s0y, H, H)     # (H, B)
    Dxr, Dxi = _phase_diag_packed(s0x, Wr, W)    # (Wr, B)
    G1r = Gr * Dyr[:, None, :] - Gi * Dyi[:, None, :]
    G1i = Gr * Dyi[:, None, :] + Gi * Dyr[:, None, :]
    Sr = jnp.einsum("iu,uvb->ivb", Ky2, G1r, precision=_P_READOUT)
    Si = jnp.einsum("iu,uvb->ivb", Ky2, G1i, precision=_P_READOUT)
    Ar = Sr[:nwin] - Si[nwin:]         # Re(Ky @ (G ⊙ Dy))
    Ai = Si[:nwin] + Sr[nwin:]         # Im(Ky @ (G ⊙ Dy))
    A2r = Ar * Dxr[None, :, :] - Ai * Dxi[None, :, :]
    A2i = Ar * Dxi[None, :, :] + Ai * Dxr[None, :, :]
    Cu = (jnp.einsum("jv,ivb->ijb", Kx2w[0], A2r, precision=_P_READOUT)
          - jnp.einsum("jv,ivb->ijb", Kx2w[1], A2i, precision=_P_READOUT))
    # DC subtraction (deferred path only) + inverse-DFT 1/n, on the
    # TINY window only
    Cu = (Cu / n if g00 is None else (Cu - g00[None, None, :]) / n)

    x, y, value, fit_ok = _find_peak_packed(Cu, int(peak_fit_box), fit_type)
    off_y = s0y.astype(jnp.float32) - (nwin // 2) / usfac
    off_x = s0x.astype(jnp.float32) - (nwin // 2) / usfac
    dx = off_x + x / usfac
    dy = off_y + y / usfac
    if scale is not None:
        value = value * scale
    return dx, dy, value, fit_ok
