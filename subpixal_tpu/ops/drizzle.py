"""Drizzle (area-weighted scatter-add resampling), on device.

Device-side equivalent of the reference's image-combination kernel
(``drizzlepac`` C extension ``cdriz.tdriz``; SURVEY.md §2 #7, §2a): each
input pixel deposits its flux onto the output grid over a shrunken square
footprint (``pixfrac``), weighted by fractional area overlap, accumulating
separate science and weight planes.

Device-first formulation: the classic drizzle is an input-driven scatter with
data-dependent footprints — hostile to SIMD. Here the footprint is bounded
by a **static** KxK candidate-cell window (K derived from pixfrac/scale at
trace time), so the whole operation becomes K² fully vectorized
area-overlap computations + flat ``scatter-add``s, which XLA lowers
efficiently (atomics on the GPU). This matches drizzlepac's 'turbo'/'square' kernel
semantics for the locally-axis-aligned case (the 'square' kernel with a
rotated Jacobian differs at the few-1e-3 level per pixel; the align loop's
difference images are insensitive to this).

Supported kernels (the AstroDrizzle kernel set, SURVEY §2 #7 / VERDICT r1
item 8): ``square`` / ``turbo`` (area overlap; drizzlepac's 'turbo' is the
axis-aligned square, which is exactly this formulation), ``point`` (all
mass to the nearest output cell), ``gaussian`` (Gaussian cloud-in-cell,
truncated at 2.5 sigma), ``lanczos2`` / ``lanczos3`` (separable windowed-
sinc), ``tophat`` (uniform within a circular radius).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

__all__ = ["drizzle_deposit", "drizzle_combine", "kernel_reach",
           "DRIZZLE_KERNELS"]

#: supported deposit kernels (drizzlepac parity set)
DRIZZLE_KERNELS = ("square", "turbo", "point", "gaussian",
                   "lanczos2", "lanczos3", "tophat")


def kernel_reach(kernel: str, pixfrac: float, pscale_ratio: float) -> float:
    """Deposit window half-extent (output pixels) of ``kernel``."""
    half = 0.5 * float(pixfrac) * float(pscale_ratio)
    s = max(float(pixfrac) * float(pscale_ratio), 1e-3)
    if kernel in ("square", "turbo"):
        return half
    if kernel == "point":
        return 0.51
    if kernel == "gaussian":
        return 2.5 * s / 2.3548
    if kernel == "lanczos2":
        return 2.0 * s
    if kernel == "lanczos3":
        return 3.0 * s
    if kernel == "tophat":
        return half
    raise ValueError(f"unknown kernel: {kernel!r} "
                     f"(expected one of {DRIZZLE_KERNELS})")


def _lanczos1d(u: jax.Array, a: float) -> jax.Array:
    """lanczos_a(u) = sinc(u)·sinc(u/a) on |u| < a, 0 outside."""
    pu = jnp.pi * u
    small = jnp.abs(u) < 1e-7
    val = jnp.where(
        small, 1.0,
        a * jnp.sin(pu) * jnp.sin(pu / a) / jnp.maximum(pu * pu, 1e-30))
    return jnp.where(jnp.abs(u) >= a, 0.0, val)


def drizzle_deposit(
    in_data: jax.Array,
    in_wht: jax.Array | None,
    x_out: jax.Array,
    y_out: jax.Array,
    out_shape: tuple[int, int],
    pixfrac: float = 1.0,
    pscale_ratio: float = 1.0,
    kernel: str = "square",
) -> tuple[jax.Array, jax.Array]:
    """Deposit one input plane onto an output grid.

    Parameters
    ----------
    in_data : (H, W) input science pixels.
    in_wht : (H, W) input weights (None = unit weights). Zero-weight
        pixels (e.g. masked/bad) deposit nothing.
    x_out, y_out : (H, W) position of each input pixel CENTER in output
        pixel coordinates (the pixmap, from WCS composition).
    out_shape : (Ho, Wo) static output shape.
    pixfrac : drizzle pixel "droplet" shrink factor (reference default 1).
    pscale_ratio : input pixel size in units of output pixels (e.g. 2.0
        when drizzling onto a 2x finer grid).
    kernel : one of :data:`DRIZZLE_KERNELS` ('square' | 'turbo' |
        'point' | 'gaussian' | 'lanczos2' | 'lanczos3' | 'tophat').

    Returns
    -------
    (sci_acc, wht_acc): (Ho, Wo) accumulators with
    ``sci_acc = Σ v·w·a`` and ``wht_acc = Σ w·a`` — combine multiple
    exposures by summing accumulators, then ``sci = sci_acc / wht_acc``
    (see :func:`drizzle_combine`).
    """
    Ho, Wo = out_shape
    data = jnp.asarray(in_data, jnp.float32).reshape(-1)
    w = (jnp.ones_like(data) if in_wht is None
         else jnp.asarray(in_wht, jnp.float32).reshape(-1))
    xo = jnp.asarray(x_out, jnp.float32).reshape(-1)
    yo = jnp.asarray(y_out, jnp.float32).reshape(-1)

    sci = jnp.zeros(Ho * Wo + 1, jnp.float32)
    wht = jnp.zeros(Ho * Wo + 1, jnp.float32)

    if kernel == "point":
        xi = jnp.floor(xo + 0.5).astype(jnp.int32)  # C (int)(x+0.5)
        yi = jnp.floor(yo + 0.5).astype(jnp.int32)
        valid = (xi >= 0) & (xi < Wo) & (yi >= 0) & (yi < Ho) & (w > 0)
        flat = jnp.where(valid, yi * Wo + xi, Ho * Wo)
        wv = jnp.where(valid, w, 0.0)
        sci = sci.at[flat].add(wv * data)
        wht = wht.at[flat].add(wv)
        return sci[:-1].reshape(Ho, Wo), wht[:-1].reshape(Ho, Wo)

    half = 0.5 * float(pixfrac) * float(pscale_ratio)
    s = max(float(pixfrac) * float(pscale_ratio), 1e-3)
    sigma = s / 2.3548  # Gaussian: FWHM = pixfrac * pscale_ratio
    reach = kernel_reach(kernel, pixfrac, pscale_ratio)

    # Static candidate window: cell c covers [c-0.5, c+0.5], so the
    # leftmost cell intersecting [xo-reach, xo+reach] is
    # floor(xo - reach + 0.5); a window of ceil(2*reach)+1 cells then
    # covers the rightmost one too. (Omitting the +0.5 cell-center shift
    # silently drops the rightmost cell's flux for fractional offsets —
    # an asymmetric loss that biases every deposited position.)
    K = int(math.ceil(2.0 * reach)) + 1
    c0x = jnp.floor(xo - reach + 0.5).astype(jnp.int32)
    c0y = jnp.floor(yo - reach + 0.5).astype(jnp.int32)

    for dy in range(K):
        cy = c0y + dy
        for dx in range(K):
            cx = c0x + dx
            if kernel in ("square", "turbo"):
                # overlap of [xo-half, xo+half] with cell [cx-0.5, cx+0.5]
                ox = (jnp.minimum(xo + half, cx + 0.5)
                      - jnp.maximum(xo - half, cx - 0.5))
                oy = (jnp.minimum(yo + half, cy + 0.5)
                      - jnp.maximum(yo - half, cy - 0.5))
                a = (jnp.maximum(ox, 0.0) * jnp.maximum(oy, 0.0)
                     / (4.0 * half * half))
            elif kernel == "gaussian":
                r2 = (cx - xo) ** 2 + (cy - yo) ** 2
                a = jnp.exp(-0.5 * r2 / (sigma * sigma))
            elif kernel in ("lanczos2", "lanczos3"):
                la = 2.0 if kernel == "lanczos2" else 3.0
                a = (_lanczos1d((cx - xo) / s, la)
                     * _lanczos1d((cy - yo) / s, la))
            else:  # tophat: uniform within a circular radius `half`
                r2 = (cx - xo) ** 2 + (cy - yo) ** 2
                a = (r2 <= half * half).astype(jnp.float32)
            valid = (cx >= 0) & (cx < Wo) & (cy >= 0) & (cy < Ho) & (w > 0)
            flat = jnp.where(valid, cy * Wo + cx, Ho * Wo)
            wa = jnp.where(valid, w * a, 0.0)
            sci = sci.at[flat].add(wa * data)
            wht = wht.at[flat].add(wa)
    return sci[:-1].reshape(Ho, Wo), wht[:-1].reshape(Ho, Wo)


def drizzle_combine(sci_acc: jax.Array, wht_acc: jax.Array,
                    fill: float = 0.0) -> jax.Array:
    """Final science image from summed accumulators (0-weight -> fill)."""
    good = wht_acc > 0
    return jnp.where(good, sci_acc / jnp.where(good, wht_acc, 1.0), fill)
