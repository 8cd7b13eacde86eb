"""Separable image interpolation (the blot gather), on device.

Device-side sampling of an image at arbitrary (x, y) coordinates, the core
of the blot operation (reference: ``drizzlepac.ablot.do_blot`` → C
``cdriz.tblot``; SURVEY.md §2 #8, §2a). The reference supports the
interpolants ``nearest / linear / poly3 / poly5 / spline3 / sinc``; this
module implements the same family as **separable static-footprint
gathers**:

* ``nearest`` — 1 tap;
* ``linear`` — bilinear, 2x2 taps;
* ``poly3`` — 4-point Lagrange cubic (drizzlepac's bicubic), 4x4 taps;
* ``poly5`` — 6-point Lagrange quintic (the reference blot default), 6x6;
* ``sinc`` — Lanczos-3 windowed sinc, 6x6 taps;
* ``spline3`` — TRUE cubic B-spline: the classic IIR prefilter (Unser
  1993) runs as two `lax.associative_scan` linear recurrences per axis
  — the recursion is a composition monoid, so it maps onto the device
  as a log-depth scan instead of the sequential loop the reference's C
  uses — then sampling is the ordinary 4x4 separable gather with
  B-spline basis weights on the coefficient image.

Everything is expressed as ``taps x taps`` advanced-indexing gathers with
per-axis weight vectors — static shapes, XLA-fusable, vmap/batch friendly.
Out-of-image samples return ``fill`` with a False validity mask (the
fixed-shape replacement for the reference's edge handling).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["sample_image", "bspline3_prefilter", "INTERP_TAPS",
           "INTERP_OFFSETS"]

#: integer tap offsets of each separable interpolant (consecutive); the
#: single source of truth shared with the row-sharded gather in
#: :mod:`subpixal_tpu.parallel.spatial`
INTERP_OFFSETS = {
    "nearest": (0,),
    "linear": (0, 1),
    "poly3": (-1, 0, 1, 2),
    "spline3": (-1, 0, 1, 2),
    "poly5": (-2, -1, 0, 1, 2, 3),
    "sinc": (-2, -1, 0, 1, 2, 3),
}

INTERP_TAPS = {k: len(v) for k, v in INTERP_OFFSETS.items()}


def _lagrange_weights(t: jax.Array, offsets: tuple[int, ...]) -> jax.Array:
    """Lagrange basis weights at fractional position ``t`` for integer
    ``offsets``. Returns shape ``t.shape + (len(offsets),)``."""
    ws = []
    for i, oi in enumerate(offsets):
        w = jnp.ones_like(t)
        for j, oj in enumerate(offsets):
            if i == j:
                continue
            w = w * (t - oj) / (oi - oj)
        ws.append(w)
    return jnp.stack(ws, axis=-1)


#: pole of the cubic B-spline direct filter (Unser 1993): sqrt(3) - 2
_BSPLINE3_POLE = -0.26794919243112270647

#: truncation horizon for the mirror-boundary causal init:
#: |pole|^18 < 5e-11 — far below f32 resolution
_BSPLINE3_HORIZON = 18


def _bspline3_weights(t: jax.Array) -> jax.Array:
    """Cubic B-spline basis at fractional ``t`` for offsets (-1,0,1,2)."""
    t2 = t * t
    t3 = t2 * t
    return jnp.stack([
        (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0,   # B3(t+1)
        (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0,       # B3(t)
        (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0,  # B3(t-1)
        t3 / 6.0,                                  # B3(t-2)
    ], axis=-1)


def _bspline3_prefilter_axis(x: jax.Array, axis: int) -> jax.Array:
    """Exact cubic B-spline coefficients along ``axis``.

    The causal/anticausal first-order IIR pair (pole ``z1``, gain 6,
    mirror boundaries) expressed as two `lax.associative_scan` passes:
    the recurrence ``y[n] = z1*y[n-1] + u[n]`` composes as the monoid
    ``(a1, b1) ∘ (a2, b2) = (a1*a2, b1*a2 + b2)``, giving a log-depth
    program instead of a length-N sequential loop.
    """
    z = jnp.asarray(_BSPLINE3_POLE, x.dtype)
    x = jnp.moveaxis(x, axis, -1)
    N = x.shape[-1]
    if N < 4:    # degenerate axis: B-spline == the samples themselves
        return jnp.moveaxis(x, -1, axis)
    x = x * 6.0
    K = min(N, _BSPLINE3_HORIZON)
    zk = z ** jnp.arange(K, dtype=x.dtype)
    # HIGHEST: a float32 contraction may otherwise run in TF32 on the GPU
    c0 = jnp.einsum("...k,k->...", x[..., :K], zk,
                    precision=jax.lax.Precision.HIGHEST)

    def comb(l, r):
        al, bl = l
        ar, br = r
        return al * ar, bl * ar + br

    ax = x.ndim - 1  # associative_scan reverse needs a nonnegative axis
    u = x.at[..., 0].set(c0)
    a = jnp.broadcast_to(z, x.shape).at[..., 0].set(0.0)
    _, cp = jax.lax.associative_scan(comb, (a, u), axis=ax)
    # anticausal, mirror init (Unser eq. 2.6)
    cm_last = (z / (z * z - 1.0)) * (cp[..., -1] + z * cp[..., -2])
    u2 = (-z) * cp
    u2 = u2.at[..., -1].set(cm_last)
    a2 = jnp.broadcast_to(z, x.shape).at[..., -1].set(0.0)
    _, cm = jax.lax.associative_scan(comb, (a2, u2), axis=ax,
                                     reverse=True)
    return jnp.moveaxis(cm, -1, axis)


def bspline3_prefilter(image: jax.Array) -> jax.Array:
    """Cubic B-spline coefficient image (both axes, mirror boundaries).

    ``sample_image(..., interp='spline3')`` calls this internally; use
    it directly (+ ``prefiltered=True``) to sample one image many
    times. Matches ``scipy.ndimage.spline_filter(order=3,
    mode='mirror')``.
    """
    image = jnp.asarray(image, jnp.float32)
    return _bspline3_prefilter_axis(
        _bspline3_prefilter_axis(image, 0), 1)


def _lanczos_weights(t: jax.Array, offsets: tuple[int, ...], a: int = 3,
                     sinscl: float = 1.0):
    """Windowed-sinc weights. ``sinscl`` scales the sinc's argument (the
    reference ``do_blot(..., sinscl=)`` knob): >1 widens the main lobe,
    low-pass filtering the interpolant; the a-tap window is unchanged."""

    def lanczos(x):
        xs = x / sinscl
        pxs = jnp.pi * xs
        pw = jnp.pi * x / a
        small_s = jnp.abs(xs) < 1e-7
        small_w = jnp.abs(x) < 1e-7
        sinc_main = jnp.where(
            small_s, 1.0, jnp.sin(pxs) / jnp.where(small_s, 1.0, pxs))
        sinc_win = jnp.where(
            small_w, 1.0, jnp.sin(pw) / jnp.where(small_w, 1.0, pw))
        return jnp.where(jnp.abs(x) >= a, 0.0, sinc_main * sinc_win)

    ws = jnp.stack([lanczos(t - o) for o in offsets], axis=-1)
    s = jnp.sum(ws, axis=-1, keepdims=True)
    # for sinscl < 1 the tap weights can sum to ~0 at some fractional
    # positions (all scaled taps land on sinc zeros): normalizing would
    # produce 0/0 = NaN (or huge amplification) at samples flagged
    # valid. Fall back to plain bilinear weights there — finite,
    # partition-of-unity, and exact where the field is locally linear.
    lin = jnp.zeros_like(ws)
    i0 = offsets.index(0)
    lin = lin.at[..., i0].set(1.0 - t).at[..., i0 + 1].set(t)
    bad = jnp.abs(s) < 1e-3
    return jnp.where(bad, lin, ws / jnp.where(bad, 1.0, s))


def _axis_weights(t: jax.Array, interp: str,
                  sinscl: float = 1.0) -> tuple[jax.Array, tuple[int, ...]]:
    """Per-axis taps weights for fractional coordinate part ``t`` in [0,1)."""
    if interp not in INTERP_OFFSETS:
        raise ValueError(
            f"unknown interp: {interp!r} "
            f"(expected one of {sorted(INTERP_TAPS)})")
    offs = INTERP_OFFSETS[interp]
    if interp == "nearest":
        return jnp.ones(t.shape + (1,), t.dtype), offs
    if interp == "linear":
        return jnp.stack([1.0 - t, t], axis=-1), offs
    if interp == "sinc":
        return _lanczos_weights(t, offs, sinscl=sinscl), offs
    if interp == "spline3":
        return _bspline3_weights(t), offs
    return _lagrange_weights(t, offs), offs


def sample_image(
    image: jax.Array,
    x: jax.Array,
    y: jax.Array,
    interp: str = "poly5",
    fill: float = 0.0,
    sinscl: float = 1.0,
    prefiltered: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Sample ``image`` at float coordinates (x, y) (0-based, x=column).

    Returns ``(values, valid)`` with the shapes of ``x``; ``valid`` is
    False where the interpolation footprint left the image (those values
    are ``fill``). ``sinscl`` scales the sinc interpolant's kernel
    (``interp='sinc'`` only; reference ``do_blot`` kwarg).
    ``interp='spline3'`` prefilters ``image`` into B-spline
    coefficients first (:func:`bspline3_prefilter`); pass
    ``prefiltered=True`` when ``image`` already holds coefficients.
    """
    H, W = image.shape
    if interp == "spline3" and not prefiltered:
        image = bspline3_prefilter(image)
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)

    if interp == "nearest":
        # floor(x+0.5): reference C (int)(x+0.5) convention — NOT
        # banker's rounding, which picks a different pixel at .5
        xi = jnp.floor(x + 0.5).astype(jnp.int32)
        yi = jnp.floor(y + 0.5).astype(jnp.int32)
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi = jnp.clip(xi, 0, W - 1)
        yi = jnp.clip(yi, 0, H - 1)
        vals = image[yi, xi]
        return jnp.where(valid, vals, fill), valid

    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    tx = x - x0
    ty = y - y0
    wx, offs = _axis_weights(tx, interp, sinscl=sinscl)
    wy, _ = _axis_weights(ty, interp, sinscl=sinscl)
    xi0 = x0.astype(jnp.int32)
    yi0 = y0.astype(jnp.int32)

    lo, hi = offs[0], offs[-1]
    valid = ((xi0 + lo >= 0) & (xi0 + hi < W)
             & (yi0 + lo >= 0) & (yi0 + hi < H))

    acc = jnp.zeros_like(x)
    for i, oy in enumerate(offs):
        yi = jnp.clip(yi0 + oy, 0, H - 1)
        row_acc = jnp.zeros_like(x)
        for j, ox in enumerate(offs):
            xi = jnp.clip(xi0 + ox, 0, W - 1)
            row_acc = row_acc + wx[..., j] * image[yi, xi]
        acc = acc + wy[..., i] * row_acc
    return jnp.where(valid, acc, fill), valid
