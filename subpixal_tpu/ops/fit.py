"""Sigma-clipped linear (WCS-correction) fits, on device.

Capability parity with the reference's fitting layer
(``subpixal/align.py · find_linear_fit`` — iterative sigma-clipped LSQ fit
of measured displacements, SURVEY.md §1 "Fitting layer", §3.1): given
matched source positions ``xy`` and their measured counterparts ``uv``,
fit ``uv ≈ M @ xy + t`` with ``fitgeom`` in ``{'shift','rscale','general'}``
and iteratively reject outliers beyond ``sigma`` times the fit RMS,
``nclip`` times.

Device-first redesign: the clip loop is a fixed-trip loop over boolean
weights (fixed shapes — the reference's data-dependent point removal
becomes weight zeroing, SURVEY §7), and the whole fit is expressed through
**weighted moment sums** so the identical code runs single-device or
sharded: under ``shard_map`` the moment sums are simply ``lax.psum``-ed
over the device mesh (SURVEY §2b "Collectives" — the device answer to
a distributed least-squares), giving a bit-identical distributed fit.

Closed forms (with weighted centroids removed; X = xy - <xy>, U = uv - <uv>):

* ``shift``  : M = I,              t = <uv> - <xy>
* ``rscale`` : M = s R (similarity: rotation + single scale),
  a = Σw(X·U), b = Σw(X×U), s = |(a,b)| / Σw|X|².
* ``general``: M = S_ux S_xx⁻¹ (full 2x2 affine), t from centroids.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "iter_linear_fit",
    "iter_linear_fit_sharded",
    "iter_linear_fit_frames",
    "LinearFitResult",
    "apply_affine",
]

_P = jax.lax.Precision.HIGHEST


class LinearFitResult(NamedTuple):
    """Result of a sigma-clipped linear fit.

    matrix : (2, 2) — fitted linear part M.
    shift : (2,) — fitted translation t, so that ``uv ≈ xy @ M.T + t``.
    rms : (2,) — weighted per-axis RMS of the final residuals.
    rmse : () — weighted total RMS residual.
    mae : () — weighted mean absolute (radial) error.
    nmatches : () int32 — number of points surviving the clipping
        (global count when sharded).
    weights : (N,) — final effective weights (0 where clipped; local shard
        when sharded).
    """

    matrix: jax.Array
    shift: jax.Array
    rms: jax.Array
    rmse: jax.Array
    mae: jax.Array
    nmatches: jax.Array
    weights: jax.Array


def apply_affine(xy: jax.Array, matrix: jax.Array, shift: jax.Array) -> jax.Array:
    """Apply ``xy @ M.T + t`` (row-vector convention used throughout)."""
    return jnp.dot(xy, matrix.T, precision=_P) + shift


def _solve_from_moments(mom: dict, fitgeom: str, dtype):
    """Closed-form (M, t) from (possibly psum-reduced) moment sums.

    mom: sw=Σw, sx=Σw·xy (2,), su=Σw·uv (2,), sxx=Σw·xyᵀxy (2,2),
    sux=Σw·uvᵀxy (2,2).
    """
    eye = jnp.eye(2, dtype=dtype)
    # a frame with (almost) no weight has NO measurement: return the
    # IDENTITY correction, not the zero matrix the degenerate moments
    # would produce — composing G=0 into the affine state would destroy
    # that frame's WCS while the loop reports convergence (weight-0
    # frames contribute nothing to the eps_shift metric).
    dead = mom["sw"] <= 1e-8
    sw = jnp.maximum(mom["sw"], 1e-12)
    cx = mom["sx"] / sw
    cu = mom["su"] / sw
    # centered second moments
    Sxx = mom["sxx"] - sw * jnp.outer(cx, cx)
    Sux = mom["sux"] - sw * jnp.outer(cu, cx)

    if fitgeom == "shift":
        M = eye
    elif fitgeom == "rscale":
        a = Sux[0, 0] + Sux[1, 1]
        b = Sux[1, 0] - Sux[0, 1]
        nx = jnp.maximum(Sxx[0, 0] + Sxx[1, 1], 1e-12)
        denom = jnp.maximum(jnp.sqrt(a * a + b * b), 1e-12)
        cos_t = a / denom
        sin_t = b / denom
        s = denom / nx
        R = jnp.stack([jnp.stack([cos_t, -sin_t]), jnp.stack([sin_t, cos_t])])
        M = s * R
    elif fitgeom == "general":
        Sxx = Sxx + 1e-10 * jnp.trace(Sxx) * eye + 1e-12 * eye
        M = jnp.dot(Sux, jnp.linalg.inv(Sxx), precision=_P)
    else:
        raise ValueError(
            f"unknown fitgeom: {fitgeom!r} (expected 'shift'|'rscale'|'general')"
        )
    t = cu - jnp.dot(M, cx, precision=_P)
    M = jnp.where(dead, eye, M)
    t = jnp.where(dead, jnp.zeros_like(t), t)
    return M, t


def _iter_fit_impl(
    xy: jax.Array,
    uv: jax.Array,
    w0: jax.Array,
    fitgeom: str,
    nclip: int,
    sigma: float,
    reduce_sum: Callable[[jax.Array], jax.Array],
) -> LinearFitResult:
    """Shared single-device / sharded implementation.

    ``reduce_sum`` is identity locally, or ``lax.psum(·, axis)`` under
    shard_map — every cross-point reduction funnels through it.

    Coordinates are CENTERED on their (initial-weight) centroid before
    any moment accumulation: float32 second moments of absolute pixel
    coordinates cancel catastrophically when the catalog sits far from
    the origin (e.g. sources clustered around (3500, 3500): ``sxx -
    sw·c²`` loses ~7 digits and the fitted shift can be off by pixels).
    The same offset is applied to both sides and undone on the returned
    shift, so the result is identical in exact arithmetic.
    """
    sw0 = jnp.maximum(reduce_sum(jnp.sum(w0)), 1e-12)
    c = reduce_sum(jnp.einsum("n,ni->i", w0, xy, precision=_P)) / sw0
    xy = xy - c
    uv = uv - c

    def moments(w):
        return dict(
            sw=reduce_sum(jnp.sum(w)),
            sx=reduce_sum(jnp.einsum("n,ni->i", w, xy, precision=_P)),
            su=reduce_sum(jnp.einsum("n,ni->i", w, uv, precision=_P)),
            sxx=reduce_sum(jnp.einsum("n,ni,nj->ij", w, xy, xy, precision=_P)),
            sux=reduce_sum(jnp.einsum("n,ni,nj->ij", w, uv, xy, precision=_P)),
        )

    def fit_and_resid(w):
        M, t = _solve_from_moments(moments(w), fitgeom, xy.dtype)
        resid = uv - apply_affine(xy, M, t)
        r2 = jnp.sum(resid * resid, axis=1)
        return M, t, resid, r2

    def clip_step(_, w):
        M, t, resid, r2 = fit_and_resid(w)
        wsum = jnp.maximum(reduce_sum(jnp.sum(w)), 1e-12)
        rms2 = reduce_sum(jnp.sum(w * r2)) / wsum
        keep = r2 <= (sigma * sigma) * jnp.maximum(rms2, 1e-24)
        w_new = jnp.where(keep, w, 0.0)
        enough = reduce_sum(jnp.sum(w_new > 0)) >= 3
        return jnp.where(enough, w_new, w)

    w = jax.lax.fori_loop(0, nclip, clip_step, w0) if nclip > 0 else w0
    M, t, resid, r2 = fit_and_resid(w)

    wsum = jnp.maximum(reduce_sum(jnp.sum(w)), 1e-12)
    rms = jnp.sqrt(
        reduce_sum(jnp.sum(w[:, None] * resid * resid, axis=0)) / wsum
    )
    rmse = jnp.sqrt(reduce_sum(jnp.sum(w * r2)) / wsum)
    mae = reduce_sum(jnp.sum(w * jnp.sqrt(r2))) / wsum
    nmatches = reduce_sum(jnp.sum(w > 0)).astype(jnp.int32)
    # un-center: uv = M xy + t in ORIGINAL coordinates
    t = t + c - jnp.dot(M, c, precision=_P)
    return LinearFitResult(
        matrix=M, shift=t, rms=rms, rmse=rmse, mae=mae,
        nmatches=nmatches, weights=w,
    )


def _prep(xy, uv, wxy):
    xy = jnp.asarray(xy, jnp.float32)
    uv = jnp.asarray(uv, jnp.float32)
    n = xy.shape[0]
    w0 = (jnp.ones((n,), jnp.float32) if wxy is None
          else jnp.asarray(wxy, jnp.float32))
    return xy, uv, jnp.maximum(w0, 0.0)


def iter_linear_fit(
    xy: jax.Array,
    uv: jax.Array,
    wxy: jax.Array | None = None,
    fitgeom: str = "general",
    nclip: int = 3,
    sigma: float = 3.0,
) -> LinearFitResult:
    """Iterative sigma-clipped weighted linear fit of ``uv`` against ``xy``.

    Parameters
    ----------
    xy, uv : (N, 2) matched positions; solves ``uv ≈ xy @ M.T + t``.
    wxy : (N,) optional nonnegative weights (reference ``use_weights``
        path). Zero-weight points are pre-clipped. ``None`` = uniform.
    fitgeom : 'shift' | 'rscale' | 'general'
    nclip : number of sigma-clip iterations (reference default 3).
    sigma : clip threshold in units of the fit RMS.

    Fixed-shape semantics: clipping zeroes weights instead of removing
    rows (jit/vmap-safe). If clipping would leave fewer than 3 points,
    that clip iteration is skipped (mirrors the reference keeping the
    last valid fit).
    """
    xy, uv, w0 = _prep(xy, uv, wxy)
    return _iter_fit_impl(xy, uv, w0, fitgeom, nclip, sigma, lambda s: s)


def iter_linear_fit_frames(
    xy: jax.Array,
    uv: jax.Array,
    frame_id: jax.Array,
    n_frames: int,
    wxy: jax.Array | None = None,
    fitgeom: str = "general",
    nclip: int = 3,
    sigma: float = 3.0,
    axis_name: str | None = None,
) -> LinearFitResult:
    """Per-frame sigma-clipped fits over a FLATTENED (frame, source) batch.

    The joint multi-exposure layout (BASELINE config 5): points from all
    frames are concatenated (and, under shard_map, sharded) along one
    axis; ``frame_id`` (N,) assigns each point to a frame. Moments are
    accumulated per frame via a one-hot contraction, reduced with
    ``lax.psum`` when ``axis_name`` is given, and solved per frame — so
    per-frame affine fits come out of one SPMD program with no gather of
    the point data.

    Returns a LinearFitResult whose matrix/shift/rms/... have a leading
    (n_frames,) axis; ``weights`` stays per-point (local shard).
    """
    xy, uv, w0 = _prep(xy, uv, wxy)
    reduce_sum = ((lambda s: jax.lax.psum(s, axis_name))
                  if axis_name is not None else (lambda s: s))
    E = int(n_frames)
    onehot = (frame_id[:, None] == jnp.arange(E)[None, :]).astype(xy.dtype)

    # center per frame before accumulating second moments (see
    # _iter_fit_impl: float32 absolute-coordinate moments cancel
    # catastrophically for catalogs far from the origin)
    we0 = onehot * w0[:, None]
    sw0 = jnp.maximum(reduce_sum(jnp.sum(we0, axis=0)), 1e-12)  # (E,)
    c = (reduce_sum(jnp.einsum("ne,ni->ei", we0, xy, precision=_P))
         / sw0[:, None])                                        # (E, 2)
    xy = xy - c[frame_id]
    uv = uv - c[frame_id]

    def moments(w):
        we = onehot * w[:, None]  # (N, E)
        return dict(
            sw=reduce_sum(jnp.sum(we, axis=0)),
            sx=reduce_sum(jnp.einsum("ne,ni->ei", we, xy, precision=_P)),
            su=reduce_sum(jnp.einsum("ne,ni->ei", we, uv, precision=_P)),
            sxx=reduce_sum(jnp.einsum("ne,ni,nj->eij", we, xy, xy,
                                      precision=_P)),
            sux=reduce_sum(jnp.einsum("ne,ni,nj->eij", we, uv, xy,
                                      precision=_P)),
        )

    def solve(mom):
        return jax.vmap(
            lambda sw, sx, su, sxx, sux: _solve_from_moments(
                dict(sw=sw, sx=sx, su=su, sxx=sxx, sux=sux),
                fitgeom, xy.dtype)
        )(mom["sw"], mom["sx"], mom["su"], mom["sxx"], mom["sux"])

    def fit_and_resid(w):
        M, t = solve(moments(w))  # (E,2,2), (E,2)
        Mi = M[frame_id]
        ti = t[frame_id]
        pred = jnp.einsum("nij,nj->ni", Mi, xy, precision=_P) + ti
        resid = uv - pred
        r2 = jnp.sum(resid * resid, axis=1)
        return M, t, resid, r2

    def clip_step(_, w):
        M, t, resid, r2 = fit_and_resid(w)
        we = onehot * w[:, None]
        wsum = jnp.maximum(reduce_sum(jnp.sum(we, axis=0)), 1e-12)  # (E,)
        rms2 = reduce_sum(jnp.sum(we * r2[:, None], axis=0)) / wsum
        thr = (sigma * sigma) * jnp.maximum(rms2, 1e-24)
        keep = r2 <= thr[frame_id]
        w_new = jnp.where(keep, w, 0.0)
        counts = reduce_sum(jnp.sum(onehot * (w_new > 0)[:, None], axis=0))
        enough = (counts >= 3)[frame_id]
        return jnp.where(enough, w_new, w)

    w = jax.lax.fori_loop(0, nclip, clip_step, w0) if nclip > 0 else w0
    M, t, resid, r2 = fit_and_resid(w)

    we = onehot * w[:, None]
    wsum = jnp.maximum(reduce_sum(jnp.sum(we, axis=0)), 1e-12)
    rms = jnp.sqrt(
        reduce_sum(jnp.einsum("ne,ni->ei", we, resid * resid, precision=_P))
        / wsum[:, None]
    )
    rmse = jnp.sqrt(reduce_sum(jnp.sum(we * r2[:, None], axis=0)) / wsum)
    mae = reduce_sum(jnp.sum(we * jnp.sqrt(r2)[:, None], axis=0)) / wsum
    nmatches = reduce_sum(
        jnp.sum(onehot * (w > 0)[:, None], axis=0)).astype(jnp.int32)
    # un-center per frame: uv = M xy + t in ORIGINAL coordinates
    t = t + c - jnp.einsum("eij,ej->ei", M, c, precision=_P)
    return LinearFitResult(
        matrix=M, shift=t, rms=rms, rmse=rmse, mae=mae,
        nmatches=nmatches, weights=w,
    )


def iter_linear_fit_sharded(
    xy: jax.Array,
    uv: jax.Array,
    wxy: jax.Array | None,
    axis_name: str,
    fitgeom: str = "general",
    nclip: int = 3,
    sigma: float = 3.0,
) -> LinearFitResult:
    """Distributed fit for use INSIDE ``shard_map``: the point axis is
    sharded over ``axis_name`` and all moment reductions go through
    ``lax.psum`` (ICI/DCN collectives — SURVEY §2b). Numerically identical
    to the single-device fit up to reduction order.
    """
    xy, uv, w0 = _prep(xy, uv, wxy)
    return _iter_fit_impl(
        xy, uv, w0, fitgeom, nclip, sigma,
        lambda s: jax.lax.psum(s, axis_name),
    )
