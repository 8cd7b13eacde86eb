"""Mesh construction + SPMD measurement/fit (shard_map + collectives).

Design (SURVEY §2b, scaling-book recipe): pick a 1-D mesh over the cutout
batch axis — the natural data-parallel axis of this workload (hundreds of
sources × exposures, each an independent FFT correlation) — annotate the
batch inputs with a NamedSharding, run the measurement under ``shard_map``
(embarrassingly parallel), and let the *fit* reductions ride ``psum``
collectives so the sigma-clipped global solve is exact, not per-shard.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.correlate import Displacement, find_displacement
from ..ops.fit import (
    LinearFitResult,
    iter_linear_fit_frames,
    iter_linear_fit_sharded,
)
from ..ops.interp import sample_image

__all__ = [
    "make_mesh",
    "pad_to_multiple",
    "sharded_find_displacement",
    "sharded_measure_and_fit",
    "make_sharded_align_step",
]

AXIS = "cutouts"


def make_mesh(n_devices: int | None = None, axis_name: str = AXIS) -> Mesh:
    """A 1-D device mesh over the cutout-batch axis.

    ``n_devices=None`` uses all available devices. The cards of one
    host reach each other all to all (NVLink), so a plain 1-D list of
    devices is the right mesh: the collectives need no topology.
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def pad_to_multiple(arr: jax.Array, multiple: int, axis: int = 0,
                    fill=0) -> tuple[jax.Array, int]:
    """Pad ``axis`` up to a multiple (returns padded array + pad count).

    Sharding needs the batch divisible by the mesh size; padded entries
    must be masked out by the caller (weight 0 / mask False).
    """
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr, 0
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return jnp.pad(arr, widths, constant_values=fill), pad


def sharded_find_displacement(
    ref: jax.Array,
    img: jax.Array,
    mesh: Mesh | None = None,
    ref_mask: jax.Array | None = None,
    img_mask: jax.Array | None = None,
    **kw,
) -> Displacement:
    """Batched displacement measurement sharded over the cutout axis.

    Embarrassingly parallel — no collectives; each device runs the batched
    rfft2/irfft2 + peak fit on its shard. The batch is padded to the mesh
    size and the padding stripped from the result.
    """
    if mesh is None:
        mesh = make_mesh()
    n = mesh.devices.size
    axis = mesh.axis_names[0]
    B = ref.shape[0]
    ref_p, pad = pad_to_multiple(jnp.asarray(ref), n)
    img_p, _ = pad_to_multiple(jnp.asarray(img), n)
    masks = []
    for m in (ref_mask, img_mask):
        if m is None:
            masks.append(jnp.ones(ref_p.shape, jnp.float32))
        else:
            masks.append(pad_to_multiple(
                jnp.asarray(m, jnp.float32), n)[0])
    rm, im = masks

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )
    def run(r, i, rmk, imk):
        return find_displacement(r, i, ref_mask=rmk, img_mask=imk, **kw)

    out = jax.jit(run)(ref_p, img_p, rm, im)
    return Displacement(*(o[:B] for o in out))


def sharded_measure_and_fit(
    blotted: jax.Array,
    img: jax.Array,
    mask: jax.Array,
    xy: jax.Array,
    weights: jax.Array,
    mesh: Mesh | None = None,
    jac: jax.Array | None = None,
    cc_type: str = "NCC",
    usfac: int = 1,
    peak_fit_box: int = 5,
    fit_type: str = "quadratic",
    fitgeom: str = "general",
    nclip: int = 3,
    sigma: float = 3.0,
    peak_search_box="fitbox",
) -> tuple[Displacement, LinearFitResult]:
    """One SPMD alignment measurement for ONE exposure (or jointly for a
    stack flattened over (exposure, source)).

    blotted/img/mask : (B, h, w) cutout pairs, sharded over B.
    xy : (B, 2) reference-frame source positions.
    weights : (B,) measurement weights (0 = padded/invalid).
    jac : optional (B, 2, 2) exposure→ref Jacobians applied to the
        measured pixel displacements.

    The displacement measurement is local per shard; the sigma-clipped
    linear fit reduces through ``lax.psum`` so all devices agree on the
    global (M, t) — this is BASELINE config 5's joint-fit collective path.
    """
    if mesh is None:
        mesh = make_mesh()
    n = mesh.devices.size
    axis = mesh.axis_names[0]
    B = img.shape[0]

    blotted_p, _ = pad_to_multiple(jnp.asarray(blotted), n)
    img_p, _ = pad_to_multiple(jnp.asarray(img), n)
    mask_p, _ = pad_to_multiple(jnp.asarray(mask, jnp.float32), n)
    xy_p, _ = pad_to_multiple(jnp.asarray(xy, jnp.float32), n)
    w_p, _ = pad_to_multiple(jnp.asarray(weights, jnp.float32), n)
    if jac is None:
        jac = jnp.tile(jnp.eye(2, dtype=jnp.float32)[None], (B, 1, 1))
    jac_p, _ = pad_to_multiple(jnp.asarray(jac, jnp.float32), n)

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis),) * 6,
        out_specs=(P(axis), (P(), P(), P(), P(), P(), P(), P(axis))),
    )
    def run(bl, im, mk, pos, wgt, J):
        d = find_displacement(
            bl, im, cc_type=cc_type, usfac=usfac,
            peak_fit_box=peak_fit_box, fit_type=fit_type,
            ref_mask=mk, img_mask=mk, peak_search_box=peak_search_box,
        )
        dxy = jnp.stack([d.dx, d.dy], axis=-1)
        duv = jnp.einsum("nik,nk->ni", J, dxy,
                         precision=jax.lax.Precision.HIGHEST)
        uv = pos + duv
        w_eff = wgt * (d.fit_ok & (d.peak > 0)).astype(jnp.float32)
        fit = iter_linear_fit_sharded(
            uv, pos, w_eff, axis_name=axis,
            fitgeom=fitgeom, nclip=nclip, sigma=sigma,
        )
        return d, tuple(fit)

    d, fit = jax.jit(run)(blotted_p, img_p, mask_p, xy_p, w_p, jac_p)
    d = Displacement(*(o[:B] for o in d))
    fit = LinearFitResult(*fit[:-1], fit[-1][:B])
    return d, fit


def make_sharded_align_step(
    mesh: Mesh,
    n_frames: int,
    cc_type: str = "NCC",
    usfac: int = 1,
    peak_fit_box: int = 5,
    fit_type: str = "quadratic",
    fitgeom: str = "general",
    nclip: int = 3,
    sigma: float = 3.0,
    peak_search_box="fitbox",
    interp: str = "poly5",
):
    """Build the full multi-chip align iteration (BASELINE config 5).

    One jit-compiled SPMD program over a flattened (frame, source) cutout
    batch sharded across the mesh: every device blots its shard of cutout
    grids from the (replicated) reference plane, measures displacements
    with batched FFT correlation + subpixel peak fit, contributes per-
    frame moment sums to the psum-reduced sigma-clipped fits, and all
    devices deterministically compose the same per-frame affine update.

    Returned callable signature::

        step(Ms, ts, drz, cut_px, cut_py, img, msk, xy0, jac, w, frame_id)
            -> (Ms', ts', LinearFitResult)

    with Ms (E,2,2) / ts (E,2) / drz (H,W) replicated and all (B, ...)
    inputs sharded over the mesh axis. ``frame_id`` (B,) int32 maps each
    cutout to its frame. B must be divisible by the mesh size (use
    :func:`pad_to_multiple` + zero weights).
    """
    axis = mesh.axis_names[0]
    E = int(n_frames)
    _HP = jax.lax.Precision.HIGHEST

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(),                      # Ms, ts, drz
                  P(axis), P(axis), P(axis), P(axis),  # cut_px/py, img, msk
                  P(axis), P(axis), P(axis), P(axis)),  # xy0, jac, w, fid
        out_specs=(P(), P(),
                   (P(), P(), P(), P(), P(), P(), P(axis))),
    )
    def step(Ms, ts, drz, cut_px, cut_py, img, msk, xy0, jac, w, frame_id):
        Mi = Ms[frame_id]                      # (B,2,2) per-point affine
        ti = ts[frame_id]
        # blot: affine-correct the pixmaps, then gather from the reference
        bx = (Mi[:, 0, 0, None, None] * cut_px
              + Mi[:, 0, 1, None, None] * cut_py + ti[:, 0, None, None])
        by = (Mi[:, 1, 0, None, None] * cut_px
              + Mi[:, 1, 1, None, None] * cut_py + ti[:, 1, None, None])
        blotted, ok = jax.vmap(
            lambda x, y: sample_image(drz, x, y, interp=interp)
        )(bx, by)
        m = msk & ok
        d = find_displacement(
            blotted, img, cc_type=cc_type, usfac=usfac,
            peak_fit_box=peak_fit_box, fit_type=fit_type,
            ref_mask=m, img_mask=m, peak_search_box=peak_search_box,
        )
        dxy = jnp.stack([d.dx, d.dy], axis=-1)
        MJ = jnp.einsum("nij,njk->nik", Mi, jac, precision=_HP)
        duv = jnp.einsum("nik,nk->ni", MJ, dxy, precision=_HP)
        uv = xy0 + duv
        w_eff = w * (d.fit_ok & (d.peak > 0)).astype(jnp.float32)
        fit = iter_linear_fit_frames(
            uv, xy0, frame_id, E, wxy=w_eff,
            fitgeom=fitgeom, nclip=nclip, sigma=sigma, axis_name=axis,
        )
        G_M, G_t = fit.matrix, fit.shift       # (E,2,2), (E,2)
        newM = jnp.einsum("eij,ejk->eik", G_M, Ms, precision=_HP)
        newt = jnp.einsum("eij,ej->ei", G_M, ts, precision=_HP) + G_t
        return newM, newt, tuple(fit)

    def wrapped(Ms, ts, drz, cut_px, cut_py, img, msk, xy0, jac, w,
                frame_id):
        newM, newt, fit = step(Ms, ts, drz, cut_px, cut_py, img, msk,
                               xy0, jac, w, frame_id)
        return newM, newt, LinearFitResult(*fit)

    return jax.jit(wrapped)
