"""Fixed-shape cutout extraction/insertion on device.

Device-side counterpart of the reference's ``subpixal/cutout.py`` geometry
core (SURVEY.md §2 #3, §3.5). The reference creates variable-sized numpy
view cutouts and raises ``NoOverlapError`` / ``PartialOverlapError``;
under XLA everything must be static-shaped, so this module redesigns the
semantics:

* all cutouts in a batch share one **static (h, w) shape** (callers bucket
  or pad; the align pipeline sizes from the largest segmentation footprint);
* extraction is a **vectorized gather**: ``lax.dynamic_slice`` of a
  zero-padded plane under ``vmap`` — one fused HBM gather for the whole
  catalog (BASELINE north-star: "cutout extraction ... becomes a
  vectorized gather over HBM-resident image planes");
* overlap exceptions become per-cutout **validity masks**: ``mask`` marks
  pixels that landed inside the image, and ``overlap`` summarizes each
  cutout as NONE / PARTIAL / FULL so the host API can reproduce the
  reference's exception behavior (SURVEY §5 "failure detection").

Host-side ``Cutout`` objects (WCS-aware, reference-API-compatible) live in
``subpixal_tpu.cutout``; they wrap the arrays produced here.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "CutoutBatch",
    "extract_cutouts",
    "insert_cutouts",
    "OVERLAP_NONE",
    "OVERLAP_PARTIAL",
    "OVERLAP_FULL",
]

OVERLAP_NONE = 0
OVERLAP_PARTIAL = 1
OVERLAP_FULL = 2


class CutoutBatch(NamedTuple):
    """A batch of fixed-shape cutouts gathered from one image plane.

    data : (B, h, w) float — pixel data; zero outside the source image.
    mask : (B, h, w) bool — True where the pixel came from inside the image.
    blc : (B, 2) int32 — (y, x) of each cutout's bottom-left corner in the
        source image frame (may be negative / past the edge; ``mask`` tells
        which pixels are real). Matches the reference ``Cutout.blc`` role.
    overlap : (B,) int32 — OVERLAP_NONE / OVERLAP_PARTIAL / OVERLAP_FULL,
        the fixed-shape stand-in for NoOverlapError / PartialOverlapError.
    """

    data: jax.Array
    mask: jax.Array
    blc: jax.Array
    overlap: jax.Array


def _pixel_coords(blc, shape, bounds):
    """Per-cutout absolute pixel grids + in-image validity (shared by
    extract and insert so their bounds conventions cannot diverge)."""
    h, w = shape
    H, W = bounds
    ii = jnp.arange(h)[None, :, None]
    jj = jnp.arange(w)[None, None, :]
    yy = blc[:, 0][:, None, None] + ii
    xx = blc[:, 1][:, None, None] + jj
    return yy, xx, (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)


def cutout_blc(centers: jax.Array, shape: tuple[int, int]) -> jax.Array:
    """Bottom-left corners (y, x) so each cutout is centered on ``centers``.

    centers : (B, 2) float array of (x, y) positions (reference convention:
    catalog x = column, y = row).
    """
    h, w = shape
    cx = centers[:, 0]
    cy = centers[:, 1]
    # floor(c+0.5): reference round-half-up convention (py2round)
    bx = jnp.floor(cx + 0.5).astype(jnp.int32) - (w // 2)
    by = jnp.floor(cy + 0.5).astype(jnp.int32) - (h // 2)
    return jnp.stack([by, bx], axis=1)


def extract_cutouts(
    image: jax.Array,
    centers: jax.Array,
    shape: tuple[int, int],
    fill_value: float = 0.0,
) -> CutoutBatch:
    """Gather fixed-shape cutouts centered on catalog positions.

    Parameters
    ----------
    image : (H, W) array — HBM-resident plane.
    centers : (B, 2) float — (x, y) source positions.
    shape : (h, w) static cutout shape.
    fill_value : value used for pixels outside the image.

    Returns a :class:`CutoutBatch`. Out-of-image cutouts are not an error —
    their ``overlap`` is OVERLAP_NONE and their mask is all-False.
    """
    h, w = shape
    H, W = image.shape
    blc = cutout_blc(centers, shape)

    # Zero-pad by the cutout size on each side so every dynamic_slice is
    # in-bounds; the gather itself then never needs clipping logic.
    padded = jnp.pad(image, ((h, h), (w, w)), constant_values=fill_value)

    def one(b):
        return jax.lax.dynamic_slice(padded, (b[0] + h, b[1] + w), (h, w))

    data = jax.vmap(one)(blc)

    # Validity: cutout pixel (i, j) maps to image pixel (blc + (i, j)).
    _, _, mask = _pixel_coords(blc, (h, w), (H, W))

    nvalid = jnp.sum(mask, axis=(1, 2))
    overlap = jnp.where(
        nvalid == 0,
        OVERLAP_NONE,
        jnp.where(nvalid == h * w, OVERLAP_FULL, OVERLAP_PARTIAL),
    ).astype(jnp.int32)
    return CutoutBatch(data=data, mask=mask, blc=blc, overlap=overlap)


def insert_cutouts(
    image: jax.Array,
    data: jax.Array,
    blc: jax.Array,
    mask: jax.Array | None = None,
    mode: str = "set",
) -> jax.Array:
    """Insert (scatter) a batch of cutouts back into an image plane.

    Parity: reference ``Cutout.insert_into_image()`` (SURVEY §2 #3),
    vectorized. ``mode='set'`` overwrites (last write wins on overlap,
    matching serial insertion order), ``mode='add'`` accumulates — the
    primitive the drizzle resampler builds on.

    Out-of-image pixels (and ``mask``-False pixels) are dropped, matching
    the reference's silent clipping on insertion.
    """
    H, W = image.shape
    B, h, w = data.shape
    yy, xx, valid = _pixel_coords(blc, (h, w), (H, W))
    if mask is not None:
        valid = valid & mask

    # Flat scatter with a trash slot for invalid pixels (fixed shapes, no
    # data-dependent filtering).
    flat_idx = jnp.where(valid, yy * W + xx, H * W)
    vals = data.astype(image.dtype)
    buf = jnp.concatenate([image.reshape(-1), jnp.zeros((1,), image.dtype)])
    if mode == "add":
        vals = jnp.where(valid, vals, 0)
        buf = buf.at[flat_idx.reshape(-1)].add(vals.reshape(-1))
    elif mode == "set":
        # one scatter PER cutout, in batch order: XLA applies duplicate
        # .set indices in implementation-defined order, so a single
        # scatter would make overlap regions nondeterministic — the
        # sequential loop pins the documented last-write-wins (serial
        # insertion) semantics. Not a hot path (host-utility op).
        fi = flat_idx.reshape(B, h * w)
        fv = vals.reshape(B, h * w)

        def body(b, acc):
            return acc.at[
                jax.lax.dynamic_index_in_dim(fi, b, keepdims=False)].set(
                jax.lax.dynamic_index_in_dim(fv, b, keepdims=False))

        buf = jax.lax.fori_loop(0, B, body, buf)
    else:
        raise ValueError(f"unknown mode: {mode!r} (expected 'set'|'add')")
    return buf[:-1].reshape(H, W)
