"""Host-side Cutout objects and catalog-driven cutout creation.

Capability parity with the reference's largest module,
``subpixal/cutout.py`` (SURVEY.md §2 #3, §3.5): the ``Cutout`` container
(data + WCS + bbox + source position + mask/weight), creation of *primary*
cutouts around catalog sources on the drizzled reference image (sized from
the segmentation footprint), matched cutouts on each input exposure,
the reverse mapping (drz-from-input), insertion back into images, and the
``NoOverlapError`` / ``PartialOverlapError`` semantics.

Device-first split: these host objects carry bookkeeping (WCS, ids, units);
the *pixels* for the hot loop are packed into fixed-shape device batches
via :func:`cutouts_to_batch` (padded to one static (h, w) with validity
masks — SURVEY §7 "Fixed shapes under jit") and processed by
:mod:`subpixal_tpu.ops`.
"""

from __future__ import annotations

import numpy as np

from .wcs.wcs import TanWCS

__all__ = [
    "Cutout",
    "NoOverlapError",
    "PartialOverlapError",
    "create_primary_cutouts",
    "create_input_image_cutouts",
    "create_cutouts",
    "drz_from_input_cutouts",
    "cutouts_to_batch",
]


class NoOverlapError(ValueError):
    """Cutout bounding box has no overlap with the image (reference
    ``cutout.NoOverlapError``)."""


class PartialOverlapError(ValueError):
    """Cutout bounding box only partially overlaps the image (reference
    ``cutout.PartialOverlapError``)."""


class Cutout:
    """A rectangular cutout of an image with WCS and source metadata.

    Attributes (parity with reference ``Cutout``): ``data``, ``mask``
    (True = valid pixel), ``src_weight``, ``blc``/``trc`` ((y, x) corners
    in the parent image, inclusive), ``src_pos`` ((x, y) of the source in
    *cutout* coordinates), ``wcs`` (cutout-local, CRPIX-shifted),``exptime``,
    ``data_units``.
    """

    def __init__(self, data, wcs: TanWCS, blc=(0, 0), src_pos=None,
                 mask=None, src_weight: float = 1.0, exptime: float = 1.0,
                 data_units: str = "rate", src_id: int = -1):
        self.data = np.asarray(data)
        self.wcs = wcs
        self.blc = (int(blc[0]), int(blc[1]))
        h, w = self.data.shape
        self.trc = (self.blc[0] + h - 1, self.blc[1] + w - 1)
        self.src_pos = (float(src_pos[0]), float(src_pos[1])) \
            if src_pos is not None else (w / 2.0, h / 2.0)
        self.mask = (np.ones(self.data.shape, bool) if mask is None
                     else np.asarray(mask, bool))
        self.src_weight = float(src_weight)
        self.exptime = float(exptime)
        self.data_units = data_units
        self.src_id = int(src_id)

    # -- geometry ------------------------------------------------------ #
    @property
    def shape(self) -> tuple[int, int]:
        return self.data.shape

    def get_bbox(self) -> tuple[tuple[int, int], tuple[int, int]]:
        """((y0, x0), (y1, x1)) inclusive corners in the parent frame."""
        return self.blc, self.trc

    @property
    def pscale(self) -> float:
        """Pixel scale, arcsec/pix (parity with reference pixel-scale
        properties)."""
        return self.wcs.pscale

    @property
    def src_pos_parent(self) -> tuple[float, float]:
        """Source position (x, y) in the parent image frame."""
        return (self.src_pos[0] + self.blc[1], self.src_pos[1] + self.blc[0])

    # -- data movement -------------------------------------------------- #
    def insert_into_image(self, image: np.ndarray, mode: str = "set"):
        """Insert this cutout's data into a numpy image in place (clipped;
        parity with reference ``Cutout.insert_into_image``)."""
        H, W = image.shape
        y0, x0 = self.blc
        h, w = self.data.shape
        iy0, ix0 = max(y0, 0), max(x0, 0)
        iy1, ix1 = min(y0 + h, H), min(x0 + w, W)
        if iy1 <= iy0 or ix1 <= ix0:
            raise NoOverlapError("cutout does not overlap the image")
        cy0, cx0 = iy0 - y0, ix0 - x0
        src = self.data[cy0:cy0 + (iy1 - iy0), cx0:cx0 + (ix1 - ix0)]
        msk = self.mask[cy0:cy0 + (iy1 - iy0), cx0:cx0 + (ix1 - ix0)]
        tgt = image[iy0:iy1, ix0:ix1]
        if mode == "set":
            tgt[msk] = src[msk]
        elif mode == "add":
            tgt[msk] += src[msk]
        else:
            raise ValueError(f"unknown mode: {mode!r}")
        return image

    def __repr__(self):
        return (f"Cutout(id={self.src_id}, blc={self.blc}, "
                f"shape={self.data.shape})")


def _extract_host(imdata: np.ndarray, y0: int, x0: int, h: int, w: int,
                  allow_partial: bool = True):
    """Host cutout extraction with overlap classification."""
    H, W = imdata.shape
    iy0, ix0 = max(y0, 0), max(x0, 0)
    iy1, ix1 = min(y0 + h, H), min(x0 + w, W)
    if iy1 <= iy0 or ix1 <= ix0:
        raise NoOverlapError(f"bbox ({y0},{x0})+({h},{w}) outside image")
    partial = (iy0 != y0 or ix0 != x0 or iy1 != y0 + h or ix1 != x0 + w)
    if partial and not allow_partial:
        raise PartialOverlapError(f"bbox ({y0},{x0})+({h},{w}) truncated")
    data = np.zeros((h, w), imdata.dtype)
    mask = np.zeros((h, w), bool)
    data[iy0 - y0:iy1 - y0, ix0 - x0:ix1 - x0] = imdata[iy0:iy1, ix0:ix1]
    mask[iy0 - y0:iy1 - y0, ix0 - x0:ix1 - x0] = True
    return data, mask


def create_primary_cutouts(
    catalog,
    segmentation_image: np.ndarray,
    imdata: np.ndarray,
    imwcs: TanWCS,
    pad: int = 1,
    min_box_size: int = 8,
    max_box_size: int = 512,
    combine_seg_mask: bool = True,
    exptime: float = 1.0,
    data_units: str = "rate",
) -> list[Cutout]:
    """Cutouts around catalog sources on the (drizzled) reference image.

    Parity: reference ``cutout.create_primary_cutouts`` (SURVEY §3.5):
    each source's box comes from its segmentation footprint (+``pad``),
    too-small/off-image sources are rejected, the segmentation mask is
    attached (and multiplied into the data when ``combine_seg_mask`` —
    reference ``combine_seg_mask=True`` behavior), and each cutout gets a
    CRPIX-shifted deep-copied WCS.
    """
    seg = np.asarray(segmentation_image)
    out: list[Cutout] = []
    n = len(catalog)
    ids = (np.asarray(catalog["id"], int) if "id" in catalog
           else np.arange(1, n + 1))
    xs = np.asarray(catalog["x"], float)
    ys = np.asarray(catalog["y"], float)
    flux = (np.asarray(catalog["flux"], float) if "flux" in catalog
            else np.ones(n))

    # all footprint bboxes in ONE image pass (a per-source ``seg == id``
    # scan is O(n_sources * H * W) — tens of seconds at catalog scale)
    maxid = int(seg.max(initial=0))
    big = np.iinfo(np.int64).max
    bb_y0 = np.full(maxid + 1, big)
    bb_x0 = np.full(maxid + 1, big)
    bb_y1 = np.full(maxid + 1, -1)
    bb_x1 = np.full(maxid + 1, -1)
    if maxid > 0:
        myy, mxx = np.nonzero(seg > 0)
        vals = seg[myy, mxx].astype(np.int64)
        np.minimum.at(bb_y0, vals, myy)
        np.minimum.at(bb_x0, vals, mxx)
        np.maximum.at(bb_y1, vals, myy)
        np.maximum.at(bb_x1, vals, mxx)

    for k in range(n):
        sid = int(ids[k])
        has_fp = 0 < sid <= maxid and bb_y1[sid] >= 0
        if not has_fp:
            # no segmentation footprint: fall back to a min-size box
            y0 = int(round(ys[k])) - min_box_size // 2
            x0 = int(round(xs[k])) - min_box_size // 2
            h = w = min_box_size
        else:
            fy0, fy1 = int(bb_y0[sid]), int(bb_y1[sid])
            fx0, fx1 = int(bb_x0[sid]), int(bb_x1[sid])
            y0 = fy0 - pad
            x0 = fx0 - pad
            h = fy1 - y0 + 1 + pad
            w = fx1 - x0 + 1 + pad
            if h < min_box_size or w < min_box_size:
                cy, cx = (fy0 + fy1) / 2, (fx0 + fx1) / 2
                h = w = max(h, w, min_box_size)
                y0 = int(round(cy)) - h // 2
                x0 = int(round(cx)) - w // 2
            if h > max_box_size or w > max_box_size:
                continue  # reject absurd footprints (blended junk)
        try:
            data, mask = _extract_host(imdata, y0, x0, h, w)
        except NoOverlapError:
            continue
        segmask, _ = _extract_host(seg, y0, x0, h, w)
        srcmask = (segmask == sid) | (segmask == 0)
        if has_fp:
            srcsel = segmask == sid
            if combine_seg_mask:
                data = data * srcsel
            mask = mask & srcmask
        cw = imwcs.with_shifted_crpix(x0, y0)
        out.append(Cutout(
            data=data, wcs=cw, blc=(y0, x0),
            src_pos=(xs[k] - x0, ys[k] - y0),
            mask=mask, src_weight=float(flux[k]),
            exptime=exptime, data_units=data_units, src_id=sid,
        ))
    return out


def create_input_image_cutouts(
    primary_cutouts: list[Cutout],
    imdata: np.ndarray,
    imwcs: TanWCS,
    pad: int = 2,
    exptime: float = 1.0,
    data_units: str = "rate",
) -> tuple[list[Cutout], list[Cutout]]:
    """Cutouts on an input exposure matched to the primary cutouts.

    Parity: reference ``cutout.create_input_image_cutouts`` (SURVEY §3.1):
    each primary cutout's sky box is mapped through the exposure's WCS
    (distortion included); sources that fall off the exposure are skipped
    (the reference's NoOverlapError path). Returns (image_cutouts,
    matching_primary_cutouts) — only the surviving pairs.
    """
    img_cutouts: list[Cutout] = []
    matched: list[Cutout] = []
    H, W = imdata.shape
    for pc in primary_cutouts:
        h, w = pc.data.shape
        # map the primary cutout corners + source to the exposure frame
        corners_x = np.array([0.0, w - 1.0, 0.0, w - 1.0])
        corners_y = np.array([0.0, 0.0, h - 1.0, h - 1.0])
        ra, dec = pc.wcs.pixel_to_world(corners_x, corners_y)
        cx, cy = imwcs.world_to_pixel(ra, dec)
        sra, sdec = pc.wcs.pixel_to_world(*pc.src_pos)
        sx, sy = imwcs.world_to_pixel(sra, sdec)
        x0 = int(np.floor(cx.min())) - pad
        x1 = int(np.ceil(cx.max())) + pad
        y0 = int(np.floor(cy.min())) - pad
        y1 = int(np.ceil(cy.max())) + pad
        try:
            data, mask = _extract_host(imdata, y0, x0, y1 - y0 + 1, x1 - x0 + 1)
        except NoOverlapError:
            continue
        cw = imwcs.with_shifted_crpix(x0, y0)
        img_cutouts.append(Cutout(
            data=data, wcs=cw, blc=(y0, x0),
            src_pos=(float(sx) - x0, float(sy) - y0),
            mask=mask, src_weight=pc.src_weight,
            exptime=exptime, data_units=data_units, src_id=pc.src_id,
        ))
        matched.append(pc)
    return img_cutouts, matched


def create_cutouts(
    primary_cutouts: list[Cutout],
    imdata: np.ndarray,
    imwcs: TanWCS,
    pad: int = 2,
    **kw,
) -> tuple[list[Cutout], list[Cutout]]:
    """Matched (image_cutout, primary_cutout) pairs for one exposure.

    Parity: reference ``cutout.create_cutouts`` — the convenience wrapper
    the align loop calls per exposure (SURVEY §3.1)."""
    return create_input_image_cutouts(primary_cutouts, imdata, imwcs,
                                      pad=pad, **kw)


def drz_from_input_cutouts(
    input_cutouts: list[Cutout],
    drz_data: np.ndarray,
    drz_wcs: TanWCS,
    pad: int = 2,
    exptime: float = 1.0,
    data_units: str = "rate",
) -> tuple[list[Cutout], list[Cutout]]:
    """Reverse mapping: cutouts on the drizzled image matched to input
    exposure cutouts (parity: reference ``cutout.drz_from_input_cutouts``).
    """
    return create_input_image_cutouts(
        input_cutouts, drz_data, drz_wcs, pad=pad,
        exptime=exptime, data_units=data_units,
    )


def cutouts_to_batch(
    cutouts: list[Cutout],
    shape: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack host cutouts into one fixed-shape batch for the device ops.

    Pads every cutout (centered) to a common static ``shape`` (default:
    the max h/w over the batch, rounded up to a multiple of 8 for aligned
    tiling). Returns (data (B,h,w) f32, mask (B,h,w) bool, offsets (B,2)
    f32) where ``offsets`` is the (y, x) of each original cutout's (0,0)
    inside the padded frame — needed to convert measured displacements
    back to original-cutout coordinates (they cancel for same-padded
    pairs).
    """
    if not cutouts:
        raise ValueError("no cutouts to batch")
    if shape is None:
        h = max(c.data.shape[0] for c in cutouts)
        w = max(c.data.shape[1] for c in cutouts)
        h = int(np.ceil(h / 8) * 8)
        w = int(np.ceil(w / 8) * 8)
        shape = (h, w)
    h, w = shape
    B = len(cutouts)
    data = np.zeros((B, h, w), np.float32)
    mask = np.zeros((B, h, w), bool)
    offs = np.zeros((B, 2), np.float32)
    for i, c in enumerate(cutouts):
        ch, cw = c.data.shape
        ch2, cw2 = min(ch, h), min(cw, w)
        oy = (h - ch2) // 2
        ox = (w - cw2) // 2
        data[i, oy:oy + ch2, ox:ox + cw2] = c.data[:ch2, :cw2]
        mask[i, oy:oy + ch2, ox:ox + cw2] = c.mask[:ch2, :cw2]
        offs[i] = (oy, ox)
    return data, mask, offs
