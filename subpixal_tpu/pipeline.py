"""FITS-level pipeline: the reference's file-based workflow.

The reference's users hand ``align_images`` FITS files; the corrected
WCSs are written back into the SCI extension headers (with HISTORY
records — SURVEY.md §3.1 "apply WCS correction to exposure SCI
header(s)", §5 "Checkpoint/resume": state between iterations lives in
FITS headers, so a killed run resumes from the last written headers).

This module provides that workflow on top of the array-level
:func:`subpixal_tpu.align.align_images`:

* :func:`load_exposures` — read SCI extensions (+ optional WHT) into
  :class:`~subpixal_tpu.resample.Exposure` objects;
* :func:`align_fits` — end-to-end: load, align, write corrected WCS
  keywords + HISTORY back into the input files (or copies);
* :class:`AlignState` — an explicit serializable checkpoint of the
  alignment state (per-image affine, iteration count, fit history) as a
  JSON file, beyond the implicit header-based resume.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import numpy as np

from .align import AlignResult, align_images
from .io.fits import read_fits, write_fits
from .resample import Drizzle, Exposure
from .utils import parse_file_name
from .wcs.fitswcs import wcs_from_header, wcs_to_header

__all__ = ["load_exposures", "align_fits", "AlignState"]


def _aux_data(hdul, aux_ext, sci_ver):
    """Load a WHT/ERR-style companion extension for one SCI chip.

    A bare NAME string pairs with the SCI chip's EXTVER (HST layout:
    ``SCI,2`` ↔ ``WHT,2``/``ERR,2``); an explicit tuple/int is used
    verbatim."""
    if aux_ext is None:
        return None
    key = (aux_ext, sci_ver) if isinstance(aux_ext, str) else aux_ext
    try:
        return np.asarray(hdul[key].data, np.float32)
    except (KeyError, IndexError):
        return None


def _exposure_from_hdu(hdul, hdu, name, wht_ext, err_ext) -> Exposure:
    from .wcs.fitswcs import wcs_from_hdul

    # full stwcs-style chain: SCI-header TAN+SIP plus any lookup-table
    # distortion extensions (WCSDVARR/D2IMARR) in the file, chip k's
    # grids at EXTVER (2k-1, 2k) with the single (1, 2) pair shared
    # when that is all the file carries (round-5 fix: the loader read
    # only the SCI header, silently dropping table distortion)
    wcs = wcs_from_hdul(hdul, ext=hdu, chip=getattr(hdu, "ver", 1))
    exptime = float(hdu.header.get(
        "EXPTIME", hdul[0].header.get("EXPTIME", 1.0)))
    bunit = str(hdu.header.get("BUNIT", "")).upper()
    # rate units appear as '/S', 'S-1', 'S^-1', 'S**-1', 'SEC-1', ...
    rate_forms = ("/S", "S-1", "S^-1", "S**-1",
                  "SEC-1", "SEC^-1", "SEC**-1", "/SEC")
    counts = (bool(bunit)
              and not any(f in bunit for f in rate_forms)
              and bunit not in ("UNITLESS",))
    ver = getattr(hdu, "ver", 1)
    return Exposure(np.asarray(hdu.data, np.float32), wcs,
                    weight=_aux_data(hdul, wht_ext, ver),
                    exptime=exptime, name=name,
                    data_units="counts" if counts else "rate",
                    err=_aux_data(hdul, err_ext, ver))


def load_exposures(
    image_fnames: Sequence[str] | str,
    ext=None,
    wht_ext=None,
    err_ext=None,
) -> list[Exposure]:
    """Read FITS exposures (``"file.fits[sci,1]"`` specs supported).

    By default (``ext=None``) a bare filename expands to **every SCI
    extension** — reference parity: the align loop processes "each SCI
    ext" of every FLT/FLC (SURVEY §3.1), so a 2-chip ACS file yields two
    :class:`Exposure` objects named ``f.fits[sci,1]`` / ``f.fits[sci,2]``
    that share the file (and :func:`align_fits` writes each chip's WCS
    back to its own header). Pass an explicit ``ext`` (``("SCI", 1)`` /
    int) or a per-spec ``"f.fits[sci,2]"`` to load one extension.

    Data units are inferred from BUNIT (HST convention: 'ELECTRONS' /
    'COUNTS' = counts-type *_flt data, anything per-second = rate);
    EXPTIME is read from the SCI or primary header. ``wht_ext`` /
    ``err_ext`` load companion weight/error extensions (a bare name like
    ``"WHT"`` pairs with each SCI chip's EXTVER).
    """
    if isinstance(image_fnames, str):
        image_fnames = [image_fnames]
    exps = []
    for spec in image_fnames:
        fname, fext = parse_file_name(spec)
        hdul = read_fits(fname)
        if fext is None and ext is None:
            # expand to all SCI extensions (one Exposure per chip)
            scis = [h for h in hdul
                    if h.name == "SCI" and h.data is not None]
            if len(scis) > 1:
                for h in scis:
                    exps.append(_exposure_from_hdu(
                        hdul, h, f"{fname}[sci,{h.ver}]",
                        wht_ext, err_ext))
                continue
            if scis:
                exps.append(_exposure_from_hdu(hdul, scis[0], spec,
                                               wht_ext, err_ext))
                continue
        use_ext = fext if fext is not None else (
            ext if ext is not None else ("SCI", 1))
        try:
            hdu = hdul[use_ext]
        except (KeyError, IndexError):  # int specs raise IndexError
            hdu = next((h for h in hdul if h.data is not None), None)
            if hdu is None:
                raise ValueError(f"{fname}: no HDU with image data")
        exps.append(_exposure_from_hdu(hdul, hdu, spec, wht_ext, err_ext))
    return exps


def align_fits(
    image_fnames: Sequence[str] | str,
    ext=None,
    wht_ext=None,
    update_headers: bool = True,
    state_file: str | None = None,
    **align_kwargs,
) -> AlignResult:
    """End-to-end file-based alignment (the reference's usage pattern).

    Reads the exposures (multi-SCI files expand to one exposure per
    chip — see :func:`load_exposures`), runs the device align loop, and (by
    default) writes the corrected WCS keywords back into each chip's own
    SCI header with a HISTORY record (reference ``history`` semantics;
    SURVEY §3.1 "apply WCS correction to exposure SCI header(s)"). A
    re-run after interruption picks up the last written headers —
    the reference's implicit resume — and ``state_file`` additionally
    saves an explicit :class:`AlignState` JSON checkpoint.
    """
    exps = load_exposures(image_fnames, ext=ext, wht_ext=wht_ext)
    result = align_images(resample=Drizzle(exps), **align_kwargs)
    if update_headers:
        # group per FILE so a 2-chip exposure is read+written once, both
        # chips' WCSs updated in that one atomic rewrite
        by_file: dict[str, list] = {}
        for exp, M, t in zip(result.exposures, result.matrices,
                             result.shifts):
            fname, fext = parse_file_name(exp.name)
            hist = [
                "subpixal_tpu: aligned "
                f"(converged={result.converged}, "
                f"iters={result.n_iterations})",
                f"subpixal_tpu: shift=({t[0]:.6f}, {t[1]:.6f}) "
                f"matrix=[[{M[0,0]:.8f},{M[0,1]:.8f}],"
                f"[{M[1,0]:.8f},{M[1,1]:.8f}]]",
            ]
            by_file.setdefault(fname, []).append((fext, exp.wcs, hist))
        for fname, items in by_file.items():
            hdul = read_fits(fname)
            for fext, wcs, hist in items:
                use_ext = fext if fext is not None else (
                    ext if ext is not None else ("SCI", 1))
                try:
                    hdu = hdul[use_ext]
                except (KeyError, IndexError):
                    hdu = next((h for h in hdul if h.data is not None),
                               None)
                    if hdu is None:
                        raise ValueError(
                            f"{fname}: no HDU with image data")
                wcs_to_header(wcs, hdu.header)
                for line in hist:
                    hdu.header.add_history(line)
            write_fits(fname, list(hdul))
    if state_file:
        AlignState.from_result(
            result, [e.name for e in result.exposures]).save(state_file)
    return result


@dataclasses.dataclass
class AlignState:
    """Explicit serializable alignment state (SURVEY §5 checkpoint/resume).

    The reference has no checkpointing beyond FITS headers; this gives the
    device build an explicit artifact: per-image affines, convergence info
    and the per-iteration fit history, restorable into new runs.
    """

    images: list[str]
    matrices: list  # (E, 2, 2) nested lists
    shifts: list    # (E, 2)
    converged: bool
    n_iterations: int
    history: list   # per-iteration list of per-image record dicts

    @classmethod
    def from_result(cls, result: AlignResult,
                    images: Sequence[str]) -> "AlignState":
        return cls(
            images=list(images),
            matrices=np.asarray(result.matrices).tolist(),
            shifts=np.asarray(result.shifts).tolist(),
            converged=bool(result.converged),
            n_iterations=int(result.n_iterations),
            history=[[dataclasses.asdict(r) for r in recs]
                     for recs in result.history],
        )

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=1)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "AlignState":
        with open(path) as f:
            return cls(**json.load(f))
