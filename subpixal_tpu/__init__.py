"""subpixal_tpu — subpixel cross-correlation image alignment on device.

A ground-up JAX/XLA re-design of the capabilities of
``spacetelescope/subpixal`` (see SURVEY.md): catalog-driven cutout
extraction, batched FFT cross-correlation with Fourier-domain upsampling,
subpixel peak fitting, sigma-clipped linear WCS-correction fits, and
blot/drizzle resampling — all batched, jit-compiled, and shardable over
device meshes. Host-side FITS/WCS I/O and catalog bookkeeping are
self-contained (no astropy dependency).

Module map (reference module -> here):
  subpixal.align     -> subpixal_tpu.align        (align_images, AlignConfig)
  subpixal.cc        -> subpixal_tpu.cc           (find_displacement)
  subpixal.centroid  -> subpixal_tpu.centroid     (find_peak)
  subpixal.cutout    -> subpixal_tpu.cutout       (Cutout, create_*_cutouts)
  subpixal.blot      -> subpixal_tpu.blot         (blot_cutout, blot_image)
  subpixal.catalogs  -> subpixal_tpu.catalogs     (ImageCatalog, SEx*, finder)
  subpixal.resample  -> subpixal_tpu.resample     (Resample, Drizzle)
  subpixal.utils     -> subpixal_tpu.utils        (parse_file_name)
  (astropy.io.fits)  -> subpixal_tpu.io.fits      (pure-numpy FITS)
  (astropy.wcs)      -> subpixal_tpu.wcs          (TanWCS, TAN+SIP)
  (new)              -> subpixal_tpu.ops          (device ops)
  (new)              -> subpixal_tpu.backend      (the backend decision)
  (new)              -> subpixal_tpu.parallel     (mesh/shard_map/collectives)
"""

from .version import __version__

from .ops.peaks import find_peak, PeakFitResult
from .ops.correlate import cross_correlate, find_displacement, Displacement
from .ops.fit import (
    iter_linear_fit,
    iter_linear_fit_frames,
    iter_linear_fit_sharded,
    LinearFitResult,
    apply_affine,
)
from .ops.cutouts import extract_cutouts, insert_cutouts, CutoutBatch
from .cutout import (
    Cutout,
    NoOverlapError,
    PartialOverlapError,
    create_primary_cutouts,
    create_input_image_cutouts,
    create_cutouts,
    drz_from_input_cutouts,
    cutouts_to_batch,
)
from .blot import blot_cutout, blot_image, compute_pixmap
from .catalogs import (
    ImageCatalog,
    ImageSourceCatalog,
    SExCatalog,
    SExImageCatalog,
    Table,
    find_sources,
)
from .resample import Resample, Drizzle, Exposure, make_output_wcs
from .wcs.wcs import TanWCS, DistGrid, apply_tangent_affine
from .wcs.fitswcs import (wcs_from_header, wcs_to_header,
                          wcs_from_hdul)
from .align import align_images, AlignConfig, AlignResult, ImageAlignInfo
from .utils import parse_file_name

__all__ = [
    "__version__",
    # measurement
    "find_peak", "PeakFitResult",
    "cross_correlate", "find_displacement", "Displacement",
    # fitting
    "iter_linear_fit", "iter_linear_fit_frames", "iter_linear_fit_sharded",
    "LinearFitResult", "apply_affine",
    # cutouts
    "extract_cutouts", "insert_cutouts", "CutoutBatch",
    "Cutout", "NoOverlapError", "PartialOverlapError",
    "create_primary_cutouts", "create_input_image_cutouts",
    "create_cutouts", "drz_from_input_cutouts", "cutouts_to_batch",
    # blot / resample
    "blot_cutout", "blot_image", "compute_pixmap",
    "Resample", "Drizzle", "Exposure", "make_output_wcs",
    # catalogs
    "ImageCatalog", "ImageSourceCatalog", "SExCatalog", "SExImageCatalog",
    "Table", "find_sources",
    # wcs
    "TanWCS", "DistGrid", "apply_tangent_affine", "wcs_from_header",
    "wcs_to_header", "wcs_from_hdul",
    # align
    "align_images", "AlignConfig", "AlignResult", "ImageAlignInfo",
    # utils
    "parse_file_name",
]
