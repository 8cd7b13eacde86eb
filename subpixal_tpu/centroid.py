"""Peak centroiding module (reference-familiar name).

The reference exposes its subpixel peak fit as ``subpixal.centroid ·
find_peak`` (SURVEY.md §2 #5); this module re-exports the device
batched implementation from :mod:`subpixal_tpu.ops.peaks`.
"""

from .ops.peaks import PeakFitResult, find_peak  # noqa: F401

__all__ = ["PeakFitResult", "find_peak"]
