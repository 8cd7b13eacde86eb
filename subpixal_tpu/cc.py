"""Cross-correlation module (reference-familiar name).

The reference exposes its pair-wise displacement measurement as
``subpixal.cc`` (SURVEY.md §2 #4); this module re-exports the device
implementations from :mod:`subpixal_tpu.ops.correlate` under that familiar
name. Everything here is batched and jit-compiled.
"""

from .ops.correlate import (  # noqa: F401
    Displacement,
    cross_correlate,
    find_displacement,
)

__all__ = ["Displacement", "cross_correlate", "find_displacement"]
