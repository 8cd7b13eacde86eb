"""Small host-side helpers.

Parity with the reference's ``subpixal/utils.py`` (SURVEY.md §2 #9),
notably parsing ``"image.fits[sci,1]"``-style file specifications.
"""

from __future__ import annotations

import os
import re

import numpy as np

__all__ = ["parse_file_name", "py2round", "enable_compilation_cache",
           "cache_dir", "fetch_to_host"]

#: compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset: one fixed path inside the checkout (listed in .gitignore), so
#: every process of the checkout finds what an earlier one cached
_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir() -> str:
    """Where compiled programs are cached: ``JAX_COMPILATION_CACHE_DIR``
    when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_CACHE


def enable_compilation_cache(path: str | None = None,
                             min_compile_secs: float = 0.0) -> str:
    """Turn on JAX's persistent compilation cache at :func:`cache_dir`
    (or ``path``) and return the directory.

    First compiles of the jitted align step, the source finder and the
    setup programs cost seconds each; with the cache a later process
    reads them from disk. Called by ``bench.py``, ``chip_smoke.py`` and
    the test suite; ``align_images`` calls it on the GPU when no cache
    is configured.

    ``min_compile_secs`` defaults to 0 — cache EVERY executable: a
    fresh align process issues dozens of small compiles whose entries
    are KB-sized, far cheaper than compiling them again.
    """
    import jax

    path = path or cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path

_EXT_RE = re.compile(r"^(?P<file>.+?)(?:\[(?P<ext>[^\]]+)\])?$")


def parse_file_name(image_fname: str) -> tuple[str, int | tuple[str, int] | None]:
    """Split ``"name.fits[sci,2]"`` into (``"name.fits"``, ``("SCI", 2)``).

    Parity: reference ``subpixal/utils.py · parse_file_name``. Supported
    extension specs: ``[3]`` (integer index), ``[sci]`` (name, ver 1
    implied -> returned as ``("SCI", 1)``), ``[sci,2]`` (name, ver).
    Returns ``(filename, None)`` when no extension is given.
    """
    m = _EXT_RE.match(image_fname.strip())
    if m is None:  # pragma: no cover - regex always matches
        raise ValueError(f"cannot parse file name: {image_fname!r}")
    fname = m.group("file")
    ext = m.group("ext")
    if ext is None:
        return fname, None
    parts = [p.strip() for p in ext.split(",")]
    if len(parts) == 1:
        if re.fullmatch(r"[+-]?\d+", parts[0]):
            return fname, int(parts[0])
        return fname, (parts[0].upper(), 1)
    if len(parts) == 2:
        return fname, (parts[0].upper(), int(parts[1]))
    raise ValueError(f"invalid extension specification in {image_fname!r}")


def py2round(x: float) -> float:
    """Round-half-away-from-zero (Python-2 style), as used by the
    reference for pixel index math."""
    import math

    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def fetch_to_host(arr) -> np.ndarray:
    """Device->host fetch that also serves multi-process global arrays.

    A global array whose shards live on other hosts cannot go through
    ``np.asarray``; every process reaches this point (SPMD host code),
    so the collective all-gather is safe there. It runs row chunk by
    row chunk along the leading axis: a whole-array
    ``process_allgather`` replicates the result into EVERY device's
    memory first, which would exhaust memory on exactly the
    row-band-sharded mosaics this path serves. Set
    ``SUBPIXAL_TPU_FETCH_CHUNK_BYTES`` to bound each chunk (default: one
    chunk).
    """
    if getattr(arr, "is_fully_addressable", True) is not False:
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    def _ag(x):
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))

    chunk_bytes = int(os.environ.get("SUBPIXAL_TPU_FETCH_CHUNK_BYTES", 0))
    if arr.ndim < 2:
        return _ag(arr)
    n = arr.shape[0]
    row_bytes = max(1, int(np.prod(arr.shape[1:])) * arr.dtype.itemsize)
    if chunk_bytes <= 0 or n * row_bytes <= chunk_bytes:
        return _ag(arr)
    step = max(1, chunk_bytes // row_bytes)
    out = np.empty(arr.shape, arr.dtype)
    for i in range(0, n, step):
        out[i:i + step] = _ag(arr[i:i + step])
    return out
