"""The one backend decision: which kind of device the program runs on.

Every default that depends on the device asks :func:`platform` instead
of comparing backend names itself: the device source finder, device
cutout and drizzle pixmaps, the serialized-executable cache, the
persistent compilation cache and the displacement pipeline's transform
choice (``ops.correlate``). It answers ``"gpu"`` when JAX's default
backend is a GPU and ``"cpu"`` otherwise.
"""

from __future__ import annotations

import jax

__all__ = ["platform", "on_gpu"]


def platform() -> str:
    """``"gpu"`` or ``"cpu"``: the kind of JAX's default backend."""
    try:
        return "gpu" if jax.default_backend() == "gpu" else "cpu"
    except RuntimeError:  # pragma: no cover - no backend at all
        return "cpu"


def on_gpu() -> bool:
    """Whether the accelerator defaults (device setup stages, on-disk
    serialized executables, compile cache) apply."""
    return platform() == "gpu"
