"""Test configuration: run everything on a virtual 8-device CPU mesh.

Per SURVEY.md §4 item 4: multi-device shard_map/collective paths are
exercised under pytest on CPU via XLA's forced host platform device count;
numerics are asserted against single-device/numpy oracles. The GPU path
is exercised by ``chip_smoke.py`` / ``bench.py`` and by the tests marked
``gpu`` (skipped here; see the ``gpu_device`` fixture).

The platform is pinned through jax.config as well as ``JAX_PLATFORMS``,
before any backend is initialized, so a machine whose JAX has a GPU
plugin still runs this suite on the virtual CPU mesh.
"""

import os
import re

# force (or CORRECT — a pre-existing smaller count would silently run
# the mesh suite on too few devices) the 8-device virtual CPU platform
_flags = os.environ.get("XLA_FLAGS", "")
_want = "--xla_force_host_platform_device_count=8"
if "xla_force_host_platform_device_count" in _flags:
    _flags = re.sub(r"--xla_force_host_platform_device_count=\d+",
                    _want, _flags)
else:
    _flags = (_flags + " " + _want).strip()
os.environ["XLA_FLAGS"] = _flags

import jax  # noqa: E402

# the suite runs on the virtual CPU mesh unless JAX_PLATFORMS asks for
# the card explicitly (JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)
if os.environ.get("JAX_PLATFORMS", "").lower() not in ("cuda", "gpu"):
    jax.config.update("jax_platforms", "cpu")

# SURVEY §5 "race detection / sanitizers": CI can run the whole suite with
# NaN trapping and/or x64 on to catch dtype bugs —
#   SUBPIXAL_TPU_DEBUG_NANS=1 SUBPIXAL_TPU_X64=1 pytest tests/
def _env_on(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "off", "no")


if _env_on("SUBPIXAL_TPU_DEBUG_NANS"):
    jax.config.update("jax_debug_nans", True)
if _env_on("SUBPIXAL_TPU_X64"):
    jax.config.update("jax_enable_x64", True)

# persistent compilation cache: most of the suite's runtime is jit
# compiles; repeated runs are served from disk
# (JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache)
from subpixal_tpu.utils import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when there is none. Decided
    here, at run time — never at import or collection, so every xdist
    worker collects the same tests."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)")
    return devs[0]
