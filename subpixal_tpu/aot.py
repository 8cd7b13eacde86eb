"""Serialized-executable cache: zero-compile warm process startup.

``align_images``'s fixed-point loop ships as a serialized compiled
executable (``align._aot_loop_load/_aot_loop_save``). This module
generalizes that mechanism to ANY jitted setup program — the device
source finder, the drizzle deposit stack, the staging gather — so a
warm process deserializes each program instead of compiling it. A
compile served from the persistent compilation cache still pays the
Python trace and lowering; ``jax.experimental.serialize_executable``
loads skip both.

The reference (a serial numpy package, SURVEY.md §1) has no analogue —
its per-process startup cost is ``import astropy``. Every real
invocation of a production pipeline is a fresh process, so warm
startup matters.

Keying: like the loop blobs, executables are keyed by jax version,
backend, device kind, the library source fingerprint (any code change
invalidates every blob), trace-time env knobs, and the full
shape/dtype + static-argument signature. Blobs live in :func:`aot_dir`.
Any load failure deletes the blob and falls back to a normal compile.
The CPU never uses the pickle path (XLA:CPU AOT loads are unreliable —
see :func:`_use_serialized`); there ``get_executable`` returns the
plainly compiled executable without touching disk.
"""

from __future__ import annotations

import functools
import hashlib
import os
import time

import jax
import jax.numpy as jnp

__all__ = ["code_fingerprint", "aot_dir", "aot_enabled",
           "get_executable"]


@functools.lru_cache(maxsize=1)
def code_fingerprint() -> str:
    """Content hash of the package's source files.

    Serialized blobs bake in the traced program: any library change
    that alters a traced program (a faster measurement path, a
    numerics fix) must invalidate old blobs, or a warm process would
    silently keep running the old program.
    """
    root = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if fname.endswith((".py", ".cpp", ".so")):
                p = os.path.join(dirpath, fname)
                h.update(fname.encode())
                with open(p, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()[:16]


#: trace-time env knobs that change compiled PROGRAMS (not just their
#: inputs) — they must key every blob or a knob flip would silently
#: load an executable built under the other setting
ENV_KNOBS = ("SUBPIXAL_TPU_PACKED", "SUBPIXAL_TPU_FFT",
             "SUBPIXAL_TPU_FWD_PRECISION",
             "SUBPIXAL_TPU_READOUT_PRECISION",
             "SUBPIXAL_TPU_COARSE_PRECISION")


def aot_dir() -> str:
    """``SUBPIXAL_TPU_AOT_DIR`` when set, else ``subpixal_aot`` inside
    the compile-cache directory (:func:`subpixal_tpu.utils.cache_dir`:
    ``JAX_COMPILATION_CACHE_DIR``, or a fixed path in the checkout)."""
    from .utils import cache_dir

    d = (os.environ.get("SUBPIXAL_TPU_AOT_DIR")
         or os.path.join(cache_dir(), "subpixal_aot"))
    os.makedirs(d, exist_ok=True)
    return d


def _use_serialized() -> bool:
    """serialize_executable (load: no lower, no compile) on the GPU;
    the CPU keeps jax.export. XLA:CPU AOT-loads complex executables
    unreliably: the align loop (while_loop subcomputations) loads
    without error but its results raise ``Buffer Definition Event:
    Function ... not found`` at fetch."""
    from .backend import on_gpu

    return on_gpu()


def aot_enabled() -> bool:
    """Serialized executables on disk: on the GPU by default;
    ``SUBPIXAL_TPU_AOT_LOOP=0|1`` forces them off or on."""
    from .backend import on_gpu

    v = os.environ.get("SUBPIXAL_TPU_AOT_LOOP", "").lower()
    if v in ("0", "false", "off"):
        return False
    if v in ("1", "true", "on"):
        return True
    return on_gpu()


_MEM: dict = {}
_MEM_MAX = 64


def _key(name: str, shapes, statics, key_extra) -> str:
    dev = jax.devices()[0]
    knobs = tuple(os.environ.get(k, "") for k in ENV_KNOBS)
    raw = repr((name, jax.__version__, jax.default_backend(),
                getattr(dev, "device_kind", "?"), code_fingerprint(),
                knobs, shapes, statics, key_extra))
    return hashlib.sha256(raw.encode()).hexdigest()[:32]


def _named_sharding(a):
    """The arg's NamedSharding, or None. Single-device shardings are
    deliberately ignored: a plain device array and a bare
    ShapeDtypeStruct (warm_compile pre-warms with the latter) must
    produce the SAME key/executable. Mesh-sharded inputs (shard_map
    programs) bake their layout into the binary — those must key."""
    from jax.sharding import NamedSharding

    sh = getattr(a, "sharding", None)
    return sh if isinstance(sh, NamedSharding) else None


def _leaf_sig(a):
    if hasattr(a, "shape"):
        sh = _named_sharding(a)
        return (tuple(a.shape), str(a.dtype),
                repr(sh) if sh is not None else "")
    return repr(a)


def _shape_sig(tree):
    return jax.tree.map(_leaf_sig, tree)


def get_executable(name: str, fn, arg_shapes: tuple, *,
                   statics: dict | None = None, key_extra=(),
                   timings: dict | None = None):
    """Compiled executable for ``fn(*arg_shapes, **statics)``.

    ``fn`` must be a ``jax.jit``-wrapped callable; ``arg_shapes`` a
    tuple of arrays or ``ShapeDtypeStruct``s (a pytree per positional
    arg); ``statics`` keyword statics baked into the lowering. The
    returned executable is invoked with ``compiled(*arrays)`` — the
    statics are already baked in.

    Resolution order: in-memory LRU → on-disk serialized executable
    (accelerators) → ``fn.lower(...).compile()`` (saved to disk for
    the next process when serialization is available). Returns None
    only when ``fn`` cannot be lowered (caller falls back to a plain
    call). ``timings`` (optional dict) receives per-phase seconds
    under ``{name}.load`` / ``{name}.compile`` / ``{name}.save``.
    """
    statics = statics or {}

    def _to_sds(a):
        if isinstance(a, jax.ShapeDtypeStruct) or not hasattr(a, "shape"):
            return a
        sh = _named_sharding(a)
        if sh is not None:
            return jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a),
                                        sharding=sh)
        return jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a))

    shapes = tuple(jax.tree.map(_to_sds, a) for a in arg_shapes)
    key = _key(name, _shape_sig(shapes), repr(sorted(statics.items())),
               key_extra)
    hit = _MEM.get(key)
    if hit is not None:
        _MEM[key] = _MEM.pop(key)  # LRU refresh
        return hit

    use_disk = aot_enabled() and _use_serialized()
    path = os.path.join(aot_dir(), key + ".jaxexe")
    if use_disk and os.path.exists(path):
        try:
            import gzip
            import pickle

            from jax.experimental import serialize_executable as _se

            t0 = time.time()
            # blobs are gzip-compressed (the align-loop pickle shrinks
            # several-fold)
            with open(path, "rb") as f:
                head = f.read(2)
            opener = gzip.open if head == b"\x1f\x8b" else open
            with opener(path, "rb") as f:
                payload, in_tree, out_tree = pickle.load(f)
            # mesh-sharded programs execute on the mesh's device set;
            # everything else is pinned to ONE device (or the loader
            # defaults to ALL local devices and builds an N-shard
            # executable on forced-multi-device test platforms)
            exec_devs = None
            for a in jax.tree.leaves(shapes):
                sh = _named_sharding(a)
                if sh is not None:
                    exec_devs = list(sh.mesh.devices.flat)
                    break
            if exec_devs is None:
                exec_devs = [jax.devices()[0]]
            compiled = _se.deserialize_and_load(
                payload, in_tree, out_tree, backend=exec_devs[0].client,
                execution_devices=exec_devs)
            if timings is not None:
                timings[f"{name}.load"] = round(time.time() - t0, 3)
            _remember(key, compiled)
            return compiled
        except Exception:  # noqa: BLE001 - poisoned blob -> recompile
            try:
                os.unlink(path)
            except OSError:
                pass

    t0 = time.time()
    try:
        compiled = fn.lower(*shapes, **statics).compile()
    except Exception:  # noqa: BLE001 - caller falls back to plain call
        return None
    if timings is not None:
        timings[f"{name}.compile"] = round(time.time() - t0, 3)
    if use_disk:
        try:
            import gzip
            import pickle

            from jax.experimental import serialize_executable as _se

            t0 = time.time()
            payload, in_tree, out_tree = _se.serialize(compiled)
            tmp = path + f".tmp{os.getpid()}"
            with gzip.open(tmp, "wb", compresslevel=1) as f:
                pickle.dump((payload, in_tree, out_tree), f)
            os.replace(tmp, path)
            if timings is not None:
                timings[f"{name}.save"] = round(time.time() - t0, 3)
        except Exception:  # noqa: BLE001 - cache write is best-effort
            pass
    _remember(key, compiled)
    return compiled


def _remember(key, compiled) -> None:
    if len(_MEM) >= _MEM_MAX:
        _MEM.pop(next(iter(_MEM)))
    _MEM[key] = compiled
