"""Multi-host plumbing (SURVEY §2b, §5 "distributed communication
backend").

The reference is a single-process numpy program with no distributed
runtime of any kind (SURVEY §2b); across several GPU hosts the
equivalent is jax's distributed runtime: every host calls
:func:`jax.distributed.initialize`, after which ``jax.devices()``
enumerates the GLOBAL device list and the same ``shard_map`` + ``psum``
programs used single-host (:mod:`subpixal_tpu.parallel.sharding`) run
across hosts — XLA inserts the collectives (NCCL over NVLink within a
host, the network between hosts) from the sharding annotations.

This module provides the thin, testable layer around that:

* :func:`init_distributed` — idempotent wrapper over
  ``jax.distributed.initialize`` (explicit args, env vars, or no-op for
  single-process runs);
* :func:`make_global_mesh` — a 1-D mesh over the global device list;
* :func:`global_batch_from_local` — assemble per-host cutout batches
  into one globally-sharded array
  (``jax.make_array_from_process_local_data``).

The 2-process CPU test in ``tests/test_distributed.py`` proves the
psum-reduced sigma-clipped fit agrees with the single-process result —
no multi-host hardware claim is made (none is available here).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["init_distributed", "make_global_mesh",
           "global_batch_from_local", "process_info"]

_AXIS = "cutouts"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None,
                     **kwargs) -> bool:
    """Initialize jax's multi-process runtime (idempotent).

    Argument resolution order:

    1. explicit arguments;
    2. ``SUBPIXAL_TPU_COORDINATOR`` / ``SUBPIXAL_TPU_NUM_PROCESSES`` /
       ``SUBPIXAL_TPU_PROCESS_ID`` environment variables;
    3. neither -> single-process run, returns False without touching
       the runtime (the no-op path every test/bench takes on this rig).

    Returns True when the distributed runtime is (already) initialized.
    Call BEFORE any jax backend use, one call per process.
    """
    import jax

    if coordinator_address is None:
        coordinator_address = os.environ.get("SUBPIXAL_TPU_COORDINATOR")
    if num_processes is None:
        v = os.environ.get("SUBPIXAL_TPU_NUM_PROCESSES")
        num_processes = int(v) if v else None
    if process_id is None:
        v = os.environ.get("SUBPIXAL_TPU_PROCESS_ID")
        process_id = int(v) if v else None

    try:
        from jax._src import distributed as _dist

        already = _dist.global_state.client is not None
    except Exception:  # pragma: no cover - private API moved
        already = False
    if already:
        return True
    if coordinator_address is None and num_processes is None:
        return False  # single-process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
        **kwargs,
    )
    return True


def process_info() -> tuple[int, int]:
    """(process_index, process_count) of this host."""
    import jax

    return jax.process_index(), jax.process_count()


def make_global_mesh(n_devices: int | None = None, axis_name: str = _AXIS):
    """A 1-D mesh over the GLOBAL (all-host) device list.

    Multi-host jax requires every process to build the identical mesh
    from ``jax.devices()`` (which is global after
    :func:`init_distributed`); devices enumerate host by host, so a
    psum crosses the network only at host boundaries.
    """
    from .sharding import make_mesh

    # same construction as the single-host mesh: after init_distributed,
    # jax.devices() already enumerates the global (all-host) device list
    return make_mesh(n_devices, axis_name=axis_name)


def global_batch_from_local(local_batch, mesh, axis_name: str = _AXIS):
    """Assemble each process's LOCAL batch shard into one global array.

    ``local_batch``: this host's (B_local, ...) numpy/jax array — e.g.
    the cutouts extracted from FITS files this host read. The result is
    a (B_local * process_count, ...) global array sharded over ``mesh``
    along axis 0; no data leaves the host (single-device addressable
    shards are laid out in place).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis_name))
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(local_batch))


def stage_global(value, mesh, spec):
    """Stage one (globally identical) array for a jit over ``mesh``.

    Under a multi-process runtime every jit input must be a GLOBAL
    array; each process holds the same full ``value`` (align setup is
    deterministic from the same inputs on every host), so this slices
    out the locally-addressable shards and assembles the global array.
    Single-process: a plain ``device_put`` with the target sharding.
    """
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        # device-resident values reshard device-to-device — no host copy
        return jax.device_put(value, sharding)
    arr = np.asarray(value)
    return jax.make_array_from_process_local_data(
        sharding, arr, global_shape=arr.shape)
