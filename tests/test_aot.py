"""Unit tests for the serialized-executable cache (subpixal_tpu/aot.py).

On the CPU test rig the disk path is disabled (XLA:CPU AOT loads are
unreliable — aot._use_serialized), so these pin the key/memoization
semantics every backend shares plus the gating itself; the disk
round-trip is exercised on the card by bench.py's fresh-process
section and every align run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from subpixal_tpu import aot


@jax.jit
def _f(a, b):
    return a @ b + 1.0


def test_memoized_and_shape_keyed():
    x = jnp.ones((4, 4))
    e1 = aot.get_executable("t_aot", _f, (x, x))
    e2 = aot.get_executable("t_aot", _f, (x, x))
    assert e1 is e2  # in-memory LRU hit
    y = jnp.ones((8, 8))
    e3 = aot.get_executable("t_aot", _f, (y, y))
    assert e3 is not e1  # shapes key the executable
    np.testing.assert_allclose(np.asarray(e1(x, x)), 4 * np.ones((4, 4)) + 1)


def test_statics_key_and_bake():
    import functools

    @functools.partial(jax.jit, static_argnames=("k",))
    def g(a, *, k):
        return a * k

    x = jnp.ones((4,))
    e2 = aot.get_executable("t_aot_s", g, (x,), statics=dict(k=2))
    e3 = aot.get_executable("t_aot_s", g, (x,), statics=dict(k=3))
    assert e2 is not e3
    np.testing.assert_allclose(np.asarray(e2(x)), 2.0)
    np.testing.assert_allclose(np.asarray(e3(x)), 3.0)


def test_cpu_gating():
    # conftest forces the cpu platform: no disk blobs, no pickle loads
    assert jax.default_backend() == "cpu"
    assert not aot.aot_enabled()


def test_fingerprint_stable_and_content_sensitive(tmp_path):
    fp1 = aot.code_fingerprint()
    assert fp1 == aot.code_fingerprint()  # cached + deterministic
    assert len(fp1) == 16


def test_sharding_keys_the_signature():
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:2]), ("r",))
    x = jnp.ones((8, 8))
    xs = jax.device_put(x, NamedSharding(mesh, P("r", None)))
    sig_plain = aot._shape_sig((aot.jax.ShapeDtypeStruct((8, 8),
                                                         jnp.float32),))
    sig_shard = aot._shape_sig((xs,))
    assert sig_plain != sig_shard          # NamedSharding must miss
    # a single-device array matches the bare ShapeDtypeStruct (so
    # warm_compile blobs serve the later concrete-array calls)
    sig_single = aot._shape_sig((x,))
    assert sig_single == sig_plain
