"""The backend decision, the block partition and the cache directories."""

import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from subpixal_tpu import aot, backend, utils
from subpixal_tpu.ops.blocks import DEPOSIT_BLOCK, block_partition

ROOT = Path(__file__).resolve().parent.parent


def test_platform_is_cpu_here():
    assert backend.platform() == "cpu"
    assert not backend.on_gpu()


def test_platform_answers_gpu_or_cpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.platform() == "gpu" and backend.on_gpu()
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm?")
    assert backend.platform() == "cpu"


def test_backend_decided_in_one_place():
    """Only subpixal_tpu.backend compares JAX's backend name; everything
    else asks it (other calls merely key caches by the name)."""
    pat = re.compile(r"default_backend\(\)\s*(==|!=|in\b|not\s+in\b)")
    hits = []
    for path in [*ROOT.glob("subpixal_tpu/**/*.py"), ROOT / "bench.py",
                 ROOT / "chip_smoke.py", ROOT / "__graft_entry__.py"]:
        if path.name == "backend.py":
            continue
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if pat.search(line):
                hits.append(f"{path.relative_to(ROOT)}:{n}")
    assert not hits, hits


# --------------------------------------------------------------------- #
# block_partition
# --------------------------------------------------------------------- #

def test_block_partition_order_and_padding():
    a = np.arange(20 * 300, dtype=np.float32).reshape(20, 300)
    b = block_partition(a, mode="edge")
    bh, bw = DEPOSIT_BLOCK
    nby, nbx = -(-20 // bh), -(-300 // bw)
    assert b.shape == (nby * nbx, bh, bw)
    # row-major over (by, bx): block 1 is the second column block
    np.testing.assert_array_equal(b[1][:bh, :bw], a[:bh, bw:2 * bw])
    # edge padding repeats the last row / column
    last = b[nby * nbx - 1]
    np.testing.assert_array_equal(last[-1, -1], a[-1, -1])


def test_block_partition_numpy_and_jax_agree():
    a = np.random.default_rng(0).random((2, 33, 130)).astype(np.float32)
    bn = block_partition(a, (8, 64), constant_values=-1.0)
    bj = block_partition(jnp.asarray(a), (8, 64), constant_values=-1.0)
    np.testing.assert_array_equal(bn, np.asarray(bj))
    assert bn.shape == (2, 5 * 3, 8, 64)
    assert (bn == -1.0).sum() == 2 * (40 * 192 - 33 * 130)


def test_block_partition_round_trip():
    a = np.arange(32 * 256).reshape(32, 256)
    b = block_partition(a)
    bh, bw = DEPOSIT_BLOCK
    nbx = 256 // bw
    back = b.reshape(32 // bh, nbx, bh, bw).transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(back.reshape(32, 256), a)


# --------------------------------------------------------------------- #
# compile cache and serialized-executable directories
# --------------------------------------------------------------------- #

def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert utils.cache_dir() == str(tmp_path / "c")


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = utils.cache_dir()
    assert d == utils.cache_dir()                 # no temp name, no pid
    assert Path(d) == ROOT / ".jax_cache"
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text()


def test_enable_compilation_cache_uses_env_dir(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    try:
        got = utils.enable_compilation_cache()
        assert got == str(tmp_path / "xla")
        assert jax.config.jax_compilation_cache_dir == got
        assert os.path.isdir(got)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("explicit", [False, True])
def test_aot_dir_follows_cache_rule(monkeypatch, tmp_path, explicit):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    if explicit:
        monkeypatch.setenv("SUBPIXAL_TPU_AOT_DIR", str(tmp_path / "aot"))
        assert aot.aot_dir() == str(tmp_path / "aot")
    else:
        monkeypatch.delenv("SUBPIXAL_TPU_AOT_DIR", raising=False)
        assert aot.aot_dir() == str(tmp_path / "xla" / "subpixal_aot")
