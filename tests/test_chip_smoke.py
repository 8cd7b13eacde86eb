"""chip_smoke.py: its phases at tiny sizes on the CPU, its refusals, and
its last line. The full-size run is on the card (``python chip_smoke.py``;
the ``gpu``-marked test below runs it there)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent.parent


def _run_script(cwd, *args, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_refuses_without_gpu():
    r = _run_script(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_script(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_result_line_format():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")] * 4
    line = cs.result_line(devs)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100", "count": 4}}
    assert "\n" not in line


def test_four_selects_only_mesh_phases():
    assert cs.plan_phases(four=True) == ("device", "four")
    one = cs.plan_phases(four=False)
    assert "four" not in one
    assert one == ("device", "displacement", "blot", "deposit", "align")


def test_phase_displacement_tiny():
    r = cs.phase_displacement(B=12, size=32)
    assert r["shift_rmse_vs_reference_mpix"] < r["gate_mpix"]


def test_phase_blot_tiny():
    r = cs.phase_blot(B=6, size=16, plane=96)
    assert r["max_abs_err"] <= r["tol"]
    assert 0.5 < r["valid_frac"] <= 1.0


def test_phase_deposit_tiny():
    r = cs.phase_deposit(n=64)
    for k in ("square", "lanczos3"):
        assert r[k]["max_rel_err"] <= r[k]["rtol"]


def test_phase_align_tiny():
    r = cs.phase_align(n_exp=3, shape=(96, 96), n_stars=6, seed=21,
                       max_err_mpix=100.0, cutout_shape=(16, 16),
                       max_iterations=3, min_sources=3, usfac=4)
    assert r["loops_max_dpix"] <= 1e-3
    assert r["host_loop"]["iterations"] >= 1


def test_phase_four_tiny():
    out = dict(cs.phase_four(n_dev=4, n_exp=3, shape=(96, 96),
                             n_stars=6, seed=21, max_err_mpix=100.0,
                             cutout_shape=(16, 16), max_iterations=3,
                             min_sources=3, usfac=4))
    assert set(out) == {"align_one", "mesh_align", "spatial_align"}
    assert out["mesh_align"]["vs_one_card_max_dpix"] <= 2e-2
    assert out["spatial_align"]["vs_one_card_max_dpix"] <= 2e-2


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu_device, capsys):
    """Every one-card phase on the card, in this process (a second
    process could not get the card's memory)."""
    assert cs.main([]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
