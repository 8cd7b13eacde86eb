"""Smoke test of the align path on an NVIDIA GPU.

Run from the root of the checkout::

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the mesh phases only

Phases (one card):

1. device line — device kind, JAX version, ``nvidia-smi`` name and power
   limit, compile-cache directory;
2. displacement batch — 500x64x64 NCC + 10x upsampling + Gaussian fit
   against bench.py's float64 serial reference (``bench._np_find_
   displacement``); gate: shift RMSE vs the reference < 0.1 mpix;
3. blot gather and drizzle deposit at real widths against the float64
   references in :mod:`subpixal_tpu.testing`;
4. full align of an 8x1024² simulated stack, host loop and device loop;
   gate: pairwise shift error vs planted <= 1 mpix, loops agree.

With ``--four`` it runs the frame-sharded ``mesh=`` align and the
row-band ``spatial_mesh=`` align on four cards and compares both with
the one-card align of the same scene.

Each phase prints one line of its numbers. The script never falls back
to the CPU: without a GPU, or without the package beside it, it exits
non-zero and prints no result. When every phase passed, the last line
of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: the phases each mode runs, in order ("four" reports three runs:
#: align_one, mesh_align, spatial_align)
PHASES = {
    "one": ("device", "displacement", "blot", "deposit", "align"),
    "four": ("device", "four"),
}


def plan_phases(four: bool) -> tuple[str, ...]:
    return PHASES["four" if four else "one"]


def result_line(devices) -> str:
    """The final line: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def _emit(phase: str, numbers: dict) -> None:
    print(f"{phase}: {json.dumps(numbers, default=float)}", flush=True)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _median_ms(fn, *args, reps: int = 5) -> float:
    """Median wall ms of ``fn(*args)`` ending in block_until_ready
    (already compiled)."""
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #

def phase_device() -> dict:
    import jax

    from bench import nvidia_smi
    from subpixal_tpu.utils import cache_dir

    d = jax.devices()[0]
    smi = nvidia_smi()
    print(smi, flush=True)
    return dict(device_kind=d.device_kind, jax=jax.__version__,
                n_devices=len(jax.devices()), nvidia_smi=smi,
                compile_cache=cache_dir())


def phase_displacement(B: int = 500, size: int = 64,
                       max_rmse_mpix: float = 0.1) -> dict:
    """bench.py's headline workload against its f64 serial reference."""
    import jax
    import jax.numpy as jnp

    from bench import _np_find_displacement, make_workload
    from subpixal_tpu.ops.correlate import find_displacement

    refs, imgs, dxs, dys = make_workload(B=B, h=size, w=size)
    f = jax.jit(lambda r, i: find_displacement(
        r, i, cc_type="NCC", usfac=10, fit_type="gaussian"))
    r_j, i_j = jnp.asarray(refs), jnp.asarray(imgs)
    out = jax.block_until_ready(f(r_j, i_j))
    got = np.stack([np.asarray(out.dx), np.asarray(out.dy)], 1)
    ref = np.asarray([_np_find_displacement(refs[b], imgs[b])
                      for b in range(B)])
    vs_ref = 1e3 * float(np.sqrt(np.mean(np.sum((got - ref) ** 2, 1))))
    vs_truth = 1e3 * float(np.sqrt(np.mean(
        (got[:, 0] - dxs) ** 2 + (got[:, 1] - dys) ** 2)))
    ms = _median_ms(f, r_j, i_j)
    res = dict(batch=B, shape=[size, size],
               shift_rmse_vs_reference_mpix=vs_ref,
               shift_rmse_vs_truth_mpix=vs_truth, gate_mpix=max_rmse_mpix,
               batch_ms_median=ms)
    _check(vs_ref < max_rmse_mpix,
           f"shift_rmse_vs_reference_mpix={vs_ref:.4f} >= {max_rmse_mpix}")
    return res


#: blot gather tolerance, relative to max|reference|: poly5 sums 36 f32
#: products whose weights carry ~1e-7 relative rounding (~2e-7 seen)
BLOT_RTOL = 1e-5
#: deposit tolerances, relative to max|reference|. Scatter-add atomics
#: reorder the f32 sums from run to run (~1e-6). The square kernel's
#: overlap edges x ± half are rounded in f32 at |x| <= 1100 px, where
#: the half-ulp is 6.1e-5 px, so each cell's area carries up to ~1e-4
#: relative error (5.6e-5 seen at 1024²); lanczos3 weights depend on
#: x - c smoothly (6e-7 seen).
DEPOSIT_RTOL = {"square": 2e-4, "lanczos3": 1e-5}


def phase_blot(B: int = 500, size: int = 64, plane: int = 1024,
               seed: int = 5) -> dict:
    """XLA blot gather (poly5, the align loop's per-cutout vmap) at
    500x64² from a plane, against the float64 reference."""
    import jax
    import jax.numpy as jnp

    from subpixal_tpu.ops.interp import sample_image
    from subpixal_tpu.testing import sample_image_reference

    rng = np.random.default_rng(seed)
    img = rng.random((plane, plane)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    ang = np.deg2rad(rng.uniform(-0.5, 0.5, B))[:, None, None]
    ox = rng.uniform(-2.0, plane - size + 2.0, B)[:, None, None]
    oy = rng.uniform(-2.0, plane - size + 2.0, B)[:, None, None]
    cx = (np.cos(ang) * xx - np.sin(ang) * yy + ox).astype(np.float32)
    cy = (np.sin(ang) * xx + np.cos(ang) * yy + oy).astype(np.float32)
    f = jax.jit(jax.vmap(lambda x, y, im: sample_image(im, x, y,
                                                       interp="poly5"),
                         in_axes=(0, 0, None)))
    img_j, cx_j, cy_j = jnp.asarray(img), jnp.asarray(cx), jnp.asarray(cy)
    vals, ok = jax.block_until_ready(f(cx_j, cy_j, img_j))
    ref, ok_ref = sample_image_reference(img, cx, cy, "poly5")
    err = float(np.abs(np.asarray(vals, np.float64) - ref).max())
    tol = BLOT_RTOL * float(np.abs(ref).max())
    ms = _median_ms(f, cx_j, cy_j, img_j)
    n_px = B * size * size
    # least traffic: read x, y (8 B/px), write value + valid (5 B/px),
    # read the plane once (it fits in L2)
    min_bytes = 13 * n_px + 4 * plane * plane
    res = dict(interp="poly5", batch=B, cutout=[size, size],
               plane=[plane, plane], max_abs_err=err, tol=tol,
               valid_frac=float(np.asarray(ok).mean()), ms_median=ms,
               mpix_per_s=n_px / (ms * 1e3), min_bytes=min_bytes,
               gb_per_s=min_bytes / (ms * 1e6))
    _check(bool((np.asarray(ok) == ok_ref).all()), "blot validity differs")
    _check(err <= tol, f"blot max err {err:.3e} > tol {tol:.3e}")
    return res


def _rotated_pixmap(n: int, ang_deg: float = 0.2, tx: float = 20.3,
                    ty: float = 15.7):
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    c, s = np.cos(np.deg2rad(ang_deg)), np.sin(np.deg2rad(ang_deg))
    return ((c * xx - s * yy + tx).astype(np.float32),
            (s * xx + c * yy + ty).astype(np.float32))


def phase_deposit(n: int = 1024, kernels=("square", "lanczos3"),
                  seed: int = 6) -> dict:
    """XLA drizzle deposit of an n² frame on a slightly rotated pixmap,
    against the float64 reference, for each kernel."""
    import jax
    import jax.numpy as jnp

    from subpixal_tpu.ops.drizzle import drizzle_deposit
    from subpixal_tpu.testing import drizzle_deposit_reference

    rng = np.random.default_rng(seed)
    data = rng.random((n, n)).astype(np.float32)
    gx, gy = _rotated_pixmap(n)
    out_shape = (n + 48, n + 48)
    d_j, gx_j, gy_j = jnp.asarray(data), jnp.asarray(gx), jnp.asarray(gy)
    res = {"frame": [n, n], "out": list(out_shape)}
    for k in kernels:
        f = jax.jit(lambda d, x, y, k=k: drizzle_deposit(
            d, None, x, y, out_shape, kernel=k))
        sci, wht = jax.block_until_ready(f(d_j, gx_j, gy_j))
        s_ref, w_ref = drizzle_deposit_reference(data, None, gx, gy,
                                                 out_shape, kernel=k)
        err = max(
            float(np.abs(np.asarray(sci, np.float64) - s_ref).max()
                  / np.abs(s_ref).max()),
            float(np.abs(np.asarray(wht, np.float64) - w_ref).max()
                  / np.abs(w_ref).max()))
        ms = _median_ms(f, d_j, gx_j, gy_j)
        # least traffic: read value, x, y (12 B/px), write sci + wht
        min_bytes = 12 * n * n + 8 * out_shape[0] * out_shape[1]
        res[k] = dict(max_rel_err=err, rtol=DEPOSIT_RTOL[k], ms_median=ms,
                      mpix_per_s=n * n / (ms * 1e3), min_bytes=min_bytes,
                      gb_per_s=min_bytes / (ms * 1e6))
        _check(err <= DEPOSIT_RTOL[k],
               f"{k} deposit rel err {err:.3e} > {DEPOSIT_RTOL[k]}")
    return res


def _scene(n_exp: int = 8, shape=(1024, 1024), n_stars: int = 60,
           seed: int = 11):
    from subpixal_tpu.testing import simulate_stack

    return simulate_stack(n_exp=n_exp, shape=shape, n_stars=n_stars,
                          seed=seed)


ALIGN_KW = dict(fitgeom="shift", usfac=8, fit_type="gaussian")


def _align_numbers(res, planted, wall_s: float) -> dict:
    from subpixal_tpu.testing import pairwise_shift_errors

    return dict(
        err_mpix=1e3 * pairwise_shift_errors(res.shifts, planted),
        iterations=res.n_iterations, converged=res.converged,
        setup_s=res.setup_s,
        loop_s=float(sum(r[0].iter_s for r in res.history)),
        wall_s=wall_s)


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_align(n_exp: int = 8, shape=(1024, 1024), n_stars: int = 60,
                seed: int = 11, max_err_mpix: float = 1.0,
                loop_agree_px: float = 1e-3, **extra) -> dict:
    """align_images on a simulated stack, host loop and device loop."""
    from subpixal_tpu.align import align_images

    exps, planted = _scene(n_exp, shape, n_stars, seed)
    out = {"scene": [n_exp, *shape], "n_stars": n_stars}
    shifts = {}
    for name, dev_loop in (("host_loop", False), ("device_loop", True)):
        t0 = time.time()
        res = align_images(exposures=[e.copy() for e in exps],
                           device_loop=dev_loop, **{**ALIGN_KW, **extra})
        out[name] = _align_numbers(res, planted, time.time() - t0)
        shifts[name] = np.asarray(res.shifts)
        _check(out[name]["err_mpix"] <= max_err_mpix,
               f"{name} err {out[name]['err_mpix']:.3f} mpix > "
               f"{max_err_mpix}")
    dloop = float(np.abs(shifts["host_loop"] - shifts["device_loop"]).max())
    out["loops_max_dpix"] = dloop
    out["peak_bytes_in_use"] = _peak_bytes()
    _check(dloop <= loop_agree_px,
           f"host and device loops differ by {dloop:.2e} px")
    return out


def phase_four(n_dev: int = 4, n_exp: int = 8, shape=(1024, 1024),
               n_stars: int = 60, seed: int = 11,
               max_err_mpix: float = 1.0, agree_px: float = 2e-2,
               **extra) -> list[tuple[str, dict]]:
    """The one-card align, then the frame-sharded ``mesh=`` align and
    the row-band ``spatial_mesh=`` align over ``n_dev`` devices."""
    from subpixal_tpu.align import align_images
    from subpixal_tpu.parallel import make_mesh
    from subpixal_tpu.resample import Drizzle

    import jax

    _check(len(jax.devices()) >= n_dev,
           f"--four needs {n_dev} devices, found {len(jax.devices())}")
    exps, planted = _scene(n_exp, shape, n_stars, seed)
    runs = [
        ("align_one", lambda: align_images(
            exposures=[e.copy() for e in exps], **{**ALIGN_KW, **extra})),
        ("mesh_align", lambda: align_images(
            exposures=[e.copy() for e in exps], mesh=make_mesh(n_dev),
            **{**ALIGN_KW, **extra})),
        ("spatial_align", lambda: align_images(
            resample=Drizzle([e.copy() for e in exps],
                             spatial_mesh=make_mesh(n_dev,
                                                    axis_name="rows")),
            **{**ALIGN_KW, **extra})),
    ]
    out, base = [], None
    for name, run in runs:
        t0 = time.time()
        res = run()
        nums = _align_numbers(res, planted, time.time() - t0)
        sh = np.asarray(res.shifts)
        if base is None:
            base = sh
        else:
            nums["vs_one_card_max_dpix"] = float(np.abs(sh - base).max())
        out.append((name, nums))
        _check(nums["err_mpix"] <= max_err_mpix,
               f"{name} err {nums['err_mpix']:.3f} mpix > {max_err_mpix}")
        dpix = nums.get("vs_one_card_max_dpix", 0.0)
        _check(dpix <= agree_px, f"{name} differs from the one-card "
               f"align by {dpix:.2e} px")
    return out


# --------------------------------------------------------------------- #
# driver
# --------------------------------------------------------------------- #

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phases")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "subpixal_tpu")):
        print("chip_smoke: the subpixal_tpu package is not beside this "
              "script; run it from the root of a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); "
              "this script runs on the card only", file=sys.stderr)
        return 2
    from subpixal_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    failed = []

    def run(name, fn):
        t0 = time.time()
        try:
            nums = fn()
        except Exception as e:  # noqa: BLE001 - reported, then exit 1
            print(f"FAIL {name}: {type(e).__name__}: {e}", file=sys.stderr,
                  flush=True)
            failed.append(name)
            return
        if isinstance(nums, dict):
            nums["phase_s"] = time.time() - t0
            _emit(name, nums)
        else:
            for sub, sub_nums in nums:
                _emit(sub, sub_nums)

    funcs = dict(device=phase_device, displacement=phase_displacement,
                 blot=phase_blot, deposit=phase_deposit, align=phase_align,
                 four=phase_four)
    for name in plan_phases(args.four):
        run(name, funcs[name])
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
