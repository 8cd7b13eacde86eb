"""Benchmark: batched cutout cross-correlation throughput + shift RMSE.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "cc/s", "vs_baseline": N, ...}

Workload = BASELINE configs 2+3: a 500-source catalog of 64x64 cutout
pairs with planted subpixel shifts; each pair is measured with NCC
cross-correlation, 10x Fourier-domain upsampling and a Gaussian surface
peak fit.

vs_baseline compares the batched device path against a faithful serial
numpy implementation of the reference's per-pair algorithm
(subpixal/cc.py: fft2 -> conj-multiply -> ifft2 -> upsampled matrix-DFT
-> quadratic/log peak fit), timed on this host's CPU. The reference
publishes no numbers (BASELINE.md), so its algorithm re-timed on CPU is
the baseline.

The remaining sections time the blot gather, the drizzle deposit, the
displacement pipeline's transform variants, and align_images on
simulated stacks (1024², 2048², spatial, 4096² spatial, fresh process).
Every section runs on the GPU; without one the script exits non-zero.

    python bench.py                      # every section
    python bench.py --only kernels,dft   # selected sections
"""

import json
import time

import numpy as np


# --------------------------------------------------------------------- #
# workload
# --------------------------------------------------------------------- #
def make_workload(B=500, h=64, w=64, seed=0, sigma=2.0, noise=1e-3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dxs = rng.uniform(-0.5, 0.5, B)
    dys = rng.uniform(-0.5, 0.5, B)
    ref = np.exp(-((xx - w / 2) ** 2 + (yy - h / 2) ** 2) / (2 * sigma**2))
    refs = (ref[None] + rng.normal(0, noise, (B, h, w))).astype(np.float32)
    imgs = np.exp(
        -((xx[None] - w / 2 - dxs[:, None, None]) ** 2
          + (yy[None] - h / 2 - dys[:, None, None]) ** 2) / (2 * sigma**2)
    )
    imgs = (imgs + rng.normal(0, noise, (B, h, w))).astype(np.float32)
    return refs, imgs, dxs, dys


# --------------------------------------------------------------------- #
# serial numpy reference (the subpixal algorithm, per pair)
# --------------------------------------------------------------------- #
def _np_find_displacement(ref, img, usfac=10, kfit=5):
    """One pair, reference-style: NCC + FFT + upsampled DFT + peak fit."""
    h, w = ref.shape

    def norm(a):
        a = a.astype(np.float64)
        a = a - a.mean()
        s = a.std()
        return a / (s * np.sqrt(a.size) + 1e-30)

    r = norm(ref)
    i = norm(img)
    Fr = np.fft.fft2(r)
    Fi = np.fft.fft2(i)
    G = Fi * np.conj(Fr)
    cc = np.fft.ifft2(G).real
    cc_s = np.fft.fftshift(cc)
    py, px = np.unravel_index(np.argmax(cc_s), cc_s.shape)
    s0y, s0x = py - h // 2, px - w // 2

    # matrix-DFT upsampling around the coarse peak (Guizar-Sicairos style)
    n = usfac + kfit + 3
    fy = np.fft.fftfreq(h) * h
    fx = np.fft.fftfreq(w) * w
    ty = s0y + (np.arange(n) - n // 2) / usfac
    tx = s0x + (np.arange(n) - n // 2) / usfac
    kr = np.exp(2j * np.pi * np.outer(ty, fy) / h)
    kc = np.exp(2j * np.pi * np.outer(fx, tx) / w)
    C = (kr @ G @ kc).real / (h * w)

    # quadratic fit on log surface around the argmax
    qy, qx = np.unravel_index(np.argmax(C), C.shape)
    k = kfit
    y0 = min(max(qy - k // 2, 0), n - k)
    x0 = min(max(qx - k // 2, 0), n - k)
    box = C[y0:y0 + k, x0:x0 + k]
    bmax = box.max()
    z = np.log(np.clip(box / bmax, 1e-8, None))
    wts = np.clip(box / bmax, 0, 1).ravel()
    c = (k - 1) / 2.0
    gy, gx = np.mgrid[0:k, 0:k].astype(np.float64)
    X = np.stack([np.ones(k * k), (gx - c).ravel(), (gy - c).ravel(),
                  ((gx - c) ** 2).ravel(), ((gx - c) * (gy - c)).ravel(),
                  ((gy - c) ** 2).ravel()], 1)
    A = X * wts[:, None]
    coef, *_ = np.linalg.lstsq(A, z.ravel() * wts, rcond=None)
    c0, c1, c2, c3, c4, c5 = coef
    det = 4 * c3 * c5 - c4 * c4
    if det > 0 and c3 < 0:
        sx = (-2 * c5 * c1 + c4 * c2) / det
        sy = (c4 * c1 - 2 * c3 * c2) / det
    else:
        sx = sy = 0.0
    ux = x0 + c + sx
    uy = y0 + c + sy
    dx = s0x + (ux - n // 2) / usfac
    dy = s0y + (uy - n // 2) / usfac
    return dx, dy


def bench_cpu_reference(refs, imgs, n_pairs=200, repeats=5):
    """Serial-numpy baseline rate: BEST of ``repeats`` timed passes over
    ``n_pairs`` pairs — the host is shared, so the max is the capability
    number and the one robust to one-sided slowdown noise."""
    out = []
    rates = []
    for rep in range(repeats):
        t0 = time.perf_counter()
        res = [_np_find_displacement(refs[b], imgs[b])
               for b in range(n_pairs)]
        rates.append(n_pairs / (time.perf_counter() - t0))
        if rep == 0:
            out = res
    return float(np.max(rates)), np.asarray(out)


def nvidia_smi(query: str = "name,power.limit") -> str:
    """``nvidia-smi --query-gpu=<query>`` as CSV without header."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _dev_time_per_iter(make_loop, iters=(1, 21)):
    """Device time per iteration of a dependent loop.

    ``make_loop(k)`` must return a one-scalar-argument function running
    the op k times in a *dependent* ``lax.fori_loop`` that folds both the
    scalar and the previous iteration's output into the next input. One
    jit per loop length; differencing two lengths removes the fixed
    dispatch and sync cost; a distinct scalar per call keeps every call
    a real computation. Returns the MEDIAN of 5 differenced samples.
    """
    import jax
    import numpy as _np

    fs = {k: jax.jit(make_loop(k)) for k in iters}
    seed = 0.0
    for k in iters:  # compile + warm
        jax.block_until_ready(fs[k](_np.float32(seed)))
        seed += 1.0
    deltas = []
    for _ in range(5):
        ts = {}
        for k in iters:
            arg = _np.float32(seed)
            seed += 1.0
            t0 = time.perf_counter()
            jax.block_until_ready(fs[k](arg))
            ts[k] = time.perf_counter() - t0
        k0, k1 = iters
        deltas.append((ts[k1] - ts[k0]) / (k1 - k0))
    return float(np.median(deltas))


def _displacement_loop(r_j, i_j):
    import jax
    import jax.numpy as jnp

    from subpixal_tpu.ops.correlate import find_displacement

    def make_loop(k):
        def run(seed):
            def body(_, carry):
                s, _ = carry
                # constant offset: numerically visible, NCC-invariant
                d = find_displacement(
                    r_j + (s * 1e-12 + seed * 1e-6), i_j, cc_type="NCC",
                    usfac=10, fit_type="gaussian")
                return (jnp.sum(d.dx), d.dx[0])
            return jax.lax.fori_loop(
                0, k, body, (jnp.float32(0), jnp.float32(0)))[1]
        return run
    return make_loop


def bench_displacement(refs, imgs, dxs, dys):
    """Headline: cutout pairs per second of the default pipeline."""
    import jax
    import jax.numpy as jnp

    from subpixal_tpu.ops.correlate import find_displacement

    f = jax.jit(lambda r, i: find_displacement(
        r, i, cc_type="NCC", usfac=10, fit_type="gaussian"))
    r_j = jnp.asarray(refs)
    i_j = jnp.asarray(imgs)
    out = jax.block_until_ready(f(r_j, i_j))
    dt = _dev_time_per_iter(_displacement_loop(r_j, i_j), iters=(1, 201))
    ex = np.asarray(out.dx) - dxs
    ey = np.asarray(out.dy) - dys
    rmse_mpix = 1e3 * float(np.sqrt(np.mean(ex**2 + ey**2)))
    dxy = np.stack([np.asarray(out.dx), np.asarray(out.dy)], 1)
    return refs.shape[0] / dt, rmse_mpix, dxy


#: the displacement pipeline's transform variants: env settings read at
#: trace time by ops.correlate / ops.correlate_packed
DFT_VARIANTS = {
    "fft": {"SUBPIXAL_TPU_FFT": "", "SUBPIXAL_TPU_PACKED": ""},
    "matmul": {"SUBPIXAL_TPU_FFT": "matmul", "SUBPIXAL_TPU_PACKED": ""},
    "packed": {"SUBPIXAL_TPU_FFT": "", "SUBPIXAL_TPU_PACKED": "force"},
}


def bench_dft_variants(refs, imgs, ref_dxy):
    """Per-batch device time of each transform variant on the headline
    workload, each with the reference gate (rmse vs the f64 serial
    reference on the first len(ref_dxy) pairs)."""
    import os

    import jax
    import jax.numpy as jnp

    from subpixal_tpu.ops.correlate import find_displacement

    r_j = jnp.asarray(refs)
    i_j = jnp.asarray(imgs)
    out = {}
    saved = {k: os.environ.get(k) for k in DFT_VARIANTS["fft"]}
    try:
        for name, env in DFT_VARIANTS.items():
            os.environ.update(env)
            # a fresh closure retraces under the new settings
            f = jax.jit(lambda r, i: find_displacement(
                r, i, cc_type="NCC", usfac=10, fit_type="gaussian"))
            d = jax.block_until_ready(f(r_j, i_j))
            dxy = np.stack([np.asarray(d.dx), np.asarray(d.dy)], 1)
            n = ref_dxy.shape[0]
            vs_ref = 1e3 * float(np.sqrt(np.mean(
                np.sum((dxy[:n] - ref_dxy) ** 2, axis=1))))
            dt = _dev_time_per_iter(_displacement_loop(r_j, i_j),
                                    iters=(1, 201))
            out[name] = {"batch_us": round(1e6 * dt, 2),
                         "cc_per_s": round(refs.shape[0] / dt, 1),
                         "shift_rmse_vs_reference_mpix": round(vs_ref, 4),
                         "gate_ok": vs_ref < 0.1}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"dft_variants": out}


def bench_kernels():
    """XLA blot gather (poly5, 500x64² cutouts from a 1024² plane) and
    XLA drizzle deposit (square, 1024² frame), device time per call."""
    import jax
    import jax.numpy as jnp

    from subpixal_tpu.ops.drizzle import drizzle_deposit
    from subpixal_tpu.ops.interp import sample_image

    rng = np.random.default_rng(3)
    H = W = 1024
    img = jnp.asarray(rng.random((H, W)).astype(np.float32))
    B, h, w = 500, 64, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx = jnp.asarray((xx[None] + rng.uniform(3, W - 80, B)[:, None, None]
                      ).astype(np.float32))
    cy = jnp.asarray((yy[None] + rng.uniform(3, H - 80, B)[:, None, None]
                      ).astype(np.float32))
    gx = jnp.asarray(np.mgrid[0:H, 0:W][1].astype(np.float32) + 0.3)
    gy = jnp.asarray(np.mgrid[0:H, 0:W][0].astype(np.float32) + 0.2)
    blot = jax.vmap(lambda x, y: sample_image(img, x, y, interp="poly5"))

    def blot_loop(k):
        def run(seed):
            def body(_, s):
                v, _ok = blot(cx + (s * 1e-20 + seed * 1e-6), cy)
                return jnp.sum(v) * 1e-12
            return jax.lax.fori_loop(0, k, body, jnp.float32(0))
        return run

    def driz_loop(k):
        def run(seed):
            def body(_, s):
                sci, _w = drizzle_deposit(
                    img, None, gx + (s * 1e-20 + seed * 1e-6), gy, (H, W))
                return jnp.sum(sci) * 1e-12
            return jax.lax.fori_loop(0, k, body, jnp.float32(0))
        return run

    dt_b = _dev_time_per_iter(blot_loop, iters=(1, 41))
    dt_d = _dev_time_per_iter(driz_loop, iters=(1, 41))
    return {
        "xla_blot_poly5_ms": round(1e3 * dt_b, 4),
        "xla_blot_poly5_mpix_per_s": round(B * h * w / dt_b / 1e6, 1),
        "xla_drizzle_square_ms": round(1e3 * dt_d, 4),
        "xla_drizzle_square_mpix_per_s": round(H * W / dt_d / 1e6, 1),
    }


def _iter_ms_diff(run, reps=3, counts=(4, 12)):
    """Per-iteration ms of an align runner: walls at two iteration
    counts, differenced at their medians (cancels the fixed per-entry
    dispatch and history fetch)."""

    def wall(res):
        return sum(r[0].iter_s for r in res.history)

    lo, hi = counts
    w_lo = [wall(run(lo)) for _ in range(reps)]
    w_hi = [wall(run(hi)) for _ in range(reps)]
    return 1e3 * float(np.median(w_hi) - np.median(w_lo)) / (hi - lo)


def bench_align_smoke():
    """8-frame 1024² align (SURVEY §3.1 hot loop), 4 device iterations.

    Asserts the planted shifts are recovered (<10 mpix pairwise) and
    emits setup seconds, the setup breakdown and ms/iter. A second scene
    rendered on device (no exposure host->device transfer) gives the
    framework's own setup cost.
    """
    from subpixal_tpu.align import align_images
    from subpixal_tpu.testing import pairwise_shift_errors, simulate_stack

    exps, planted = simulate_stack(n_exp=8, shape=(1024, 1024),
                                   n_stars=60, seed=11)
    # eps_shift pinned tiny so exactly max_iterations device iterations
    # run — align_iter_ms then amortizes the single host sync over a
    # fixed count instead of varying with convergence speed
    kw = dict(fitgeom="shift", eps_shift=1e-7, usfac=8,
              fit_type="gaussian")
    res = align_images(exposures=exps, max_iterations=4, **kw)
    err_mpix = 1e3 * pairwise_shift_errors(res.shifts, planted)
    assert err_mpix < 10.0, f"align smoke fit error {err_mpix:.2f} mpix"
    out = {
        "align_fit_err_mpix": round(err_mpix, 3),
        "align_setup_s": round(res.setup_s, 2),
        "align_setup_breakdown": {
            k: round(v, 2) for k, v in
            (res.setup_breakdown or {}).items()
            if isinstance(v, float) and
            (v > 0.25 or k in ("resample_execute", "cutout_pixmaps",
                               "frame_pixmaps"))
        },
        "align_n_iterations": res.n_iterations,
    }
    exps_d, planted_d = simulate_stack(n_exp=8, shape=(1024, 1024),
                                       n_stars=60, seed=11, device=True)
    res_d = align_images(exposures=exps_d, max_iterations=4, **kw)
    err_d = 1e3 * pairwise_shift_errors(res_d.shifts, planted_d)
    assert err_d < 10.0, f"device-scene smoke fit error {err_d:.2f} mpix"
    out["align_setup_device_s"] = round(res_d.setup_s, 2)
    out["align_iter_ms"] = round(_iter_ms_diff(
        lambda it: align_images(exposures=exps_d, max_iterations=it,
                                **kw)), 2)
    return out


def bench_align_2k():
    """Mosaic-scale align: 4×2048² frames, 40 sources. Emits the
    live-block fraction when the sparse in-loop deposit engages."""
    from subpixal_tpu.align import align_images
    from subpixal_tpu.testing import pairwise_shift_errors, simulate_stack

    kw = dict(fitgeom="shift", eps_shift=1e-7, usfac=8,
              fit_type="gaussian")
    exps, planted = simulate_stack(n_exp=4, shape=(2048, 2048),
                                   n_stars=40, seed=17)
    res = align_images(exposures=exps, max_iterations=3, **kw)
    err_mpix = 1e3 * pairwise_shift_errors(res.shifts, planted)
    assert err_mpix < 10.0, f"2k align fit error {err_mpix:.2f} mpix"
    exps_d, planted_d = simulate_stack(n_exp=4, shape=(2048, 2048),
                                       n_stars=40, seed=17, device=True)
    res_d = align_images(exposures=exps_d, max_iterations=3, **kw)
    err_d = 1e3 * pairwise_shift_errors(res_d.shifts, planted_d)
    assert err_d < 10.0, f"2k device-scene fit error {err_d:.2f} mpix"
    return {
        "align2k_iter_ms": round(_iter_ms_diff(
            lambda it: align_images(exposures=exps_d, max_iterations=it,
                                    **kw), reps=2, counts=(3, 9)), 2),
        "align2k_setup_s": round(res.setup_s, 2),
        "align2k_setup_device_s": round(res_d.setup_s, 2),
        "align2k_fit_err_mpix": round(err_mpix, 3),
        "align2k_sparse_live_frac":
            res.setup_breakdown.get("sparse_live_frac", 1.0),
    }


def bench_align_spatial():
    """Spatial (row-band-sharded) align at the smoke's frame size: the
    same 8x1024² scene through ``Drizzle(spatial_mesh=...)`` on a
    1-device mesh — the sharded program (band deposit, banded gather,
    psum'd fit) on the card, for comparison with ``align_iter_ms``."""
    from subpixal_tpu.align import align_images
    from subpixal_tpu.parallel.sharding import make_mesh
    from subpixal_tpu.resample import Drizzle
    from subpixal_tpu.testing import pairwise_shift_errors, simulate_stack

    mesh = make_mesh(1, axis_name="rows")
    exps, planted = simulate_stack(n_exp=8, shape=(1024, 1024),
                                   n_stars=60, seed=11, device=True)

    def run(it):
        return align_images(resample=Drizzle(exps, spatial_mesh=mesh),
                            fitgeom="shift", max_iterations=it,
                            eps_shift=1e-7, usfac=8, fit_type="gaussian")

    res = run(4)
    err_mpix = 1e3 * pairwise_shift_errors(res.shifts, planted)
    assert err_mpix < 10.0, f"spatial align fit error {err_mpix:.2f} mpix"
    out = {
        "align_spatial_iter_ms": round(_iter_ms_diff(run), 2),
        "align_spatial_fit_err_mpix": round(err_mpix, 3),
        "align_spatial_setup_s": round(res.setup_s, 2),
    }
    if "sparse_live_frac" in res.setup_breakdown:
        out["align_spatial_sparse_live_frac"] = (
            res.setup_breakdown["sparse_live_frac"])
    return out


def bench_align_4k_spatial():
    """4096² spatial datapoint: a 4x4096² scene through
    ``Drizzle(spatial_mesh=...)``: setup, fit error, sparse live
    fraction and ms/iter."""
    from subpixal_tpu.align import align_images
    from subpixal_tpu.parallel.sharding import make_mesh
    from subpixal_tpu.resample import Drizzle
    from subpixal_tpu.testing import pairwise_shift_errors, simulate_stack

    exps, planted = simulate_stack(n_exp=4, shape=(4096, 4096),
                                   n_stars=80, seed=23, device=True)
    mesh = make_mesh(1, axis_name="rows")

    def run(iters):
        return align_images(resample=Drizzle(exps, spatial_mesh=mesh),
                            fitgeom="shift", max_iterations=iters,
                            eps_shift=1e-7, usfac=8,
                            fit_type="gaussian")

    res = run(2)
    err = 1e3 * pairwise_shift_errors(res.shifts, planted)
    assert err < 10.0, f"4k spatial fit error {err:.2f} mpix"
    return {
        "align4k_spatial_setup_s": round(res.setup_s, 2),
        "align4k_spatial_fit_err_mpix": round(float(err), 3),
        "align4k_spatial_live_frac":
            res.setup_breakdown.get("sparse_live_frac"),
        "align4k_spatial_iter_ms": round(
            _iter_ms_diff(run, reps=2, counts=(2, 6)), 2),
    }


def _fresh_child_main():
    """Child mode (``python bench.py --fresh-child``): run the 8x1024²
    device-scene align in THIS fresh process and print one JSON line
    with end-to-end wall timings."""
    import os
    import sys

    t0 = time.time()
    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from subpixal_tpu.align import align_images
    from subpixal_tpu.testing import pairwise_shift_errors, simulate_stack

    t_imp = time.time()
    jax.devices()
    t_dev = time.time()
    exps, planted = simulate_stack(n_exp=8, shape=(1024, 1024),
                                   n_stars=60, seed=11, device=True)
    t_scene = time.time()
    res = align_images(exposures=exps, fitgeom="shift", max_iterations=4,
                       eps_shift=1e-7, usfac=8, fit_type="gaussian")
    t_align = time.time()
    err = 1e3 * pairwise_shift_errors(res.shifts, planted)
    assert err < 10.0, f"fresh-child fit error {err:.2f} mpix"
    print(json.dumps({
        "total_s": round(time.time() - t0, 2),
        "import_s": round(t_imp - t0, 2),
        "client_init_s": round(t_dev - t_imp, 2),
        "scene_s": round(t_scene - t_dev, 2),
        "align_s": round(t_align - t_scene, 2),
        "err_mpix": round(float(err), 3),
        "setup_s": round(res.setup_s, 2),
        "breakdown": {k: (round(v, 2) if isinstance(v, float) else v)
                      for k, v in (res.setup_breakdown or {}).items()
                      if isinstance(v, float) and v > 0.25},
    }))


def bench_align_fresh():
    """Fresh-PROCESS align latency: child processes run the 8x1024²
    device-scene align one after another — one COLD (empty caches),
    then two WARM with the serialized-executable cache on and two with
    it off (``SUBPIXAL_TPU_AOT_LOOP=0``; the XLA compile cache stays).

    The parent must not hold the card while a child runs (a JAX process
    reserves most of its memory), so this section runs FIRST, before
    the parent touches JAX. The caches live in ``fresh_bench`` under
    the compile-cache directory and are emptied first.
    """
    import os
    import shutil
    import subprocess
    import sys

    from subpixal_tpu.utils import cache_dir

    script = os.path.abspath(__file__)
    base = os.path.join(cache_dir(), "fresh_bench")
    shutil.rmtree(base, ignore_errors=True)
    env = dict(os.environ)
    env["SUBPIXAL_TPU_AOT_DIR"] = os.path.join(base, "aot")
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(base, "xla")

    def run(extra_env, timeout):
        t0 = time.time()
        r = subprocess.run([sys.executable, script, "--fresh-child"],
                           capture_output=True, text=True,
                           env={**env, **extra_env}, timeout=timeout,
                           cwd=os.path.dirname(script))
        wall = time.time() - t0
        if r.returncode != 0:
            raise RuntimeError(f"fresh child rc={r.returncode}: "
                               f"{r.stderr.strip()[-2000:]}")
        child = json.loads(r.stdout.strip().splitlines()[-1])
        child["process_wall_s"] = round(wall, 2)
        return child

    cold = run({}, timeout=1200)
    warm = [run({}, timeout=600) for _ in range(2)]
    warm_no_aot = [run({"SUBPIXAL_TPU_AOT_LOOP": "0"}, timeout=600)
                   for _ in range(2)]
    shutil.rmtree(base, ignore_errors=True)
    return {"align_fresh": {"cold": cold, "warm": warm,
                            "warm_no_aot": warm_no_aot}}


SECTIONS = ("fresh", "headline", "dft", "kernels", "smoke", "2k",
            "spatial", "4k")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="subpixal_tpu benchmark")
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="comma-separated sections of: "
                         + ", ".join(SECTIONS))
    args = ap.parse_args(argv)
    only = [s.strip() for s in args.only.split(",") if s.strip()]
    bad = set(only) - set(SECTIONS)
    if bad:
        ap.error(f"unknown sections {sorted(bad)}")

    # before the parent touches JAX: its children need the card
    extras = bench_align_fresh() if "fresh" in only else {}

    import os

    import jax

    from subpixal_tpu.utils import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX found {dev.platform})")
    enable_compilation_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "nvidia_smi": nvidia_smi()}

    result = {}
    if {"headline", "dft"} & set(only):
        refs, imgs, dxs, dys = make_workload()
        cpu_ccs, cpu_dxy = bench_cpu_reference(refs, imgs)
    if "headline" in only:
        trace_dir = os.environ.get("SUBPIXAL_TPU_TRACE")
        if trace_dir:  # SURVEY §5 tracing hook: perfetto/xplane dump
            jax.profiler.start_trace(trace_dir)
        try:
            ccs, rmse_mpix, dxy = bench_displacement(refs, imgs, dxs, dys)
        finally:
            if trace_dir:
                jax.profiler.stop_trace()
        # BASELINE metric "shift RMSE vs reference": same data, device
        # vs the reference algorithm's own measurements (data noise
        # cancels). Hard gate: the device algorithm must track the f64
        # reference algorithm to well under the mpix regime.
        n = cpu_dxy.shape[0]
        vs_ref = 1e3 * float(
            np.sqrt(np.mean(np.sum((dxy[:n] - cpu_dxy) ** 2, axis=1))))
        assert vs_ref < 0.1, (
            f"shift_rmse_vs_reference_mpix={vs_ref:.4f} >= 0.1 — device "
            "measurement drifted from the f64 reference algorithm")
        result = {
            "metric": "batched cutout cross-correlations/sec "
                      "(NCC + 10x Fourier upsampling + Gaussian peak fit, "
                      "500x64x64)",
            "value": round(ccs, 1),
            "unit": "cc/s",
            "vs_baseline": round(ccs / cpu_ccs, 2),
            "baseline_cpu_ccs": round(cpu_ccs, 1),
            "shift_rmse_vs_truth_mpix": round(rmse_mpix, 4),
            "shift_rmse_vs_reference_mpix": round(vs_ref, 4),
        }
    if "dft" in only:
        extras.update(bench_dft_variants(refs, imgs, cpu_dxy))
    if "kernels" in only:
        extras.update(bench_kernels())
    if "smoke" in only:
        extras.update(bench_align_smoke())
    if "2k" in only:
        extras.update(bench_align_2k())
    if "spatial" in only:
        extras.update(bench_align_spatial())
        if "align_iter_ms" in extras:
            extras["align_spatial_vs_replicated"] = round(
                extras["align_spatial_iter_ms"] / extras["align_iter_ms"],
                2)
    if "4k" in only:
        extras.update(bench_align_4k_spatial())
    print(json.dumps({**result, "device": device, **extras}))


if __name__ == "__main__":
    import sys as _sys

    if "--fresh-child" in _sys.argv:
        _fresh_child_main()
        raise SystemExit(0)
    main()
