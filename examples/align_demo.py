"""End-to-end subpixal_tpu demo: simulate, align, inspect.

Runs on CPU or GPU (auto-detected). Three parts:

1. array-level alignment of a synthetic dithered stack with planted
   sub-pixel WCS errors (`align_images(exposures=...)`);
2. the same through the FITS workflow the reference uses
   (`align_fits`: files in, corrected headers out);
3. (optional) the SPMD mesh path over whatever devices exist.

Usage::

    python examples/align_demo.py            # parts 1 + 2
    python examples/align_demo.py --mesh     # adds part 3
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from subpixal_tpu import align_images
from subpixal_tpu.pipeline import align_fits
from subpixal_tpu.io.fits import HDU, Header, write_fits
from subpixal_tpu.testing import pairwise_shift_errors, simulate_stack
from subpixal_tpu.utils import enable_compilation_cache
from subpixal_tpu.wcs.fitswcs import wcs_to_header


def report(res, planted):
    print(f"  converged={res.converged} after {res.n_iterations} "
          f"iteration(s); setup {res.setup_s:.1f}s")
    err = pairwise_shift_errors(res.shifts, planted)
    print(f"  max pairwise error vs planted: {1e3 * err:.2f} mpix")
    for recs in res.history[-1:]:
        for r in recs:
            print(f"  {r.name}: shift=({r.shift[0]:+.4f}, "
                  f"{r.shift[1]:+.4f}) px, nmatches={r.nmatches}, "
                  f"rmse={r.rmse:.4f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", action="store_true",
                    help="also run the SPMD mesh path")
    args = ap.parse_args()
    enable_compilation_cache()

    print("== 1. array-level alignment ==")
    exps, planted = simulate_stack()
    res = align_images(exposures=exps, fitgeom="shift", usfac=8,
                       fit_type="gaussian")
    report(res, planted)
    print("  combined reference:",
          np.asarray(res.drizzle.output_sci).shape)

    print("== 2. FITS workflow (reference usage pattern) ==")
    exps, planted = simulate_stack(seed=7)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for e in exps:
            h = Header()
            h["EXTNAME"] = "SCI"
            h["EXTVER"] = 1
            h["EXPTIME"] = 1.0
            wcs_to_header(e.wcs, h)
            p = os.path.join(tmp, f"{e.name}_flt.fits")
            write_fits(p, [HDU(), HDU(e.data, h)])
            paths.append(p)
        res = align_fits(paths, fitgeom="shift", usfac=8,
                         fit_type="gaussian",
                         state_file=os.path.join(tmp, "state.json"))
        report(res, planted)
        print("  headers updated in place; checkpoint:",
              os.path.join(tmp, "state.json"))

    if args.mesh:
        print("== 3. SPMD mesh path ==")
        import jax

        from subpixal_tpu.parallel import make_mesh

        n = len(jax.devices())
        exps, planted = simulate_stack(seed=11)
        res = align_images(exposures=exps, mesh=make_mesh(n),
                           fitgeom="shift", usfac=8, fit_type="gaussian")
        print(f"  over {n} device(s):")
        report(res, planted)


if __name__ == "__main__":
    main()
