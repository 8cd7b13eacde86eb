"""Spatially-sharded mosaic demo: build and sample a mosaic whose
science/weight planes are row-band-sharded over a device mesh.

The frame/cutout mesh (`align_demo.py --mesh`) scales throughput; this
demo shows the MEMORY axis (`parallel/spatial.py`, SURVEY §5 "very
large mosaics"): per device only H/N mosaic rows are resident, so a
mosaic bounded by one card's memory spreads across the cards. Everything
here also runs on the 8-device virtual CPU mesh::

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/mosaic_spatial.py

On a host with several GPUs the same code shards over its cards.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from subpixal_tpu.parallel import (  # noqa: E402
    gather_rows,
    make_mesh,
    sample_spatial,
)
from subpixal_tpu.resample import Drizzle, Exposure  # noqa: E402
from subpixal_tpu.utils import enable_compilation_cache  # noqa: E402
from subpixal_tpu.wcs.wcs import TanWCS  # noqa: E402


def main():
    enable_compilation_cache()
    n = len(jax.devices())
    mesh = make_mesh(n, axis_name="rows")
    print(f"mesh: {n} device(s), axis 'rows'")

    # a dithered stack of detector frames
    rng = np.random.default_rng(0)
    s = 0.05 / 3600.0
    shape = (512, 512)
    gy, gx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    stars = rng.uniform(40, shape[1] - 40, (25, 2)).astype(np.float32)
    exps = []
    for k in range(4):
        img = rng.normal(0, 0.01, shape).astype(np.float32)
        for sx, sy in stars:
            img += 8.0 * np.exp(-((gx - sx - 0.3 * k) ** 2
                                  + (gy - sy + 0.2 * k) ** 2) / 8.0)
        wcs = TanWCS(
            crpix=np.array([shape[1] / 2 + 5 * k, shape[0] / 2 - 3 * k]),
            crval=np.array([150.0, 2.0]),
            cd=s * np.array([[-1.0, 0.0], [0.0, 1.0]]))
        exps.append(Exposure(img, wcs, name=f"m{k}"))

    # the mosaic accumulators live row-band-sharded on the mesh; on a
    # real slice each device holds only H/n rows
    d = Drizzle(exps, spatial_mesh=mesh)
    d.execute()
    Ho, Wo = d._oshape
    print(f"mosaic {Ho}x{Wo}: accumulators sharded "
          f"{d._sci_acc.sharding.spec}, "
          f"~{d._sci_acc.shape[0] // n} rows/device")

    # incremental update stays sharded (the align loop's fast path)
    moved = exps[1].copy()
    moved.wcs = moved.wcs.replace(crpix=moved.wcs.crpix + 0.25)
    d.fast_replace_image(moved)

    # blot a cutout window straight from the sharded plane
    from subpixal_tpu.ops.drizzle import drizzle_combine

    mosaic_sharded = jax.jit(drizzle_combine)(d._sci_acc, d._wht_acc)
    bx = (np.mgrid[0:48, 0:48][1] + Wo / 2 - 24).astype(np.float32)
    by = (np.mgrid[0:48, 0:48][0] + Ho / 2 - 24).astype(np.float32)
    vals, ok = sample_spatial(mesh, mosaic_sharded, bx, by,
                              interp="poly5", logical_rows=Ho)
    print(f"blot window from sharded mosaic: mean={float(vals.mean()):.4f}"
          f" valid={int(np.asarray(ok).sum())}/{ok.size}")

    # the FULL align loop drives the sharded reference directly
    from subpixal_tpu import align_images

    res = align_images(resample=Drizzle([e.copy() for e in exps],
                                        spatial_mesh=mesh),
                       fitgeom="shift", max_iterations=3, usfac=8,
                       fit_type="gaussian", cutout_shape=(24, 24),
                       min_sources=3)
    print(f"spatial align: {res.n_iterations} iteration(s), shifts:\n"
          f"{np.asarray(res.shifts).round(4)}")

    # the full product only materializes when explicitly gathered
    sci = d.output_sci
    print(f"gathered product: {sci.shape}, peak {sci.max():.2f}")
    # sanity vs an unsharded build
    ref = Drizzle([e.copy() for e in exps[:1]] + [moved.copy()]
                  + [e.copy() for e in exps[2:]])
    ref.execute()
    print(f"max |sharded - unsharded| = "
          f"{np.abs(sci - ref.output_sci).max():.2e}")


if __name__ == "__main__":
    main()
