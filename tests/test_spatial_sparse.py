"""Band-local sparse live set for the spatial (row-band-sharded) align.

VERDICT r3 task 5 (final piece): under ``spatial_mesh`` the in-loop
re-drizzle no longer walks every input block on every device — each
band keeps only the blocks whose deposits can reach a blot-needed
output cell INSIDE its rows (`align._live_block_indices(bands=...)`),
and the band-compacted pseudo-images shard over the mesh rows axis
(`parallel.spatial.drizzle_deposit_sparse_spatial`).

Core guarantee tested here: the union over bands of the band-local
live sets equals the replicated sparse live set — a straddling block
appears in every band its padded bbox touches, and out-of-band cells
fail each band deposit's own bounds check — so the band-sharded
deposit reproduces the replicated sparse deposit on every pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from subpixal_tpu.align import (_block_bboxes, _compact_blocks,
                                _compact_blocks_bands,
                                _live_block_indices)
from subpixal_tpu.ops.drizzle import drizzle_deposit
from subpixal_tpu.parallel import (band_rows, gather_rows, make_mesh,
                                   make_mesh2d,
                                   drizzle_deposit_sparse_spatial)
from subpixal_tpu.parallel.spatial import _n_bands


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, axis_name="rows")


def _scene(E=2, H=256, W=256, n_cut=3, h=24, w=24, seed=5):
    rng = np.random.default_rng(seed)
    data = rng.normal(1.0, 0.1, (E, H, W)).astype(np.float32)
    wht = np.ones((E, H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    px = np.stack([xx + 0.3 * e + 1e-3 * yy for e in range(E)])
    py = np.stack([yy - 0.2 * e + 1e-3 * xx for e in range(E)])
    cyy, cxx = np.mgrid[0:h, 0:w].astype(np.float32)
    centers = rng.uniform(40, min(H, W) - 40, (n_cut, 2)).astype(
        np.float32)
    cut_px = np.stack([np.stack([cx - w / 2 + cxx for cx, _ in centers])
                       for _ in range(E)])
    cut_py = np.stack([np.stack([cy - h / 2 + cyy for _, cy in centers])
                       for _ in range(E)])
    return data, wht, px, py, cut_px, cut_py


def _live_sets(mesh, out_shape, px, py, cut_px, cut_py,
               blot_margin=24.0, corr_margin=2.0):
    bb = _block_bboxes(jnp.asarray(px), jnp.asarray(py))
    cut_bb = (cut_py.min((2, 3)), cut_py.max((2, 3)),
              cut_px.min((2, 3)), cut_px.max((2, 3)))
    rep = _live_block_indices(bb, cut_bb, out_shape,
                              blot_margin=blot_margin,
                              corr_margin=corr_margin)
    bands = (_n_bands(mesh), band_rows(mesh, out_shape[0]))
    per_band = _live_block_indices(bb, cut_bb, out_shape,
                                   blot_margin=blot_margin,
                                   corr_margin=corr_margin, bands=bands)
    return rep, per_band


class TestBandLiveSet:
    def test_union_over_bands_is_replicated_set(self, mesh):
        data, wht, px, py, cut_px, cut_py = _scene()
        out_shape = data.shape[1:]
        (idx, valid), (idx_b, valid_b) = _live_sets(
            mesh, out_shape, px, py, cut_px, cut_py)
        assert idx_b.shape[:2] == (8, data.shape[0])
        E = data.shape[0]
        for e in range(E):
            rep = set(np.asarray(idx)[e][np.asarray(valid)[e]])
            union = set()
            for b in range(8):
                union |= set(np.asarray(idx_b)[b, e][
                    np.asarray(valid_b)[b, e]])
            assert union == rep
        # and each band's set is a strict subset on a tall scene
        per_band_max = max(
            int(valid_b[b].sum(1).max()) for b in range(8))
        assert per_band_max < int(valid.sum(1).max())

    def test_band_deposit_matches_full_on_needed_cells(self, mesh):
        """On every blot-needed cell the band-sharded sparse deposit
        equals the FULL (all-blocks) deposit — the same contract the
        replicated sparse path tests. Away from needed cells the band
        deposit may legitimately write less (a block live only in band
        b deposits nothing into other bands unless they list it too),
        which the blot never reads."""
        data, wht, px, py, cut_px, cut_py = _scene()
        E, H, W = data.shape
        out_shape = (H, W)
        blot_margin = 24.0
        _, (idx_b, valid_b) = _live_sets(
            mesh, out_shape, px, py, cut_px, cut_py,
            blot_margin=blot_margin)

        # oracle: FULL deposit, all blocks, frames summed
        s_ref = np.zeros(out_shape, np.float32)
        w_ref = np.zeros(out_shape, np.float32)
        for e in range(E):
            s, w = drizzle_deposit(
                jnp.asarray(data[e]), jnp.asarray(wht[e]),
                jnp.asarray(px[e]), jnp.asarray(py[e]), out_shape)
            s_ref += np.asarray(s)
            w_ref += np.asarray(w)

        bd, bw_, bx, by = _compact_blocks_bands(
            jnp.asarray(data), jnp.asarray(wht), jnp.asarray(px),
            jnp.asarray(py), jnp.asarray(idx_b), jnp.asarray(valid_b))
        s_sp, w_sp = drizzle_deposit_sparse_spatial(
            mesh, bd, bw_, bx, by, out_shape)
        assert s_sp.sharding.spec in (P("rows"), P("rows", None))

        need = np.zeros(out_shape, bool)
        for e in range(E):
            for n in range(cut_px.shape[1]):
                y0 = max(int(cut_py[e, n].min() - blot_margin), 0)
                y1 = min(int(cut_py[e, n].max() + blot_margin) + 1, H)
                x0 = max(int(cut_px[e, n].min() - blot_margin), 0)
                x1 = min(int(cut_px[e, n].max() + blot_margin) + 1, W)
                need[y0:y1, x0:x1] = True
        assert need.any() and not need.all()
        s_g = gather_rows(s_sp, H)
        w_g = gather_rows(w_sp, H)
        np.testing.assert_allclose(s_g[need], s_ref[need],
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(w_g[need], w_ref[need],
                                   atol=1e-5, rtol=1e-4)

    def test_2d_mesh_psums_frames(self):
        mesh2 = make_mesh2d(2, 4)
        data, wht, px, py, cut_px, cut_py = _scene(E=3)  # pads to 4
        E, H, W = data.shape
        _, (idx_b, valid_b) = _live_sets(mesh2, (H, W), px, py,
                                         cut_px, cut_py)
        bd, bw_, bx, by = _compact_blocks_bands(
            jnp.asarray(data), jnp.asarray(wht), jnp.asarray(px),
            jnp.asarray(py), jnp.asarray(idx_b), jnp.asarray(valid_b))
        s2, w2 = drizzle_deposit_sparse_spatial(
            mesh2, bd, bw_, bx, by, (H, W))
        mesh1 = make_mesh(4, axis_name="rows")
        _, (idx_1, valid_1) = _live_sets(mesh1, (H, W), px, py,
                                         cut_px, cut_py)
        b1 = _compact_blocks_bands(
            jnp.asarray(data), jnp.asarray(wht), jnp.asarray(px),
            jnp.asarray(py), jnp.asarray(idx_1), jnp.asarray(valid_1))
        s1, w1 = drizzle_deposit_sparse_spatial(
            mesh1, *b1, (H, W))
        np.testing.assert_allclose(gather_rows(s2, H),
                                   gather_rows(s1, H),
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(gather_rows(w2, H),
                                   gather_rows(w1, H),
                                   atol=1e-5, rtol=1e-4)

    def test_band_count_mismatch_raises(self, mesh):
        data = jnp.zeros((4, 2, 64, 8))  # 4 bands on an 8-band mesh
        with pytest.raises(ValueError, match="band axis"):
            drizzle_deposit_sparse_spatial(
                mesh, data, data, data, data, (64, 64))


class TestSparseSpatialAlign:
    """End-to-end: align under a spatial mesh with sparse_deposit=True
    lands on the plain align's fixed point, with the band-compacted
    deposit genuinely engaged (``sparse_live_frac`` present — a tall
    scene with clustered stars, so the live set beats the 64-bucket)."""

    def _kw(self, iters=2):
        return dict(fitgeom="shift", max_iterations=iters, usfac=4,
                    fit_type="gaussian", cutout_shape=(16, 16),
                    min_sources=3)

    @staticmethod
    def _tall_scene():
        from subpixal_tpu.testing import simulate_stack

        # 1024x256 -> 64x2 = 128 deposit blocks; stars confined to the
        # top 300 rows so most bands' live sets are (near) empty
        return simulate_stack(n_exp=3, shape=(1024, 256), n_stars=6,
                              seed=7, star_box=(40, 216, 40, 300))

    def test_matches_plain_align(self, mesh):
        from subpixal_tpu.align import align_images
        from subpixal_tpu.resample import Drizzle

        exps, _ = self._tall_scene()
        ref = align_images(exposures=[e.copy() for e in exps],
                           **self._kw())
        d = Drizzle([e.copy() for e in exps], spatial_mesh=mesh)
        res = align_images(resample=d, sparse_deposit=True, **self._kw())
        assert res.setup_breakdown.get("sparse_live_frac", 1.0) <= 0.5
        np.testing.assert_allclose(np.asarray(res.shifts),
                                   np.asarray(ref.shifts), atol=2e-3)

    def test_2d_mesh_and_device_loop_compose(self):
        from subpixal_tpu.align import align_images
        from subpixal_tpu.resample import Drizzle

        mesh2 = make_mesh2d(2, 4)
        exps, _ = self._tall_scene()
        ref = align_images(exposures=[e.copy() for e in exps],
                           **self._kw())
        res = align_images(
            resample=Drizzle([e.copy() for e in exps],
                             spatial_mesh=mesh2),
            sparse_deposit=True, **self._kw())
        assert res.setup_breakdown.get("sparse_live_frac", 1.0) <= 0.5
        np.testing.assert_allclose(np.asarray(res.shifts),
                                   np.asarray(ref.shifts), atol=2e-3)
        dev = align_images(
            resample=Drizzle([e.copy() for e in exps],
                             spatial_mesh=mesh2),
            sparse_deposit=True, device_loop=True, **self._kw())
        np.testing.assert_allclose(np.asarray(dev.shifts),
                                   np.asarray(res.shifts), atol=2e-3)


def test_spatial_sparse_self_heal_recovers(mesh):
    """The live-set self-heal re-stages BAND-compacted deposit arrays
    under a spatial mesh (same recovery the replicated and ``mesh=``
    paths have): a frame planted 30 px off heals the band live sets and
    lands on the dense spatial answer instead of only warning."""
    from subpixal_tpu.catalogs import ImageSourceCatalog
    from subpixal_tpu.resample import Drizzle, Exposure

    import subpixal_tpu.align as A
    from test_sparse_deposit import _warning_scene

    def scene():
        # 256 rows (vs the mesh test's 512): the heal still fires and
        # the suite saves ~40 s of CPU shard_map compiles
        exps = _warning_scene(shape=(256, 1024), E=3, seed=21)
        e2 = exps[2]
        bad = e2.wcs.replace(crpix=e2.wcs.crpix + np.array([30.0, 0.0]))
        return exps[:2] + [Exposure(e2.data.copy(), bad, name=e2.name)]

    clean = Drizzle([scene()[0]])
    clean.execute()
    cat = ImageSourceCatalog(np.asarray(clean.output_sci))

    kw = dict(fitgeom="shift", max_iterations=8, usfac=2,
              fit_type="gaussian", cutout_shape=(96, 96), min_sources=3,
              combine_seg_mask=False, peak_search_box=None)
    res_sp = A.align_images(
        [cat], Drizzle(scene(), spatial_mesh=mesh),
        sparse_deposit=True, **kw)
    res_dense = A.align_images(
        [cat], Drizzle(scene(), spatial_mesh=mesh),
        sparse_deposit=False, **kw)
    assert res_sp.setup_breakdown.get("sparse_heals", 0) >= 1, \
        res_sp.setup_breakdown
    assert res_sp.converged and res_dense.converged
    np.testing.assert_allclose(np.asarray(res_sp.shifts),
                               np.asarray(res_dense.shifts), atol=5e-3)


def test_spatial_oversized_footprint_bucket(mesh):
    """Round 5 (VERDICT r4 task 4): the oversized-footprint bucket runs
    under ``spatial_mesh`` — a giant source is measured WHOLE in the
    big-shape bucket (no truncation record, no footprint warning) and
    the spatial fixed point matches the replicated one on the same
    scene."""
    import warnings

    from subpixal_tpu.align import align_images
    from subpixal_tpu.resample import Drizzle
    from subpixal_tpu.testing import simulate_stack

    def scene():
        exps, planted = simulate_stack(n_exp=2, shape=(256, 256),
                                       n_stars=12, seed=31)
        yy, xx = np.mgrid[0:256, 0:256].astype(np.float64)
        for exp in exps:
            exp.data = exp.data + (300.0 * np.exp(
                -((xx - 70.0) ** 2 + (yy - 180.0) ** 2)
                / (2 * 8.0 ** 2))).astype(np.float32)
        return exps, planted

    kw = dict(fitgeom="shift", max_iterations=6, eps_shift=0.004,
              usfac=4, fit_type="gaussian", min_sources=5,
              max_cut_size=32, use_weights=False)
    exps_r, _ = scene()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # footprint warn must NOT fire
        ref = align_images(resample=Drizzle(exps_r, pixfrac=1.0), **kw)
    assert ref.truncated_sources == []
    assert "big_bucket_stage" in ref.setup_breakdown

    exps_s, _ = scene()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = align_images(
            resample=Drizzle(exps_s, pixfrac=1.0, spatial_mesh=mesh),
            **kw)
    assert res.truncated_sources == []
    assert "big_bucket_stage" in res.setup_breakdown
    np.testing.assert_allclose(np.asarray(res.shifts),
                               np.asarray(ref.shifts), atol=2e-3)
