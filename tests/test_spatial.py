"""Spatially-sharded mosaic planes (parallel/spatial.py) on the 8-device
virtual CPU mesh.

The SURVEY §5 "very large mosaics" axis: drizzle deposits onto a
row-band-sharded output plane and blot gathers from one must match the
unsharded ops — the deposit exactly (band-disjoint scatter), the gather
to f32 reduction noise (per-band partials + psum), the B-spline
prefilter to its documented ``|z1|**halo`` truncation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from subpixal_tpu.ops.drizzle import drizzle_deposit, drizzle_combine
from subpixal_tpu.ops.interp import sample_image
from subpixal_tpu.parallel import (
    band_rows,
    drizzle_deposit_spatial,
    drizzle_deposit_stack_spatial,
    gather_rows,
    halo_exchange,
    make_mesh,
    make_mesh2d,
    sample_spatial,
    shard_rows,
)
from jax.sharding import PartitionSpec as P


import os

_MESH_N = int(os.environ.get("SUBPIXAL_TPU_TEST_MESH", "8"))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(_MESH_N, axis_name="rows")


def _pixmap(h, w, sx=1.03, sy=1.11, tx=1.7, ty=2.3):
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    return gx * sx + tx, gy * sy + ty


class TestShardRows:
    def test_round_trip_with_padding(self, mesh):
        plane = np.arange(100 * 16, dtype=np.float32).reshape(100, 16)
        sp = shard_rows(mesh, jnp.asarray(plane))
        assert sp.shape == (104, 16)  # padded to 8*13
        assert band_rows(mesh, 100) == 13
        np.testing.assert_array_equal(gather_rows(sp, 100), plane)
        # padded rows are zero
        assert float(np.abs(np.asarray(sp)[100:]).max()) == 0.0


class TestHaloExchange:
    @pytest.mark.parametrize("edge", ["mirror", "zero"])
    def test_neighbor_and_edge_rows(self, mesh, edge):
        Hl, W, halo = 8, 16, 3
        rows = np.arange(8 * Hl, dtype=np.float32)
        plane = np.broadcast_to(rows[:, None], (8 * Hl, W)).copy()
        sp = jax.device_put(
            jnp.asarray(plane),
            jax.sharding.NamedSharding(mesh, P("rows", None)))
        out = jax.jit(jax.shard_map(
            lambda b: halo_exchange(b, halo, "rows", edge=edge),
            mesh=mesh, in_specs=P("rows", None),
            out_specs=P("rows", None)))(sp)
        out = np.asarray(out).reshape(8, Hl + 2 * halo, W)
        for d in range(8):
            core = rows[d * Hl:(d + 1) * Hl]
            np.testing.assert_array_equal(out[d, halo:halo + Hl, 0], core)
            if d > 0:  # top halo = previous band's last rows
                np.testing.assert_array_equal(
                    out[d, :halo, 0], rows[d * Hl - halo:d * Hl])
            else:
                want = (rows[1:halo + 1][::-1] if edge == "mirror"
                        else np.zeros(halo))
                np.testing.assert_array_equal(out[0, :halo, 0], want)
            if d < 7:  # bottom halo = next band's first rows
                np.testing.assert_array_equal(
                    out[d, halo + Hl:, 0],
                    rows[(d + 1) * Hl:(d + 1) * Hl + halo])
            else:
                want = (rows[-2:-halo - 2:-1] if edge == "mirror"
                        else np.zeros(halo))
                np.testing.assert_array_equal(out[7, halo + Hl:, 0], want)

    def test_halo_bounds_checked(self, mesh):
        sp = shard_rows(mesh, jnp.zeros((64, 16)))
        with pytest.raises(ValueError, match="halo"):
            jax.shard_map(
                lambda b: halo_exchange(b, 9, "rows", edge="zero"),
                mesh=mesh, in_specs=P("rows", None),
                out_specs=P("rows", None))(sp)


class TestDepositSpatial:
    @pytest.mark.parametrize(
        "kernel", ["square", "turbo", "point", "gaussian", "lanczos3",
                   "tophat"])
    def test_matches_unsharded(self, mesh, kernel):
        rng = np.random.default_rng(3)
        H, W = 100, 64  # not divisible by 8: padding + logical-edge path
        img = rng.random((80, 60)).astype(np.float32)
        wht = rng.random((80, 60)).astype(np.float32)
        gx, gy = _pixmap(80, 60)
        s_ref, w_ref = drizzle_deposit(img, wht, gx, gy, (H, W),
                                       kernel=kernel, pixfrac=0.8)
        s_sh, w_sh = drizzle_deposit_spatial(mesh, img, wht, gx, gy,
                                             (H, W), kernel=kernel,
                                             pixfrac=0.8)
        # square/turbo overlap areas see the band-frame y-shift in f32
        # (yo - row0 before the +/-half window), worth ~4e-6 abs
        np.testing.assert_allclose(gather_rows(s_sh, H),
                                   np.asarray(s_ref), atol=1e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(gather_rows(w_sh, H),
                                   np.asarray(w_ref), atol=1e-5,
                                   rtol=1e-4)

    def test_multi_frame_combine_stays_sharded(self, mesh):
        """Accumulate several frames into the sharded accumulators and
        combine — the full mosaic never exists on one device."""
        rng = np.random.default_rng(4)
        H, W = 96, 48
        sci = wht = None
        planes = []
        for k in range(3):
            img = rng.random((64, 40)).astype(np.float32)
            gx, gy = _pixmap(64, 40, tx=2.0 + 3 * k, ty=1.0 + 5 * k)
            planes.append((img, gx, gy))
            s, w = drizzle_deposit_spatial(mesh, img, None, gx, gy,
                                           (H, W))
            sci = s if sci is None else sci + s
            wht = w if wht is None else wht + w
        # elementwise combine under jit preserves the row sharding
        # (jit normalizes away the trailing None of the spec)
        out = jax.jit(drizzle_combine)(sci, wht)
        assert out.sharding.spec in (P("rows"), P("rows", None))
        # oracle: unsharded accumulation
        s_ref = np.zeros((H, W), np.float32)
        w_ref = np.zeros((H, W), np.float32)
        for img, gx, gy in planes:
            s, w = drizzle_deposit(img, None, gx, gy, (H, W))
            s_ref += np.asarray(s)
            w_ref += np.asarray(w)
        ref = np.where(w_ref > 0, s_ref / np.maximum(w_ref, 1e-30), 0.0)
        np.testing.assert_allclose(gather_rows(out, H), ref, atol=2e-5)


class TestSampleSpatial:
    @pytest.mark.parametrize(
        "interp", ["nearest", "linear", "poly3", "poly5", "sinc"])
    def test_matches_unsharded(self, mesh, interp):
        rng = np.random.default_rng(5)
        H, W = 100, 64
        plane = rng.random((H, W)).astype(np.float32)
        xs = rng.uniform(-3, W + 2, (300,)).astype(np.float32)
        ys = rng.uniform(-3, H + 2, (300,)).astype(np.float32)
        v_ref, ok_ref = sample_image(jnp.asarray(plane), xs, ys,
                                     interp=interp, fill=-7.0)
        sp = shard_rows(mesh, jnp.asarray(plane))
        v_sh, ok_sh = sample_spatial(mesh, sp, xs, ys, interp=interp,
                                     fill=-7.0, logical_rows=H)
        np.testing.assert_array_equal(np.asarray(ok_sh),
                                      np.asarray(ok_ref))
        np.testing.assert_allclose(np.asarray(v_sh), np.asarray(v_ref),
                                   atol=5e-6)

    def test_spline3_prefilter_truncation(self, mesh):
        """Mirror-remapped per-band prefilter ≈ global prefilter: the
        documented |z1|**halo truncation, incl. at the logical bottom
        edge where the row padding lives."""
        rng = np.random.default_rng(6)
        H, W = 100, 64  # pad=4 on 8 devices
        plane = rng.random((H, W)).astype(np.float32)
        xs = rng.uniform(0, W - 1, (400,)).astype(np.float32)
        ys = np.concatenate([
            rng.uniform(0, H - 1, (360,)),
            rng.uniform(H - 4, H - 1, (40,)),  # bottom edge stress
        ]).astype(np.float32)
        v_ref, _ = sample_image(jnp.asarray(plane), xs, ys,
                                interp="spline3")
        sp = shard_rows(mesh, jnp.asarray(plane))
        v_sh, _ = sample_spatial(mesh, sp, xs, ys, interp="spline3",
                                 logical_rows=H, spline_halo=9)
        np.testing.assert_allclose(np.asarray(v_sh), np.asarray(v_ref),
                                   atol=2e-5)

    def test_spline3_guard(self, mesh):
        sp = shard_rows(mesh, jnp.zeros((100, 16)))  # band 13, pad 4
        with pytest.raises(ValueError, match="spline3 needs"):
            sample_spatial(mesh, sp, jnp.zeros(4), jnp.zeros(4),
                           interp="spline3", logical_rows=100,
                           spline_halo=10)  # > band_rows - pad

    def test_unknown_interp(self, mesh):
        sp = shard_rows(mesh, jnp.zeros((64, 16)))
        with pytest.raises(ValueError, match="unknown interp"):
            sample_spatial(mesh, sp, jnp.zeros(4), jnp.zeros(4),
                           interp="nope")


class TestMesh2D:
    """(frames, rows) 2-D mesh: frames shard for throughput, output
    rows for memory; psum over frames only."""

    @pytest.fixture(scope="class")
    def mesh2(self):
        return make_mesh2d(2, 4)

    def test_stack_deposit_matches_unsharded(self, mesh2):
        rng = np.random.default_rng(9)
        H, W = 100, 48        # rows pad (4 bands of 25)
        E = 3                 # frames pad (2-frame axis)
        data = rng.random((E, 40, 36)).astype(np.float32)
        wht = rng.random((E, 40, 36)).astype(np.float32)
        gx = np.stack([_pixmap(40, 36, tx=1.0 + 2 * k)[0]
                       for k in range(E)])
        gy = np.stack([_pixmap(40, 36, ty=2.0 - k)[1] for k in range(E)])
        s_sh, w_sh = drizzle_deposit_stack_spatial(
            mesh2, data, wht, gx, gy, (H, W), pixfrac=0.9)
        s_ref = np.zeros((H, W), np.float32)
        w_ref = np.zeros((H, W), np.float32)
        for k in range(E):
            s, w = drizzle_deposit(data[k], wht[k], gx[k], gy[k], (H, W),
                                   pixfrac=0.9)
            s_ref += np.asarray(s)
            w_ref += np.asarray(w)
        np.testing.assert_allclose(gather_rows(s_sh, H), s_ref,
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(gather_rows(w_sh, H), w_ref,
                                   atol=1e-5, rtol=1e-4)

    def test_stack_deposit_mixed_pscale_ratios(self, mesh2):
        """VERDICT r3 task 6: a two-pscale stack (two-camera mosaic)
        on the 2-D (frames, rows) mesh matches the per-frame deposits
        with each frame's own ratio."""
        rng = np.random.default_rng(12)
        H, W = 96, 48
        E = 3
        ratios = (1.0, 0.7, 0.7)
        data = rng.random((E, 40, 36)).astype(np.float32)
        wht = rng.random((E, 40, 36)).astype(np.float32)
        gx = np.stack([_pixmap(40, 36, tx=1.0 + 2 * k)[0]
                       for k in range(E)])
        gy = np.stack([_pixmap(40, 36, ty=2.0 - k)[1] for k in range(E)])
        s_sh, w_sh = drizzle_deposit_stack_spatial(
            mesh2, data, wht, gx, gy, (H, W), pixfrac=0.9,
            pscale_ratio=ratios)
        s_ref = np.zeros((H, W), np.float32)
        w_ref = np.zeros((H, W), np.float32)
        for k in range(E):
            s, w = drizzle_deposit(data[k], wht[k], gx[k], gy[k],
                                   (H, W), pixfrac=0.9,
                                   pscale_ratio=ratios[k])
            s_ref += np.asarray(s)
            w_ref += np.asarray(w)
        np.testing.assert_allclose(gather_rows(s_sh, H), s_ref,
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(gather_rows(w_sh, H), w_ref,
                                   atol=1e-5, rtol=1e-4)

    def test_shared_pixmap_broadcast(self, mesh2):
        """A single (H, W) pixmap is broadcast over the stack."""
        rng = np.random.default_rng(10)
        data = rng.random((2, 32, 32)).astype(np.float32)
        gx, gy = _pixmap(32, 32)
        s_sh, _ = drizzle_deposit_stack_spatial(
            mesh2, data, None, gx, gy, (64, 48))
        s_ref = np.zeros((64, 48), np.float32)
        for k in range(2):
            s, _ = drizzle_deposit(data[k], None, gx, gy, (64, 48))
            s_ref += np.asarray(s)
        np.testing.assert_allclose(gather_rows(s_sh, 64), s_ref,
                                   atol=1e-5, rtol=1e-4)

    def test_gather_from_2d_sharded_product(self, mesh2):
        """sample_spatial reads the rows axis of the 2-D mesh."""
        rng = np.random.default_rng(11)
        H, W = 96, 40
        plane = rng.random((H, W)).astype(np.float32)
        xs = rng.uniform(0, W - 1, (200,)).astype(np.float32)
        ys = rng.uniform(0, H - 1, (200,)).astype(np.float32)
        sp = shard_rows(mesh2, jnp.asarray(plane))
        v_sh, _ = sample_spatial(mesh2, sp, xs, ys, interp="poly5",
                                 logical_rows=H)
        v_ref, _ = sample_image(jnp.asarray(plane), xs, ys,
                                interp="poly5")
        np.testing.assert_allclose(np.asarray(v_sh), np.asarray(v_ref),
                                   atol=5e-6)

    def test_drizzle_api_accepts_2d_mesh(self, mesh2):
        """Drizzle(spatial_mesh=<2-D mesh>): per-exposure deposits key
        off the rows axis; product matches the unsharded build."""
        from subpixal_tpu.resample import Drizzle

        exps = TestSpatialDrizzle._scene()
        ref = Drizzle([e.copy() for e in exps])
        ref.execute()
        d = Drizzle(exps, spatial_mesh=mesh2)
        d.execute()
        assert d._sci_acc.sharding.spec == P("rows", None)
        np.testing.assert_allclose(d.output_sci, ref.output_sci,
                                   atol=1e-5, rtol=1e-4)

    def test_requires_2d_mesh(self, mesh):
        with pytest.raises(ValueError, match="2-D"):
            drizzle_deposit_stack_spatial(
                mesh, jnp.zeros((2, 8, 8)), None, jnp.zeros((2, 8, 8)),
                jnp.zeros((2, 8, 8)), (16, 16))


class TestSpatialDrizzle:
    """Drizzle(spatial_mesh=...): the user-facing resample API with
    row-band-sharded accumulators."""

    @staticmethod
    def _scene(n=3, shape=(40, 36), seed=11):
        from subpixal_tpu.resample import Exposure
        from subpixal_tpu.wcs.wcs import TanWCS

        rng = np.random.default_rng(seed)
        s = 0.05 / 3600.0
        exps = []
        for k in range(n):
            wcs = TanWCS(
                crpix=np.array([shape[1] / 2 + 0.3 * k,
                                shape[0] / 2 - 0.2 * k]),
                crval=np.array([150.0, 2.0]),
                cd=s * np.array([[-1.0, 0.0], [0.0, 1.0]]))
            exps.append(Exposure(
                rng.random(shape).astype(np.float32), wcs,
                exptime=1.0 + k, name=f"s{k}"))
        return exps

    def test_execute_matches_unsharded(self, mesh):
        from subpixal_tpu.resample import Drizzle

        exps = self._scene()
        ref = Drizzle([e.copy() for e in exps])
        ref.execute()
        d = Drizzle(exps, spatial_mesh=mesh)
        d.execute()
        assert d._sci_acc.sharding.spec == P("rows", None)
        np.testing.assert_allclose(d.output_sci, ref.output_sci,
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(d.output_wht, ref.output_wht,
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_array_equal(d.output_ctx, ref.output_ctx)

    def test_fast_replace_matches_execute(self, mesh):
        from subpixal_tpu.resample import Drizzle

        exps = self._scene()
        d = Drizzle(exps, spatial_mesh=mesh)
        d.execute()
        moved = exps[1].copy()
        moved.wcs = moved.wcs.replace(
            crpix=moved.wcs.crpix + np.array([0.4, -0.3]))
        d.fast_replace_image(moved)
        ref = Drizzle([exps[0].copy(), moved.copy(), exps[2].copy()],
                      spatial_mesh=mesh)
        ref.execute()
        np.testing.assert_allclose(d.output_sci, ref.output_sci,
                                   atol=1e-5, rtol=1e-4)

    def test_reject_cr_matches_unsharded(self, mesh):
        """CR rejection with sharded deposits: the sharded median +
        sample_spatial blot-back flags the same pixels as the plain
        device path and the re-drizzled product agrees."""
        from subpixal_tpu.resample import Drizzle

        exps = self._scene(n=4, seed=31)
        # plant a cosmic ray in one exposure
        exps[1].data[20, 18] += 50.0
        ref = Drizzle([e.copy() for e in exps])
        ref.execute()
        masks_ref = ref.reject_cr()
        d = Drizzle([e.copy() for e in exps], spatial_mesh=mesh)
        d.execute()
        masks_sp = d.reject_cr()
        assert masks_sp[1][20, 18], "planted CR not flagged"
        for a, b in zip(masks_sp, masks_ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_allclose(d.output_sci, ref.output_sci,
                                   atol=2e-5, rtol=1e-4)

    # (align_images now DRIVES a spatial Drizzle — see TestSpatialAlign;
    # the mesh=/spatial_mesh exclusivity guard is tested there)

    def test_match_sky_and_static_mask(self, mesh):
        """The pre-combine stages operate on exposures and re-execute;
        they compose with sharded accumulators unchanged."""
        from subpixal_tpu.resample import Drizzle

        exps = self._scene(seed=41)
        for e in exps:
            e.data = e.data + 0.25  # uniform sky pedestal
        ref = Drizzle([e.copy() for e in exps])
        ref.execute()
        ref.match_sky()
        d = Drizzle([e.copy() for e in exps], spatial_mesh=mesh)
        d.execute()
        d.match_sky()
        np.testing.assert_allclose(d.output_sci, ref.output_sci,
                                   atol=2e-5, rtol=1e-4)
        m_sp = d.apply_static_mask()
        m_ref = ref.apply_static_mask()
        np.testing.assert_array_equal(np.asarray(m_sp),
                                      np.asarray(m_ref))


class TestSpatialAlign:
    """align_images driving a spatial_mesh Drizzle: the full iterative
    alignment with the reference plane row-band-sharded."""

    def test_matches_plain_align(self, mesh):
        from subpixal_tpu.align import align_images
        from subpixal_tpu.resample import Drizzle
        from subpixal_tpu.testing import (pairwise_shift_errors,
                                          simulate_stack)

        exps, planted = simulate_stack(n_exp=3, shape=(96, 96),
                                       n_stars=6, seed=21)
        kw = dict(fitgeom="shift", max_iterations=3, usfac=4,
                  fit_type="gaussian", cutout_shape=(16, 16),
                  min_sources=3)
        ref = align_images(exposures=[e.copy() for e in exps], **kw)
        d = Drizzle([e.copy() for e in exps], spatial_mesh=mesh)
        res = align_images(resample=d, **kw)
        # same fixed point as the replicated-plane loop (measured
        # bit-identical on the virtual mesh — the band deposit and the
        # psum'd gather are exact reformulations)
        np.testing.assert_allclose(np.asarray(res.shifts),
                                   np.asarray(ref.shifts), atol=2e-3)
        err_sp = pairwise_shift_errors(res.shifts, planted)
        # absolute quality == the plain path's on this small 6-star
        # scene (~0.07 px, one truncated footprint); just bound it
        assert err_sp < max(
            0.1, 1.5 * pairwise_shift_errors(ref.shifts, planted))

    def test_2d_mesh_stack_deposit_matches_plain(self):
        """The align step's 2-D (frames, rows) fast path — ONE stack
        deposit, psum over frames — lands on the plain fixed point."""
        from subpixal_tpu.align import align_images
        from subpixal_tpu.resample import Drizzle
        from subpixal_tpu.testing import simulate_stack

        mesh2 = make_mesh2d(2, 4)
        exps, planted = simulate_stack(n_exp=3, shape=(96, 96),
                                       n_stars=6, seed=21)
        kw = dict(fitgeom="shift", max_iterations=2, usfac=4,
                  fit_type="gaussian", cutout_shape=(16, 16),
                  min_sources=3)
        ref = align_images(exposures=[e.copy() for e in exps], **kw)
        d = Drizzle([e.copy() for e in exps], spatial_mesh=mesh2)
        res = align_images(resample=d, **kw)
        np.testing.assert_allclose(np.asarray(res.shifts),
                                   np.asarray(ref.shifts), atol=2e-3)

    def test_otf_wcsupdate_matches_plain(self, mesh):
        """The update-as-you-go branch (reference non-'batch' mode)
        composes with the sharded reference plane."""
        from subpixal_tpu.align import align_images
        from subpixal_tpu.resample import Drizzle
        from subpixal_tpu.testing import simulate_stack

        exps, planted = simulate_stack(n_exp=3, shape=(96, 96),
                                       n_stars=6, seed=21)
        kw = dict(fitgeom="shift", max_iterations=2, usfac=4,
                  fit_type="gaussian", cutout_shape=(16, 16),
                  min_sources=3, wcsupdate="otf")
        ref = align_images(exposures=[e.copy() for e in exps], **kw)
        d = Drizzle([e.copy() for e in exps], spatial_mesh=mesh)
        res = align_images(resample=d, **kw)
        np.testing.assert_allclose(np.asarray(res.shifts),
                                   np.asarray(ref.shifts), atol=2e-3)

    def test_forces_incompatible_knobs_off(self, mesh):
        """Spatial align has no kernel knob left to force off: the
        retired ``use_pallas`` option is rejected outright, and the
        default configuration runs without a warning."""
        import warnings

        from subpixal_tpu.align import align_images
        from subpixal_tpu.resample import Drizzle
        from subpixal_tpu.testing import simulate_stack

        exps, _ = simulate_stack(n_exp=3, shape=(96, 96), n_stars=6,
                                 seed=21)
        kw = dict(fitgeom="shift", max_iterations=1, usfac=4,
                  cutout_shape=(16, 16), min_sources=3)
        with pytest.raises(TypeError, match="use_pallas"):
            align_images(resample=Drizzle(exps, spatial_mesh=mesh),
                         use_pallas=True, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            res = align_images(resample=Drizzle(exps, spatial_mesh=mesh),
                               **kw)
        assert res.n_iterations == 1

    def test_device_loop_matches_host_loop(self, mesh):
        """The on-device while_loop fixed point (one host sync) works
        under a spatial mesh — shard_map composes inside lax.while_loop
        — and lands on the host loop's shifts."""
        from subpixal_tpu.align import align_images
        from subpixal_tpu.resample import Drizzle
        from subpixal_tpu.testing import simulate_stack

        exps, _ = simulate_stack(n_exp=3, shape=(96, 96), n_stars=6,
                                 seed=21)
        kw = dict(fitgeom="shift", max_iterations=2, usfac=4,
                  fit_type="gaussian", cutout_shape=(16, 16),
                  min_sources=3)
        host = align_images(
            resample=Drizzle([e.copy() for e in exps],
                             spatial_mesh=mesh),
            device_loop=False, **kw)
        dev = align_images(
            resample=Drizzle([e.copy() for e in exps],
                             spatial_mesh=mesh),
            device_loop=True, **kw)
        np.testing.assert_allclose(np.asarray(dev.shifts),
                                   np.asarray(host.shifts), atol=2e-3)

    def test_mesh_and_spatial_exclusive(self, mesh):
        from subpixal_tpu.align import align_images
        from subpixal_tpu.resample import Drizzle
        from subpixal_tpu.testing import simulate_stack

        exps, _ = simulate_stack(n_exp=3, shape=(96, 96), n_stars=6,
                                 seed=21)
        d = Drizzle(exps, spatial_mesh=mesh)
        with pytest.raises(ValueError, match="mutually exclusive"):
            align_images(resample=d, mesh=mesh, cutout_shape=(16, 16))


class TestEndToEnd:
    def test_deposit_then_blot_round_trip(self, mesh):
        """Mosaic life-cycle entirely sharded: deposit 2 frames, combine,
        blot a cutout grid back — matches the unsharded pipeline."""
        rng = np.random.default_rng(7)
        H, W = 104, 56
        frames = []
        for k in range(2):
            img = rng.random((72, 48)).astype(np.float32)
            gx, gy = _pixmap(72, 48, tx=1.0 + 2 * k, ty=3.0 - k)
            frames.append((img, gx, gy))
        sci = wht = None
        for img, gx, gy in frames:
            s, w = drizzle_deposit_spatial(mesh, img, None, gx, gy,
                                           (H, W))
            sci = s if sci is None else sci + s
            wht = w if wht is None else wht + w
        mosaic_sh = jax.jit(drizzle_combine)(sci, wht)
        # blot window back onto frame 0's grid
        bx, by = _pixmap(24, 24, sx=0.97, sy=1.02, tx=8.0, ty=9.0)
        v_sh, ok_sh = sample_spatial(mesh, mosaic_sh, bx, by,
                                     interp="poly5", logical_rows=H)
        # unsharded oracle
        s_ref = np.zeros((H, W), np.float32)
        w_ref = np.zeros((H, W), np.float32)
        for img, gx, gy in frames:
            s, w = drizzle_deposit(img, None, gx, gy, (H, W))
            s_ref += np.asarray(s)
            w_ref += np.asarray(w)
        mosaic = np.where(w_ref > 0, s_ref / np.maximum(w_ref, 1e-30),
                          0.0)
        v_ref, ok_ref = sample_image(jnp.asarray(mosaic), bx, by,
                                     interp="poly5")
        np.testing.assert_array_equal(np.asarray(ok_sh),
                                      np.asarray(ok_ref))
        np.testing.assert_allclose(np.asarray(v_sh), np.asarray(v_ref),
                                   atol=5e-5)
