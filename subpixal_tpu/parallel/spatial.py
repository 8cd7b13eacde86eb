"""Spatially-sharded mosaic planes: row bands over a device mesh.

The frame/cutout axes (``parallel.sharding``) scale THROUGHPUT; this
module scales MOSAIC SIZE — the SURVEY §5 "long-context" axis ("for very
large mosaics, shard full image planes spatially with halo exchange").
A 64k×64k float32 drizzle product (sci + wht accumulators = 32 GB)
plus its working set crowds one 80 GB card; its row bands across 4
cards (8 GB each) fit with room to spare.

Design — exactness over cleverness:

- Both hot plane ops are LINEAR in the plane. Drizzle deposit restricted
  to a row band is just the same deposit with shifted ``y`` and a
  shorter output (out-of-band cells drop in the kernel's own validity
  mask), so each device deposits its band and nothing is ever summed
  across devices. Blot/gather is a weighted sum of taps, each tap owned
  by exactly ONE band, so per-band partial sums ``lax.psum`` to the
  bit-identical unsharded answer (no halo needed for exactness).
- Halo exchange (``halo_exchange``) is still provided — the cubic
  B-spline prefilter is a y-axis IIR whose band-local evaluation needs
  neighbor rows; with ``halo`` rows the core coefficients match the
  global prefilter to ``|z1|**halo`` (pole z1 = √3−2 ≈ −0.268: 1e-18 at
  halo=32). At the global top/bottom the halo is filled by local mirror
  reflection, which IS the global mirror boundary condition when
  ``halo < band_rows``.

Reference mapping: the reference (serial numpy, `subpixal/blot.py` /
`drizzlepac.cdriz`) has no concept of plane sharding; these are
capability extensions with no reference counterpart (SURVEY §2b).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.drizzle import drizzle_deposit
from ..ops.interp import (
    INTERP_OFFSETS,
    _axis_weights,
    _bspline3_prefilter_axis,
)

__all__ = [
    "band_rows",
    "shard_rows",
    "gather_rows",
    "halo_exchange",
    "make_mesh2d",
    "drizzle_deposit_spatial",
    "drizzle_deposit_sparse_spatial",
    "drizzle_deposit_stack_spatial",
    "sample_spatial",
]


def _rows_axis(mesh: Mesh) -> str:
    """The plane-rows mesh axis: the only axis of a 1-D mesh, the LAST
    axis of a 2-D ``(frames, rows)`` mesh (``make_mesh2d``)."""
    if len(mesh.axis_names) not in (1, 2):
        raise ValueError(
            f"spatial sharding wants a 1-D (rows) or 2-D (frames, rows) "
            f"mesh, got axes {mesh.axis_names}")
    return mesh.axis_names[-1]


def _n_bands(mesh: Mesh) -> int:
    return int(mesh.shape[_rows_axis(mesh)])


def band_rows(mesh: Mesh, n_rows: int) -> int:
    """Rows per band: ``n_rows`` split over the rows axis, rounded up."""
    return -(-int(n_rows) // _n_bands(mesh))


def shard_rows(mesh: Mesh, plane: jax.Array) -> jax.Array:
    """Place an ``(H, W)`` plane row-band-sharded over the mesh
    (replicated over the frames axis of a 2-D mesh).

    Rows are zero-padded up to a multiple of the rows-axis size; pass
    the LOGICAL row count to the consumers (``sample_spatial(...,
    logical_rows=H)``) — padded rows are never owned by any sample tap.
    """
    H, W = plane.shape
    Hl = band_rows(mesh, H)
    pad = Hl * _n_bands(mesh) - H
    if pad:
        plane = jnp.pad(plane, ((0, pad), (0, 0)))
    return jax.device_put(
        plane, NamedSharding(mesh, P(_rows_axis(mesh), None)))


def gather_rows(plane: jax.Array, logical_rows: int | None = None):
    """Fetch a row-sharded plane to host, cropping the row padding.

    Multi-process global planes (bands on other hosts) all-gather via
    :func:`subpixal_tpu.utils.fetch_to_host`'s collective path — call
    from EVERY process.
    """
    from ..utils import fetch_to_host

    out = fetch_to_host(plane)
    return out if logical_rows is None else out[:logical_rows]


def _mirror_halos(band: jax.Array, halo: int):
    """(top, bottom) local mirror reflections of a band's edges.

    Mirror convention of the B-spline prefilter (``x[-n] = x[n]``,
    ``x[N-1+n] = x[N-1-n]`` — Unser mirror, no edge duplication).
    """
    top = band[1:halo + 1][::-1]
    bot = band[-2:-halo - 2:-1]
    return top, bot


def halo_exchange(band: jax.Array, halo: int, axis_name: str,
                  edge: str = "mirror") -> jax.Array:
    """Extend a ``(Hl, W)`` band with ``halo`` rows from each neighbor.

    Runs INSIDE ``shard_map`` over a 1-D mesh. Returns
    ``(Hl + 2*halo, W)``; rows ``[halo:halo+Hl]`` are the original band.
    At the global top/bottom the missing neighbor is replaced by
    ``edge=``'mirror' (local mirror reflection — the B-spline boundary
    condition) or 'zero'.
    """
    max_halo = band.shape[0] - (1 if edge == "mirror" else 0)
    if not 0 < halo <= max_halo:
        raise ValueError(
            f"halo must be in (0, {max_halo}] for edge={edge!r}; got "
            f"{halo} for band {band.shape}")
    n = jax.lax.axis_size(axis_name)
    i = jax.lax.axis_index(axis_name)
    # ppermute zero-fills targets nobody sends to (the global edges)
    top = jax.lax.ppermute(band[-halo:], axis_name,
                           [(k, k + 1) for k in range(n - 1)])
    bot = jax.lax.ppermute(band[:halo], axis_name,
                           [(k, k - 1) for k in range(1, n)])
    if edge == "mirror":
        mtop, mbot = _mirror_halos(band, halo)
        top = jnp.where(i == 0, mtop, top)
        bot = jnp.where(i == n - 1, mbot, bot)
    elif edge != "zero":
        raise ValueError(f"edge must be 'mirror' or 'zero', got {edge!r}")
    return jnp.concatenate([top, band, bot], axis=0)


# --------------------------------------------------------------------- #
# drizzle deposit onto a row-sharded output plane
# --------------------------------------------------------------------- #

def drizzle_deposit_spatial(
    mesh: Mesh,
    in_data: jax.Array,
    in_wht: jax.Array | None,
    x_out: jax.Array,
    y_out: jax.Array,
    out_shape: tuple[int, int],
    pixfrac: float = 1.0,
    pscale_ratio: float = 1.0,
    kernel: str = "square",
) -> tuple[jax.Array, jax.Array]:
    """:func:`subpixal_tpu.ops.drizzle.drizzle_deposit` with the OUTPUT
    accumulators row-band-sharded over ``mesh``.

    Each device runs the deposit with ``y`` shifted into its band frame
    and a band-sized output — global cells outside the band fail the
    kernel's own bounds check, so the band union is exactly the
    unsharded deposit and nothing is summed across devices. Inputs are
    replicated (detector frames are small next to the mosaic). Returned
    ``(sci, wht)`` are sharded ``(ceil(Ho/N)*N, Wo)`` arrays; combine
    elementwise (``drizzle_combine`` under jit keeps the sharding) and
    crop with :func:`gather_rows`.
    """
    fn = _deposit_spatial_jit(mesh, (int(out_shape[0]), int(out_shape[1])),
                              float(pixfrac), float(pscale_ratio), kernel,
                              in_wht is None)
    return fn(jnp.asarray(in_data, jnp.float32),
              None if in_wht is None else jnp.asarray(in_wht, jnp.float32),
              jnp.asarray(x_out, jnp.float32),
              jnp.asarray(y_out, jnp.float32))


@functools.lru_cache(maxsize=64)
def _deposit_spatial_jit(mesh, out_shape, pixfrac, pscale_ratio, kernel,
                         no_wht):
    """Jitted sharded deposit for one static config.

    The shard_map MUST run under jit: an eager shard_map dispatches
    every primitive of the deposit graph as its own one-op sharded
    program (~3,800 dispatches per call). The cache keys the jitted
    callable on the static config so repeat calls (the align loop,
    parity tests) reuse one executable.
    """
    Ho, Wo = out_shape
    ax = _rows_axis(mesh)
    Hl = band_rows(mesh, Ho)

    def shard_fn(data, wht, xo, yo):
        row0 = (jax.lax.axis_index(ax) * Hl).astype(jnp.float32)
        sci, wht_acc = drizzle_deposit(
            data, wht, xo, yo - row0, (Hl, Wo),
            pixfrac=pixfrac, pscale_ratio=pscale_ratio, kernel=kernel)
        # rows past the logical Ho live only in the LAST band's padding;
        # the unsharded deposit drops them, so must we
        keep = (row0 + jax.lax.iota(jnp.float32, Hl) < Ho)[:, None]
        return sci * keep, wht_acc * keep

    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(ax, None), P(ax, None)),
    )

    @jax.jit
    def run(data, wht, xo, yo):
        w = jnp.ones_like(data) if no_wht else wht
        return sharded(data, w, xo, yo)

    return run


def make_mesh2d(n_frames: int, n_rows: int,
                axis_names: tuple[str, str] = ("frames", "rows")) -> Mesh:
    """A 2-D ``(frames, rows)`` device mesh: exposures shard over the
    first axis (throughput), mosaic rows over the second (memory)."""
    devs = jax.devices()
    need = n_frames * n_rows
    if len(devs) < need:
        raise ValueError(
            f"mesh2d wants {n_frames}x{n_rows}={need} devices, have "
            f"{len(devs)}")
    return Mesh(np.asarray(devs[:need]).reshape(n_frames, n_rows),
                axis_names)


def drizzle_deposit_stack_spatial(
    mesh: Mesh,
    data: jax.Array,
    wht: jax.Array | None,
    x_out: jax.Array,
    y_out: jax.Array,
    out_shape: tuple[int, int],
    pixfrac: float = 1.0,
    pscale_ratio=1.0,
    kernel: str = "square",
) -> tuple[jax.Array, jax.Array]:
    """Deposit an ``(E, H, W)`` exposure stack over a 2-D ``(frames,
    rows)`` mesh: frames shard for THROUGHPUT, output rows shard for
    MEMORY — the scaling-book composition of the two axes.

    Each device deposits its local frames into its local row band
    (band-exact, as :func:`drizzle_deposit_spatial`), then the
    accumulators ``psum`` over the frames axis only — the collective
    moves band-sized tiles (``HW/N_rows``), never the full mosaic.
    Per-device compute is ``E/N_frames`` deposits; per-device memory is
    ``HW/N_rows`` accumulator rows.

    ``E`` is zero-padded to a multiple of the frames axis (zero-weight
    frames deposit nothing). ``pscale_ratio`` may be a scalar or a
    per-frame sequence (two-camera mosaics): the kernel's candidate
    window is shaped statically by the ratio, so distinct ratios become
    ``lax.switch`` branches selected by each device's LOCAL frame ids —
    the same trick the 1-D frame mesh uses (align.py · deposit_local).
    Returns row-sharded ``(ceil(Ho/Nr)*Nr, Wo)`` accumulators
    (replicated over the frames axis).
    """
    if len(mesh.axis_names) != 2:
        raise ValueError(
            f"drizzle_deposit_stack_spatial wants a 2-D (frames, rows) "
            f"mesh, got axes {mesh.axis_names}")
    E = int(jnp.shape(data)[0])
    ratios = (tuple(float(r) for r in pscale_ratio)
              if hasattr(pscale_ratio, "__len__")
              else (float(pscale_ratio),) * E)
    if len(ratios) != E:
        raise ValueError(
            f"pscale_ratio: expected {E} per-frame values, got "
            f"{len(ratios)}")
    fn = _deposit_stack_spatial_jit(
        mesh, (int(out_shape[0]), int(out_shape[1])), float(pixfrac),
        ratios, kernel, wht is None)
    return fn(jnp.asarray(data, jnp.float32),
              None if wht is None else jnp.asarray(wht, jnp.float32),
              jnp.asarray(x_out, jnp.float32),
              jnp.asarray(y_out, jnp.float32))


@functools.lru_cache(maxsize=64)
def _deposit_stack_spatial_jit(mesh, out_shape, pixfrac, ratios, kernel,
                               no_wht):
    """Jitted 2-D-mesh stack deposit for one static config (see
    ``_deposit_spatial_jit`` for why the shard_map must be jitted)."""
    fax, rax = mesh.axis_names
    Nf = mesh.shape[fax]
    Ho, Wo = out_shape
    Hl = -(-Ho // mesh.shape[rax])
    E = len(ratios)
    uniq = tuple(sorted(set(ratios)))
    ridx_np = np.asarray([uniq.index(r) for r in ratios], np.int32)
    pad = (-E) % Nf
    El = (E + pad) // Nf

    def _branch(ratio):
        def f(d_, w_, x_, y_):
            return drizzle_deposit(
                d_, w_, x_, y_, (Hl, Wo), pixfrac=pixfrac,
                pscale_ratio=ratio, kernel=kernel)
        return f

    def shard_fn(d, wl, xl, yl, ri):
        row0 = (jax.lax.axis_index(rax) * Hl).astype(jnp.float32)
        sci = jnp.zeros((Hl, Wo), jnp.float32)
        whtb = jnp.zeros((Hl, Wo), jnp.float32)
        branches = [_branch(r) for r in uniq]
        for e in range(El):  # static unroll over local frame slots
            if len(branches) == 1:
                s, ww = branches[0](d[e], wl[e], xl[e], yl[e] - row0)
            else:
                s, ww = jax.lax.switch(
                    ri[e], branches, d[e], wl[e], xl[e], yl[e] - row0)
            sci = sci + s
            whtb = whtb + ww
        keep = (row0 + jax.lax.iota(jnp.float32, Hl) < Ho)[:, None]
        # band-sized psum over the frames axis only (tiles of
        # HW/N_rows, never the full mosaic)
        return (jax.lax.psum(sci * keep, fax),
                jax.lax.psum(whtb * keep, fax))

    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(fax, None, None),) * 4 + (P(fax),),
        out_specs=(P(rax, None), P(rax, None)),
    )

    @jax.jit
    def run(data, wht, x_out, y_out):
        _, H, W = data.shape
        w = jnp.ones_like(data) if no_wht else wht
        xo = jnp.broadcast_to(x_out, (E, H, W))
        yo = jnp.broadcast_to(y_out, (E, H, W))
        ridx = jnp.asarray(ridx_np)
        if pad:
            zpad = ((0, pad), (0, 0), (0, 0))
            data = jnp.pad(data, zpad)
            w = jnp.pad(w, zpad)    # zero weight -> deposits nothing
            xo = jnp.pad(xo, zpad)
            yo = jnp.pad(yo, zpad)
            ridx = jnp.pad(ridx, (0, pad))
        return sharded(data, w, xo, yo, ridx)

    return run


def drizzle_deposit_sparse_spatial(
    mesh: Mesh,
    data: jax.Array,
    wht: jax.Array,
    x_out: jax.Array,
    y_out: jax.Array,
    out_shape: tuple[int, int],
    pixfrac: float = 1.0,
    pscale_ratio=1.0,
    kernel: str = "square",
) -> tuple[jax.Array, jax.Array]:
    """Band-compacted sparse deposit onto a row-sharded plane.

    ``data``/``wht``/``x_out``/``y_out`` are ``(Nb, E, L·bh, bw)``
    per-band pseudo-image stacks (``align._compact_blocks_bands``):
    each band's entry holds only the input blocks whose deposits can
    reach a blot-needed output cell INSIDE that band's rows — the
    spatial restriction of the replicated sparse live set, so the band
    union reproduces its deposits exactly (a straddling block appears
    in every band its padded bbox touches; out-of-band cells fail each
    band deposit's own bounds check). The band axis shards over the
    mesh rows axis; on a 2-D ``(frames, rows)`` mesh the frame axis
    shards over the frames axis (``E`` zero-padded internally) and the
    band accumulators ``psum`` over it.

    ``pscale_ratio`` scalar or per-frame sequence (``lax.switch``
    branches, as :func:`drizzle_deposit_stack_spatial`).
    """
    Nb, E = int(jnp.shape(data)[0]), int(jnp.shape(data)[1])
    if Nb != _n_bands(mesh):
        raise ValueError(
            f"band axis {Nb} != mesh rows axis {_n_bands(mesh)}")
    ratios = (tuple(float(r) for r in pscale_ratio)
              if hasattr(pscale_ratio, "__len__")
              else (float(pscale_ratio),) * E)
    if len(ratios) != E:
        raise ValueError(
            f"pscale_ratio: expected {E} per-frame values, got "
            f"{len(ratios)}")
    fn = _deposit_sparse_spatial_jit(
        mesh, (int(out_shape[0]), int(out_shape[1])), float(pixfrac),
        ratios, kernel)
    return fn(jnp.asarray(data, jnp.float32),
              jnp.asarray(wht, jnp.float32),
              jnp.asarray(x_out, jnp.float32),
              jnp.asarray(y_out, jnp.float32))


@functools.lru_cache(maxsize=64)
def _deposit_sparse_spatial_jit(mesh, out_shape, pixfrac, ratios, kernel):
    """Jitted band-sparse deposit for one static config (see
    ``_deposit_spatial_jit`` for why the shard_map must be jitted)."""
    ax = _rows_axis(mesh)
    two_d = len(mesh.axis_names) == 2
    fax = mesh.axis_names[0] if two_d else None
    Nf = int(mesh.shape[fax]) if two_d else 1
    Ho, Wo = out_shape
    Hl = band_rows(mesh, Ho)
    E = len(ratios)
    uniq = tuple(sorted(set(ratios)))
    ridx_np = np.asarray([uniq.index(r) for r in ratios], np.int32)
    pad = (-E) % Nf
    El = (E + pad) // Nf

    def _branch(ratio):
        def f(d_, w_, x_, y_):
            return drizzle_deposit(
                d_, w_, x_, y_, (Hl, Wo), pixfrac=pixfrac,
                pscale_ratio=ratio, kernel=kernel)
        return f

    def shard_fn(d, w, xs, ys, ri):
        # d: (1, El, L·bh, bw) — this band's blocks, local frame slots
        row0 = (jax.lax.axis_index(ax) * Hl).astype(jnp.float32)
        sci = jnp.zeros((Hl, Wo), jnp.float32)
        whtb = jnp.zeros((Hl, Wo), jnp.float32)
        branches = [_branch(r) for r in uniq]
        for e in range(El):  # static unroll; local frame count is small
            if len(branches) == 1:
                s, ww = branches[0](d[0, e], w[0, e], xs[0, e],
                                    ys[0, e] - row0)
            else:
                s, ww = jax.lax.switch(ri[e], branches, d[0, e], w[0, e],
                                       xs[0, e], ys[0, e] - row0)
            sci = sci + s
            whtb = whtb + ww
        keep = (row0 + jax.lax.iota(jnp.float32, Hl) < Ho)[:, None]
        sci = sci * keep
        whtb = whtb * keep
        if two_d:  # band-sized psum over the frames axis only
            sci = jax.lax.psum(sci, fax)
            whtb = jax.lax.psum(whtb, fax)
        return sci, whtb

    spec_in = (P(ax, fax, None, None) if two_d
               else P(ax, None, None, None))
    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(spec_in,) * 4 + ((P(fax),) if two_d else (P(),)),
        out_specs=(P(ax, None), P(ax, None)),
    )

    @jax.jit
    def run(data, wht, xo, yo):
        ridx = jnp.asarray(ridx_np)
        if pad:  # zero-weight frame slots deposit nothing
            zpad = ((0, 0), (0, pad), (0, 0), (0, 0))
            data = jnp.pad(data, zpad)
            wht = jnp.pad(wht, zpad)
            xo = jnp.pad(xo, zpad)
            yo = jnp.pad(yo, zpad)
            ridx = jnp.pad(ridx, (0, pad))
        return sharded(data, wht, xo, yo, ridx)

    return run


# --------------------------------------------------------------------- #
# interpolated gather from a row-sharded plane
# --------------------------------------------------------------------- #

def _band_sample_partial(band, row0, Hg, x, y, interp, sinscl):
    """This band's additive share of ``sample_image(global, x, y)``.

    Every tap row (after the global edge clamp to ``[0, Hg)``) is owned
    by exactly one band, so ``psum`` of these partials reproduces the
    unsharded sampler bit-for-bit. The global footprint-validity mask is
    applied by the caller (it is replicated).
    """
    Hl, W = band.shape

    def owned_row(yi):
        own = (yi >= row0) & (yi < row0 + Hl)
        yl = jnp.where(own, yi - row0, 0)
        return yl, own.astype(band.dtype)

    if interp == "nearest":
        xi = jnp.clip(jnp.floor(x + 0.5).astype(jnp.int32), 0, W - 1)
        yi = jnp.clip(jnp.floor(y + 0.5).astype(jnp.int32), 0, Hg - 1)
        yl, own = owned_row(yi)
        return band[yl, xi] * own

    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    wx, offs = _axis_weights(x - x0, interp, sinscl=sinscl)
    wy, _ = _axis_weights(y - y0, interp, sinscl=sinscl)
    xi0 = x0.astype(jnp.int32)
    yi0 = y0.astype(jnp.int32)
    acc = jnp.zeros_like(x)
    for i, oy in enumerate(offs):
        yi = jnp.clip(yi0 + oy, 0, Hg - 1)   # global edge clamp
        yl, own = owned_row(yi)
        row_acc = jnp.zeros_like(x)
        for j, ox in enumerate(offs):
            xi = jnp.clip(xi0 + ox, 0, W - 1)
            row_acc = row_acc + wx[..., j] * band[yl, xi]
        acc = acc + wy[..., i] * row_acc * own
    return acc


def sample_spatial(
    mesh: Mesh,
    plane: jax.Array,
    x: jax.Array,
    y: jax.Array,
    interp: str = "poly5",
    fill: float = 0.0,
    sinscl: float = 1.0,
    logical_rows: int | None = None,
    spline_halo: int = 32,
) -> tuple[jax.Array, jax.Array]:
    """:func:`subpixal_tpu.ops.interp.sample_image` from a row-sharded
    plane — the blot gather for mosaics too large for one device.

    ``plane`` is the sharded ``(ceil(H/N)*N, W)`` array from
    :func:`shard_rows`; ``logical_rows`` its unpadded row count (default:
    the padded count). Sample coordinates are replicated; the result
    (values + footprint validity, as in ``sample_image``) is replicated.

    ``interp='spline3'`` prefilters per band over a ``spline_halo``-row
    halo exchange whose slots are mirror-remapped into the LOGICAL rows
    — the extended band is then a window of the infinite mirror
    extension of the true plane, whose prefilter restricted to the
    image IS the global mirror-boundary prefilter. Core-coefficient
    truncation error is ``|z1|**spline_halo`` (the IIR pole is
    z1 = √3−2 ≈ −0.268: 1e-18 at the default 32) — bit-comparable to
    the unsharded prefilter, not bit-identical.
    """
    if interp not in INTERP_OFFSETS:
        raise ValueError(
            f"unknown interp: {interp!r} "
            f"(expected one of {sorted(INTERP_OFFSETS)})")
    Hp = int(plane.shape[0])
    fn = _sample_spatial_jit(
        mesh, Hp, interp, float(fill), float(sinscl),
        int(logical_rows) if logical_rows is not None else Hp,
        int(spline_halo))
    return fn(plane, jnp.asarray(x, jnp.float32),
              jnp.asarray(y, jnp.float32))


@functools.lru_cache(maxsize=64)
def _sample_spatial_jit(mesh, Hp, interp, fill, sinscl, Hg, spline_halo):
    """Jitted sharded gather for one static config (see
    ``_deposit_spatial_jit`` for why the shard_map must be jitted)."""
    ax = _rows_axis(mesh)
    Hl = Hp // _n_bands(mesh)
    pad = Hp - Hg
    offs = INTERP_OFFSETS[interp]
    lo, hi = offs[0], offs[-1]
    if interp == "spline3":
        # mirror-remap validity: every extended-band slot's reflection
        # must land inside the device's own extended range (see
        # shard_fn) — true when the halo fits a band alongside the row
        # padding and the plane is taller than halo+pad
        if (not 0 < spline_halo <= Hl - pad) or Hl < 2 * pad + 1:
            raise ValueError(
                f"spline3 needs 0 < spline_halo <= band_rows - pad "
                f"({Hl} - {pad}) and band_rows >= 2*pad + 1; got "
                f"spline_halo={spline_halo} — use more rows per band "
                "or fewer devices")

    def _spline_ext(band, row0, halo):
        """Mirror-remapped ``spline_halo``-extended band, axis-0
        prefiltered (the global mirror-boundary prefilter restricted
        to this band — see the sample_spatial docstring)."""
        ext = halo_exchange(band, halo, ax, edge="zero")
        # global row of each extended slot, reflected into the
        # logical rows (mirror: x[-n]=x[n], x[Hg-1+n]=x[Hg-1-n]);
        # identity for in-image slots, and exactly the rows the
        # zero-filled edge halos / zero row padding should hold
        g = row0 - halo + jnp.arange(Hl + 2 * halo)
        m = jnp.abs(g)
        m = jnp.where(m >= Hg, 2 * (Hg - 1) - m, m)
        ext = ext[jnp.clip(m - (row0 - halo), 0, Hl + 2 * halo - 1)]
        return _bspline3_prefilter_axis(ext, 0)

    def shard_fn(band, xs, ys):
        row0 = jax.lax.axis_index(ax) * Hl
        if interp == "spline3":
            ext = _spline_ext(band, row0, spline_halo)
            band_c = _bspline3_prefilter_axis(
                ext[spline_halo:spline_halo + Hl], 1)
            part = _band_sample_partial(band_c, row0, Hg, xs, ys,
                                        interp, sinscl)
        else:
            part = _band_sample_partial(band, row0, Hg, xs, ys,
                                        interp, sinscl)
        return jax.lax.psum(part, ax)

    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(ax, None), P(), P()),
        out_specs=P(),
    )

    @jax.jit
    def run(plane, xq, yq):
        W = plane.shape[1]
        if interp == "nearest":
            xi = jnp.floor(xq + 0.5).astype(jnp.int32)
            yi = jnp.floor(yq + 0.5).astype(jnp.int32)
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < Hg)
        else:
            xi0 = jnp.floor(xq).astype(jnp.int32)
            yi0 = jnp.floor(yq).astype(jnp.int32)
            valid = ((xi0 + lo >= 0) & (xi0 + hi < W)
                     & (yi0 + lo >= 0) & (yi0 + hi < Hg))
        vals = sharded(plane, xq, yq)
        return jnp.where(valid, vals, fill), valid

    return run
