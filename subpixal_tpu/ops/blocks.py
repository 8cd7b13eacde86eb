"""Input-block partition of a frame, shared by the sparse in-loop deposit.

The align loop's sparse deposit (``align._live_block_indices`` /
``align._compact_blocks``) keeps only the input blocks whose deposits can
reach a cutout's blot window. Block bboxes, the live set and the
compaction must walk the SAME blocks in the same order, so all of them
call :func:`block_partition` with :data:`DEPOSIT_BLOCK`.
"""

from __future__ import annotations

#: the input block (rows, cols) the sparse deposit keeps or drops whole
DEPOSIT_BLOCK = (16, 128)


def round_up(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return -(-n // m) * m


def block_partition(a, block: tuple[int, int] | None = None,
                    **pad_kw):
    """``(..., H, W) -> (..., nb, bh, bw)``: the input block partition,
    padding the trailing axes to whole blocks.

    Blocks are ordered row-major over (by, bx). ``pad_kw`` forwards to
    ``np.pad`` / ``jnp.pad`` (e.g. ``mode='edge'`` for bbox sizing).
    Works on numpy and jax arrays alike.
    """
    import numpy as np

    if block is None:
        block = DEPOSIT_BLOCK
    *lead, H, W = a.shape
    bh, bw = block
    Hp = round_up(H, bh)
    Wp = round_up(W, bw)
    if (Hp, Wp) != (H, W):
        spec = [(0, 0)] * len(lead) + [(0, Hp - H), (0, Wp - W)]
        if isinstance(a, np.ndarray):
            a = np.pad(a, spec, **pad_kw)
        else:
            import jax.numpy as jnp

            a = jnp.pad(a, spec, **pad_kw)
    a = a.reshape(*lead, Hp // bh, bh, Wp // bw, bw)
    n = a.ndim
    perm = tuple(range(len(lead))) + (n - 4, n - 2, n - 3, n - 1)
    return a.transpose(perm).reshape(
        *lead, (Hp // bh) * (Wp // bw), bh, bw)
