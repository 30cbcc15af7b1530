"""Mask summary: flatten N per-neuron masks to one 2-D mask, erasing pixels
where different neurons touch or overlap, preserving the neuron count.

Parity target: reference ``_summarize_mask`` (``unet_2d_summary.py:244-291``):

1. Keep only pixels covered by exactly one neuron (overlaps removed;
   reference ``:269-273``).
2. Walk the surviving pixels in their original (z-major) discovery order; for
   each, take the union of z-values (neuron ids) over its surviving 3x3
   neighborhood; if more than one distinct id appears, delete the whole
   surviving neighborhood (reference ``:277-284``). Deletions are *visible to
   later iterations* — the walk is sequential and order-dependent.

Two implementations:

- :func:`mask_summary_exact` — faithful sequential reproduction (host-side,
  dict-based, same iteration order). This is the default mask summary used
  for training targets and scoring, since it is run once per dataset and
  bit-for-bit parity with the reference target masks matters.
- :func:`mask_summary_stencil` — a jit-able, vectorized *parallel*
  APPROXIMATION, kept as a tested alternative implementation, NOT a
  production path: a pixel survives iff its 3x3 neighborhood within the
  single-cover set is id-homogeneous AND no neighbor is conflicted
  (conflicts dilated by 3x3). It can differ from the sequential walk on
  chains of touching neurons where an early deletion removes the witness
  of a later conflict (only ever OVER-deleting — never adding pixels);
  tests bound the divergence on synthetic data. Status: the exact walk
  runs ONCE per dataset on the host and is
  nowhere near any hot path, so the stencil earns no default-path caller;
  it stays available through the ``mask_summary_func`` injection point
  for users who want jit-able target generation and accept the
  documented divergence.
"""

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["mask_summary_exact", "mask_summary_stencil", "id_map_from_stack"]

_NBRS = [(-1, 0), (1, 0), (0, -1), (0, 1), (1, 1), (-1, -1), (1, -1), (-1, 1)]


def mask_summary_exact(msks: np.ndarray) -> np.ndarray:
    """Sequential reference-faithful mask summary.

    # Arguments
        msks: (N, H, W) stack of binary per-neuron masks.

    # Returns
        (H, W) float array with 1.0 at surviving pixels.
    """
    msks = np.asarray(msks)
    zz, yy, xx = np.where(msks == 1)

    # (y, x) -> z of the single covering neuron; insertion in z-major order
    # (np.where order), with multi-covered pixels dropped — reference :264-273.
    counts: dict = {}
    for z, y, x in zip(zz.tolist(), yy.tolist(), xx.tolist()):
        counts.setdefault((y, x), []).append(z)
    yx_z = {k: v[0] for k, v in counts.items() if len(v) == 1}

    # Sequential neighborhood-conflict deletion — reference :277-284. The
    # snapshot includes every single-covered pixel; pixels already deleted
    # still trigger a check of their surviving neighbors.
    for y, x in list(yx_z.keys()):
        nbrs = [
            (y + dy, x + dx) for dy, dx in _NBRS + [(0, 0)] if (y + dy, x + dx) in yx_z
        ]
        if not nbrs:
            continue
        allz = {yx_z[k] for k in nbrs}
        if len(allz) > 1:
            for k in nbrs:
                del yx_z[k]

    summ = np.zeros(msks.shape[1:], dtype=np.float64)
    if yx_z:
        ys, xs = zip(*yx_z.keys())
        summ[list(ys), list(xs)] = 1.0
    return summ


def id_map_from_stack(msks):
    """(N, H, W) binary stack -> (cover_count, id_map) both (H, W).

    ``id_map`` holds the 1-based neuron id at single-covered pixels, 0
    elsewhere. Pure jnp; the contraction over N is a matmul-shaped reduction
    XLA maps onto the matrix units for large N.
    """
    msks = jnp.asarray(msks)
    n = msks.shape[0]
    ids = jnp.arange(1, n + 1, dtype=jnp.int32)[:, None, None]
    cover = jnp.sum(msks.astype(jnp.int32), axis=0)
    idsum = jnp.sum(msks.astype(jnp.int32) * ids, axis=0)
    id_map = jnp.where(cover == 1, idsum, 0)
    return cover, id_map


def _shift2d(x, dy, dx):
    """Shift an (H, W) map by (dy, dx), zero-filling — a stencil tap."""
    return jnp.roll(x, (dy, dx), axis=(0, 1)) * _edge_mask(x.shape, dy, dx)


def _edge_mask(shape, dy, dx):
    h, w = shape
    rows = jnp.arange(h)[:, None]
    cols = jnp.arange(w)[None, :]
    rmask = (rows >= dy) & (rows < h + dy)
    cmask = (cols >= dx) & (cols < w + dx)
    return (rmask & cmask).astype(jnp.int32)


@jax.jit
def mask_summary_stencil(msks):
    """Vectorized (parallel-semantics) mask summary; see module docstring.

    # Arguments
        msks: (N, H, W) binary stack (any numeric dtype).

    # Returns
        (H, W) float32 array with 1.0 at surviving pixels.
    """
    _, id_map = id_map_from_stack(msks)
    present = (id_map > 0).astype(jnp.int32)

    # conflict[p] = any 8-neighbor present with a different id.
    conflict = jnp.zeros_like(present)
    for dy, dx in _NBRS:
        nid = _shift2d(id_map, dy, dx)
        npres = _shift2d(present, dy, dx)
        conflict = conflict | ((npres == 1) & (nid != id_map)).astype(jnp.int32)
    conflict = conflict * present

    # Deleting a conflicted pixel removes its whole present neighborhood:
    # dilate conflicts by the 3x3 window.
    deleted = conflict
    for dy, dx in _NBRS:
        deleted = deleted | _shift2d(conflict, dy, dx)

    return ((present == 1) & (deleted == 0)).astype(jnp.float32)
