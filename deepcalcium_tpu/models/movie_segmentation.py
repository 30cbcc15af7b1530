"""Full-movie streaming segmentation: per-frame UNet2DS over raw movies.

The BASELINE stretch config ("per-frame UNet2DS over raw HDF5 movies",
sharded over a device mesh). The reference has no such capability — its closest
analogue streams frames one at a time on CPU for the summary reduction
(``nf.py:126-130``).

Design: frames are z-normalized per frame on device, reflect-padded to a
pooling-friendly shape, and pushed through the fully-convolutional UNet2DS in
fixed-size time slabs. With a mesh, each slab's frame axis shards over the
``data`` axis; params replicate. Host->device transfer overlaps compute via
double-buffered slab feeding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from deepcalcium_tpu.models import unet2d
from deepcalcium_tpu.parallel.mesh import batch_sharding, replicated

__all__ = ["segment_movie"]


def _pad16(hw: int) -> int:
    return -(-hw // 16) * 16


# Module-level partial: a stable identity so the lru-cached slab builder
# below actually hits on repeat upsampling-mode calls.
_UPSAMPLING_APPLY = functools.partial(unet2d.apply, up_mode="upsampling")


def _resolve_apply(apply_fn, params):
    """Stock net: dispatch the W-packed inference rewrite (exact,
    models/unet2d_fast.py) when the checkpoint is transpose-mode; hp/wp are
    already %16 by construction. Upsampling-mode checkpoints (no tconv
    weights) take the parity forward with the matching up_mode."""
    if apply_fn is not None:
        return apply_fn
    if params is not None and "up0_tconv" in params:
        from deepcalcium_tpu.models.unet2d_fast import apply_fast_w

        return apply_fast_w
    return _UPSAMPLING_APPLY


@functools.lru_cache(maxsize=16)
def _make_segment_slab(hp, wp, compute_dtype, threshold, mesh, apply_fn):
    """lru-cached so repeat segment_movie calls in one process reuse ONE
    jitted executable — a fresh closure per call recompiled the full
    forward every time (the same identity-stable-jit rule as
    trainer.stable_apply_fn)."""

    def seg(params, state, slab):
        x = slab.astype(jnp.float32)
        # Per-frame z-normalization (the summary-image convention,
        # unet_2d_summary.py:239, applied framewise).
        mean = jnp.mean(x, axis=(1, 2), keepdims=True)
        std = jnp.std(x, axis=(1, 2), keepdims=True) + 1e-6
        x = (x - mean) / std
        h, w = x.shape[1], x.shape[2]
        x = jnp.pad(x, ((0, 0), (0, hp - h), (0, wp - w)), mode="reflect")
        probs, _ = apply_fn(params, state, x, train=False,
                            compute_dtype=compute_dtype)
        return (probs[:, :h, :w] > threshold).astype(jnp.uint8)

    if mesh is None:
        return jax.jit(seg)
    return jax.jit(
        seg,
        in_shardings=(replicated(mesh), replicated(mesh), batch_sharding(mesh, 3)),
        out_shardings=batch_sharding(mesh, 3),
    )


def segment_movie(params, state, movie, slab: int = 64, mesh=None,
                  threshold: float = 0.5, compute_dtype=jnp.bfloat16,
                  apply_fn=None):
    """Segment every frame of a (T, H, W) movie; returns (T, H, W) uint8.

    # Arguments
        movie: host array or h5py dataset (sliced lazily per slab).
        slab: frames per device batch; with a mesh, must divide by the mesh
            size after padding (handled internally).
        mesh: optional Mesh; shards each slab's frame axis over 'data'.
    """
    t, h, w = movie.shape
    hp, wp = _pad16(h), _pad16(w)

    if mesh is not None:
        n = mesh.devices.size
        slab = -(-slab // n) * n
    seg = _make_segment_slab(hp, wp, compute_dtype, float(threshold), mesh,
                             _resolve_apply(apply_fn, params))
    # Transfer params/state ONCE (replicated under a mesh): checkpoints
    # load as host numpy pytrees, and handing those to every slab dispatch
    # re-uploads ~31 MB of weights per slab through the link the Prefetcher
    # exists to keep busy with frames.
    sh = replicated(mesh) if mesh is not None else None
    params = jax.device_put(params, sh) if sh else jax.device_put(params)
    state = jax.device_put(state, sh) if sh else jax.device_put(state)

    # HDF5-read + pad + host->device transfer runs on a background thread
    # (Prefetcher) so it overlaps the device compute of the previous slab —
    # the pipeline is transfer-bound on thin host links.
    from deepcalcium_tpu.train.sampler import Prefetcher

    def slabs():
        for t0 in range(0, t, slab):
            chunk = np.asarray(movie[t0 : t0 + slab])
            true = chunk.shape[0]
            if true < slab:  # pad the tail slab to the compiled shape
                chunk = np.concatenate(
                    [chunk, np.zeros((slab - true, h, w), chunk.dtype)])
            yield t0, true, chunk

    def put(item):
        t0, true, chunk = item
        if mesh is not None:
            dev = jax.device_put(chunk, batch_sharding(mesh, 3))
        else:
            dev = jax.device_put(chunk)
        return t0, true, dev

    out = np.empty((t, h, w), np.uint8)
    pending = []  # (future, t0, true_len) — keep one slab in flight
    prefetch = Prefetcher(slabs(), put_fn=put, depth=2)
    try:
        for t0, true, dev in prefetch:
            fut = seg(params, state, dev)
            pending.append((fut, t0, true))
            if len(pending) >= 2:  # drain the oldest
                f, s0, n0 = pending.pop(0)
                out[s0 : s0 + n0] = np.asarray(f)[:n0]
        for f, s0, n0 in pending:
            out[s0 : s0 + n0] = np.asarray(f)[:n0]
    finally:
        prefetch.close()
    return out
