"""Full-image prediction: padding, batching, and fused test-time augmentation.

Replaces the reference predict path (``unet_2d_summary.py:532-625``):

- Reflect-pad each summary image bottom/right to the inference window
  (reference ``:569-571``) — same np.pad semantics.
- Plain prediction: one batched forward over all images at once (the
  reference loops datasets with batch=1).
- 8x TTA: :func:`predict_tta` builds all 8 views of the whole image batch
  with ``tta_expand``, folds them into one (8*B, H, W) device batch, runs ONE
  forward, and inverts+averages on device (``tta_collapse``) — versus the
  reference's 8 sequential host->GPU round trips per dataset
  (``:585-590``). With a mesh, the 8*B batch shards over devices, so 8-way
  TTA on 8 devices costs one forward's wall-clock.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from deepcalcium_tpu.ops.augment import (tta_collapse, tta_collapse_np,
                                          tta_expand, tta_expand_np)
from deepcalcium_tpu.parallel.mesh import pad_batch_to, shard_batch

__all__ = ["reflect_pad_to", "predict_batched", "predict_tta",
           "predict_tiled", "tile_grid", "make_movie_evaluator",
           "make_summary_evaluator", "evaluate_movie_streaming",
           "evaluate_movie_tiled"]


def _image_eval_body(apply_fn, image_shape, window, tta, threshold):
    """Shared device body: z-norm -> reflect-pad -> (8x TTA) forward ->
    inverse/average -> threshold, from a MEAN image. Used by both the fused
    movie evaluator and the summary-image evaluator."""
    h, w = image_shape
    hw, ww = window
    if h > hw or w > ww:
        raise ValueError(f"image {(h, w)} larger than window {window}")
    if tta and hw != ww:
        raise ValueError(f"TTA needs a square window (rot90 views); "
                         f"got {window}")

    def body(params, state, mean):
        # max() with a subnormal-scale floor: exact for any real image
        # (std >= 1e-12 is untouched bit-for-bit), and a CONSTANT image
        # (dead recording) yields z=0 instead of NaN probs -> silent
        # all-zero mask.
        z = (mean - jnp.mean(mean)) / jnp.maximum(jnp.std(mean), 1e-12)
        if (h, w) != (hw, ww):
            z = jnp.pad(z, ((0, hw - h), (0, ww - w)), mode="reflect")
        if tta:
            views = tta_expand(z[None]).reshape(8, hw, ww)
            # Materialize the views before the net, so XLA cannot fuse the
            # rot90/flip transposes into the forward's entry convs. A
            # barrier on the OUTPUT probs would force a layout on the
            # collapse instead, so only the views get one. Whether the
            # barrier helps on the GPU is not measured.
            views = jax.lax.optimization_barrier(views)
            probs, _ = apply_fn(params, state, views, train=False)
            prob = tta_collapse(probs.reshape(8, 1, hw, ww))[0]
        else:
            probs, _ = apply_fn(params, state, z[None], train=False)
            prob = probs[0]
        prob = prob[:h, :w]
        return (prob > threshold).astype(jnp.uint8), prob

    return body


def make_movie_evaluator(apply_fn, movie_shape, window=(512, 512), tta=True,
                         threshold=0.5, mesh=None):
    """See :func:`_make_movie_evaluator`. This thin wrapper normalizes the
    shape arguments (lists/np shapes -> tuples) so the lru_cached core —
    which exists so repeat calls do not recompile the full graph — never
    sees unhashable arguments. Pass an identity-STABLE ``apply_fn`` (build
    the partial once, not per call)."""
    return _make_movie_evaluator(apply_fn, tuple(movie_shape), tuple(window),
                                 bool(tta), float(threshold), mesh)


@functools.lru_cache(maxsize=16)
def _make_movie_evaluator(apply_fn, movie_shape, window=(512, 512), tta=True,
                          threshold=0.5, mesh=None):
    """Build the fused end-to-end movie evaluator: ONE jitted graph running
    summary-reduction -> z-norm -> reflect-pad -> (8x TTA) forward ->
    inverse/average -> threshold, entirely on device.

    This is the library form of the headline benchmark pipeline (the
    reference's ingest+summarize+predict path, dlmia_workshop_figures.ipynb
    cell 7): the movie crosses host->device once and a single dispatch
    returns the final mask. ``UNet2DSummary.evaluate_movie`` and ``bench.py``
    both run through here.

    # Arguments
        apply_fn: f(params, state, x, train=...) -> (probs, state); bake
            compute_dtype in with functools.partial.
        movie_shape: static (T, H, W) of the movies this evaluator serves.
        window: inference window (>= image, multiples of 16).
        tta: fold the 8 invertible augmentations into one (8, H, W) batch.
        mesh: optional Mesh — shards the movie's time axis over 'data' for
            the summary reduction and the TTA view batch for the forward.

    # Returns
        evaluate(params, state, movie) -> (mask uint8 (H, W),
        prob float32 (H, W), mean float32 (H, W))
    """
    from deepcalcium_tpu.ops.summary import (movie_summary,
                                             movie_summary_sharded)

    t, h, w = movie_shape
    body = _image_eval_body(apply_fn, (h, w), window, tta, threshold)

    def evaluate(params, state, movie):
        if mesh is not None:
            mean, _ = movie_summary_sharded(movie, mesh)
        else:
            mean, _ = movie_summary(movie)
        mask, prob = body(params, state, mean)
        return mask, prob, mean

    if mesh is None:
        return jax.jit(evaluate)
    from jax.sharding import NamedSharding, PartitionSpec as P

    from deepcalcium_tpu.parallel.mesh import replicated

    rep = replicated(mesh)
    # Ragged T: movie_summary_sharded splits head/tail internally, but the
    # input layout itself must divide to shard — replicate it otherwise.
    even = t % mesh.shape["data"] == 0
    tshard = NamedSharding(mesh, P("data" if even else None, None, None))
    return jax.jit(evaluate, in_shardings=(rep, rep, tshard),
                   out_shardings=(rep, rep, rep))


def make_summary_evaluator(apply_fn, image_shape, window=(512, 512),
                           tta=True, threshold=0.5, mesh=None):
    """Shape-normalizing wrapper over the lru_cached core (see
    :func:`make_movie_evaluator` for why)."""
    return _make_summary_evaluator(apply_fn, tuple(image_shape),
                                   tuple(window), bool(tta),
                                   float(threshold), mesh)


@functools.lru_cache(maxsize=16)
def _make_summary_evaluator(apply_fn, image_shape, window=(512, 512),
                            tta=True, threshold=0.5, mesh=None):
    """Build the jitted evaluator from a MEAN summary image (instead of a
    resident movie): z-norm -> pad -> (8x TTA) forward -> threshold.

    Cached on all arguments (so repeated calls reuse the compiled graph —
    a fresh jit per call would recompile): pass an identity-STABLE
    ``apply_fn`` (build the partial once, not inline per call).

    This is the forward half of the streaming evaluate path: the movie is
    folded chunk by chunk through
    :class:`~deepcalcium_tpu.ops.summary.StreamingSummary` and only the
    mean image reaches this graph.

    # Returns
        evaluate(params, state, mean (H, W) float32) ->
        (mask uint8 (H, W), prob float32 (H, W))
    """
    body = _image_eval_body(apply_fn, image_shape, window, tta, threshold)
    if mesh is None:
        return jax.jit(body)
    from deepcalcium_tpu.parallel.mesh import replicated

    rep = replicated(mesh)
    return jax.jit(body, in_shardings=(rep, rep, rep),
                   out_shardings=(rep, rep))


def evaluate_movie_streaming(apply_fn, params, state, movie,
                             window=(512, 512), tta=True, threshold=0.5,
                             mesh=None, chunk=256, backend="auto"):
    """Evaluate a HOST-resident movie (numpy array or any (T, H, W)
    sliceable, e.g. an open h5py dataset) without shipping the raw frames
    to the device.

    Frames fold through :class:`StreamingSummary` in ``chunk``-frame slabs
    (donated device updates by default, ``backend="host"`` for NumPy
    accumulation), then the mean image runs the fused z-norm -> TTA ->
    forward -> threshold graph. The whole movie is never resident at once,
    which is what an HDF5 dataset on disk needs; for a movie already in
    memory, :func:`make_movie_evaluator` is the one-dispatch path.

    # Returns
        (mask uint8 (H, W), prob float32 (H, W), mean float32 (H, W))
        as host arrays.
    """
    mean = _streaming_mean(movie, chunk, backend)
    h, w = movie.shape[1:]
    ev = make_summary_evaluator(apply_fn, (h, w), window=window, tta=tta,
                                threshold=threshold, mesh=mesh)
    mask, prob = ev(params, state, jnp.asarray(mean))
    return np.asarray(mask), np.asarray(prob), mean


def _streaming_mean(movie, chunk, backend):
    """Fold a host-resident (T, H, W) movie to its mean image through
    :class:`StreamingSummary` in ``chunk``-frame slabs. track_max=False:
    the evaluate paths need only the mean image, and the max projection
    would cost a second full per-frame pass on the host."""
    from deepcalcium_tpu.ops.summary import StreamingSummary

    t = movie.shape[0]
    h, w = movie.shape[1:]
    dtype = np.asarray(movie[0:1]).dtype
    ss = StreamingSummary((h, w), dtype=dtype, backend=backend,
                          track_max=False)
    for i in range(0, t, chunk):
        ss.update(np.asarray(movie[i : i + chunk]))
    mean, _ = ss.result()
    return mean


def evaluate_movie_tiled(apply_fn, params, state, movie, window=(512, 512),
                         tta=True, threshold=0.5, overlap=None, mesh=None,
                         max_batch=None, chunk=256, backend="auto"):
    """Evaluate a movie whose frames EXCEED the inference window (a
    beyond-reference capability — the reference asserts 512² fields of
    view, ``unet_2d_summary.py:565-566``): streaming mean summary ->
    host z-norm -> sliding-window tiled forward (:func:`predict_tiled`,
    per-tile TTA) -> threshold.

    The raw frames fold chunk by chunk into the mean image and only the
    window-sized tile batches run the forward, so a 2048² field of view
    needs no more device memory than a 512² one.

    # Returns
        (mask uint8 (H, W), prob float32 (H, W), mean float32 (H, W))
        as host arrays.
    """
    from deepcalcium_tpu.train.trainer import make_eval_forward

    mean = _streaming_mean(movie, chunk, backend)
    # Same z-norm semantics as _image_eval_body (subnormal-scale floor so a
    # constant movie yields z=0, not NaN probs), on host.
    z = (mean - np.mean(mean)) / max(float(np.std(mean)), 1e-12)

    fwd = make_eval_forward(apply_fn, mesh=mesh)
    prob = predict_tiled(fwd, params, state, z, window=window,
                         overlap=overlap, mesh=mesh, max_batch=max_batch,
                         tta=tta)
    return (prob > threshold).astype(np.uint8), prob, mean


def reflect_pad_to(img: np.ndarray, hw: int, ww: int) -> np.ndarray:
    """Pad (H, W) -> (hw, ww) bottom/right with reflection (reference
    ``unet_2d_summary.py:569-571``)."""
    h, w = img.shape
    if h > hw or w > ww:
        raise ValueError(f"image {img.shape} larger than window {(hw, ww)}")
    if h == hw and w == ww:
        return img
    return np.pad(img, ((0, hw - h), (0, ww - w)), mode="reflect")


def _run_batched(fwd, params, state, batch_np, mesh=None, max_batch=None):
    """Run ``fwd`` over a (N, H, W) host batch in device-sized slabs."""
    n = batch_np.shape[0]
    max_batch = max_batch or n
    outs = []
    for i in range(0, n, max_batch):
        slab = batch_np[i : i + max_batch]
        true = slab.shape[0]
        if true < max_batch:
            # Zero-pad the ragged tail slab to the compiled batch shape:
            # a second batch shape re-specializes (recompiles) the full
            # forward — same rule as StreamingSummary's chunk padding.
            # Crop below via [:true].
            slab = np.concatenate(
                [slab, np.zeros((max_batch - true,) + slab.shape[1:],
                                slab.dtype)])
        if mesh is not None:
            slab, _ = pad_batch_to(slab, mesh.devices.size)
            slab = shard_batch(mesh, slab)
        out = np.asarray(fwd(params, state, jnp.asarray(slab)))
        outs.append(out[:true])
    return np.concatenate(outs, axis=0)


def predict_batched(fwd, params, state, images, window=(512, 512), mesh=None,
                    max_batch=None):
    """Predict a list of (H_i, W_i) images; returns same-shaped prob maps.

    Images are reflect-padded to ``window``, stacked, run through ``fwd`` in
    slabs, and cropped back.
    """
    hw, ww = window
    batch = np.stack([reflect_pad_to(np.asarray(s, np.float32), hw, ww) for s in images])
    probs = _run_batched(fwd, params, state, batch, mesh=mesh, max_batch=max_batch)
    return [p[: s.shape[0], : s.shape[1]] for p, s in zip(probs, images)]


def tile_grid(shape, window=(512, 512), overlap=None):
    """(ys, xs) top-left corners of the sliding-window tiling of a
    ``shape`` = (H, W) image by ``window`` tiles.

    The single source of the tiling geometry: :func:`predict_tiled` builds
    its tiles from this grid, and ``UNet2DSummary.predict``'s views/s
    accounting counts ``len(ys) * len(xs)`` — the two must agree or the
    throughput log silently lies.

    ``overlap``: pixels shared by adjacent tiles; None (default) picks
    ``min(64, min(window) // 2)`` so any window size works. Dimensions not
    exceeding the window produce a single row/column at corner 0.
    """
    hw, ww = window
    if overlap is None:
        overlap = min(64, min(hw, ww) // 2)
    if not (0 <= overlap < min(hw, ww)):
        raise ValueError(
            f"overlap must be in [0, min(window)) = [0, {min(hw, ww)}); "
            f"got {overlap}")
    h, w = shape
    ph, pw = max(h, hw), max(w, ww)
    stride_y = hw - overlap if ph > hw else hw
    stride_x = ww - overlap if pw > ww else ww
    ys = list(range(0, max(ph - hw, 0) + 1, stride_y))
    xs = list(range(0, max(pw - ww, 0) + 1, stride_x))
    if ys[-1] != ph - hw:
        ys.append(ph - hw)
    if xs[-1] != pw - ww:
        xs.append(pw - ww)
    return ys, xs


def predict_tiled(fwd, params, state, img, window=(512, 512), overlap=None,
                  mesh=None, max_batch=None, tta=False):
    """Sliding-window prediction for an image LARGER than the network window.

    The reference cannot do this (it asserts 512² and pads up,
    ``unet_2d_summary.py:565-566``); here big fields of view tile into
    overlapping windows, run as one batch, and blend by averaging the
    overlaps (cosine-free uniform blend — U-Net borders are the reason for
    the overlap). Reached automatically from ``UNet2DSummary.predict`` /
    ``evaluate_movie`` when an image exceeds ``window_shape``.

    # Arguments
        img: one (H, W) image with H, W >= window is allowed in either or
            both dims (smaller dims are reflect-padded).
        overlap: pixels of overlap between adjacent tiles; None (default)
            picks min(64, min(window)//2) so any window size works.
        tta: run each tile through the fused 8-view test-time-augmentation
            batch (the tiled generalization of :func:`predict_tta`: views
            expand/collapse PER TILE — a rot90 of a big field of view would
            change which pixels share a window, so whole-image TTA does not
            commute with tiling).

    # Returns
        (H, W) float probability map.
    """
    img = np.asarray(img, np.float32)
    hw, ww = window
    if max_batch is None:
        # Cap the compiled slab at a fixed 16 windows: without a cap the
        # batch dim is (8*)ntiles, so every distinct field-of-view
        # geometry re-specializes (recompiles) the full forward and a big
        # movie needs one giant view slab in device memory. A fixed slab
        # compiles once and streams; the ragged tail is zero-padded by
        # _run_batched.
        max_batch = 16
    if tta and hw != ww:
        raise ValueError(f"TTA needs a square window (rot90 views); "
                         f"got {window}")
    h, w = img.shape
    ph, pw = max(h, hw), max(w, ww)
    padded = np.pad(img, ((0, ph - h), (0, pw - w)), mode="reflect") \
        if (ph > h or pw > w) else img

    ys, xs = tile_grid((h, w), window, overlap)

    tiles = np.stack([padded[y : y + hw, x : x + ww] for y in ys for x in xs])
    if tta:
        n = tiles.shape[0]
        views = tta_expand_np(tiles).reshape(8 * n, hw, ww)
        vprobs = _run_batched(fwd, params, state, views, mesh=mesh,
                              max_batch=max_batch)
        probs = tta_collapse_np(vprobs.reshape(8, n, hw, ww))
    else:
        probs = _run_batched(fwd, params, state, tiles, mesh=mesh,
                             max_batch=max_batch)

    acc = np.zeros((ph, pw), np.float64)
    cnt = np.zeros((ph, pw), np.float64)
    i = 0
    for y in ys:
        for x in xs:
            acc[y : y + hw, x : x + ww] += probs[i]
            cnt[y : y + hw, x : x + ww] += 1.0
            i += 1
    return (acc / cnt)[:h, :w].astype(np.float32)


def predict_tta(fwd, params, state, images, window=(512, 512), mesh=None,
                max_batch=None):
    """8x TTA prediction as one fused batch; returns per-image prob maps.

    Equivalent in score to the reference TTA loop (``unet_2d_summary.py:
    585-590``); the augment->forward->invert->average chain lives in one
    device computation.
    """
    hw, ww = window
    batch = np.stack([reflect_pad_to(np.asarray(s, np.float32), hw, ww) for s in images])
    # Expand AND collapse the 8 views on HOST (numpy twins of
    # tta_expand/tta_collapse, parity-tested): the views feed _run_batched's
    # host slabs directly, so expanding on device would copy the 8x tensor
    # device->host->device, and the flips are view-cheap in numpy.
    views = tta_expand_np(batch)  # (8, B, hw, ww)
    n = batch.shape[0]
    flat = views.reshape(8 * n, hw, ww)
    probs = _run_batched(fwd, params, state, flat, mesh=mesh, max_batch=max_batch)
    merged = tta_collapse_np(probs.reshape(8, n, hw, ww))
    return [p[: s.shape[0], : s.shape[1]] for p, s in zip(merged, images)]
