"""Mean/max summary-image reduction over a movie's time axis.

Parity target: the reference ingest hot loop (``datasets/nf.py:126-130``) —
one CPU pass over T TIFF frames accumulating ``series/mean`` (float16 +=) and
``series/max`` (np.maximum). That loop ran at ~205 frames/s and was the
end-to-end throughput bottleneck (BASELINE.md).

- :func:`movie_summary` — one fused XLA reduction over a resident (T, H, W)
  array: the int->float32 convert folds into the sum, and sum and max read
  the movie in one pass. Every production path calls this.
- :class:`StreamingSummary` — host-streaming accumulator for ingest: frames
  decoded on host arrive in chunks; a donated jitted update folds each chunk
  into device-resident state. Mean accumulates in float32 (deliberate upgrade
  over the reference's lossy float16 ``+=``; stored dtype stays float16 per
  the HDF5 contract).
- :func:`movie_summary_sharded` — time-axis sharding over a mesh: each device
  reduces its T-shard, then ``psum``/``pmax`` combine across devices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

__all__ = [
    "movie_summary",
    "movie_summary_sharded",
    "StreamingSummary",
]


@jax.jit
def movie_summary(movie):
    """Mean and max projections of a (T, H, W) movie.

    # Returns
        (mean, mx): (H, W) float32 mean and (H, W) max in the input dtype.
    """
    s = jnp.sum(movie, axis=0, dtype=jnp.float32)
    return s / jnp.float32(movie.shape[0]), jnp.max(movie, axis=0)


# ---------------------------------------------------------------------------
# Host-streaming accumulator (ingest path)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, donate_argnums=(0, 1))
def _streaming_device_update(s, m, chunk, n_valid):
    """Donated device fold of one frame chunk into (sum, max) accumulators.
    Module-level (not a per-instance closure) so jax's global jit cache
    reuses the compiled kernel across StreamingSummary instances — a fresh
    closure per instance recompiled on every evaluate_movie call.

    ``n_valid`` (traced int32 scalar): frames past it are zero padding from
    the caller and are masked out of both reductions — so the RAGGED TAIL
    chunk of a stream reuses the same compiled executable as the full
    chunks instead of triggering a second compile mid-measurement."""
    valid = jax.lax.broadcasted_iota(jnp.int32, chunk.shape, 0) < n_valid
    neg = (jnp.finfo(chunk.dtype).min
           if jnp.issubdtype(chunk.dtype, jnp.floating)
           else jnp.iinfo(chunk.dtype).min)
    s = s + jnp.sum(jnp.where(valid, chunk.astype(jnp.float32), 0.0), axis=0)
    m = jnp.maximum(m, jnp.max(jnp.where(valid, chunk, neg), axis=0))
    return s, m


@functools.partial(jax.jit, donate_argnums=(0,))
def _streaming_device_update_mean(s, chunk, n_valid):
    """Mean-only variant (track_max=False); same masking contract."""
    valid = jax.lax.broadcasted_iota(jnp.int32, chunk.shape, 0) < n_valid
    return s + jnp.sum(jnp.where(valid, chunk.astype(jnp.float32), 0.0),
                       axis=0)


class StreamingSummary:
    """Fold host-decoded frame chunks into mean/max accumulators.

    Replaces the reference's per-frame NumPy accumulation
    (``datasets/nf.py:126-130``). Two backends:

    - ``device`` (what ``"auto"`` selects): donated jitted chunk updates;
      each frame crosses host->device once and the reduction runs on the
      accelerator alongside the transfer.
    - ``host``: vectorized NumPy accumulation, an explicit choice for
      callers that want to keep the raw frames off the device.
    """

    def __init__(self, frame_shape, dtype=jnp.int16, backend: str = "auto",
                 track_max: bool = True):
        """``track_max=False`` skips the max projection — the mean-only
        consumers (evaluate_movie_streaming) save a full per-frame pass."""
        if backend not in ("auto", "device", "host"):
            raise ValueError(f"backend={backend!r}: expected 'auto', "
                             f"'device' or 'host'")
        self.track_max = track_max
        if backend == "auto":
            backend = "device"
        self.backend = backend
        self._chunk_len = None  # first-seen chunk length (device path)
        npdtype = np.dtype(dtype)
        neg = (np.finfo(npdtype).min if np.issubdtype(npdtype, np.floating)
               else np.iinfo(npdtype).min)
        self._count = 0

        if backend == "host":
            self._sum = np.zeros(frame_shape, np.float32)
            self._max = np.full(frame_shape, neg, npdtype)
        else:
            self._sum = jnp.zeros(frame_shape, jnp.float32)
            self._max = jnp.full(frame_shape, neg, dtype)

    def update(self, chunk) -> None:
        """chunk: (C, H, W) host array of frames."""
        n = chunk.shape[0]
        if self.backend == "host":
            self._sum += np.sum(np.asarray(chunk, np.float32), axis=0)
            if self.track_max:
                np.maximum(self._max, np.max(chunk, axis=0), out=self._max)
        else:
            # The jitted update specializes on chunk.shape: a ragged tail
            # chunk would trigger a second compile mid-stream. Zero-pad to
            # the first-seen chunk length and mask inside the update.
            if self._chunk_len is None:
                self._chunk_len = n
            if n > self._chunk_len:
                # A chunk LARGER than the first-seen one would specialize a
                # NEW executable just like a ragged tail would — split it
                # into first-seen-size slabs instead; a short final slab
                # pads below.
                for i in range(0, n, self._chunk_len):
                    self.update(chunk[i:i + self._chunk_len])
                return
            if n < self._chunk_len:
                pad = np.zeros((self._chunk_len - n,) + chunk.shape[1:],
                               np.asarray(chunk[:1]).dtype)
                chunk = np.concatenate([np.asarray(chunk), pad])
            if self.track_max:
                self._sum, self._max = _streaming_device_update(
                    self._sum, self._max, jnp.asarray(chunk), np.int32(n))
            else:
                self._sum = _streaming_device_update_mean(
                    self._sum, jnp.asarray(chunk), np.int32(n))
        self._count += n

    def result(self):
        """(mean float32, max) as host numpy arrays; max is ``None`` when
        constructed with ``track_max=False`` (it was never folded — the
        min-sentinel buffer must not escape as data)."""
        if self._count == 0:
            raise ValueError("no frames accumulated")
        return (
            np.asarray(self._sum) / self._count,
            np.asarray(self._max) if self.track_max else None,
        )


# ---------------------------------------------------------------------------
# Time-axis sharding over a device mesh
# ---------------------------------------------------------------------------

def movie_summary_sharded(movie, mesh, axis: str = "data"):
    """Mean/max projection with the time axis sharded over ``mesh[axis]``.

    Each device reduces its local T-shard with :func:`movie_summary`, then
    partial sums combine with ``psum`` and partial maxes with ``pmax``.

    Ragged T is handled without materializing a padded copy of the movie:
    the divisible head reduces sharded, the tail (< mesh size frames)
    reduces single-device, and the two combine exactly.

    # Returns
        (mean, mx): (H, W) float32 mean and (H, W) float32 max.
    """
    t = movie.shape[0]
    n = mesh.shape[axis]
    r = t % n
    if r:
        if t < n:
            mean, mx = movie_summary(movie)
            return mean, mx.astype(jnp.float32)
        head_mean, head_max = movie_summary_sharded(movie[: t - r], mesh,
                                                    axis=axis)
        tail_mean, tail_max = movie_summary(movie[t - r :])
        mean = (head_mean * (t - r) + tail_mean * r) / jnp.float32(t)
        return mean, jnp.maximum(head_max, tail_max.astype(jnp.float32))

    return _sharded_summary_fn(mesh, axis, t)(movie)


@functools.lru_cache(maxsize=32)
def _sharded_summary_fn(mesh, axis: str, t: int):
    """Cached jitted shard_map for :func:`movie_summary_sharded`.

    Module-level cache so REPEAT top-level calls on same-shaped movies
    reuse one executable — a fresh shard_map closure + ``jax.jit(fn)`` per
    call would retrace and recompile every time. ``t`` keys the cache
    because the global mean divides by it inside the mapped fn; jit itself
    re-specializes on the (T, H, W)/dtype of the movie as usual."""

    def local(mv):
        mean_local, max_local = movie_summary(mv)
        s = jax.lax.psum(mean_local * mv.shape[0], axis)
        m = jax.lax.pmax(max_local.astype(jnp.float32), axis)
        return s / jnp.float32(t), m

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(axis, None, None),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )
    return jax.jit(fn)
