"""Neuron-centered training-window sampler (the training-batch hot loop).

Behavioral mirror of the reference generator ``UNet2DSummary._batch_gen``
(``unet_2d_summary.py:434-530``):

- Sample a dataset index from a probability distribution, optionally
  re-weighted from per-dataset validation F1 scores (``1 - mean(F1)``
  normalized; reference ``:482-489``).
- Center a window on a random neuron pixel (pre-computed location tables,
  reference ``:468-472``) with ±5 px jitter, clipped to the dataset's
  training row band; zero-pad at borders (``:495-521``).
- Apply 0..nb_max_augment random D4 generators — composed in the group table
  to a single element per sample (see ops.augment) and applied with one
  vectorized numpy take (``:523-527``).

Host/device split: index generation and window crops are irregular,
data-dependent gathers over tiny 2-D images — they stay on host NumPy. The
produced (B, hw, ww) batches are dense and fixed-shape: they stream to the
device through :class:`Prefetcher`, which keeps the next batch in flight
while the device runs the current step (replaces Keras ``fit_generator``'s
1-deep queue, reference ``:429-430``).
"""

import queue
import threading

import numpy as np

from deepcalcium_tpu.ops.augment import compose_random_walk

__all__ = ["WindowSampler", "Prefetcher", "apply_d4_numpy"]

_D4_NUMPY = [
    lambda a: a,
    lambda a: a[::-1, :],
    lambda a: a[:, ::-1],
    lambda a: np.rot90(a, 1),
    lambda a: np.rot90(a, 2),
    lambda a: np.rot90(a, 3),
    lambda a: np.rot90(a, 1)[::-1, :],
    lambda a: np.rot90(a, 1)[:, ::-1],
]


def apply_d4_numpy(img: np.ndarray, code: int) -> np.ndarray:
    """Apply D4 element ``code`` to a single (H, W) array (host path)."""
    return _D4_NUMPY[code](img)


class WindowSampler:
    """Infinite neuron-centered window batches over multiple datasets."""

    def __init__(self, S_summ, M_summ, names, y_coords, window_shape,
                 nb_max_augment=0, seed=865):
        assert len(S_summ) == len(M_summ) == len(names) == len(y_coords)
        self.S = [np.asarray(s, np.float32) for s in S_summ]
        self.M = [np.asarray(m, np.uint8) for m in M_summ]
        self.names = list(names)
        self.y_coords = list(y_coords)
        self.window_shape = tuple(window_shape)
        self.nb_max_augment = nb_max_augment
        self.rng = np.random.default_rng(seed)

        # Neuron locations restricted to each dataset's sampling row band
        # (reference :468-472). Datasets with no positive pixels in the band
        # are excluded from sampling.
        self.neuron_locs = []
        for m, (ymin, ymax) in zip(self.M, self.y_coords):
            yy, xx = np.where(m[ymin:ymax, :] == 1)
            self.neuron_locs.append(np.stack([yy + ymin, xx], axis=1))
        self.valid = np.array([len(l) > 0 for l in self.neuron_locs])
        if not self.valid.any():
            raise ValueError("no dataset has positive mask pixels in its band")
        self.ds_probs = self.valid / self.valid.sum()

    def reweight(self, name_to_scores: dict) -> None:
        """Adaptive sampling from validation F1 (reference :482-489)."""
        w = np.array(
            [1.0 - float(np.mean(name_to_scores.get(n, [0.0]))) for n in self.names]
        )
        w = np.clip(w, 1e-6, None) * self.valid
        self.ds_probs = w / w.sum()

    def sample_batch(self, batch_size: int):
        hw, ww = self.window_shape
        s_batch = np.zeros((batch_size, hw, ww), np.float32)
        m_batch = np.zeros((batch_size, hw, ww), np.uint8)
        for b in range(batch_size):
            ds = int(self.rng.choice(len(self.S), p=self.ds_probs))
            s, m = self.S[ds], self.M[ds]
            hs, ws = s.shape
            ymin, ymax = self.y_coords[ds]
            locs = self.neuron_locs[ds]
            cy, cx = locs[int(self.rng.integers(0, len(locs)))]
            # ±5 jitter, clipped (reference :512-517).
            cy = min(max(ymin, cy + int(self.rng.integers(-5, 5))), ymax)
            cx = min(max(0, cx + int(self.rng.integers(-5, 5))), ws)
            y0 = max(ymin, int(cy - hw // 2))
            y1 = min(y0 + hw, ymax)
            x0 = max(0, int(cx - ww // 2))
            x1 = min(x0 + ww, ws)
            s_batch[b, : y1 - y0, : x1 - x0] = s[y0:y1, x0:x1]
            m_batch[b, : y1 - y0, : x1 - x0] = m[y0:y1, x0:x1]
            code = compose_random_walk(self.rng, self.nb_max_augment)
            if code:
                s_batch[b] = apply_d4_numpy(s_batch[b], code)
                m_batch[b] = apply_d4_numpy(m_batch[b], code)
        return s_batch, m_batch.astype(np.float32)

    def batches(self, batch_size: int):
        while True:
            yield self.sample_batch(batch_size)


def make_put_fn(mesh=None, kdisp: int = 1):
    """Producer-thread host->device transfer for :class:`Prefetcher`.

    With a ``mesh``, shards the BATCH axis over the mesh's ``data`` axis —
    dim 1 for the (K, B, ...) slabs :func:`stack_batches` emits when
    ``kdisp > 1``, dim 0 for plain (B, ...) batches. Without a mesh, a
    plain single-device ``device_put``. One implementation for the 2-D and
    1-D fit loops (their sharding feeders must not diverge)."""
    import jax

    if mesh is None:
        return lambda b: tuple(jax.device_put(a) for a in b)
    from jax.sharding import NamedSharding, PartitionSpec

    bdim = 1 if kdisp > 1 else 0

    def put_fn(b):
        def sh(x):
            spec = PartitionSpec(
                *([None] * bdim), "data", *([None] * (x.ndim - bdim - 1)))
            return jax.device_put(x, NamedSharding(mesh, spec))

        return tuple(sh(a) for a in b)

    return put_fn


def stack_batches(gen, k: int):
    """Stack ``k`` consecutive (x, y) batches from ``gen`` into one
    (k, B, ...) slab pair — the feeder for ``steps_per_dispatch=k``
    K-scan dispatch (``trainer.make_multi_step``). Runs on the producer
    side (typically inside a :class:`Prefetcher` thread)."""
    while True:
        bs = [next(gen) for _ in range(k)]
        yield (np.stack([b[0] for b in bs]),
               np.stack([b[1] for b in bs]))


class Prefetcher:
    """Background-thread batch producer with a bounded queue.

    Depth-2 by default: one batch transferring/ready while the device chews
    the current one. ``put_fn`` (e.g. a sharded ``jax.device_put``) runs on
    the producer thread so transfer overlaps compute.
    """

    def __init__(self, gen, put_fn=None, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._put = put_fn or (lambda x: x)
        self._err = None

        def run():
            try:
                for item in gen:
                    if self._stop.is_set():
                        return
                    self._q.put(self._put(item))
                self._q.put(None)  # clean exhaustion -> StopIteration
            except Exception as e:  # surfaced on next __next__
                self._err = e
                self._q.put(None)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is None:
            self._q.put(None)  # keep the sentinel for further __next__ calls
            raise self._err or StopIteration
        return item

    def close(self):
        self._stop.set()
        # Drain so the producer can exit.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
