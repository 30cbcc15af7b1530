"""UNet1DSegmentation: spike-segmentation wrapper (fit / predict).

API-parity rebuild of the reference wrapper
(``models/spikes/unet_1d_segmentation.py:177-459``): HDF5 contract
(``traces``/``spikes`` + attr ``name``), per-trace z-normalization, margin
max-pooling of labels, random-split and k-fold cross-validation fits,
best-on-val_F2 checkpointing, full-trace-length prediction.

Mechanics: one fully-convolutional apply serves the 4096-sample training
windows and full-length traces (reflect-padded to a multiple of 16); labels
are margin-pooled once on the host; batches stream through the same
Prefetcher as the 2-D model (host->device transfer on the producer thread),
and ``fit(steps_per_dispatch=K)`` runs K gradient steps per device dispatch
through one ``lax.scan``, as the 2-D loop does.
"""

import functools
import logging
import os
import time
from itertools import cycle
from math import ceil

import jax
import jax.numpy as jnp
import numpy as np

from deepcalcium_tpu.models import unet1d
from deepcalcium_tpu.ops import losses as L
from deepcalcium_tpu.train import trainer as T
from deepcalcium_tpu.train.callbacks import CSVMetricsLogger, plot_metrics_grid
from deepcalcium_tpu.train.checkpoints import load_checkpoint, save_checkpoint
from deepcalcium_tpu.utils.config import checkpoints_dir
from deepcalcium_tpu.utils.runtime import funcname

__all__ = ["UNet1DSegmentation", "get_dataset_attrs", "get_dataset_traces",
           "get_dataset_spikes", "maxpool_labels", "margin_metrics"]


# --- Dataset accessors (reference :151-174) ---------------------------------

def get_dataset_attrs(dspath: str) -> dict:
    import h5py

    with h5py.File(dspath, "r") as fp:
        return {k: v for k, v in fp.attrs.items()}


def get_dataset_traces(dspath: str) -> np.ndarray:
    """Per-trace z-normalized traces with the reference's sanity asserts
    (``:162-167``)."""
    import h5py

    with h5py.File(dspath, "r") as fp:
        traces = fp["traces"][...]
    m = np.mean(traces, axis=1, keepdims=True)
    s = np.std(traces, axis=1, keepdims=True)
    traces = (traces - m) / s
    assert -5 < np.mean(traces) < 5, np.mean(traces)
    assert -5 < np.std(traces) < 5, np.std(traces)
    return traces


def get_dataset_spikes(dspath: str) -> np.ndarray:
    import h5py

    with h5py.File(dspath, "r") as fp:
        return fp["spikes"][...]


def maxpool_labels(spikes: np.ndarray, margin: int) -> np.ndarray:
    """Pre-apply the error margin to labels: max-pool spikes with window
    margin+1, stride 1, SAME (reference ``:385-394`` via K.pool2d).

    Host numpy on purpose: the training batch gen margin-pools each trace
    once up front, and a device pool specializes on every distinct trace
    length — with ragged datasets that is one compile PER LENGTH inside
    the Prefetcher producer thread, for an op that is microseconds on the
    host. Window
    placement matches XLA SAME padding (pad_low = (w-1)//2), pinned
    against ``lax.reduce_window`` in tests/test_unet1d.py.
    """
    x = np.asarray(spikes, np.float32)
    if margin <= 0:
        return x
    w = int(margin) + 1
    lo = (w - 1) // 2
    pad = [(0, 0)] * (x.ndim - 1) + [(lo, w - 1 - lo)]
    xp = np.pad(x, pad, constant_values=-np.inf)
    return np.lib.stride_tricks.sliding_window_view(
        xp, w, axis=-1).max(axis=-1)


def margin_metrics(spikes_true, spikes_pred, margin: int = 4) -> dict:
    """Margin-aware spike scoring.

    The reference's predict docstring (``:426-431``) instructs users to apply
    the error margin to the ground truth before comparing; this helper does
    exactly that: max-pool the true spikes with window margin+1, then compute
    the spike metric set.
    """
    from deepcalcium_tpu.ops import losses as L

    yt = maxpool_labels(np.asarray(spikes_true, np.float32), int(margin))
    yp = np.asarray(spikes_pred, np.float32)
    return {k: float(np.mean(np.asarray(fn(yt, yp))))
            for k, fn in L.SPIKE_METRICS.items()}


def _pad_to_multiple(x: np.ndarray, mult: int):
    t = x.shape[-1]
    pad = (-t) % mult
    if pad == 0:
        return x, t
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)], mode="reflect"), t


class UNet1DSegmentation:
    """Trace -> binary spike segmentation wrapper."""

    def __init__(self, cpdir=None, dataset_attrs_func=get_dataset_attrs,
                 dataset_traces_func=get_dataset_traces,
                 dataset_spikes_func=get_dataset_spikes,
                 net_init_func=unet1d.init, net_apply_func=unet1d.apply,
                 compute_dtype=None):
        self.cpdir = cpdir or os.path.join(checkpoints_dir(), "spikes_unet1d")
        os.makedirs(self.cpdir, exist_ok=True)
        self.dataset_attrs_func = dataset_attrs_func
        self.dataset_traces_func = dataset_traces_func
        self.dataset_spikes_func = dataset_spikes_func
        self.net_init_func = net_init_func
        self.net_apply_func = net_apply_func
        self.compute_dtype = compute_dtype

    # ------------------------------------------------------------------ fit

    def fit(self, dataset_paths, shape=(4096,), error_margin=4, batch=20,
            nb_epochs=20, val_type="random_split", prop_trn=0.8, prop_val=0.2,
            nb_folds=5, learning_rate=2e-3, seed=865, mesh=None,
            steps_per_dispatch=1, weight_decay=0.0,
            prng_impl="threefry2x32", preset=None):
        """Train; returns (metrics_trn, metrics_val, best_model_path) for
        random_split, or aggregated fold metrics for cross_validate.

        Mirrors reference ``fit`` (``:217-380``): loss = wbce(pos=2), metrics
        F2/prec/reca/ytspks/ypspks, 1 epoch = 1 window from every trace.

        ``weight_decay``: > 0 trains with AdamW decoupled decay on conv
        kernels; ``prng_impl``: PRNG implementation for the dropout stream
        ('rbg' draws a different random stream, score-level equivalent) —
        the same knobs as the 2-D ``fit``.

        ``steps_per_dispatch`` (K): run K train steps inside ONE jitted
        ``lax.scan`` dispatch on stacked (K, B, T) batches — amortizes the
        per-step host dispatch cost exactly like the 2-D fit. Must divide
        the per-epoch step count ``ceil(n_train_traces / batch)``.
        Semantically identical to K=1.

        ``preset``: one-flag recipe bundles mirroring the 2-D ``fit``:
        ``None``/``"parity"`` = the reference-faithful defaults above;
        ``"perf"`` = the measured throughput configuration: the largest
        ``steps_per_dispatch`` of (4, 2, 1) that divides each split's
        per-epoch step count (K=4 measured 2.67 vs 5.16 ms/step at K=1 as
        ``fit`` runs it on the H100, batch 20 x 4096, bf16). The PRNG stays
        as given: rbg was not faster there. The preset OVERRIDES
        ``steps_per_dispatch`` and logs it.
        """
        logger = logging.getLogger(funcname())
        # ValueError, not assert: user-facing knob validation must survive
        # python -O (a stripped val_type assert would silently run k-fold
        # on a typo and change the return type).
        if len(shape) != 1:
            raise ValueError(f"shape must be (window_len,), got {shape}")
        # Fail BEFORE loading/z-norming every trace, not at first-step
        # trace time with a cryptic pool shape mismatch: 4 2x T-pools
        # need a window length divisible by 16.
        if shape[0] < 16 or shape[0] % 16:
            raise ValueError(f"shape={shape}: window length must be a "
                             f"multiple of 16 (4 2x pools)")
        if not (0 < prop_trn < 1 and 0 < prop_val < 1):
            raise ValueError(f"prop_trn={prop_trn}, prop_val={prop_val} "
                             f"must lie in (0, 1)")
        if val_type not in ("random_split", "cross_validate"):
            raise ValueError(f"unknown val_type {val_type!r}")
        if nb_folds <= 1:
            raise ValueError(f"nb_folds={nb_folds} must be > 1")
        if abs(prop_trn + prop_val - 1.0) > 1e-9:
            raise ValueError(f"prop_trn + prop_val must be 1, got "
                             f"{prop_trn} + {prop_val}")
        if preset not in (None, "parity", "perf"):
            raise ValueError(f"preset={preset!r}: expected None, 'parity' "
                             f"or 'perf'")
        if preset == "perf":
            # None = per-split auto-K sentinel. Deliberately NOT a user-
            # reachable int: fit(steps_per_dispatch=0) must keep raising
            # ValueError, not silently activate the preset's auto-K.
            steps_per_dispatch = None
            logger.info("preset='perf': auto K-step scan dispatch")

        kdisp_arg = (None if steps_per_dispatch is None
                     else int(steps_per_dispatch))
        traces = [t for p in dataset_paths for t in self.dataset_traces_func(p)]
        spikes = [s for p in dataset_paths for s in self.dataset_spikes_func(p)]
        if len(traces) != len(spikes):
            raise ValueError(f"datasets yield {len(traces)} traces but "
                             f"{len(spikes)} spike rows")
        if not traces:
            raise ValueError(f"no traces in {list(dataset_paths)}")
        rng = np.random.default_rng(seed)

        if val_type == "random_split":
            idxs = rng.permutation(len(traces))
            n_trn = int(len(idxs) * prop_trn)
            idxs_trn = idxs[:n_trn]
            # Complementary split. (The reference's ``idxs[-int(n*prop):]``
            # silently validates on the WHOLE dataset when the slice length
            # rounds to 0 — unet_1d_segmentation.py:337; fixed here.)
            idxs_val = idxs[n_trn:]
            # Non-empty by construction: 0 < prop_trn < 1 (validated above)
            # makes n_trn < len(idxs), and traces is non-empty.
            mt, mv, bmp = self._fit_single(
                traces, spikes, idxs_trn, idxs_val, shape, error_margin,
                batch, nb_epochs, learning_rate, seed, mesh,
                kdisp_arg, weight_decay, prng_impl)
            for k in sorted(mt.keys()):
                logger.info("%-20s trn=%-9.4f val=%-9.4f", k, mt[k], mv[k])
            logger.info("Best model path: %s", bmp)
            return mt, mv, bmp

        # K-fold cross-validation (reference :344-380). array_split spreads
        # the remainder over the first folds — len % nb_folds traces must
        # not silently vanish from every fold (the reference's fixed-size
        # slicing dropped them).
        idxs = rng.permutation(len(traces))
        folds = np.array_split(idxs, nb_folds)
        metrics_trn, metrics_val = [], []
        for val_idx in range(nb_folds):
            idxs_trn = np.concatenate(
                [f for i, f in enumerate(folds) if i != val_idx])
            idxs_val = folds[val_idx]
            logger.info("Cross validation fold = %d", val_idx)
            mt, mv, _ = self._fit_single(
                traces, spikes, idxs_trn, idxs_val, shape, error_margin,
                batch, nb_epochs, learning_rate, seed + val_idx, mesh,
                kdisp_arg, weight_decay, prng_impl)
            metrics_trn.append(mt)
            metrics_val.append(mv)
        agg = {}
        for k in sorted(metrics_trn[0].keys()):
            vt = [m[k] for m in metrics_trn]
            vv = [m[k] for m in metrics_val]
            agg[k] = {"trn_mean": float(np.mean(vt)), "trn_std": float(np.std(vt)),
                      "val_mean": float(np.mean(vv)), "val_std": float(np.std(vv))}
            logger.info("%-20s trn=%-9.4f (%.4f) val=%-9.4f (%.4f)", k,
                        agg[k]["trn_mean"], agg[k]["trn_std"],
                        agg[k]["val_mean"], agg[k]["val_std"])
        return agg

    def _fit_single(self, traces, spikes, idxs_trn, idxs_val, shape, margin,
                    batch, nb_epochs, learning_rate, seed, mesh, kdisp=1,
                    weight_decay=0.0, prng_impl="threefry2x32"):
        logger = logging.getLogger(funcname())
        loss_fn = functools.partial(L.weighted_binary_crossentropy, weightpos=2.0)
        metric_fns = dict(L.SPIKE_METRICS)

        params, state = self.net_init_func(jax.random.PRNGKey(seed))
        optimizer = T.make_optimizer(learning_rate,
                                     weight_decay=weight_decay)
        opt_state = optimizer.init(params)
        # Identity-stable partial: make_eval_forward/make_train_step cache
        # on apply_fn identity; a fresh partial per fold recompiled the
        # eval forward every cross-validation fold.
        apply_fn = T.stable_apply_fn(self, self.net_apply_func,
                                     margin=int(margin),
                                     compute_dtype=self.compute_dtype)
        tr_trn = [traces[i] for i in idxs_trn]
        sp_trn = [spikes[i] for i in idxs_trn]
        tr_val = [traces[i] for i in idxs_val]
        sp_val = [spikes[i] for i in idxs_val]
        steps_trn = int(ceil(len(tr_trn) / batch))
        if kdisp is None:
            # preset='perf' sentinel: the largest supported K that divides
            # THIS split's per-epoch step count (cross-validation folds can
            # differ in size, so the choice is per-split, not per-fit).
            kdisp = next(kk for kk in (4, 2, 1) if steps_trn % kk == 0)
            logger.info("preset='perf': steps_per_dispatch=%d "
                        "(steps_trn=%d)", kdisp, steps_trn)
        # ValueError, not assert: user-facing knob validation must survive
        # python -O (a stripped assert would silently train fewer steps).
        if kdisp < 1 or steps_trn % kdisp != 0:
            raise ValueError(
                f"steps_per_dispatch={kdisp} must divide the per-epoch step "
                f"count ceil(n_train_traces/batch)={steps_trn}")
        if kdisp > 1:
            step = T.make_multi_step(apply_fn, loss_fn, optimizer, kdisp,
                                     metric_fns=metric_fns, mesh=mesh)
        else:
            step = T.make_train_step(apply_fn, loss_fn, optimizer,
                                     metric_fns=metric_fns, mesh=mesh)
        eval_fwd = T.make_eval_forward(apply_fn, mesh=mesh)

        gen = self._batch_gen(tr_trn, sp_trn, shape, batch, margin, seed)
        # Prefetch with host->device transfer on the producer thread (same
        # machinery as the 2-D fit: train/sampler.py::Prefetcher); K-step
        # dispatch stacks K batches into one (K, B, T) slab per dispatch.
        from deepcalcium_tpu.train.sampler import (Prefetcher, make_put_fn,
                                                    stack_batches)

        batch_gen = stack_batches(gen, kdisp) if kdisp > 1 else gen
        prefetch = Prefetcher(batch_gen, put_fn=make_put_fn(mesh, kdisp))
        # Fixed validation batch: two windows from every val trace (:283-284).
        x_val, y_val = next(self._batch_gen(
            tr_val, sp_val, shape, len(tr_val) * 2, margin, seed + 1))

        tic = int(time.time())
        csvlog = CSVMetricsLogger(os.path.join(self.cpdir, f"{tic}_metrics.csv"))
        rng = jax.random.key(seed + 2, impl=prng_impl)
        # Fixed sample batches for the per-epoch prediction plots
        # (reference _SamplePlotCallback, :26-46, plotted <=30; we cap at 8 —
        # 30 full-length matplotlib subplots per epoch dominates wall-clock
        # on small hosts).
        nb_plot = min(8, x_val.shape[0])

        try:
            params, state, opt_state, best_path = self._epoch_loop(
                nb_epochs, steps_trn, kdisp, step, eval_fwd, prefetch,
                metric_fns, x_val, y_val, nb_plot, csvlog, tic, rng,
                params, state, opt_state, logger)
        finally:
            prefetch.close()

        # Reload best and re-evaluate train + val (reference :304-314). The
        # train-side evaluation covers steps_trn batches — one window per
        # training trace, like the reference's evaluate_generator — not a
        # single high-variance batch. A FRESH generator: the training
        # generator is owned by the (now closed) prefetch producer thread.
        assert best_path is not None  # guaranteed by the NaN sanitizer
        gen_eval = self._batch_gen(tr_trn, sp_trn, shape, batch, margin,
                                   seed + 3)
        params, state, _, _ = load_checkpoint(best_path, params, state)
        sums: dict[str, float] = {}
        for _ in range(steps_trn):
            x_trn, y_trn = next(gen_eval)
            out_trn = np.asarray(eval_fwd(params, state, jnp.asarray(x_trn)))
            for k, fn in metric_fns.items():
                sums[k] = sums.get(k, 0.0) + float(
                    np.mean(np.asarray(fn(y_trn, out_trn))))
        mt = {k: v / steps_trn for k, v in sums.items()}
        out_val = np.asarray(eval_fwd(params, state, jnp.asarray(x_val)))
        mv = {k: float(np.mean(np.asarray(fn(y_val, out_val))))
              for k, fn in metric_fns.items()}
        return mt, mv, best_path

    def _epoch_loop(self, nb_epochs, steps_trn, kdisp, step, eval_fwd,
                    prefetch, metric_fns, x_val, y_val, nb_plot, csvlog,
                    tic, rng, params, state, opt_state, logger):
        best_f2, best_path = -1.0, None
        for epoch in range(nb_epochs):
            # Device-side metric accumulation; one host sync per epoch.
            step_metrics: list[dict] = []
            for _ in range(steps_trn // kdisp):
                tb, sb = next(prefetch)
                rng, sub = jax.random.split(rng)
                if kdisp > 1:
                    # ema_decay=None: the ema slot is unused (pass None —
                    # passing params would double-donate its buffers).
                    params, state, opt_state, _, met = step(
                        params, state, opt_state, None, tb, sb, sub)
                else:
                    params, state, opt_state, met = step(
                        params, state, opt_state, tb, sb, sub)
                step_metrics.append(met)
            fetched = jax.device_get(step_metrics)
            # np.mean flattens (K,)-valued multi-step metrics and scalars
            # alike -> identical per-step averaging at any K.
            agg: dict[str, float] = {
                k: float(np.mean([m[k] for m in fetched])) for k in fetched[0]
            }

            # Validation metrics on the fixed batch.
            probs = np.asarray(eval_fwd(params, state, jnp.asarray(x_val)))
            for k, fn in metric_fns.items():
                agg[f"val_{k}"] = float(np.mean(np.asarray(fn(y_val, probs))))
            csvlog.append(epoch, agg)
            plot_metrics_grid(csvlog.history,
                              os.path.join(self.cpdir, f"{tic}_metrics.png"))
            # Sample-prediction plot on fixed validation traces (reference
            # _SamplePlotCallback, :26-46).
            try:
                from deepcalcium_tpu.utils.visualization import plot_traces_spikes

                plot_traces_spikes(
                    x_val[:nb_plot], spikes_true=y_val[:nb_plot],
                    spikes_pred=probs[:nb_plot],
                    title=f"Epoch {epoch} val_F2={agg['val_F2']:.3f}",
                    save_path=os.path.join(
                        self.cpdir, f"{tic}_samples_{epoch:03d}_val.png"))
            except Exception as e:  # plotting must never kill training
                logger.warning("sample plot failed: %s", e)
            logger.info("epoch %d: loss=%.4f F2=%.4f val_F2=%.4f",
                        epoch, agg["loss"], agg["F2"], agg["val_F2"])

            # NaN sanitizer (same policy as the 2D fit): fail loud instead of
            # finishing a diverged run with no checkpoint at all.
            if not np.isfinite(agg["loss"]) or not np.isfinite(agg["val_F2"]):
                raise FloatingPointError(
                    f"non-finite training loss/val_F2 at epoch {epoch}: "
                    f"loss={agg['loss']}, val_F2={agg['val_F2']}")

            # Best-only checkpoint on val_F2 (reference :293-294).
            if agg["val_F2"] > best_f2:
                best_f2 = agg["val_F2"]
                best_path = os.path.join(
                    self.cpdir, f"{tic}_model_val_F2_{best_f2:.3f}_{epoch:03d}.ckpt")
                save_checkpoint(best_path, params, state, opt_state,
                                meta={"epoch": epoch, "val_F2": best_f2})
        return params, state, opt_state, best_path

    def _batch_gen(self, traces, spikes, shape, batch_size, margin, seed):
        """Random fixed-length windows cycling a shuffled trace order
        (reference ``:382-420``); labels are margin-pooled once up front."""
        rng = np.random.default_rng(seed)
        spikes = [np.asarray(maxpool_labels(s[None], margin))[0] for s in spikes]
        wlen = shape[0]
        while True:
            order = cycle(rng.permutation(len(traces)))
            for _ in range(max(1, int(ceil(len(traces) / batch_size)))):
                tb = np.zeros((batch_size, wlen), np.float32)
                sb = np.zeros((batch_size, wlen), np.float32)
                for b in range(batch_size):
                    idx = next(order)
                    t, s = traces[idx], spikes[idx]
                    if len(t) <= wlen:
                        tb[b, : len(t)] = t
                        sb[b, : len(s)] = s
                    else:
                        x0 = int(rng.integers(0, len(t) - wlen))
                        tb[b] = t[x0 : x0 + wlen]
                        sb[b] = s[x0 : x0 + wlen]
                yield tb, sb

    # -------------------------------------------------------------- predict

    def predict(self, dataset_paths, model_path, batch=32, threshold=0.5,
                error_margin=4, mesh=None, fast="auto"):
        """Full-trace-length spike prediction (reference ``:422-459``):
        :meth:`predict_proba` thresholded to uint8 decisions.

        # Returns
            (list of (N, T) uint8 arrays, list of dataset names)
        """
        probs_all, names_all = self.predict_proba(
            dataset_paths, model_path, batch=batch,
            error_margin=error_margin, mesh=mesh, fast=fast)
        return ([(p > threshold).astype(np.uint8) for p in probs_all],
                names_all)

    def predict_proba(self, dataset_paths, model_path, batch=32,
                      error_margin=4, mesh=None, fast="auto"):
        """Full-trace-length spike probabilities, (N, T) float32 per dataset.

        Traces are reflect-padded to a multiple of 16 (4 pools) and cropped
        back — no model rebuild needed. ``model_path`` may be a native
        ``.ckpt`` or a Keras ``.hdf5`` (imported via interop.keras_import).

        ``fast``: dispatch the T-packed inference rewrite
        (``models/unet1d_fast.apply_fast_t`` — numerically equivalent)
        when the stock net is in use; True/False forces. On the H100 it is
        the faster forward at full trace length (3.1-3.2 vs 3.9-4.0 ms for
        32 x 30,000 samples, bf16).
        """
        if str(model_path).endswith((".hdf5", ".h5")):
            from deepcalcium_tpu.interop.keras_import import load_unet1d_keras

            params, state = load_unet1d_keras(model_path)
        else:
            params0, state0 = self.net_init_func(jax.random.PRNGKey(0))
            params, state, _, _ = load_checkpoint(model_path, params0, state0)
        use_fast = (fast is True or
                    (fast == "auto" and self.net_apply_func is unet1d.apply))
        if use_fast:
            from deepcalcium_tpu.models.unet1d_fast import apply_fast_t

            net = apply_fast_t
            logging.getLogger(funcname()).info(
                "fast=%r: dispatching the T-packed inference forward "
                "(models/unet1d_fast.apply_fast_t — numerically "
                "equivalent)", fast)
        else:
            net = self.net_apply_func
        # Identity-stable partial (make_eval_forward is lru_cached on it).
        apply_fn = T.stable_apply_fn(self, net, margin=int(error_margin),
                                     compute_dtype=self.compute_dtype)
        fwd = T.make_eval_forward(apply_fn, mesh=mesh)

        # Slab batching via the shared pad/crop policy (one compiled batch
        # shape, mesh-aware padding/sharding) instead of a re-rolled loop:
        # the local version padded the tail only when the dataset exceeded
        # `batch`, so every smaller dataset compiled its own batch shape,
        # and it never sharded slabs for the mesh path.
        from deepcalcium_tpu.train.evaluate import _run_batched

        probs_all, names_all = [], []
        for p in dataset_paths:
            names_all.append(self.dataset_attrs_func(p)["name"])
            traces = self.dataset_traces_func(p).astype(np.float32)
            padded, t = _pad_to_multiple(traces, 16)
            out = _run_batched(fwd, params, state, padded, mesh=mesh,
                               max_batch=batch)
            probs_all.append(np.asarray(out[:, :t]))
        return probs_all, names_all
