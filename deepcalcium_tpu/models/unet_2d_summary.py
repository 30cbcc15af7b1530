"""UNet2DSummary: the neuron-segmentation model wrapper (fit / predict).

API-parity rebuild of the reference wrapper class
(``models/neurons/unet_2d_summary.py:301-625``), keeping its
function-injection composability (``dataset_name_func`` /
``series_summary_func`` / ``mask_summary_func`` / net builder) while swapping
the machinery underneath:

reference (Keras/TF, 1 GPU)                 -> this module (JAX, device mesh)
---------------------------------------------------------------------------
two models at two shapes + hdf5 rewrite     -> one fully-convolutional apply
fit_generator w/ 1-deep queue               -> Prefetcher + donated jit step
per-epoch val predict, 6 views, loop        -> one batched sharded forward
8x TTA loop of host->GPU predicts           -> one fused (8B, H, W) forward
ModelCheckpoint hdf5                        -> atomic npz pytree ckpts
ReduceLROnPlateau callback                  -> host-side policy + lr inject
CSVLogger/MetricsPlotCallback               -> CSVMetricsLogger/plot grid
scores pickle for adaptive sampling         -> in-process dict hand-off
"""

import functools
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from deepcalcium_tpu.metrics.neurofinder import nf_mask_metrics
from deepcalcium_tpu.models import unet2d
from deepcalcium_tpu.ops import losses as L
from deepcalcium_tpu.ops.mask_summary import mask_summary_exact
from deepcalcium_tpu.train import trainer as T
from deepcalcium_tpu.train.callbacks import CSVMetricsLogger, plot_metrics_grid
from deepcalcium_tpu.train.checkpoints import load_checkpoint, save_checkpoint
from deepcalcium_tpu.train.evaluate import (make_movie_evaluator,
                                            predict_batched, predict_tta)
from deepcalcium_tpu.train.sampler import (Prefetcher, WindowSampler,
                                            make_put_fn, stack_batches)
from deepcalcium_tpu.utils.config import checkpoints_dir
from deepcalcium_tpu.utils.runtime import funcname

__all__ = ["UNet2DSummary", "summarize_series", "summarize_mask",
           "summarize_mask_stencil", "name_dataset"]


# --- Default dataset accessors (reference unet_2d_summary.py:227-298) -------

def summarize_series(dspath: str) -> np.ndarray:
    """z-normalized mean summary image (reference ``_summarize_series``)."""
    import h5py

    with h5py.File(dspath, "r") as fp:
        summ = fp["series/mean"][...].astype(np.float32)
    return (summ - np.mean(summ)) / np.std(summ)


def summarize_mask(dspath: str) -> np.ndarray:
    """Flattened, conflict-eroded mask summary (reference
    ``_summarize_mask``; exact sequential semantics — see ops.mask_summary)."""
    import h5py

    with h5py.File(dspath, "r") as fp:
        if "masks" not in fp:
            raise KeyError(
                f"{dspath} has no ground-truth masks (a .test set?) — "
                f"scoring/outlines against ground truth need masks/raw")
        msks = fp["masks/raw"][...]
    return mask_summary_exact(msks)


def summarize_mask_stencil(dspath: str) -> np.ndarray:
    """Mask summary via the vectorized parallel-stencil APPROXIMATION
    (:func:`~deepcalcium_tpu.ops.mask_summary.mask_summary_stencil`) —
    a tested alternative implementation, NOT a production path (status
    settled round 4: the exact walk runs once per dataset on the host,
    nowhere near a hot loop, so this variant earns no default caller).
    Opt in through the injection point if jit-able target generation is
    worth the documented divergence:

        UNet2DSummary(mask_summary_func=summarize_mask_stencil).fit(...)

    Targets may differ from the exact walk by a few OVER-deleted pixels
    on chains of touching neurons (never added pixels —
    tests/test_mask_summary.py bounds the divergence); the exact default
    is required wherever bit-parity with the reference targets matters
    (scoring, golden comparisons).
    """
    import h5py

    with h5py.File(dspath, "r") as fp:
        if "masks" not in fp:
            raise KeyError(
                f"{dspath} has no ground-truth masks (a .test set?) — "
                f"scoring/outlines against ground truth need masks/raw")
        msks = fp["masks/raw"][...]
    from deepcalcium_tpu.ops.mask_summary import mask_summary_stencil

    return np.asarray(mask_summary_stencil(msks), np.float64)


def name_dataset(dspath: str) -> str:
    import h5py

    with h5py.File(dspath, "r") as fp:
        name = fp.attrs["name"]
    return name if isinstance(name, str) else name.decode()


class UNet2DSummary:
    """Neuron-segmentation wrapper around the functional UNet2DS."""

    def __init__(self, cpdir=None, dataset_name_func=name_dataset,
                 series_summary_func=summarize_series,
                 mask_summary_func=summarize_mask,
                 net_init_func=unet2d.init, net_apply_func=unet2d.apply,
                 compute_dtype=None, remat=False):
        self.cpdir = cpdir or os.path.join(checkpoints_dir(), "neurons_unet2ds")
        os.makedirs(self.cpdir, exist_ok=True)
        self.dataset_name_func = dataset_name_func
        self.series_summary_func = series_summary_func
        self.mask_summary_func = mask_summary_func
        self.net_init_func = net_init_func
        self.net_apply_func = net_apply_func
        self.compute_dtype = compute_dtype
        # remat: rematerialize conv blocks on the backward pass — the knob
        # for training at large windows (e.g. shape_trn=512²) where
        # activations would otherwise exceed HBM. Training-only; predict
        # has no backward pass.
        self.remat = remat

    def _resolve_apply_fn(self, fast, params, shapes, train=False,
                          remat=False):
        """Pick the forward for this call and return it as an
        identity-STABLE partial (cached per (net, dtype, remat): the
        evaluator/forward builders are lru_cached on apply_fn, so a fresh
        partial per call would force a recompile).

        ``fast``: True forces the W-packed rewrite
        (models/unet2d_fast.py), False forces ``self.net_apply_func``, and
        "auto" uses the inference rewrite iff the stock net, a
        transpose-mode checkpoint, and %16 ``shapes`` are in play. For the
        training step "auto" always keeps ``self.net_apply_func``: on the
        H100 the W-packed gradient step is slower than the plain one (6.1
        vs 4.2 ms at batch 20 @ 128², bf16), while the W-packed inference
        forward is faster (3.6-3.9 vs 4.6-4.7 ms for the 8-view 512² TTA
        batch, bf16).
        """
        use_fast = (fast is True or
                    (fast == "auto" and not train
                     and self.net_apply_func is unet2d.apply
                     and "up0_tconv" in params
                     and all(s % 16 == 0 for shp in shapes for s in shp)))
        if use_fast:
            from deepcalcium_tpu.models.unet2d_fast import (apply_fast_w,
                                                            apply_fast_w_train)

            net = apply_fast_w_train if train else apply_fast_w
            # Self-documenting dispatch (parity-sensitive runs need to know
            # which forward produced a trajectory: the W-packed TRAINING
            # step draws dropout in packed layout — a different random
            # sequence than the parity path at the same seed, though
            # score-level equivalent).
            logging.getLogger(funcname()).info(
                "fast=%r: dispatching the W-packed %s forward "
                "(models/unet2d_fast.%s — numerically %s)", fast,
                "training" if train else "inference",
                "apply_fast_w_train" if train else "apply_fast_w",
                "equivalent up to dropout-draw order" if train
                else "equivalent")
        else:
            net = self.net_apply_func
        kw = {"compute_dtype": self.compute_dtype}
        if remat:
            kw["remat"] = True
        return T.stable_apply_fn(self, net, **kw)

    # ------------------------------------------------------------------ fit

    def fit(self, dataset_paths, model_path=None, proceed=False,
            shape_trn=(96, 96), shape_val=(512, 512), batch_size_trn=32,
            nb_steps_trn=200, nb_epochs=20, prop_trn=0.75, prop_val=0.25,
            learning_rate=2e-3, loss="binary_crossentropy", seed=865,
            mesh=None, adaptive_sampling=False, nb_max_augment=15,
            epoch_callbacks=(), profile_dir=None, ema_decay=None,
            lr_schedule="plateau", steps_per_dispatch=1, fast_train="auto",
            weight_decay=0.0, prng_impl="threefry2x32", preset=None):
        """Train; returns (history dict, best checkpoint path).

        Signature mirrors the reference ``fit`` (``unet_2d_summary.py:
        333-432``): row-split train/validation bands per dataset, per-epoch
        Neurofinder validation on 6 augmented full-image copies, checkpoints
        every epoch named by val F1, ReduceLROnPlateau on train F1.

        ``epoch_callbacks``: the extension point the reference exposed as
        ``keras_callbacks`` (:427) — callables ``f(epoch, logs_dict)`` run at
        the end of every epoch.

        ``adaptive_sampling`` defaults to False for parity: the reference's
        fit never wires ``scores_path`` into its generator (:419 constructs
        the validation callback without it), so its adaptive re-weighting
        machinery (:482-489) is dormant by default too.

        ``ema_decay`` (e.g. 0.999): beyond-reference option — validate and
        checkpoint a Polyak average of the weights instead of the raw
        iterates (stabilizes the full-image thresholded metric).

        ``lr_schedule``: ``"plateau"`` (parity default: ReduceLROnPlateau on
        train F1, reference :425-426), ``"cosine"`` (beyond-reference:
        anneal ``learning_rate`` -> 1e-4 over ``nb_epochs``), or a callable
        ``f(next_epoch) -> lr`` for custom schedules.

        ``steps_per_dispatch`` (K): run K train steps inside ONE jitted
        ``lax.scan`` dispatch on stacked (K, B, ...) batches — amortizes
        the per-step host dispatch cost. Must divide ``nb_steps_trn``.
        Semantically identical to K=1 including per-step EMA; only the
        host-visible metric granularity changes (still per-step).

        ``fast_train``: True runs the gradient step through the W-packed
        forward (``models/unet2d_fast.apply_fast_w_train`` — same training
        dynamics up to float reassociation and dropout randomness).
        "auto" and False keep ``net_apply_func``, which is the faster step
        on the H100 (see ``_resolve_apply_fn``).

        ``weight_decay``: > 0 trains with AdamW decoupled decay — the
        capacity-control axis the reference's hyperparameter search swept
        as Keras ``l2(λ)`` (see ``trainer.make_optimizer``).

        ``prng_impl``: JAX PRNG implementation for the dropout stream —
        ``"threefry2x32"`` (default, splittable gold standard) or ``"rbg"``.
        The two draw different random sequences; seeds are not comparable
        across impls. On the H100 rbg is not faster as ``fit`` runs the
        step (batch 20 @ 128², bf16: 4.13 vs 4.10 ms/step at K=4, 7.92 vs
        6.61 at K=1).

        ``preset``: one-flag recipe bundles (the reference's ergonomics
        were one command — reference ``README.md:23``):
        ``None``/``"parity"`` = the Keras-faithful defaults above;
        ``"perf"`` = the measured throughput configuration: the largest
        ``steps_per_dispatch`` of (4, 2, 1) that divides ``nb_steps_trn``
        (K=4 measured 4.10 vs 6.61 ms/step at K=1 as ``fit`` runs it on
        the H100, batch 20 @ 128², bf16). It changes no numerics: the step is the same, only
        dispatched K at a time. The preset OVERRIDES
        ``steps_per_dispatch`` and logs it.
        """
        logger = logging.getLogger(funcname())
        # ValueError, not assert: user-facing knob validation must survive
        # python -O (a stripped assert silently mis-trains).
        if shape_trn[0] != shape_trn[1] or shape_val[0] != shape_val[1]:
            raise ValueError(f"square windows required: {shape_trn}, "
                             f"{shape_val}")
        # Fail BEFORE the disk-bound dataset summaries, not minutes later
        # with a cryptic jnp.maximum shape mismatch at first-step trace
        # time: 4 2x pools need window sides divisible by 16.
        for nm, shp in (("shape_trn", shape_trn), ("shape_val", shape_val)):
            if shp[0] < 16 or shp[0] % 16:
                raise ValueError(f"{nm}={shp}: window sides must be "
                                 f"multiples of 16 (4 2x pools)")
        if not (0 < prop_trn < 1 and 0 < prop_val < 1):
            raise ValueError(f"prop_trn={prop_trn}, prop_val={prop_val} "
                             f"must lie in (0, 1)")
        if proceed and not model_path:
            raise ValueError("proceed=True requires model_path")
        if preset not in (None, "parity", "perf"):
            raise ValueError(f"preset={preset!r}: expected None, 'parity' "
                             f"or 'perf'")
        if preset == "perf":
            steps_per_dispatch = next(
                k for k in (4, 2, 1) if nb_steps_trn % k == 0)
            logger.info("preset='perf': steps_per_dispatch=%d (K-step "
                        "lax.scan dispatch)", steps_per_dispatch)
        kdisp = int(steps_per_dispatch)
        # ValueError, not assert (must survive python -O), and validated
        # FIRST: a knob typo must not cost the minutes of disk-bound
        # dataset summaries + init below before failing.
        if kdisp < 1 or nb_steps_trn % kdisp != 0:
            raise ValueError(
                f"steps_per_dispatch={kdisp} must be >= 1 and divide "
                f"nb_steps_trn={nb_steps_trn}")
        loss_fn = L.LOSSES[loss] if isinstance(loss, str) else loss
        if model_path == "latest":
            # Preemption recovery: resume from the newest checkpoint in
            # cpdir (atomic writes guarantee it is never torn).
            from deepcalcium_tpu.train.checkpoints import latest_checkpoint

            model_path = latest_checkpoint(self.cpdir)
            if model_path is None:
                raise FileNotFoundError(
                    f"model_path='latest' but no checkpoint exists in "
                    f"{self.cpdir} — a misconfigured resume must not "
                    f"silently train from scratch")
            logger.info("resuming from latest checkpoint: %s", model_path)

        # Summaries (reference :402-404).
        names = [self.dataset_name_func(p) for p in dataset_paths]
        S = [self.series_summary_func(p) for p in dataset_paths]
        M = [self.mask_summary_func(p) for p in dataset_paths]

        # Row bands: train from the top, validate at the bottom (:406-409).
        yctrn = [(0, int(s.shape[0] * prop_trn)) for s in S]
        ycval = [(s.shape[0] - int(s.shape[0] * prop_val), s.shape[0]) for s in S]
        for nm, s_ in zip(names, S):
            # A zero-row band crashes with an obscure zero-size reduction at
            # the END of epoch 0 (after compile + a full epoch) — fail now.
            if int(s_.shape[0] * prop_val) < 1 or int(s_.shape[0] * prop_trn) < 1:
                raise ValueError(
                    f"{nm}: prop_trn={prop_trn}/prop_val={prop_val} round "
                    f"to an empty row band on a {s_.shape[0]}-row image")

        # Model + optimizer.
        optimizer = T.make_optimizer(learning_rate, weight_decay=weight_decay)
        if model_path and str(model_path).endswith((".hdf5", ".h5")):
            # Warm start / fine-tune from a Keras checkpoint — the
            # reference's fit(model_path=..., proceed=...) continuation
            # (unet_2d_summary.py:383-394 via keras_helpers.py:24-68).
            # Keras HDF5 carries Adam slots in a layout we deliberately do
            # not translate; the optimizer restarts fresh either way.
            from deepcalcium_tpu.interop.keras_import import load_unet2ds_keras

            params, state = load_unet2ds_keras(model_path)
            opt_state = optimizer.init(params)
            if proceed:
                logger.info(
                    "proceed=True with a Keras checkpoint: weights resume, "
                    "optimizer state restarts fresh (Adam slots are not "
                    "translated)")
        else:
            params, state = self.net_init_func(jax.random.PRNGKey(seed))
            opt_state = optimizer.init(params)
            if model_path:
                opt_like = opt_state if proceed else None
                params, state, opt_loaded, _ = load_checkpoint(
                    model_path, params, state, opt_like)
                if proceed and opt_loaded is not None:
                    opt_state = opt_loaded

        apply_fn = self._resolve_apply_fn(fast_train, params,
                                          (shape_trn, shape_val),
                                          train=True, remat=self.remat)
        if kdisp > 1:
            step = T.make_multi_step(apply_fn, loss_fn, optimizer, kdisp,
                                     ema_decay=ema_decay, mesh=mesh)
        else:
            step = T.make_train_step(apply_fn, loss_fn, optimizer, mesh=mesh)
        eval_fwd = T.make_eval_forward(apply_fn, mesh=mesh)

        # Sampler + device prefetch. With K-step dispatch the producer
        # thread stacks K batches into one (K, B, ...) slab per dispatch.
        sampler = WindowSampler(S, M, names, yctrn, shape_trn,
                                nb_max_augment=nb_max_augment, seed=seed)
        raw_gen = sampler.batches(batch_size_trn)
        batch_gen = stack_batches(raw_gen, kdisp) if kdisp > 1 else raw_gen
        # Host->device transfer on the producer thread so it overlaps the
        # previous step's compute.
        prefetch = Prefetcher(batch_gen, put_fn=make_put_fn(mesh, kdisp))

        # Observability.
        tic = int(time.time())
        csvlog = CSVMetricsLogger(os.path.join(self.cpdir, f"{tic}_metrics.csv"))
        if lr_schedule == "plateau":
            plateau = T.ReduceLROnPlateau(factor=0.5, patience=5, min_lr=1e-4)
            next_lr = lambda epoch, agg, lr: plateau.update(agg.get("F1", 0.0), lr)
        elif lr_schedule == "cosine":
            cosine = T.CosineDecay(learning_rate, nb_epochs, min_lr=1e-4)
            next_lr = lambda epoch, agg, lr: cosine.lr_at(epoch + 1)
        elif callable(lr_schedule):
            next_lr = lambda epoch, agg, lr: float(lr_schedule(epoch + 1))
        else:
            raise ValueError(f"unknown lr_schedule: {lr_schedule!r}")
        rng = jax.random.key(seed + 1, impl=prng_impl)

        best_f1, best_path = -1.0, None
        history: dict[str, list] = {}
        # Real copies: the step donates the params buffers each iteration.
        ema_params = jax.tree.map(jnp.copy, params) if ema_decay else None
        if ema_decay:
            # Measured pitfall (docs/VALIDATION.md): decay 0.999 over an
            # 800-step run leaves the average ~45% initialization — val
            # metrics stay near zero and the best checkpoint is garbage.
            w0 = float(ema_decay) ** (nb_steps_trn * nb_epochs)
            if w0 > 0.05:
                logger.warning(
                    "ema_decay=%s over %d total steps keeps %.0f%% of the "
                    "INIT weights in the average; use decay <= %.4f or more "
                    "steps, or expect near-zero validation metrics.",
                    ema_decay, nb_steps_trn * nb_epochs, 100 * w0,
                    0.05 ** (1.0 / max(1, nb_steps_trn * nb_epochs)))
        from deepcalcium_tpu.utils.profiling import trace

        try:
            for epoch in range(nb_epochs):
                t0 = time.time()
                # Keep per-step metrics as device arrays; fetching them here
                # would force a host sync every step and serialize the
                # pipeline.
                step_metrics: list[dict] = []
                # Profile the first post-compile epoch (epoch 1), or epoch 0
                # when it is the only one.
                profile_epoch = 1 if nb_epochs > 1 else 0
                with trace(profile_dir if epoch == profile_epoch else None):
                    for _ in range(nb_steps_trn // kdisp):
                        sb, mb = next(prefetch)
                        rng, sub = jax.random.split(rng)
                        if kdisp > 1:
                            (params, state, opt_state, ema_params,
                             met) = step(params, state, opt_state,
                                         ema_params, sb, mb, sub)
                        else:
                            params, state, opt_state, met = step(
                                params, state, opt_state, sb, mb, sub)
                            if ema_decay:
                                ema_params = T.ema_update(
                                    ema_params, params, ema_decay)
                        step_metrics.append(met)
                # One sync per epoch: fetch and average.
                fetched = jax.device_get(step_metrics)
                agg: dict[str, float] = {
                    k: float(np.mean([m[k] for m in fetched]))
                    for k in fetched[0]
                }

                # Full-image Neurofinder validation (reference :31-120);
                # with EMA enabled, the averaged weights are what get
                # validated and checkpointed.
                eval_params = ema_params if ema_decay else params
                vmet, name_to_f1 = self._validate(
                    eval_fwd, eval_params, state, S, M, names, ycval,
                    shape_val, mesh, epoch)
                agg.update(vmet)
                # NaN sanitizer (SURVEY §5): a diverged run should fail loud
                # and early, not checkpoint garbage for hours.
                if not np.isfinite(agg["loss"]):
                    raise FloatingPointError(
                        f"non-finite training loss at epoch {epoch}: "
                        f"{agg['loss']} (lr={T.current_lr(opt_state)})")
                agg["lr"] = T.current_lr(opt_state)
                agg["epoch_seconds"] = time.time() - t0
                csvlog.append(epoch, agg)
                for k, v in agg.items():
                    history.setdefault(k, []).append(v)
                plot_metrics_grid(csvlog.history,
                                  os.path.join(self.cpdir, f"{tic}_metrics.png"),
                                  title=f"epoch {epoch}")
                logger.info(
                    "epoch %d: loss=%.4f F1=%.4f val_nf_f1_mean=%.4f (%.1fs)",
                    epoch, agg["loss"], agg.get("F1", 0.0),
                    agg["val_nf_f1_mean"], agg["epoch_seconds"])

                # Checkpoint every epoch, named like the reference (:423).
                cp = os.path.join(
                    self.cpdir,
                    f"{tic}_model_{epoch:02d}_{agg['val_nf_f1_mean']:.3f}.ckpt")
                save_checkpoint(cp, eval_params, state, opt_state,
                                meta={"epoch": epoch, **{k: float(v) for k, v in agg.items()}})
                if agg["val_nf_f1_mean"] > best_f1:
                    best_f1, best_path = agg["val_nf_f1_mean"], cp

                # LR schedule step: plateau on train F1 (:425-426) by
                # default, or the configured alternative.
                opt_state = T.set_lr(
                    opt_state, next_lr(epoch, agg, T.current_lr(opt_state)))

                # Adaptive dataset re-weighting from val F1 (:482-489).
                if adaptive_sampling:
                    sampler.reweight(name_to_f1)

                for cb in epoch_callbacks:
                    cb(epoch, agg)
        finally:
            prefetch.close()

        return history, best_path

    def _validate(self, eval_fwd, params, state, S, M, names, ycval,
                  shape_val, mesh, epoch):
        """Per-epoch Neurofinder metrics on 6 augmented full-image copies.

        Mirror of ``_ValidationMetricsCB`` (``unet_2d_summary.py:31-120``):
        views = {identity, fliplr, flipud, rot90x3} of each dataset; metrics
        are computed on the validation rows only, then mean/median/min/adj
        with the reference's epsilon tiebreaker (:104-112). All views run in
        ONE batched (sharded) forward.
        """
        views, view_meta = [], []
        for s, m, name, (y0, y1) in zip(S, M, names, ycval):
            vm = np.zeros(s.shape, np.uint8)
            vm[y0:y1, :] = 1
            for f in (lambda x: x, np.fliplr, np.flipud,
                      lambda x: np.rot90(x, 1), lambda x: np.rot90(x, 2),
                      lambda x: np.rot90(x, 3)):
                fs, fm, fv = f(s), f(m), f(vm)
                yy, xx = np.where(fv == 1)
                views.append(fs)
                # NOTE: max() used as an EXCLUSIVE slice bound drops the last
                # row/column of the band — kept deliberately: it reproduces
                # the reference's crop exactly (unet_2d_summary.py:53,84-91),
                # and the val_nf_* numbers must be comparable to it.
                view_meta.append((fm, name, (yy.min(), yy.max(), xx.min(), xx.max())))

        probs = predict_batched(eval_fwd, params, state, views,
                                window=shape_val, mesh=mesh)
        pp, rr, ff = [], [], []
        name_to_f1: dict[str, list] = {}
        for mp, (m, name, (y0, y1, x0, x1)) in zip(probs, view_meta):
            p, r, _, _, f = nf_mask_metrics(
                m[y0:y1, x0:x1], np.round(mp[y0:y1, x0:x1]))
            pp.append(p)
            rr.append(r)
            ff.append(f)
            name_to_f1.setdefault(name, []).append(f)

        eps = 1e-4 * epoch if epoch else 0.0
        return {
            "val_nf_f1_mean": float(np.mean(ff) + eps),
            "val_nf_f1_median": float(np.median(ff) + eps),
            "val_nf_f1_min": float(np.min(ff) + eps),
            "val_nf_f1_adj": float(np.mean(ff) * np.min(ff) + eps),
            "val_nf_prec": float(np.mean(pp)),
            "val_nf_reca": float(np.mean(rr)),
        }, name_to_f1

    # -------------------------------------------------------------- predict

    def _load_params(self, model_path):
        """Load (params, state) from a native .ckpt or a Keras .hdf5.

        ``model_path='latest'`` resolves to the newest checkpoint in this
        model's ``cpdir`` — same convention as ``fit`` (predict/evaluate/
        segment accept it too, so "train then predict" needs no filename
        plumbing)."""
        if model_path == "latest":
            from deepcalcium_tpu.train.checkpoints import latest_checkpoint

            resolved = latest_checkpoint(self.cpdir)
            if resolved is None:
                raise FileNotFoundError(
                    f"model_path='latest' but no checkpoint exists in "
                    f"{self.cpdir}")
            model_path = resolved
        # Provenance: the RESOLVED checkpoint must be in the logs (a bare
        # "Loaded model from latest" identifies nothing).
        logging.getLogger(funcname()).info("loading params from %s",
                                           model_path)
        if str(model_path).endswith((".hdf5", ".h5")):
            from deepcalcium_tpu.interop.keras_import import load_unet2ds_keras

            return load_unet2ds_keras(model_path)
        params0, state0 = self.net_init_func(jax.random.PRNGKey(0))
        params, state, _, _ = load_checkpoint(model_path, params0, state0)
        return params, state

    def evaluate_movie(self, movie, model_path=None, params=None, state=None,
                       window_shape=(512, 512), tta=True, threshold=0.5,
                       mesh=None, fast="auto"):
        """Segment a raw movie end-to-end in ONE device dispatch: streaming
        mean summary -> z-norm -> reflect-pad -> (8x TTA) forward ->
        threshold. This is the fused pipeline the benchmark measures —
        library users get the same graph (reference counterpart: the full
        ingest+summarize+predict path, ``unet_2d_summary.py:532-625`` fed by
        ``nf.py:126-130``).

        # Arguments
            movie: (T, H, W) array (host or device), or a contract-HDF5 path
                (reads ``series/raw``).
            model_path: .ckpt or Keras .hdf5 — or pass ``params``+``state``
                directly (skips the load; e.g. reuse across movies).
            window_shape: inference window; frames reflect-pad up to it.
            tta: run the fused 8-view test-time-augmentation batch.
            mesh: optional Mesh — time axis of the summary shards over it.
            fast: use the W-packed inference rewrite
                (models/unet2d_fast.py ``apply_fast_w``: width-only
                space-to-depth W4@L0/W2@L1 with free seams, folded BN,
                sigmoid head — numerically equivalent; the faster forward
                on the H100). "auto" = when the stock net is in use;
                True/False forces.

        # Returns
            (mask uint8 (H, W), prob float32 (H, W)) as host arrays.

        Compile-cache note: the fused device graph specializes on the
        movie's full (T, H, W) shape, so movies of differing T each compile
        once. The streaming path (taken for HDF5 inputs) only specializes
        on (H, W); for summary-image fleets use ``predict``, which is
        T-free by construction.
        """
        if params is None:
            if model_path is None:
                raise ValueError("need model_path or params+state")
            params, state = self._load_params(model_path)
        elif state is None:
            # Fail here, not at trace time inside fold_bn with a cryptic
            # NoneType subscript far from the call site.
            raise ValueError("params given without state — pass both "
                             "(state carries the BN moving stats)")
        apply_fn = self._resolve_apply_fn(fast, params, (window_shape,))

        from deepcalcium_tpu.train.evaluate import (evaluate_movie_streaming,
                                                    evaluate_movie_tiled)

        def oversized(h, w):
            return h > window_shape[0] or w > window_shape[1]

        if isinstance(movie, (str, os.PathLike)):
            # Stream straight off disk: chunked reads fold through
            # StreamingSummary and only the mean image reaches the forward —
            # the raw movie never fully materializes in RAM.
            import h5py

            with h5py.File(movie, "r") as fp:
                raw = fp["series/raw"]
                ev = (evaluate_movie_tiled if oversized(*raw.shape[1:])
                      else evaluate_movie_streaming)
                mask, prob, _ = ev(
                    apply_fn, params, state, raw,
                    window=window_shape, tta=tta, threshold=threshold,
                    mesh=mesh)
            return mask, prob
        if oversized(*movie.shape[1:]):
            # Frames exceed the inference window: sliding-window tiled
            # evaluate (streaming summary; only tile batches reach the
            # forward) — the fused single-window evaluator can't pad DOWN.
            mask, prob, _ = evaluate_movie_tiled(
                apply_fn, params, state, np.asarray(movie),
                window=window_shape, tta=tta, threshold=threshold, mesh=mesh)
            return mask, prob
        evaluator = make_movie_evaluator(
            apply_fn, movie.shape, window=window_shape, tta=tta,
            threshold=threshold, mesh=mesh)
        mask, prob, _ = evaluator(params, state, jnp.asarray(movie))
        return np.asarray(mask), np.asarray(prob)

    def predict(self, dataset_paths, model_path, window_shape=(512, 512),
                print_scores=False, save=False, augmentation=False,
                threshold=0.5, mesh=None, max_batch=None, fast="auto"):
        """Predict masks; returns (Mp, names) like the reference
        (``unet_2d_summary.py:532-625``). ``augmentation=True`` runs the
        fused 8x TTA batch.

        ``model_path`` may be a native ``.ckpt`` OR a Keras ``.hdf5``/``.h5``
        checkpoint (e.g. the reference's released ``unet2ds_model.hdf5``) —
        Keras files are imported through interop.keras_import transparently.

        ``fast``: dispatch the W-packed inference rewrite
        (``models/unet2d_fast.apply_fast_w`` — numerically equivalent) when
        the stock net is in use; True/False forces.
        """
        logger = logging.getLogger(funcname())
        params, state = self._load_params(model_path)
        logger.info("Loaded model from %s.", model_path)

        apply_fn = self._resolve_apply_fn(fast, params, (window_shape,))
        fwd = T.make_eval_forward(apply_fn, mesh=mesh)

        names = [self.dataset_name_func(p) for p in dataset_paths]
        S = [self.series_summary_func(p) for p in dataset_paths]

        from deepcalcium_tpu.utils.runtime import phase_timer

        # Images larger than the window dispatch to the sliding-window tiled
        # path (beyond-reference: the reference asserts 512² fields of view,
        # unet_2d_summary.py:565-566); in-window images run as ONE batch.
        from deepcalcium_tpu.train.evaluate import predict_tiled, tile_grid

        hw, ww = window_shape
        fits = [s.shape[0] <= hw and s.shape[1] <= ww for s in S]
        predictor = predict_tta if augmentation else predict_batched

        def ntiles(s):
            """Window-sized forwards an image costs: 1 in-window, else the
            tiled path's grid count (keeps the views/s log honest — an
            oversized image is ntiles forwards, not 1). Asks tile_grid —
            the SAME geometry predict_tiled tiles with — so the accounting
            cannot drift from the actual tiling."""
            if s.shape[0] <= hw and s.shape[1] <= ww:
                return 1
            ys, xs = tile_grid(s.shape, window_shape)
            return len(ys) * len(xs)

        nviews = sum(ntiles(s) for s in S) * (8 if augmentation else 1)
        with phase_timer("predict_forward", items=nviews, unit="views"):
            small = [s for s, f in zip(S, fits) if f]
            small_probs = iter(
                predictor(fwd, params, state, small, window=window_shape,
                          mesh=mesh, max_batch=max_batch) if small else [])
            probs = [next(small_probs) if f else
                     predict_tiled(fwd, params, state, s, window=window_shape,
                                   mesh=mesh, max_batch=max_batch,
                                   tta=augmentation)
                     for s, f in zip(S, fits)]
        Mp = [(p > threshold).astype(np.uint8) for p in probs]

        # The exact mask summary is a sequential host walk — compute it at
        # most once per dataset and share between scoring and saving.
        mask_cache: dict[str, np.ndarray] = {}

        def mask_for(dsp):
            if dsp not in mask_cache:
                mask_cache[dsp] = self.mask_summary_func(dsp)
            return mask_cache[dsp]

        if print_scores:
            mean_p = mean_r = mean_c = 0.0
            for dsp, name, mp in zip(dataset_paths, names, Mp):
                m = mask_for(dsp)
                p, r, i, e, c = nf_mask_metrics(m, np.round(mp))
                logger.info(
                    "%s: prec=%.3f, reca=%.3f, incl=%.3f, excl=%.3f, comb=%.3f",
                    name, p, r, i, e, c)
                mean_p += p / len(dataset_paths)
                mean_r += r / len(dataset_paths)
                mean_c += c / len(dataset_paths)
            logger.info("Mean prec=%.3f, reca=%.3f, comb=%.3f",
                        mean_p, mean_r, mean_c)

        if save:
            import h5py

            from deepcalcium_tpu.utils.visualization import mask_outlines, save_png

            for dsp, name, s, mp in zip(dataset_paths, names, S, Mp):
                with h5py.File(dsp, "r") as fp:
                    has_masks = "masks" in fp
                if has_masks:
                    m = mask_for(dsp)
                    outlined = mask_outlines(s, [m, np.round(mp)], ["blue", "red"])
                else:
                    outlined = mask_outlines(s, [np.round(mp)], ["red"])
                out = os.path.join(self.cpdir, f"{name}_mp.png")
                save_png(out, outlined)
                logger.info("Saved %s", out)

        return Mp, names
