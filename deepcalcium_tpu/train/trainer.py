"""Data-parallel training step and epoch loop utilities.

Replaces Keras ``model.compile`` + ``fit_generator`` (reference
``unet_2d_summary.py:397-430``) with a single donated, jitted, GSPMD-sharded
train step:

- loss = mean over the global batch of the configured loss fn (same registry
  as the reference: bce / weighted bce / dice / dicesq).
- metrics computed on-device on the same forward (F1/prec/reca/dice/dicesq/
  posyt/posyp — the 7 compile-time metrics of ``unet_2d_summary.py:399``).
- batch axis sharded over the mesh ``data`` axis; GSPMD inserts the gradient
  all-reduce across devices. Params/optimizer state are replicated (UNet2DS is
  ~8M params — DP is the right decomposition, SURVEY §2.2).
- learning-rate control via ``optax.inject_hyperparams`` so the
  ReduceLROnPlateau policy (reference ``:425-426``) mutates the lr between
  epochs without recompiling.
"""


import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax

from jax.sharding import NamedSharding, PartitionSpec as P

from deepcalcium_tpu.ops import losses as L
from deepcalcium_tpu.parallel.mesh import replicated

__all__ = ["make_optimizer", "make_train_step", "make_multi_step",
           "ReduceLROnPlateau", "CosineDecay", "current_lr", "set_lr"]


def make_optimizer(learning_rate: float = 2e-3, weight_decay: float = 0.0):
    """Adam(2e-3), the reference default (``unet_2d_summary.py:335``), with
    an injectable learning rate.

    ``weight_decay`` > 0 switches to AdamW (decoupled decay) — the
    optax counterpart of the L2 kernel regularization the
    reference's hyperparameter search swept
    (``notebooks/unet2ds_random_hyperparameter_search.ipynb``, Keras
    ``l2(λ)`` on conv kernels). Decoupled decay is not literally Keras L2
    (which adds λ‖W‖² to the loss and so scales with the LR through Adam's
    normalizer), but it spans the same capacity-control axis and composes
    with LR schedules without recompiling. Like the reference's ``l2`` —
    which Keras applies to conv KERNELS only — decay is masked to
    ``kernel`` leaves: biases and BN gamma/beta are never decayed (decaying
    BN scale toward 0 distorts normalization statistics rather than
    controlling capacity)."""
    if weight_decay:
        def kernels_only(params):
            return jax.tree_util.tree_map_with_path(
                lambda path, _: path[-1].key == "kernel", params)

        # static_args: without it inject_hyperparams mistakes the callable
        # mask for an LR-style schedule and calls it on the step count.
        return optax.inject_hyperparams(optax.adamw,
                                        static_args=("mask",))(
            learning_rate=learning_rate, weight_decay=weight_decay,
            mask=kernels_only)
    return optax.inject_hyperparams(optax.adam)(learning_rate=learning_rate)


def current_lr(opt_state) -> float:
    return float(opt_state.hyperparams["learning_rate"])


def set_lr(opt_state, lr: float):
    opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
    return opt_state


class ReduceLROnPlateau:
    """Host-side LR plateau policy.

    Mirror of the reference callback (``unet_2d_summary.py:425-426``):
    monitor a metric in max mode, halve LR after ``patience`` epochs without
    improvement, floor at ``min_lr``.
    """

    def __init__(self, factor=0.5, patience=5, min_lr=1e-4, mode="max"):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.sign = 1.0 if mode == "max" else -1.0
        self.best = -np.inf
        self.wait = 0

    def update(self, value: float, lr: float) -> float:
        if self.sign * value > self.best:
            self.best = self.sign * value
            self.wait = 0
            return lr
        self.wait += 1
        if self.wait >= self.patience:
            self.wait = 0
            return max(self.min_lr, lr * self.factor)
        return lr


class CosineDecay:
    """Host-side cosine learning-rate decay over a fixed epoch horizon.

    Opt-in alternative to :class:`ReduceLROnPlateau` (which is the parity
    default, reference ``unet_2d_summary.py:425-426``): anneals from
    ``base_lr`` to ``min_lr`` along half a cosine over ``total_epochs``.
    Like the plateau policy it runs between epochs through ``set_lr`` (optax
    hyperparam injection), so switching schedules never recompiles the step.
    """

    def __init__(self, base_lr: float, total_epochs: int, min_lr: float = 1e-4):
        assert total_epochs >= 1
        self.base_lr = base_lr
        self.total_epochs = total_epochs
        self.min_lr = min_lr

    def lr_at(self, epoch: int) -> float:
        """LR to use *for* ``epoch`` (epoch 0 -> base_lr)."""
        frac = min(max(epoch, 0), self.total_epochs) / self.total_epochs
        return self.min_lr + 0.5 * (self.base_lr - self.min_lr) * (
            1.0 + float(np.cos(np.pi * frac)))


def make_train_step(apply_fn, loss_fn, optimizer, metric_fns=None, mesh=None):
    """Build the jitted train step.

    # Arguments
        apply_fn: f(params, state, x, train, rng) -> (probs, new_state).
            Dropout/compute-dtype choices should be baked in by the caller
            (functools.partial).
        loss_fn: f(yt, yp) -> array (any shape; mean is taken here).
        optimizer: optax GradientTransformation (e.g. make_optimizer()).
        metric_fns: {name: f(yt, yp) -> scalar}; defaults to the reference's
            7 neuron metrics.
        mesh: optional jax.sharding.Mesh; shards the batch over its 'data'
            axis and replicates params/opt state.

    # Returns
        step(params, state, opt_state, x, y, rng) ->
            (params, state, opt_state, metrics dict of f32 scalars)
    """
    metric_fns = metric_fns if metric_fns is not None else dict(L.NEURON_METRICS)

    def step(params, state, opt_state, x, y, rng):
        def lfn(p):
            probs, new_state = apply_fn(p, state, x, train=True, rng=rng)
            loss = jnp.mean(loss_fn(y, probs))
            return loss, (probs, new_state)

        (loss, (probs, new_state)), grads = jax.value_and_grad(lfn, has_aux=True)(params)
        updates, new_opt = optimizer.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        metrics = {k: fn(y, probs) for k, fn in metric_fns.items()}
        metrics["loss"] = loss
        metrics = {k: jnp.mean(v).astype(jnp.float32) for k, v in metrics.items()}
        return new_params, new_state, new_opt, metrics

    if mesh is None:
        return jax.jit(step, donate_argnums=(0, 1, 2))

    rep = replicated(mesh)
    # P('data') shards dim 0 and replicates the rest for any rank — serves
    # both (B, H, W) image batches and (B, T) trace batches.
    bs = NamedSharding(mesh, P("data"))
    return jax.jit(
        step,
        in_shardings=(rep, rep, rep, bs, bs, rep),
        out_shardings=(rep, rep, rep, rep),
        donate_argnums=(0, 1, 2),
    )


def make_multi_step(apply_fn, loss_fn, optimizer, nsteps: int,
                    metric_fns=None, ema_decay=None, mesh=None):
    """K train steps in ONE device dispatch via ``lax.scan``.

    A millisecond-scale device step leaves the per-step host dispatch
    visible; scanning K steps inside one jit amortizes it over K batches
    fed as stacked (K, B, ...) arrays (K=4 measured 4.10 vs 6.61 ms/step
    as ``fit`` runs the 2-D step at batch 20 @ 128², bf16, on an H100).

    # Arguments
        nsteps: steps per dispatch (the scan length; static).
        ema_decay: when set, a Polyak average rides in the scan carry so
            per-step EMA semantics match the K=1 loop exactly.
        (rest as in :func:`make_train_step`.)

    # Returns
        step(params, state, opt_state, ema_params, xs, ys, rng) ->
            (params, state, opt_state, ema_params, metrics) where
            xs/ys are (K, B, ...) stacks, metrics values are (K,) arrays,
            and ema_params is passed/returned as-is when ema_decay is None.
    """
    metric_fns = metric_fns if metric_fns is not None else dict(L.NEURON_METRICS)

    def one(carry, xs):
        params, state, opt_state, ema = carry
        x, y, rng = xs

        def lfn(p):
            probs, new_state = apply_fn(p, state, x, train=True, rng=rng)
            loss = jnp.mean(loss_fn(y, probs))
            return loss, (probs, new_state)

        (loss, (probs, new_state)), grads = jax.value_and_grad(
            lfn, has_aux=True)(params)
        updates, new_opt = optimizer.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        if ema_decay is not None:
            ema = jax.tree.map(
                lambda e, p: ema_decay * e + (1.0 - ema_decay) * p,
                ema, new_params)
        metrics = {k: fn(y, probs) for k, fn in metric_fns.items()}
        metrics["loss"] = loss
        metrics = {k: jnp.mean(v).astype(jnp.float32)
                   for k, v in metrics.items()}
        return (new_params, new_state, new_opt, ema), metrics

    def multi(params, state, opt_state, ema_params, xs, ys, rng):
        rngs = jax.random.split(rng, nsteps)
        carry = (params, state, opt_state,
                 ema_params if ema_decay is not None else params)
        (params, state, opt_state, ema), metrics = jax.lax.scan(
            one, carry, (xs, ys, rngs))
        if ema_decay is None:
            ema = ema_params
        return params, state, opt_state, ema, metrics

    if mesh is None:
        return jax.jit(multi, donate_argnums=(0, 1, 2, 3))
    rep = replicated(mesh)
    # Stacked batches: scan axis replicated, batch axis (dim 1) sharded.
    bs = NamedSharding(mesh, P(None, "data"))
    return jax.jit(
        multi,
        in_shardings=(rep, rep, rep, rep, bs, bs, rep),
        out_shardings=(rep, rep, rep, rep, rep),
        donate_argnums=(0, 1, 2, 3),
    )


@jax.jit
def ema_update(ema, params, decay):
    """Polyak averaging: ema <- decay*ema + (1-decay)*params.

    An opt-in stabilizer beyond the reference recipe: evaluating/checkpointing
    the EMA weights smooths the train-window/full-image distribution cliff
    (docs/VALIDATION.md §3b) without touching the optimization trajectory.
    """
    return jax.tree.map(lambda e, p: decay * e + (1.0 - decay) * p, ema, params)


def stable_apply_fn(holder, net, **kw):
    """Return ``functools.partial(net, **kw)`` cached on ``holder`` so
    repeat calls hand the lru-cached builders (make_eval_forward, the
    evaluator factories) the SAME function identity — a fresh partial per
    call would force a recompile. ``kw`` values must be hashable."""
    cache = holder.__dict__.setdefault("_apply_fn_cache", {})
    key = (net,) + tuple(sorted(kw.items()))
    if key not in cache:
        cache[key] = functools.partial(net, **kw)
    return cache[key]


@functools.lru_cache(maxsize=16)
def make_eval_forward(apply_fn, mesh=None):
    """Jitted batched inference forward, batch-sharded when a mesh is given.

    lru_cached on (apply_fn, mesh): a fresh jit wrapper per call would
    recompile the full forward — pass an identity-stable ``apply_fn``."""

    def fwd(params, state, x):
        probs, _ = apply_fn(params, state, x, train=False, rng=None)
        return probs

    if mesh is None:
        return jax.jit(fwd)
    bs = NamedSharding(mesh, P("data"))
    return jax.jit(
        fwd,
        in_shardings=(replicated(mesh), replicated(mesh), bs),
        out_shardings=bs,
    )
