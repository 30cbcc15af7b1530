"""GLM/STM spike inference: the JAX replacement for the C2S baseline.

The reference's ``C2SSegmentation`` wrapped the external c2s package (C++
CMT/liblbfgs STM models) and is broken upstream (SURVEY §2 row 29; see
models/c2s_segmentation.py). Instead of porting the breakage, this module
provides the working equivalent capability — classical (non-deep) spike
inference from calcium traces — at two depths:

- ``arch="glm"``: a convolutional generalized linear model,
  ``p(spike_t) = sigmoid(w · x[t-k..t+k] + b)`` — one learned temporal
  filter, weighted logistic regression. The linear core.
- ``arch="stm"``: the Spike-Triggered Mixture semantics of c2s's STM
  (CMT; Theis et al. 2016 — the model behind reference
  ``c2s_segmentation.py:106-115``): K shared quadratic features and L
  mixture components with an exponential nonlinearity,

      log-rate(x_t) = logsumexp_l [ Σ_k β_lk (u_k·x_t)² + w_l·x_t + a_l ]

  trained by Poisson maximum likelihood on the (margin-pooled) spike bins.
  ``stm_apply`` returns P(≥1 spike) = 1 - exp(-rate); ``predict_rates``
  exposes the raw Poisson rates (the c2s prediction contract).

Everything is convolutions + tiny matmuls under one jit — no CMT/liblbfgs,
no multiprocessing pool. Both archs slot into the same wrapper API as
UNet1DSegmentation (fit/predict over the ``traces``/``spikes`` HDF5
contract).
"""

import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from deepcalcium_tpu.models.unet_1d_segmentation import (
    get_dataset_attrs,
    get_dataset_spikes,
    get_dataset_traces,
    maxpool_labels,
)
from deepcalcium_tpu.ops import losses as L
from deepcalcium_tpu.train.checkpoints import load_checkpoint, save_checkpoint
from deepcalcium_tpu.utils.config import checkpoints_dir
from deepcalcium_tpu.utils.runtime import funcname

__all__ = ["GLMSegmentation", "glm_init", "glm_apply", "stm_init",
           "stm_apply", "stm_log_rate"]


def glm_init(key, filter_len: int = 41):
    assert filter_len % 2 == 1, "temporal filter length must be odd"
    return {
        "w": jax.random.normal(key, (filter_len,), jnp.float32) * 0.01,
        "b": jnp.zeros((), jnp.float32),
    }


def glm_apply(params, traces):
    """(R, T) traces -> (R, T) spike probabilities via one SAME conv."""
    w = params["w"][:, None, None]  # (K, 1, 1) WIO
    x = traces[..., None].astype(jnp.float32)  # (R, T, 1)
    y = jax.lax.conv_general_dilated(
        x, w, window_strides=(1,), padding="SAME",
        dimension_numbers=("NWC", "WIO", "NWC"))
    return jax.nn.sigmoid(y[..., 0] + params["b"])


def _conv_filters(traces, filters):
    """(R, T) traces x (K, F) filter bank -> (R, T, F) SAME conv."""
    x = traces[..., None].astype(jnp.float32)  # (R, T, 1)
    w = filters[:, None, :].astype(jnp.float32)  # (K, 1, F) WIO
    return jax.lax.conv_general_dilated(
        x, w, window_strides=(1,), padding="SAME",
        dimension_numbers=("NWC", "WIO", "NWC"))


def stm_init(key, filter_len: int = 41, nb_quad: int = 2,
             nb_components: int = 3):
    """STM params: K=nb_quad shared quadratic features U, L=nb_components
    linear filters W with quadratic weights beta and biases a (the CMT STM
    parameterization behind c2s)."""
    assert filter_len % 2 == 1, "temporal filter length must be odd"
    k1, k2, k3 = jax.random.split(key, 3)
    return {
        "U": jax.random.normal(k1, (filter_len, nb_quad), jnp.float32) * 0.05,
        "W": jax.random.normal(k2, (filter_len, nb_components),
                               jnp.float32) * 0.05,
        "beta": jax.random.normal(k3, (nb_quad, nb_components),
                                  jnp.float32) * 0.05,
        "a": jnp.full((nb_components,), -2.0, jnp.float32),
    }


def stm_log_rate(params, traces):
    """(R, T) traces -> (R, T) log Poisson rate,
    logsumexp_l[ sum_k beta_lk (u_k.x)^2 + w_l.x + a_l ]."""
    qu = _conv_filters(traces, params["U"])          # (R, T, K)
    li = _conv_filters(traces, params["W"])          # (R, T, L)
    z = jnp.einsum("rtk,kl->rtl", qu * qu, params["beta"]) + li + params["a"]
    return jax.nn.logsumexp(z, axis=-1)


def stm_apply(params, traces):
    """(R, T) traces -> (R, T) P(>=1 spike) = 1 - exp(-rate)."""
    rate = jnp.exp(jnp.clip(stm_log_rate(params, traces), -30.0, 15.0))
    return 1.0 - jnp.exp(-rate)


def stm_poisson_nll(params, traces, spikes):
    """Mean Poisson negative log-likelihood, rate - y*log(rate)."""
    lr = stm_log_rate(params, traces)
    rate = jnp.exp(jnp.clip(lr, -30.0, 15.0))
    return jnp.mean(rate - spikes * lr)


class GLMSegmentation:
    """Classical spike-inference wrapper (fit/predict), C2S-capability slot.

    ``arch="glm"`` (default) is the one-filter logistic model;
    ``arch="stm"`` is the quadratic-mixture STM with Poisson likelihood
    (capability-equivalent to the c2s STM the reference wrapped).
    """

    def __init__(self, cpdir=None, filter_len: int = 41, arch: str = "glm",
                 nb_quad: int = 2, nb_components: int = 3,
                 dataset_attrs_func=get_dataset_attrs,
                 dataset_traces_func=get_dataset_traces,
                 dataset_spikes_func=get_dataset_spikes):
        assert arch in ("glm", "stm"), arch
        self.cpdir = cpdir or os.path.join(checkpoints_dir(), f"spikes_{arch}")
        os.makedirs(self.cpdir, exist_ok=True)
        self.filter_len = filter_len
        self.arch = arch
        self.nb_quad = nb_quad
        self.nb_components = nb_components
        self.dataset_attrs_func = dataset_attrs_func
        self.dataset_traces_func = dataset_traces_func
        self.dataset_spikes_func = dataset_spikes_func

    def _init(self, key):
        if self.arch == "stm":
            return stm_init(key, self.filter_len, self.nb_quad,
                            self.nb_components)
        return glm_init(key, self.filter_len)

    def _apply(self, params, traces):
        return (stm_apply if self.arch == "stm" else glm_apply)(params, traces)

    def fit(self, dataset_paths, error_margin=4, nb_epochs=200,
            learning_rate=1e-2, prop_trn=0.8, seed=865):
        """Full-batch weighted logistic regression; returns
        (metrics_trn, metrics_val, checkpoint_path)."""
        logger = logging.getLogger(funcname())
        if nb_epochs < 1:
            raise ValueError(f"nb_epochs={nb_epochs} must be >= 1")
        tr_list = [self.dataset_traces_func(p) for p in dataset_paths]
        sp_list = [self.dataset_spikes_func(p) for p in dataset_paths]
        # Datasets may carry different trace lengths (the 1-D deep model
        # flattens to ragged per-trace lists; this full-batch model pads to
        # the longest T and masks the loss/metrics instead).
        tmax = max(t.shape[1] for t in tr_list)

        def padT(a):
            return np.pad(a, ((0, 0), (0, tmax - a.shape[1])))

        traces = np.concatenate([padT(t) for t in tr_list])
        spikes = np.concatenate([padT(s) for s in sp_list])
        mask = np.concatenate(
            [np.pad(np.ones(t.shape, np.float32),
                    ((0, 0), (0, tmax - t.shape[1]))) for t in tr_list])
        spikes = maxpool_labels(spikes, int(error_margin))
        # The margin pool can smear a real spike into the padded region;
        # the mask keeps padding out of the loss and metrics either way.

        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(traces))
        n_trn = int(len(idx) * prop_trn)
        if n_trn == 0 or n_trn == len(idx):
            raise ValueError(
                f"prop_trn={prop_trn} with {len(idx)} traces leaves an "
                f"empty split (train={n_trn}, val={len(idx) - n_trn}) — "
                f"training on a (0, T) batch yields NaN silently")
        tr_t, tr_v = traces[idx[:n_trn]], traces[idx[n_trn:]]
        sp_t, sp_v = spikes[idx[:n_trn]], spikes[idx[n_trn:]]
        mk_t, mk_v = mask[idx[:n_trn]], mask[idx[n_trn:]]

        params = self._init(jax.random.PRNGKey(seed))
        opt = optax.adam(learning_rate)
        opt_state = opt.init(params)
        arch = self.arch

        @jax.jit
        def step(params, opt_state, x, y, m):
            def lfn(p):
                # Masked mean: padded tail samples of shorter datasets
                # carry zero weight.
                if arch == "stm":
                    lr = stm_log_rate(p, x)
                    rate = jnp.exp(jnp.clip(lr, -30.0, 15.0))
                    elt = rate - y * lr
                else:
                    probs = glm_apply(p, x)
                    elt = L.weighted_binary_crossentropy(y, probs,
                                                         weightpos=2.0)
                return jnp.sum(elt * m) / jnp.sum(m)

            loss, grads = jax.value_and_grad(lfn)(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        xt, yt = jnp.asarray(tr_t, jnp.float32), jnp.asarray(sp_t, jnp.float32)
        mt_ = jnp.asarray(mk_t, jnp.float32)
        loss = np.nan
        for epoch in range(nb_epochs):
            params, opt_state, loss = step(params, opt_state, xt, yt, mt_)
        if not np.isfinite(float(loss)):
            raise FloatingPointError(
                f"{arch} training diverged: final loss {float(loss)} "
                f"(same NaN sanitizer contract as the deep fits)")
        logger.info("%s trained: final loss %.4f", arch.upper(), float(loss))

        def metrics(x, y, m):
            probs = np.asarray(self._apply(params, jnp.asarray(x, jnp.float32)))
            # Zero label+prediction in the padded region: padding becomes
            # true negatives, which none of the TP/FP/FN-sum spike metrics
            # count (the metric fns reduce per trace — axis 1 — so the 2-D
            # shape must be kept).
            mm = np.asarray(m, probs.dtype)
            return {k: float(np.mean(np.asarray(fn(y * mm, probs * mm))))
                    for k, fn in L.SPIKE_METRICS.items()}

        mt, mv = metrics(tr_t, sp_t, mk_t), metrics(tr_v, sp_v, mk_v)
        path = os.path.join(self.cpdir, f"{int(time.time())}_{arch}.ckpt")
        save_checkpoint(path, params, {},
                        meta={"val_F2": mv["F2"], "arch": arch})
        for k in sorted(mt):
            logger.info("%-10s trn=%-9.4f val=%-9.4f", k, mt[k], mv[k])
        return mt, mv, path

    def _load(self, model_path):
        params, _, _, meta = load_checkpoint(
            model_path, self._init(jax.random.PRNGKey(0)), {})
        if meta.get("arch", self.arch) != self.arch:
            raise ValueError(
                f"checkpoint arch {meta['arch']!r} != wrapper arch "
                f"{self.arch!r} — construct GLMSegmentation(arch=...) to "
                f"match")
        return params

    def predict(self, dataset_paths, model_path, threshold=0.5):
        """(list of (R, T) uint8 spike masks, names)."""
        params = self._load(model_path)
        preds, names = [], []
        for p in dataset_paths:
            names.append(self.dataset_attrs_func(p)["name"])
            traces = self.dataset_traces_func(p)
            probs = np.asarray(
                self._apply(params, jnp.asarray(traces, jnp.float32)))
            preds.append((probs > threshold).astype(np.uint8))
        return preds, names

    def predict_rates(self, dataset_paths, model_path):
        """STM only: (list of (R, T) float Poisson spike rates, names) —
        the c2s prediction contract (expected spikes per time bin)."""
        if self.arch != "stm":
            raise ValueError("predict_rates needs arch='stm' (the GLM is a "
                             "probability model, use predict)")
        params = self._load(model_path)
        rates, names = [], []
        for p in dataset_paths:
            names.append(self.dataset_attrs_func(p)["name"])
            traces = self.dataset_traces_func(p)
            lr = stm_log_rate(params, jnp.asarray(traces, jnp.float32))
            rates.append(np.asarray(jnp.exp(jnp.clip(lr, -30.0, 15.0))))
        return rates, names
