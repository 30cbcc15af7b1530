"""Shared measurement harness: device peaks, the compile cache, and the
slope-method training-step timer used by ``bench.py``.

Methodology of the step timer:
- steps run inside ``lax.scan`` so K steps cost ONE dispatch;
- per-step device time = (time(K=k) - time(K=kmin)) / (k - kmin), which
  cancels the constant per-call host cost (dispatch, the scalar fetch);
- every compiled shape is dispatched TWICE before timing, so compilation,
  autotuning and first-run allocation stay out of the reading;
- each rep ends in a host fetch of the loss sum, so the clock stops only
  after the device has finished.
"""

import os
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

# Published dense peaks per device, keyed by ``jax.devices()[0].device_kind``
# (NVIDIA H100 data sheet, SXM part, at its 700 W power limit): bf16
# tensor-core FLOP/s and HBM bytes/s. A device missing here has no peak:
# utilization is then reported as null, never against an assumed number.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def device_peak(kind: str, what: str = "bf16_flops") -> float | None:
    """Published peak ``what`` of device ``kind``, or None if unknown."""
    return DEVICE_PEAKS.get(kind, {}).get(what)


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi``'s ``name, power.limit`` CSV line for the first card
    (e.g. ``"NVIDIA H100 80GB HBM3, 700.00 W"``), or None without one. A
    card set below its maximum power runs slower under load, so every
    reported number carries this line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def power_limit_watts(smi_line: str | None) -> float | None:
    """The power limit in watts parsed from :func:`gpu_name_and_power_limit`."""
    try:
        return float(smi_line.rsplit(",", 1)[1].split()[0])
    except (AttributeError, IndexError, ValueError):
        return None


def _cache_root() -> str:
    """Repo root when running from a checkout (three levels above this
    file, identified by its pyproject.toml); the user cache dir when the
    package is pip-installed (where site-packages' parent is not writable
    and not ours to write into)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if os.path.exists(os.path.join(root, "pyproject.toml")):
        return root
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "deepcalcium_tpu")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and this
    changes nothing. Otherwise the cache lives at the fixed path
    ``<repo>/.jax_compile_cache`` (``~/.cache/deepcalcium_tpu`` for an
    installed package): the path is part of the cache key, so it is never
    built from a temp name, a pid or the time. One implementation for every
    entry point (the CLI, ``bench.py``, ``chip_smoke.py``). Call BEFORE the
    first trace."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    cache = os.path.join(_cache_root(), ".jax_compile_cache")
    os.makedirs(cache, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return cache


def _slope_scan_steps(step, params, state, opt_state, xs, ys, rng_impl,
                      k, kmin, reps):
    """Shared core: per-step device seconds via K-vs-kmin scan slope.

    One-impl view of :func:`_slope_scan_steps_ab` (single implementation
    of the scan body and timing discipline, per this module's header);
    the kmin/k cells are timed round-robin there, which for one impl is
    simply alternating scan lengths — drift-neutral like the A/B."""
    return _slope_scan_steps_ab(step, params, state, opt_state, xs, ys,
                                (rng_impl,), k, kmin, reps)[rng_impl]


def _train_step_setup(apply_fn, batch, win, k, nfb, lr, loss):
    """Shared setup for the 2-D train-step slope timers: params on device,
    optimizer state, the jitted step, and K steps of synthetic data."""
    from deepcalcium_tpu.models import unet2d
    from deepcalcium_tpu.ops import losses as L
    from deepcalcium_tpu.train import trainer as T

    params, state = unet2d.init(jax.random.PRNGKey(0), nfb=nfb)
    optimizer = T.make_optimizer(lr)
    opt_state = optimizer.init(params)
    step = T.make_train_step(apply_fn, L.LOSSES[loss], optimizer)

    rng_np = np.random.default_rng(0)
    xs = jnp.asarray(rng_np.standard_normal((k, batch, win, win)),
                     jnp.float32)
    ys = jnp.asarray(rng_np.random((k, batch, win, win)) < 0.1, jnp.float32)
    return step, params, state, opt_state, xs, ys


def slope_train_step_time(apply_fn, batch, win, *, k=12, kmin=2, reps=3,
                          nfb=32, rng_impl="threefry2x32", lr=2e-3,
                          loss="binary_crossentropy"):
    """Measured device seconds per 2-D training step for one config.

    ``apply_fn``: a train-signature forward (e.g. ``unet2d.apply`` or
    ``unet2d_fast.apply_fast_w_train``, usually with ``compute_dtype``
    bound).
    """
    step, params, state, opt_state, xs, ys = _train_step_setup(
        apply_fn, batch, win, k, nfb, lr, loss)
    return _slope_scan_steps(step, params, state, opt_state, xs, ys,
                             rng_impl, k, kmin, reps)


def slope_train_step_time_ab(apply_fn, batch, win, *, k=12, kmin=2, reps=3,
                             nfb=32, rng_impls=("threefry2x32", "rbg"),
                             lr=2e-3, loss="binary_crossentropy"):
    """INTERLEAVED A/B slope timing of the same train step under several
    PRNG implementations; returns ``{impl: seconds_per_step}``.

    Why not two :func:`slope_train_step_time` calls: a drift in the host's
    or the card's speed (clocks under a power cap, a busy neighbour on a
    shared host) between two sequential measurements can invert a small
    difference. Here every timed reading of every (impl, K) cell is taken
    round-robin inside one loop, so a drift hits all cells equally.

    All configs share ONE jit wrapper (the typed PRNG key's aval differs
    per impl, so each impl is its own compile-cache entry under the same
    wrapper) and one params/data setup.
    """
    step, params, state, opt_state, xs, ys = _train_step_setup(
        apply_fn, batch, win, k, nfb, lr, loss)
    return _slope_scan_steps_ab(step, params, state, opt_state, xs, ys,
                                rng_impls, k, kmin, reps)


def _slope_scan_steps_ab(step, params, state, opt_state, xs, ys, rng_impls,
                         k, kmin, reps):
    """Shared core of the interleaved A/B slope timers (2-D and 1-D):
    every timed reading of every (impl, K) cell is taken round-robin in
    one loop, so a drift in speed hits all cells equally."""

    def scan_steps(p, s, o, key, xs_k, ys_k):
        def body(carry, xy):
            p, s, o, key = carry
            key, sub = jax.random.split(key)
            p, s, o, logs = step(p, s, o, xy[0], xy[1], sub)
            return (p, s, o, key), logs["loss"]

        (_, _, _, _), losses = jax.lax.scan(body, (p, s, o, key),
                                            (xs_k, ys_k))
        return losses

    fn = jax.jit(scan_steps)
    keys = {impl: jax.random.key(7, impl=impl) for impl in rng_impls}
    cells = [(impl, kk) for kk in (kmin, k) for impl in rng_impls]
    # Compile, autotune and first-run allocation for every cell before any
    # timing.
    for impl, kk in cells:
        for _ in range(2):
            float(jnp.sum(fn(params, state, opt_state, keys[impl],
                             xs[:kk], ys[:kk])))
    acc = {cell: 0.0 for cell in cells}
    for _ in range(reps):
        for cell in cells:  # round-robin: a drift hits all cells equally
            impl, kk = cell
            tic = time.perf_counter()
            float(jnp.sum(fn(params, state, opt_state, keys[impl],
                             xs[:kk], ys[:kk])))
            acc[cell] += time.perf_counter() - tic
    return {impl: (acc[(impl, k)] - acc[(impl, kmin)]) / reps / (k - kmin)
            for impl in rng_impls}


def slope_train1d_step_time(batch=20, wlen=4096, *, k=12, kmin=2, reps=3,
                            nfb=32, rng_impl="threefry2x32", lr=2e-3,
                            margin=4):
    """Measured device seconds per 1-D (UNet1D spike) training step at the
    reference recipe: batch windows of ``wlen`` samples, wbce(pos=2),
    margin max-pool head, bf16, full SPIKE_METRICS — the same graph
    ``UNet1DSegmentation.fit`` dispatches per step (counterpart of
    ``slope_train_step_time`` for bench.py's ``train1d_*`` fields)."""
    step, params, state, opt_state, xs, ys = _train1d_step_setup(
        batch, wlen, k, nfb, lr, margin)
    return _slope_scan_steps(step, params, state, opt_state, xs, ys,
                             rng_impl, k, kmin, reps)


def _train1d_step_setup(batch, wlen, k, nfb, lr, margin):
    """Shared setup for the 1-D train-step slope timers (single-config and
    interleaved A/B): params on device, optimizer state, the jitted step,
    and K steps of synthetic spike data."""
    import functools

    from deepcalcium_tpu.models import unet1d
    from deepcalcium_tpu.ops import losses as L
    from deepcalcium_tpu.train import trainer as T

    params, state = unet1d.init(jax.random.PRNGKey(0), nfb=nfb)
    optimizer = T.make_optimizer(lr)
    opt_state = optimizer.init(params)
    apply_fn = functools.partial(unet1d.apply, margin=margin,
                                 compute_dtype=jnp.bfloat16)
    loss_fn = functools.partial(L.weighted_binary_crossentropy,
                                weightpos=2.0)
    step = T.make_train_step(apply_fn, loss_fn, optimizer,
                             metric_fns=dict(L.SPIKE_METRICS))

    rng_np = np.random.default_rng(0)
    xs = jnp.asarray(rng_np.standard_normal((k, batch, wlen)), jnp.float32)
    ys = jnp.asarray(rng_np.random((k, batch, wlen)) < 0.01, jnp.float32)
    return step, params, state, opt_state, xs, ys


def slope_train1d_step_time_ab(batch=20, wlen=4096, *, k=12, kmin=2, reps=3,
                               nfb=32, rng_impls=("threefry2x32", "rbg"),
                               lr=2e-3, margin=4):
    """INTERLEAVED A/B slope timing of the 1-D spike train step under
    several PRNG implementations; returns ``{impl: seconds_per_step}``.
    Same drift-immunity rationale as :func:`slope_train_step_time_ab`."""
    step, params, state, opt_state, xs, ys = _train1d_step_setup(
        batch, wlen, k, nfb, lr, margin)
    return _slope_scan_steps_ab(step, params, state, opt_state, xs, ys,
                                rng_impls, k, kmin, reps)
