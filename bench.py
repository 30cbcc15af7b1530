"""Benchmark: end-to-end evaluate throughput + MFU on one GPU.

Measures the reference's headline pipeline (BASELINE.md: ingest TIFFs +
summarize + predict at 8,057 frames/min ≈ 134.3 fps on the author's
workstation): a synthetic 3000-frame 512x512 movie is (a) reduced to its
mean summary image on the device, (b) z-normalized, and (c) segmented by
UNet2DS with full 8x TTA in bfloat16 — the complete evaluate path after
TIFF decode, as ONE fused device graph.

The graph under test is the PUBLIC LIBRARY PATH:
``deepcalcium_tpu.train.evaluate.make_movie_evaluator`` with the forward
``UNet2DSummary.evaluate_movie(fast="auto")`` dispatches. Steady-state
wall-clock (warm-up excluded, jit cache warm), mirroring how the reference
number excludes its model build.

MFU accounting: analytic conv FLOPs (``unet2d.forward_flops``) x 8 TTA
views, divided by measured step time, against the device's published bf16
peak from ``benchtools.DEVICE_PEAKS`` (keyed by ``device_kind``; an unknown
device reports ``mfu: null``).

Prints ONE JSON line:
    {"metric": "e2e_eval_frames_per_sec", "value": N, "unit": "frames/s",
     "vs_baseline": N / 134.28, "model_tflops_per_sec": N, "mfu": N,
     "flops_per_eval": N, "eval_ms": N, "device_kind": "...",
     "power_limit_w": N, ...}
"""

import json
import sys
import tempfile
import time

import numpy as np

from deepcalcium_tpu.utils.benchtools import (device_peak,
                                              enable_compile_cache,
                                              gpu_name_and_power_limit,
                                              power_limit_watts)

BASELINE_FPS = 8057.0 / 60.0  # reference: 8,057 frames/min end-to-end


def _mfu(flops_per_s, peak):
    return round(flops_per_s / peak, 4) if peak else None


def main():
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from deepcalcium_tpu.models import unet2d
    from deepcalcium_tpu.models.unet_2d_summary import UNet2DSummary
    from deepcalcium_tpu.train.evaluate import make_movie_evaluator

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX found {dev.platform!r}); device "
              f"metrics come only from a GPU run", file=sys.stderr)
        return 1
    smi = gpu_name_and_power_limit()
    peak = device_peak(dev.device_kind)

    t, h, w = 3000, 512, 512
    # Generate the movie ON DEVICE: host-side RNG of 786M values takes >1 min
    # on a small host and the data content is irrelevant to throughput.
    movie_dev = jax.jit(
        lambda k: jax.random.randint(k, (t, h, w), 0, 2000, jnp.int16)
    )(jax.random.PRNGKey(0))
    jax.block_until_ready(movie_dev)

    params, state = unet2d.init(jax.random.PRNGKey(0), nfb=32)

    # The forwards UNet2DSummary resolves for evaluate_movie(fast="auto")
    # and fit(fast_train="auto") in bf16 at the shapes timed below.
    tb, twin = 20, 128
    with tempfile.TemporaryDirectory(prefix="bench_") as cpdir:
        model = UNet2DSummary(cpdir=cpdir, compute_dtype=jnp.bfloat16)
        fast_fn = model._resolve_apply_fn("auto", params, ((h, w),))
        apply_tr = model._resolve_apply_fn("auto", params, ((twin, twin),),
                                           train=True)

    # The public library evaluator: summary -> z-norm -> pad -> 8x TTA
    # forward -> inverse/average -> threshold, one jitted graph.
    evaluate = make_movie_evaluator(fast_fn, (t, h, w), window=(512, 512),
                                    tta=True)

    # Tiny on-device checksum whose HOST FETCH ends each timed loop: the
    # clock stops only after the device has finished.
    checksum = jax.jit(lambda m: jnp.sum(m, dtype=jnp.int32))

    def timed(iters: int) -> float:
        tic = time.perf_counter()
        cks = None
        for _ in range(iters):
            mask, _, _ = evaluate(params, state, movie_dev)
            cks = checksum(mask)
        int(cks)  # scalar host fetch = full drain
        return time.perf_counter() - tic

    # Warm-up excluded from timing: TWO dispatches, so compilation,
    # autotuning and first-run allocation stay out of the reading.
    timed(1)
    timed(1)
    # Slope method: per-iteration time from the 22-vs-2 difference, which
    # cancels the constant per-loop host cost (dispatch, the checksum
    # fetch). TWO reps with a sanity guard: a slowdown of the shared host
    # or the card inside one reading can deflate or sign-flip a single
    # slope, and the headline must never publish such a dt silently.
    pairs = [(timed(22), timed(2)) for _ in range(2)]
    slopes = [(t22 - t2) / 20.0 for t22, t2 in pairs]
    good = [s for s in slopes if s > 0]
    # min() = the least disturbed rep (a disturbance only ADDS time).
    if good:
        dt = min(good)
        eval_weather_suspect = (len(good) < len(slopes)
                                or max(good) / min(good) > 1.25)
    else:
        # Both slopes non-positive: fall back to the dispatch-inclusive
        # mean (biased HIGH => fps biased LOW — an honest lower bound),
        # loudly flagged.
        dt = min(t22 / 22.0 for t22, _ in pairs)
        eval_weather_suspect = True

    # Second, transfer-inclusive metric: the movie starts on HOST (the
    # "user hands us a numpy array" case) and streams through the library's
    # chunked path (evaluate_movie_streaming: StreamingSummary folds each
    # 256-frame chunk on the device, then the mean image runs the TTA
    # graph). Ingest-from-disk is excluded everywhere: it is bound by the
    # disk in any framework.
    from deepcalcium_tpu.train.evaluate import evaluate_movie_streaming

    movie_host = np.asarray(movie_dev)
    # Host-health probe: the host's NumPy reduction bandwidth, reported
    # beside from_host_fps, which the shared host's speed also bounds.
    probe = movie_host[:128]  # 64 MB
    tic = time.perf_counter()
    float(probe.astype(np.float32).sum())
    host_mbps = probe.nbytes / 2**20 / max(time.perf_counter() - tic, 1e-9)
    # Warm the eval-from-summary jit so the steady-state number measures
    # the pipeline, not compilation. Same fast_fn identity => the cached
    # evaluator is reused by the timed call. Warm with ONE FULL 256-frame
    # chunk (the streaming default): a smaller slab would compile a
    # different _streaming_device_update specialization and the timed run
    # would pay a mid-stream compile.
    for _ in range(2):
        evaluate_movie_streaming(fast_fn, params, state, movie_host[:256],
                                 window=(512, 512), tta=True)
    tic = time.perf_counter()
    mask, _, _ = evaluate_movie_streaming(fast_fn, params, state, movie_host,
                                          window=(512, 512), tta=True)
    dt_host = time.perf_counter() - tic

    # --- Training throughput + MFU (the reference recipe shape: batch 20
    # @ 128² bf16, the gradient step fit(fast_train="auto") dispatches).
    # Shared slope-method harness: steps inside lax.scan, per-step device
    # time from the K=12-vs-2 difference, two warm dispatches per shape.
    from deepcalcium_tpu.utils.benchtools import slope_train_step_time_ab

    # threefry (the default) and rbg dropout PRNGs, timed INTERLEAVED so a
    # drift in speed hits both equally. The K-step scan of
    # fit(preset='perf') changes host dispatch only, which the slope
    # method cancels by construction.
    ab = slope_train_step_time_ab(apply_tr, tb, twin,
                                  rng_impls=("threefry2x32", "rbg"))
    dt_train, dt_train_perf = ab["threefry2x32"], ab["rbg"]
    train_perf_inverted = bool(dt_train_perf >= dt_train)
    # Analytic train-step FLOPs: fwd + input-grad + weight-grad conv passes
    # ≈ 3x the forward's conv FLOPs per window (standard accounting; BN/
    # metric/Adam elementwise ops are bandwidth-bound, <2% of arithmetic).
    train_flops = 3 * tb * unet2d.forward_flops(twin, twin, nfb=32)
    train_tflops = train_flops / dt_train / 1e12
    train_perf_tflops = train_flops / dt_train_perf / 1e12

    # 1-D (UNet1D spike) training at the reference recipe: batch 20
    # windows of 4096 samples, wbce(pos=2), margin 4, bf16, full metrics
    # (reference hot loop: unet_1d_segmentation.py:300-302).
    from deepcalcium_tpu.models import unet1d
    from deepcalcium_tpu.utils.benchtools import slope_train1d_step_time_ab

    t1b, t1w = 20, 4096
    # threefry vs rbg dropout PRNG, interleaved like the 2-D A/B.
    ab1d = slope_train1d_step_time_ab(t1b, t1w,
                                      rng_impls=("threefry2x32", "rbg"))
    dt_train1d, dt_train1d_perf = ab1d["threefry2x32"], ab1d["rbg"]
    train1d_perf_inverted = bool(dt_train1d_perf >= dt_train1d)
    train1d_flops = 3 * t1b * unet1d.forward_flops(t1w, nfb=32)
    train1d_tflops = train1d_flops / dt_train1d / 1e12
    train1d_perf_tflops = train1d_flops / dt_train1d_perf / 1e12

    fps = t / dt
    flops = 8 * unet2d.forward_flops(512, 512, nfb=32)  # 8 TTA views
    tflops = flops / dt / 1e12
    print(json.dumps({
        "metric": "e2e_eval_frames_per_sec",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 2),
        "model_tflops_per_sec": round(tflops, 1),
        "mfu": _mfu(tflops * 1e12, peak),
        "flops_per_eval": flops,
        "eval_ms": round(dt * 1e3, 2),
        # True when the two eval slope reps disagreed >25% or a rep went
        # non-positive — treat the headline as disturbed.
        "eval_weather_suspect": eval_weather_suspect,
        # Host-array rate via the streaming path (chunked host->device
        # transfer + device fold + TTA graph); host_sum_MBps is the shared
        # host's NumPy reduction bandwidth measured beside it.
        "from_host_fps": round(t / dt_host, 1),
        "host_sum_MBps": round(host_mbps, 1),
        "jax_backend": jax.default_backend(),
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "power_limit_w": power_limit_watts(smi),
        # Training at the reference recipe shape (batch 20 @ 128², bf16),
        # slope-measured device time, threefry dropout PRNG (the default).
        "train_step_ms": round(dt_train * 1e3, 2),
        "train_windows_per_sec": round(tb / dt_train, 1),
        "train_flops_per_step": train_flops,
        "train_tflops_per_sec": round(train_tflops, 1),
        "train_mfu": _mfu(train_tflops * 1e12, peak),
        # The same step with the rbg dropout PRNG, measured interleaved;
        # rbg_slower=true means rbg did not beat threefry in this run.
        "train_rbg_step_ms": round(dt_train_perf * 1e3, 2),
        "train_rbg_mfu": _mfu(train_perf_tflops * 1e12, peak),
        "train_rbg_slower": train_perf_inverted,
        # 1-D spike training (UNet1D, reference recipe shape).
        "train1d_step_ms": round(dt_train1d * 1e3, 2),
        "train1d_windows_per_sec": round(t1b / dt_train1d, 1),
        "train1d_samples_per_sec": round(t1b * t1w / dt_train1d, 1),
        "train1d_flops_per_step": train1d_flops,
        "train1d_tflops_per_sec": round(train1d_tflops, 1),
        "train1d_mfu": _mfu(train1d_tflops * 1e12, peak),
        "train1d_rbg_step_ms": round(dt_train1d_perf * 1e3, 2),
        "train1d_rbg_mfu": _mfu(train1d_perf_tflops * 1e12, peak),
        "train1d_rbg_slower": train1d_perf_inverted,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
