"""Smoke test of the whole pipeline on an NVIDIA GPU, at full model width.

    python chip_smoke.py [--seed N]          # phases a-d on one card
    python chip_smoke.py --four-gpus         # phase e only, on four cards

Phases (each prints one line: sizes, wall time, and every comparison as
``max_err`` beside its ``tol`` and the precision used):

a. summary    movie_summary over a 3000x512x512 int16 movie made on the
              card, against numpy on the host; achieved GB/s.
b. 2-D train  UNet2DSummary.fit (nfb=32) with the CLI recipe (128² windows,
              batch 20, 512² validation) on in-memory synthetic fields,
              preset=None and preset="perf": finite, falling loss, and a
              checkpoint that reloads bit-identically.
c. 2-D eval   UNet2DSummary.evaluate_movie on the phase-a movie with 8-view
              TTA, float32 and bfloat16, against plain ``unet2d.apply`` in
              float32 at ``jax.default_matmul_precision("highest")``.
d. 1-D        UNet1DSegmentation.fit (nfb=32, batch 20 x 4096) on in-memory
              synthetic traces, then predict_proba at full trace length
              (256 x 30,000), at seeded weights (probabilities) and at the
              fit's checkpoint (logits), against plain ``unet1d.apply`` in
              float32 at highest precision; predict's decisions must be
              those probabilities thresholded.
e. four GPUs  data-parallel fit(mesh=), movie_summary_sharded, the sharded
              TTA evaluator and segment_movie(mesh=) over a 4-card 'data'
              mesh, each against the same call on one card.

Any failed check raises, so the process exits non-zero; without a GPU it
exits non-zero before any phase. The last line of standard output is one
JSON object naming the device.
"""

import argparse
import contextlib
import json
import sys
import tempfile
import time

import numpy as np

from deepcalcium_tpu.utils.benchtools import (device_peak,
                                              enable_compile_cache,
                                              gpu_name_and_power_limit)

T, H, W = 3000, 512, 512           # phase a/c movie; H is the 512² window
NB_FIELDS, NB_NEURONS = 3, 60      # phase b synthetic 512² fields
WIN_TRN, BATCH, STEPS = 128, 20, 8  # CLI train recipe, cut to a few steps
NB_TRACES, TRACE_LEN = 256, 30000  # phase d traces
WIN_1D = 4096                      # phase d training window
SEG_FRAMES = 512                   # phase e per-frame segmentation

# Tolerances on probabilities in [0, 1] (and on relative logits, phase d)
# against the float32 reference at highest matmul precision.
TOL_F32_HIGHEST = 1e-4  # same arithmetic, reordered sums (BN folding,
#                         W/T packing, sigmoid head): float32 rounding only.
TOL_F32_DEFAULT = 2e-2  # XLA may run float32 convs as TF32 (10-bit
#                         mantissa) unless asked for more; ~1e-3 relative
#                         per conv, compounded over 23 conv layers.
# bfloat16 (8-bit mantissa activations and weights) has no fixed bound: it
# grows with the activations' scale. The plain net run in bfloat16 against
# the same reference measures what bf16 rounding alone costs; the path
# under test gets BF16_BUDGET times that as its tolerance, and at least
# TOL_F32_DEFAULT.
BF16_BUDGET = 2.0
# Thresholded outputs (masks, spike decisions) are compared at the threshold
# that makes this share of the reference's unsaturated probabilities
# positive (decision_threshold).
POSITIVE_SHARE = 0.1


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def fmt(name, err, tol, precision):
    return f"{name}: max_err={err:.3g} tol={tol:g} ({precision})"


def decision_threshold(ref):
    """The (1 - POSITIVE_SHARE) quantile of the reference probabilities
    that lie strictly inside (0, 1). A net trained for a few steps rarely
    crosses 0.5, and on inputs unlike its training data saturates many
    probabilities at exactly 0 or 1: a threshold no probability exceeds, or
    one at a saturated value, would check nothing."""
    inner = ref[(ref > 0) & (ref < 1)]
    check(inner.size > 0, "every reference probability is saturated")
    return float(np.quantile(inner, 1 - POSITIVE_SHARE))


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def make_movie(seed):
    """A calcium-like int16 movie made on the device from ``seed``: shot
    noise plus flickering soft-disk neurons. Sums of 3000 frames stay below
    2**24, so float32 sums of it are exact in any order."""
    import jax
    import jax.numpy as jnp

    from deepcalcium_tpu.data.fixtures import realistic_neurons

    t, h, w = T, H, W
    rng = np.random.default_rng(seed)
    masks = realistic_neurons(rng, (h, w), NB_NEURONS)
    amp = rng.uniform(80, 300, masks.shape[0])
    img = np.einsum("n,nhw->hw", amp, masks).astype(np.float32)

    @jax.jit
    def gen(key, img):
        k1, k2 = jax.random.split(key)
        act = jax.random.uniform(k1, (t, 1, 1))
        noise = jax.random.randint(k2, (t, h, w), 0, 60, jnp.int32)
        return (100 + noise + act * img[None]).astype(jnp.int16)

    return gen(jax.random.PRNGKey(seed), jnp.asarray(img)), masks


def synthetic_fields(seed):
    """In-memory z-normalized summary images and union mask targets of
    NB_FIELDS synthetic 512² fields (what the dataset functions would
    read)."""
    from deepcalcium_tpu.data.fixtures import realistic_neurons

    n, h, w = NB_FIELDS, H, W
    rng = np.random.default_rng(seed)
    S, M = {}, {}
    for i in range(n):
        masks = realistic_neurons(rng, (h, w), NB_NEURONS)
        amp = rng.uniform(20, 60, masks.shape[0])
        img = 120 + np.einsum("n,nhw->hw", amp, masks) + rng.normal(
            0, 8, (h, w))
        S[f"field.{i}"] = ((img - img.mean()) / img.std()).astype(np.float32)
        M[f"field.{i}"] = masks.max(axis=0).astype(np.float64)
    return S, M


def unet2d_model(cpdir, fields, compute_dtype=None):
    from deepcalcium_tpu.models.unet_2d_summary import UNet2DSummary

    S, M = fields
    return UNet2DSummary(cpdir=cpdir, dataset_name_func=lambda p: p,
                         series_summary_func=S.__getitem__,
                         mask_summary_func=M.__getitem__,
                         compute_dtype=compute_dtype)


def fit_2d(model, names, seed, nb_epochs=2, preset=None, mesh=None):
    """The CLI train recipe (cli.py: window 128, batch 20, 512²
    validation), cut to a few steps."""
    return model.fit(names, shape_trn=(WIN_TRN, WIN_TRN), shape_val=(H, W),
                     batch_size_trn=BATCH, nb_steps_trn=STEPS,
                     nb_epochs=nb_epochs, prop_trn=0.75, prop_val=0.25,
                     seed=seed, preset=preset, mesh=mesh)


def reference_tta_probs(params, state, mean_host, compute_dtype=None):
    """Plain ``unet2d.apply`` (float32 at highest matmul precision unless
    ``compute_dtype`` says otherwise) on the z-normalized summary image,
    with the same 8 TTA views averaged."""
    import jax
    import jax.numpy as jnp

    from deepcalcium_tpu.models import unet2d
    from deepcalcium_tpu.ops.augment import tta_collapse, tta_expand

    z = ((mean_host - mean_host.mean()) / mean_host.std()).astype(np.float32)
    h, w = z.shape

    @jax.jit
    def ref(params, state, z):
        views = tta_expand(z[None]).reshape(8, h, w)
        probs, _ = unet2d.apply(params, state, views, train=False,
                                compute_dtype=compute_dtype)
        return tta_collapse(probs.reshape(8, 1, h, w))[0]

    with precision_ctx("default" if compute_dtype else "highest"):
        return np.asarray(ref(params, state, jnp.asarray(z)))


PRECISIONS = (("float32", "highest"), ("float32", "default"),
              ("bfloat16", "default"))


def tolerance(dtype, prec, plain_bf16_err):
    if dtype == "bfloat16":
        return max(BF16_BUDGET * plain_bf16_err, TOL_F32_DEFAULT)
    return TOL_F32_HIGHEST if prec == "highest" else TOL_F32_DEFAULT


def precision_ctx(prec):
    import jax

    return (jax.default_matmul_precision("highest") if prec == "highest"
            else contextlib.nullcontext())


# ------------------------------------------------------------------ phases


def phase_a(seed):
    import jax

    from deepcalcium_tpu.ops.summary import movie_summary

    movie, t_gen = timed(lambda: jax.block_until_ready(make_movie(seed)[0]))
    (mean, mx), t_first = timed(
        lambda: jax.block_until_ready(movie_summary(movie)))
    times = []
    for _ in range(20):
        _, dt = timed(lambda: jax.block_until_ready(movie_summary(movie)))
        times.append(dt)
    med = float(np.median(times))
    host = np.asarray(movie)
    ref_mean = host.mean(axis=0, dtype=np.float64)
    ref_max = host.max(axis=0)
    err_mean = float(np.max(np.abs(np.asarray(mean, np.float64) - ref_mean)
                            / np.abs(ref_mean)))
    err_max = float(np.max(np.abs(np.asarray(mx).astype(np.int64)
                                  - ref_max.astype(np.int64))))
    gbs = host.nbytes / med / 1e9
    peak = device_peak(jax.devices()[0].device_kind, "hbm_bytes")
    print(f"phase=a summary movie={T}x{H}x{W} int16 "
          f"({host.nbytes / 1e9:.3f} GB) gen_s={t_gen:.2f} "
          f"first_call_s={t_first:.2f} median_ms={med * 1e3:.4f} "
          f"GB/s={gbs:.1f} vs_HBM_peak_GB/s="
          f"{peak / 1e9 if peak else 'unknown'} | "
          + fmt("mean", err_mean, 1e-5, "float32 sum, relative") + " | "
          + fmt("max", err_max, 0, "bit-exact"), flush=True)
    check(err_mean <= 1e-5, f"summary mean rel err {err_mean}")
    check(err_max == 0, f"summary max err {err_max}")
    return movie, ref_mean


def phase_b(seed, cpdir):
    import jax

    from deepcalcium_tpu.models import unet2d
    from deepcalcium_tpu.train.checkpoints import (load_checkpoint,
                                                   save_checkpoint)

    fields = synthetic_fields(seed)
    names = sorted(fields[0])
    parts, failed, best_params = [], [], None
    t0 = time.perf_counter()
    for preset in (None, "perf"):
        model = unet2d_model(f"{cpdir}/b_{preset}", fields)
        (hist, best), dt = timed(lambda: fit_2d(model, names, seed,
                                                preset=preset))
        loss = hist["loss"]
        check(best is not None, f"preset={preset} wrote no checkpoint")
        p0, s0 = unet2d.init(jax.random.PRNGKey(0))
        p, s, _, meta = load_checkpoint(best, p0, s0)
        again = save_checkpoint(f"{cpdir}/b_{preset}/again.ckpt", p, s,
                                meta=meta)
        p2, s2, _, _ = load_checkpoint(again, p0, s0)
        same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
                   zip(jax.tree.leaves((p, s)), jax.tree.leaves((p2, s2))))
        moved = any(not np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(p0)))
        for ok, what in ((np.isfinite(loss).all(), "loss not finite"),
                         (loss[-1] < loss[0], "loss not falling"),
                         (same, "checkpoint reload not identical"),
                         (moved, "checkpoint holds the init params")):
            if not ok:
                failed.append(f"preset={preset}: {what} {loss}")
        parts.append(f"preset={preset} fit_s={dt:.1f} loss={loss[0]:.4f}->"
                     f"{loss[-1]:.4f} val_f1={hist['val_nf_f1_mean'][-1]:.3f}"
                     f" ckpt_reload={'identical' if same else 'DIFFERENT'}")
        if preset is None:
            best_params = (p, s)
    print(f"phase=b train2d nfb=32 fields={NB_FIELDS}x{H}x{W} window="
          f"{WIN_TRN} batch={BATCH} steps={STEPS}x2 epochs val={H} float32 "
          f"wall_s={time.perf_counter() - t0:.1f} | " + " | ".join(parts),
          flush=True)
    check(not failed, "; ".join(failed))
    return best_params


def phase_c(movie, mean_host, params, state, cpdir):
    import jax.numpy as jnp

    fields = ({}, {})
    ref = reference_tta_probs(params, state, mean_host)
    plain_bf16 = float(np.max(np.abs(reference_tta_probs(
        params, state, mean_host, jnp.bfloat16) - ref)))
    thr = decision_threshold(ref)
    parts, failed = [], []
    t0 = time.perf_counter()
    for dtype, prec in PRECISIONS:
        tol = tolerance(dtype, prec, plain_bf16)
        model = unet2d_model(f"{cpdir}/c", fields,
                             compute_dtype=None if dtype == "float32"
                             else dtype)
        fwd = model._resolve_apply_fn("auto", params, ((H, W),)).func
        with precision_ctx(prec):
            (mask, prob), t_first = timed(lambda: model.evaluate_movie(
                movie, params=params, state=state, window_shape=(H, W),
                tta=True, threshold=thr))
            _, t_warm = timed(lambda: model.evaluate_movie(
                movie, params=params, state=state, window_shape=(H, W),
                tta=True, threshold=thr))
        err = float(np.max(np.abs(prob - ref)))
        flips = float(np.mean(mask != (ref > thr)))
        parts.append(fmt(f"{dtype}/{prec} fwd={fwd.__name__}", err, tol,
                         f"{dtype} compute, {prec} matmul precision")
                     + f" mask_mismatch={flips:.2e} first_s={t_first:.2f}"
                     f" warm_ms={t_warm * 1e3:.2f}")
        if not (np.isfinite(prob).all() and mask.shape == (H, W)
                and err <= tol):
            failed.append(f"evaluate_movie {dtype}/{prec} err {err} > {tol}")
    print(f"phase=c eval2d movie={T}x{H}x{W} tta=8 reference=unet2d.apply "
          f"float32/highest threshold={thr:.4g} (positive share "
          f"{POSITIVE_SHARE}) "
          f"plain_unet2d_bf16_err={plain_bf16:.3g} "
          f"wall_s={time.perf_counter() - t0:.1f} | " + " | ".join(parts),
          flush=True)
    check(not failed, "; ".join(failed))


def seeded_params(net, seed):
    """Weights of ``net`` (the unet1d or unet2d module) made from ``seed``,
    with running BN statistics drawn from it too: identity statistics would
    leave the packed forwards' BN folding untested. Their probabilities
    spread over (0, 1), where a comparison has teeth; a net fit for a few
    steps keeps near-initial running statistics and saturates its
    inference outputs at 0 or 1."""
    import jax

    params, state = net.init(jax.random.PRNGKey(seed))
    k = jax.random.PRNGKey(seed + 1)
    state = jax.tree.map(
        lambda v: v + 0.3 * jax.random.uniform(k, v.shape), state)
    return params, state


def prob_err(p, ref):
    return float(np.max(np.abs(p - ref)))


def logit_err(p, ref):
    """Largest logit error relative to the largest reference logit. A net
    fit for a few steps on sparse spikes puts most probabilities near 0,
    where an absolute probability error says nothing; the logit keeps its
    precision there. Clipping keeps 0 and 1 finite (and far off)."""

    def logit(q):
        q = np.clip(np.asarray(q, np.float64), np.finfo(np.float32).tiny,
                    1 - 2.0 ** -24)
        return np.log(q) - np.log1p(-q)

    lr = logit(ref)
    return float(np.max(np.abs(logit(p) - lr)) / np.max(np.abs(lr)))


def phase_d(seed, cpdir):
    import jax
    import jax.numpy as jnp

    from deepcalcium_tpu.data.fixtures import synthetic_spikes
    from deepcalcium_tpu.models import unet1d
    from deepcalcium_tpu.models.unet_1d_segmentation import UNet1DSegmentation
    from deepcalcium_tpu.train.checkpoints import (load_checkpoint,
                                                   save_checkpoint)

    traces, spikes = synthetic_spikes(np.random.default_rng(seed),
                                      NB_TRACES, TRACE_LEN)
    traces = ((traces - traces.mean(1, keepdims=True))
              / traces.std(1, keepdims=True)).astype(np.float32)
    data = {"spikes.smoke": (traces, spikes)}

    def model(dtype=None):
        return UNet1DSegmentation(
            cpdir=f"{cpdir}/d", compute_dtype=dtype,
            dataset_attrs_func=lambda p: {"name": p},
            dataset_traces_func=lambda p: data[p][0],
            dataset_spikes_func=lambda p: data[p][1])

    t0 = time.perf_counter()
    (mt, mv, best), t_fit = timed(lambda: model().fit(
        ["spikes.smoke"], shape=(WIN_1D,), batch=BATCH, nb_epochs=1,
        val_type="random_split", seed=seed))
    check(all(np.isfinite(v) for v in list(mt.values()) + list(mv.values())),
          f"1-D fit metrics {mt} {mv}")
    check(best is not None, "1-D fit wrote no checkpoint")
    seeded = save_checkpoint(f"{cpdir}/d/seeded.ckpt",
                             *seeded_params(unet1d, seed))

    refs = {dtype: jax.jit(lambda p, s, x, dtype=dtype: unet1d.apply(
        p, s, x, train=False, margin=4, compute_dtype=dtype)[0])
        for dtype in (None, jnp.bfloat16)}

    def reference(ckpt, dtype):
        """Plain ``unet1d.apply`` over the traces in 32-trace slabs, float32
        at highest matmul precision unless ``dtype`` says otherwise."""
        p0, s0 = unet1d.init(jax.random.PRNGKey(0))
        params, state, _, _ = load_checkpoint(ckpt, p0, s0)
        with precision_ctx("default" if dtype else "highest"):
            return np.concatenate([
                np.asarray(refs[dtype](params, state,
                                       jnp.asarray(traces[i:i + 32])))
                for i in range(0, NB_TRACES, 32)])

    # (label, checkpoint, error, what the error measures)
    cases = (("seeded", seeded, prob_err, "probability"),
             ("trained", best, logit_err, "logit, relative to max |logit|"))
    ref, plain_bf16, thr = {}, {}, {}
    for label, ckpt, err_fn, _ in cases:
        ref[label] = reference(ckpt, None)
        plain_bf16[label] = err_fn(reference(ckpt, jnp.bfloat16), ref[label])
        thr[label] = decision_threshold(ref[label])
    parts, failed = [], []
    for dtype, prec in PRECISIONS:
        m = model(None if dtype == "float32" else dtype)
        for label, ckpt, err_fn, space in cases:
            tol = tolerance(dtype, prec, plain_bf16[label])
            with precision_ctx(prec):
                (probs, _), t_first = timed(lambda: m.predict_proba(
                    ["spikes.smoke"], ckpt, batch=32))
                (dec, _), t_warm = timed(lambda: m.predict(
                    ["spikes.smoke"], ckpt, batch=32, threshold=thr[label]))
            probs, dec = probs[0], dec[0]
            check(probs.shape == dec.shape == (NB_TRACES, TRACE_LEN),
                  f"predict {probs.shape} {dec.shape}")
            err = err_fn(probs, ref[label])
            same = np.array_equal(dec, probs > thr[label])
            flips = float(np.mean(dec != (ref[label] > thr[label])))
            parts.append(fmt(f"{label} {dtype}/{prec}", err, tol,
                             f"{space}; {dtype} compute, {prec} matmul "
                             f"precision")
                         + f" decisions=thresholded_probs:{same}"
                         f" vs_reference_flips={flips:.2e}"
                         f" first_s={t_first:.2f} warm_ms={t_warm * 1e3:.1f}")
            if not (np.isfinite(probs).all() and err <= tol and same):
                failed.append(f"1-D predict {label} {dtype}/{prec} err {err} "
                              f"tol {tol} decisions match {same}")
    print(f"phase=d unet1d nfb=32 fit batch={BATCH}x{WIN_1D} steps="
          f"{int(np.ceil(0.8 * NB_TRACES / BATCH))} fit_s={t_fit:.1f} "
          f"val_F2={mv['F2']:.3f} predict={NB_TRACES}x{TRACE_LEN} "
          f"fwd=predict(fast='auto') reference=unet1d.apply float32/highest "
          + " ".join(f"{k}: ref_p10/50/90="
                     f"{'/'.join(f'{q:.3g}' for q in np.quantile(r, [.1, .5, .9]))}"
                     f" threshold={thr[k]:.4g} plain_unet1d_bf16_err="
                     f"{plain_bf16[k]:.3g}" for k, r in ref.items())
          + f" (positive share {POSITIVE_SHARE}) wall_s="
          f"{time.perf_counter() - t0:.1f} | " + " | ".join(parts),
          flush=True)
    check(not failed, "; ".join(failed))


def phase_e(seed, cpdir):
    """The mesh paths over four cards, each against one card."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from deepcalcium_tpu.models.movie_segmentation import segment_movie
    from deepcalcium_tpu.ops.summary import movie_summary, movie_summary_sharded
    from deepcalcium_tpu.parallel.mesh import get_mesh

    check(len(jax.devices()) >= 4, f"need 4 GPUs, have {jax.devices()}")
    mesh = get_mesh(4)
    t0 = time.perf_counter()

    fields = synthetic_fields(seed)
    names = sorted(fields[0])
    (h1, _), t1 = timed(lambda: fit_2d(
        unet2d_model(f"{cpdir}/e1", fields), names, seed, nb_epochs=1))
    (h4, _), t4 = timed(lambda: fit_2d(
        unet2d_model(f"{cpdir}/e4", fields), names, seed, nb_epochs=1,
        mesh=mesh))
    err_fit = max(abs(a - b) / abs(a) for a, b in zip(h1["loss"], h4["loss"]))
    print(f"phase=e1 fit(mesh=) data-parallel batch={BATCH} over 4 cards vs 1 "
          f"card, threefry dropout, float32: fit1_s={t1:.1f} fit4_s={t4:.1f} "
          f"loss1={h1['loss']} loss4={h4['loss']} | "
          + fmt("epoch loss", err_fit, 1e-2,
                "float32/TF32 convs, gradient all-reduce order, relative"),
          flush=True)
    check(err_fit <= 1e-2, f"fit(mesh=) loss rel err {err_fit}")

    movie, _ = make_movie(seed)
    mean1, max1 = movie_summary(movie)
    sharded = jax.device_put(movie, NamedSharding(mesh, P("data")))
    (mean4, max4), t_s = timed(lambda: jax.block_until_ready(
        movie_summary_sharded(sharded, mesh)))
    err_mean = float(np.max(np.abs(np.asarray(mean4) - np.asarray(mean1))
                            / np.abs(np.asarray(mean1))))
    err_max = float(np.max(np.abs(np.asarray(max4)
                                  - np.asarray(max1).astype(np.float32))))
    print(f"phase=e2 movie_summary_sharded {T}x{H}x{W} int16 over 4 cards "
          f"vs 1 card: first_call_s={t_s:.2f} | "
          + fmt("mean", err_mean, 1e-6, "exact float32 integer sums, "
                "relative") + " | " + fmt("max", err_max, 0, "bit-exact"),
          flush=True)
    check(err_mean <= 1e-6 and err_max == 0, "sharded summary mismatch")

    from deepcalcium_tpu.models import unet2d

    # Seeded weights, not e1's: after 8 steps the running BN statistics are
    # still near their initial values, and the net's inference outputs sit
    # at exactly 0 or 1, where any two paths agree.
    params, state = seeded_params(unet2d, seed)
    model = unet2d_model(f"{cpdir}/e3", ({}, {}))
    with jax.default_matmul_precision("highest"):
        _, prob1 = model.evaluate_movie(movie, params=params, state=state,
                                        tta=True)
        (_, prob4), t_e = timed(lambda: model.evaluate_movie(
            movie, params=params, state=state, tta=True, mesh=mesh))
    err_ev = float(np.max(np.abs(prob4 - prob1)))
    print(f"phase=e3 evaluate_movie(mesh=) {T}x{H}x{W} tta=8 over 4 cards vs "
          f"1 card: first_call_s={t_e:.2f} p10/50/90="
          + "/".join(f"{q:.3g}" for q in np.quantile(prob1, [.1, .5, .9]))
          + " | " + fmt("prob", err_ev, TOL_F32_HIGHEST,
                "float32 compute, highest matmul precision"), flush=True)
    check(err_ev <= TOL_F32_HIGHEST, f"sharded evaluate err {err_ev}")

    frames = np.asarray(movie[:SEG_FRAMES])
    # The threshold comes from per-frame probabilities: plain unet2d.apply
    # on the first slab, z-normalized per frame as segment_movie does.
    slab = 16
    x = frames[:slab].astype(np.float32)
    x = (x - x.mean((1, 2), keepdims=True)) / (x.std((1, 2), keepdims=True)
                                               + 1e-6)
    with jax.default_matmul_precision("highest"):
        ref_slab = np.asarray(jax.jit(lambda p, s, x: unet2d.apply(
            p, s, x, train=False)[0])(params, state, x))
        thr = decision_threshold(ref_slab)
        seg1 = segment_movie(params, state, frames, slab=slab, threshold=thr,
                             compute_dtype=None)
        seg4, t_g = timed(lambda: segment_movie(
            params, state, frames, slab=slab, mesh=mesh, threshold=thr,
            compute_dtype=None))
    err_seg = float(np.mean(seg1 != seg4))
    err_ref = float(np.mean(seg1[:slab] != (ref_slab > thr)))
    print(f"phase=e4 segment_movie(mesh=) {SEG_FRAMES}x{H}x{W} over 4 cards "
          f"vs 1 card: first_call_s={t_g:.2f} threshold={thr:.6g} (positive "
          f"share {POSITIVE_SHARE} of the first slab's unsaturated "
          f"per-frame probabilities; saturated at 0/1: "
          f"{float(np.mean(ref_slab == 0)):.3f}/"
          f"{float(np.mean(ref_slab == 1)):.3f}; p10/50/90="
          + "/".join(f"{q:.3g}" for q in np.quantile(ref_slab, [.1, .5, .9]))
          + ") positives="
          f"{float(np.mean(seg1)):.3f} | "
          + fmt("4 vs 1 card mask mismatch fraction", err_seg, 1e-4,
                "float32 compute, highest matmul precision") + " | "
          + fmt("1 card vs plain unet2d.apply, first slab, mismatch "
                "fraction", err_ref, 1e-3, "float32 compute, highest "
                "matmul precision; decisions at the threshold may flip"),
          flush=True)
    check(err_seg <= 1e-4, f"sharded segment mismatch {err_seg}")
    check(err_ref <= 1e-3, f"segment_movie vs reference mismatch {err_ref}")
    print(f"phase=e wall_s={time.perf_counter() - t0:.1f}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only phase e, over four cards")
    args = ap.parse_args(argv)

    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform!r}); refusing to "
              f"run on anything else", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {gpu_name_and_power_limit()}", flush=True)
    print(f"device_kind: {dev.device_kind}  devices: {len(jax.devices())}  "
          f"jax: {jax.__version__}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as cpdir:
        if args.four_gpus:
            phase_e(args.seed, cpdir)
        else:
            movie, mean_host = phase_a(args.seed)
            params, state = phase_b(args.seed, cpdir)
            phase_c(movie, mean_host, params, state, cpdir)
            del movie
            phase_d(args.seed, cpdir)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
