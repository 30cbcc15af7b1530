"""End-to-end: fixture HDF5 -> UNet2DSummary.fit -> predict -> submit.

The miniature counterpart of the reference CLI workflow
(examples/neurons/unet2ds_nf.py) on synthetic data: training must raise the
on-image F1, prediction must produce usable masks, submission must be valid
JSON in challenge format.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest

from deepcalcium_tpu.data.fixtures import make_neurons_hdf5
from deepcalcium_tpu.data.nf import nf_submit
from deepcalcium_tpu.models import unet2d
from deepcalcium_tpu.models.unet_2d_summary import UNet2DSummary
from deepcalcium_tpu.train import trainer as T
from deepcalcium_tpu.ops import losses as L


@pytest.fixture(scope="module")
def fixture_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("nf")
    return [
        make_neurons_hdf5(str(d / f"ds{i}" / "dataset.hdf5"),
                          name=f"synthetic.00.0{i}", shape=(96, 96),
                          nb_frames=48, nb_neurons=8, seed=i)
        for i in range(2)
    ]


@pytest.fixture(scope="module")
def tiny_model():
    return functools.partial(unet2d.init, nfb=4), unet2d.apply


def test_train_step_decreases_loss(rng):
    """Raw trainer: loss after 30 steps on one batch must drop hard."""
    params, state = unet2d.init(jax.random.PRNGKey(0), nfb=4)
    opt = T.make_optimizer(2e-3)
    opt_state = opt.init(params)
    step = T.make_train_step(unet2d.apply, L.LOSSES["binary_crossentropy"], opt)

    x = rng.standard_normal((4, 32, 32)).astype(np.float32)
    y = np.zeros((4, 32, 32), np.float32)
    y[:, 8:24, 8:24] = 1.0

    k = jax.random.PRNGKey(1)
    first = None
    for i in range(60):
        k, sub = jax.random.split(k)
        params, state, opt_state, met = step(params, state, opt_state, x, y, sub)
        if first is None:
            first = float(met["loss"])
    # Measured trajectory: 0.81 -> 0.42 over 60 steps with F1 0.29 -> 0.84.
    assert float(met["loss"]) < 0.65 * first
    assert float(met["F1"]) > 0.5


def test_multi_step_matches_loop(rng):
    """K steps in one lax.scan dispatch == K single-step dispatches when fed
    the same per-step rngs (exact semantics, amortized dispatch).

    SGD keeps the comparison tight: scan-vs-unrolled reassociation leaves
    ~3e-8/step float noise (measured), which Adam's early-step
    m/sqrt(v)+eps dynamics amplify by orders of magnitude — with SGD the
    drift stays linear and the equivalence is assertable at 1e-6."""
    import jax.numpy as jnp
    import optax

    apply_nodrop = functools.partial(unet2d.apply, drp=0.0)
    opt = optax.sgd(1e-2)
    k = 4
    xs = rng.standard_normal((k, 2, 32, 32)).astype(np.float32)
    ys = (rng.random((k, 2, 32, 32)) > 0.8).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def fresh():
        params, state = unet2d.init(jax.random.PRNGKey(0), nfb=4)
        return params, state, opt.init(params)

    # Reference: unrolled single-step loop with split(key, k)[i] per step.
    params, state, opt_state = fresh()
    ema = jax.tree.map(jnp.copy, params)
    step1 = T.make_train_step(apply_nodrop, L.LOSSES["binary_crossentropy"],
                              opt)
    mets1 = []
    for i, sub in enumerate(jax.random.split(key, k)):
        params, state, opt_state, met = step1(params, state, opt_state,
                                              xs[i], ys[i], sub)
        ema = T.ema_update(ema, params, 0.9)
        mets1.append({kk: float(v) for kk, v in met.items()})

    # Scan: one dispatch.
    paramsK, stateK, opt_stateK = fresh()
    emaK = jax.tree.map(jnp.copy, paramsK)
    stepK = T.make_multi_step(apply_nodrop, L.LOSSES["binary_crossentropy"],
                              opt, k, ema_decay=0.9)
    paramsK, stateK, opt_stateK, emaK, metsK = stepK(
        paramsK, stateK, opt_stateK, emaK, xs, ys, key)

    for (n1, a), (n2, b) in zip(
            sorted(jax.tree_util.tree_leaves_with_path(params),
                   key=lambda t: str(t[0])),
            sorted(jax.tree_util.tree_leaves_with_path(paramsK),
                   key=lambda t: str(t[0]))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-5)
    for (n1, a), (n2, b) in zip(
            sorted(jax.tree_util.tree_leaves_with_path(ema),
                   key=lambda t: str(t[0])),
            sorted(jax.tree_util.tree_leaves_with_path(emaK),
                   key=lambda t: str(t[0]))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-5)
    for i in range(k):
        assert float(metsK["loss"][i]) == pytest.approx(
            mets1[i]["loss"], abs=1e-6)


def test_fit_steps_per_dispatch(fixture_paths, tmp_path, tiny_model):
    """fit(steps_per_dispatch=2) trains end-to-end (stacked prefetch, scan
    step) and rejects non-divisible K."""
    init_fn, apply_fn = tiny_model
    model = UNet2DSummary(cpdir=str(tmp_path / "cpK"), net_init_func=init_fn,
                          net_apply_func=apply_fn)
    hist, best = model.fit(fixture_paths[:1], shape_trn=(32, 32),
                           shape_val=(96, 96), batch_size_trn=4,
                           nb_steps_trn=4, nb_epochs=1,
                           steps_per_dispatch=2, ema_decay=0.5)
    assert best is not None and np.isfinite(hist["loss"][0])
    with pytest.raises(ValueError, match="divide"):
        model.fit(fixture_paths[:1], shape_trn=(32, 32), shape_val=(96, 96),
                  batch_size_trn=4, nb_steps_trn=5, nb_epochs=1,
                  steps_per_dispatch=2)


def test_fit_predict_submit(fixture_paths, tmp_path, tiny_model):
    init_fn, apply_fn = tiny_model
    model = UNet2DSummary(cpdir=str(tmp_path / "cp"), net_init_func=init_fn,
                          net_apply_func=apply_fn)
    history, best = model.fit(
        fixture_paths, shape_trn=(48, 48), shape_val=(96, 96),
        batch_size_trn=8, nb_steps_trn=10, nb_epochs=2, seed=7)

    assert best is not None and os.path.exists(best)
    assert len(history["loss"]) == 2
    assert "val_nf_f1_mean" in history
    # Mechanics, not convergence: loss finite and moving the right way over
    # the two 10-step epochs.
    assert np.isfinite(history["loss"]).all()
    assert history["loss"][-1] < 1.2 * history["loss"][0]

    # Predict without and with TTA.
    for aug in (False, True):
        Mp, names = model.predict(
            fixture_paths, best, window_shape=(96, 96), augmentation=aug,
            print_scores=True)
        assert len(Mp) == 2 and Mp[0].shape == (96, 96)
        assert Mp[0].dtype == np.uint8
        assert set(names) == {"synthetic.00.00", "synthetic.00.01"}

    # Submission JSON (challenge format).
    sub_path = str(tmp_path / "submission.json")
    nf_submit(Mp, names, sub_path)
    sub = json.load(open(sub_path))
    # Only the "neurofinder." prefix is stripped (nf.py:197-198); synthetic
    # names pass through unchanged.
    assert {s["dataset"] for s in sub} == {"synthetic.00.00", "synthetic.00.01"}
    for s in sub:
        assert isinstance(s["regions"], list) and len(s["regions"]) >= 1
        assert "coordinates" in s["regions"][0]


def test_fit_fast_train(fixture_paths, tmp_path):
    """fit(fast_train=True) — the W-packed gradient step — trains the stock
    net end-to-end: finite falling loss, checkpoints written."""
    import functools

    from deepcalcium_tpu.models import unet2d

    model = UNet2DSummary(cpdir=str(tmp_path / "cp"),
                          net_init_func=functools.partial(unet2d.init, nfb=4))
    history, best = model.fit(
        fixture_paths, shape_trn=(48, 48), shape_val=(96, 96),
        batch_size_trn=8, nb_steps_trn=6, nb_epochs=1, seed=3,
        fast_train=True)
    assert best is not None and os.path.exists(best)
    assert np.isfinite(history["loss"]).all()


def test_fit_with_stencil_mask_summary(fixture_paths, tmp_path):
    """The vectorized stencil mask summary as a production training-target
    source through the mask_summary_func injection point: fit must run
    end-to-end, and on the fixtures' realistic densities
    the stencil targets must stay within a small one-sided divergence of
    the exact walk."""
    import functools

    from deepcalcium_tpu.models import unet2d
    from deepcalcium_tpu.models.unet_2d_summary import (summarize_mask,
                                                        summarize_mask_stencil)

    for p in fixture_paths:
        ex = summarize_mask(p)
        st = summarize_mask_stencil(p)
        assert not np.any((st == 1) & (ex == 0))  # never adds pixels
        assert (ex == 1).sum() > 0
        assert ((ex == 1) & (st == 0)).sum() <= 0.05 * (ex == 1).sum()

    model = UNet2DSummary(cpdir=str(tmp_path / "cp"),
                          mask_summary_func=summarize_mask_stencil,
                          net_init_func=functools.partial(unet2d.init, nfb=4))
    history, best = model.fit(
        fixture_paths, shape_trn=(48, 48), shape_val=(96, 96),
        batch_size_trn=8, nb_steps_trn=2, nb_epochs=1, seed=3)
    assert best is not None and os.path.exists(best)
    assert np.isfinite(history["loss"]).all()


def test_fast_train_auto_logs_dispatch(fixture_paths, tmp_path, caplog):
    """fit(fast_train='auto') keeps the plain training forward (the faster
    gradient step on the H100), while the W-packed step stays reachable
    through fast_train=True and announces itself with one INFO line. The
    inference forward's 'auto' still picks the W-packed rewrite."""
    import functools
    import logging

    from deepcalcium_tpu.models import unet2d
    from deepcalcium_tpu.models.unet2d_fast import (apply_fast_w,
                                                    apply_fast_w_train)

    model = UNet2DSummary(cpdir=str(tmp_path / "cp"),
                          net_init_func=functools.partial(unet2d.init, nfb=4))
    with caplog.at_level(logging.INFO):
        model.fit(fixture_paths, shape_trn=(48, 48), shape_val=(96, 96),
                  batch_size_trn=8, nb_steps_trn=2, nb_epochs=1, seed=3,
                  fast_train="auto")
    assert not any("W-packed" in r.message for r in caplog.records)

    params, _ = unet2d.init(jax.random.PRNGKey(0), nfb=4)
    shapes = ((48, 48), (96, 96))
    assert model._resolve_apply_fn("auto", params, shapes,
                                   train=True).func is unet2d.apply
    assert model._resolve_apply_fn("auto", params, shapes,
                                   train=False).func is apply_fast_w
    caplog.clear()
    with caplog.at_level(logging.INFO):
        fn = model._resolve_apply_fn(True, params, shapes, train=True)
    assert fn.func is apply_fast_w_train
    assert any("W-packed training" in r.message for r in caplog.records)


def test_fit_weight_decay_and_rbg_prng(fixture_paths, tmp_path):
    """The two new training knobs: AdamW decoupled decay (the reference
    search's L2 axis) and the rbg PRNG for the dropout stream."""
    import functools

    from deepcalcium_tpu.models import unet2d

    model = UNet2DSummary(cpdir=str(tmp_path / "cp"),
                          net_init_func=functools.partial(unet2d.init, nfb=4))
    history, best = model.fit(
        fixture_paths, shape_trn=(48, 48), shape_val=(96, 96),
        batch_size_trn=8, nb_steps_trn=4, nb_epochs=1, seed=3,
        weight_decay=1e-4, prng_impl="rbg")
    assert best is not None and os.path.exists(best)
    assert np.isfinite(history["loss"]).all()

    # Decay must actually bite: with an absurd λ the weights shrink.
    p0, _ = unet2d.init(jax.random.PRNGKey(0), nfb=4)
    opt = T.make_optimizer(1e-3, weight_decay=0.5)
    os_ = opt.init(p0)
    import jax.numpy as jnp
    g = jax.tree.map(jnp.zeros_like, p0)
    upd, _ = opt.update(g, os_, p0)
    # AdamW with zero gradient: update = -lr * wd * w.
    w = p0["enc0a_conv"]["kernel"]
    np.testing.assert_allclose(np.asarray(upd["enc0a_conv"]["kernel"]),
                               np.asarray(-1e-3 * 0.5 * w), rtol=1e-5)


def test_fit_preset_perf(fixture_paths, tmp_path, caplog):
    """fit(preset='perf') bundles the measured throughput lever (K=4 scan
    dispatch; the PRNG stays as given), logs it, and trains to finite
    metrics; an unknown preset fails loudly."""
    import functools
    import logging

    from deepcalcium_tpu.models import unet2d

    model = UNet2DSummary(cpdir=str(tmp_path / "cp"),
                          net_init_func=functools.partial(unet2d.init,
                                                          nfb=4))
    with caplog.at_level(logging.INFO):
        history, best = model.fit(
            fixture_paths, shape_trn=(48, 48), shape_val=(96, 96),
            batch_size_trn=8, nb_steps_trn=4, nb_epochs=1, seed=3,
            preset="perf")
    assert best is not None and os.path.exists(best)
    assert np.isfinite(history["loss"]).all()
    joined = " ".join(r.getMessage() for r in caplog.records)
    assert "preset='perf': steps_per_dispatch=4" in joined
    assert "rbg" not in joined
    # nb_steps_trn=4 -> the preset's K=4 divides it exactly; with an
    # indivisible step count it must degrade to a legal K, not raise.
    history2, _ = model.fit(
        fixture_paths, shape_trn=(48, 48), shape_val=(96, 96),
        batch_size_trn=8, nb_steps_trn=3, nb_epochs=1, seed=3,
        preset="perf")
    assert np.isfinite(history2["loss"]).all()
    with pytest.raises(ValueError, match="preset"):
        model.fit(fixture_paths, shape_trn=(48, 48), shape_val=(96, 96),
                  batch_size_trn=8, nb_steps_trn=4, nb_epochs=1,
                  preset="turbo")


def test_predict_fast_matches_slow(fixture_paths, tmp_path):
    """predict(fast=True) — the W-packed inference rewrite — returns the
    same masks as the parity forward on a stock net."""
    import functools

    import jax

    from deepcalcium_tpu.models import unet2d
    from deepcalcium_tpu.train.checkpoints import save_checkpoint

    init_fn = functools.partial(unet2d.init, nfb=4)
    params, state = init_fn(jax.random.PRNGKey(5))
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, params, state)
    model = UNet2DSummary(cpdir=str(tmp_path / "cp"), net_init_func=init_fn)
    for aug in (False, True):
        mp_fast, _ = model.predict(fixture_paths, ckpt, window_shape=(96, 96),
                                   augmentation=aug, fast=True)
        mp_slow, _ = model.predict(fixture_paths, ckpt, window_shape=(96, 96),
                                   augmentation=aug, fast=False)
        for a, b in zip(mp_fast, mp_slow):
            np.testing.assert_array_equal(a, b)


def test_fit_resume_from_checkpoint(fixture_paths, tmp_path, tiny_model):
    """model_path + proceed=True must restore params and optimizer state."""
    init_fn, apply_fn = tiny_model
    model = UNet2DSummary(cpdir=str(tmp_path / "cp1"), net_init_func=init_fn,
                          net_apply_func=apply_fn)
    _, best = model.fit(fixture_paths, shape_trn=(48, 48), shape_val=(96, 96),
                        batch_size_trn=4, nb_steps_trn=3, nb_epochs=1, seed=7)
    model2 = UNet2DSummary(cpdir=str(tmp_path / "cp2"), net_init_func=init_fn,
                           net_apply_func=apply_fn)
    hist, best2 = model2.fit(
        fixture_paths, model_path=best, proceed=True, shape_trn=(48, 48),
        shape_val=(96, 96), batch_size_trn=4, nb_steps_trn=3, nb_epochs=1,
        seed=8)
    assert best2 is not None and len(hist["loss"]) == 1


def test_sharded_train_step_matches_single(rng):
    """The mesh-sharded step must produce the same update as unsharded
    (GSPMD all-reduce == one-device batch).

    Uses SGD: Adam's first step is ~lr*sign(grad), so float noise on
    near-zero grads flips signs and the comparison is ill-conditioned.
    """
    import optax

    mesh = __import__("deepcalcium_tpu.parallel.mesh", fromlist=["get_mesh"]).get_mesh(8)
    params, state = unet2d.init(jax.random.PRNGKey(0), nfb=4)
    opt = optax.inject_hyperparams(optax.sgd)(learning_rate=0.1)
    opt_state = opt.init(params)

    x = rng.standard_normal((8, 32, 32)).astype(np.float32)
    y = (rng.random((8, 32, 32)) > 0.8).astype(np.float32)
    k = jax.random.PRNGKey(5)

    # NB: dropout noise differs between layouts; use a dropout-free apply.
    apply_nodrop = functools.partial(unet2d.apply, drp=0.0)

    step1 = T.make_train_step(apply_nodrop, L.LOSSES["binary_crossentropy"], opt)
    p1, s1, o1, m1 = step1(jax.tree.map(jax.numpy.copy, params),
                           jax.tree.map(jax.numpy.copy, state),
                           opt.init(params), x, y, k)

    stepN = T.make_train_step(apply_nodrop, L.LOSSES["binary_crossentropy"], opt,
                              mesh=mesh)
    pN, sN, oN, mN = stepN(params, state, opt_state, x, y, k)

    np.testing.assert_allclose(float(m1["loss"]), float(mN["loss"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(pN)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-5)
    # BN moving stats must also agree (global-batch statistics).
    for a, b in zip(jax.tree.leaves(s1), jax.tree.leaves(sN)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-5)


def test_fit_with_mesh_and_dispatch_k(fixture_paths, tmp_path, tiny_model):
    """fit(mesh=..., steps_per_dispatch=2): GSPMD step + stacked sharded
    prefetch (batch axis = dim 1 of the (K, B, ...) slabs) end-to-end."""
    from jax.sharding import Mesh

    init_fn, apply_fn = tiny_model
    mesh = Mesh(np.array(jax.devices()), ("data",))
    model = UNet2DSummary(cpdir=str(tmp_path / "cpm"), net_init_func=init_fn,
                          net_apply_func=apply_fn)
    hist, best = model.fit(fixture_paths[:1], shape_trn=(32, 32),
                           shape_val=(96, 96), batch_size_trn=8,
                           nb_steps_trn=4, nb_epochs=1, mesh=mesh,
                           steps_per_dispatch=2)
    assert best is not None and np.isfinite(hist["loss"][0])


def test_fit_deterministic_across_runs(fixture_paths, tmp_path, tiny_model):
    """Same seed -> identical loss trajectory (a guarantee the reference's
    global-RNG Keras setup never had)."""
    init_fn, apply_fn = tiny_model

    def run(cp):
        model = UNet2DSummary(cpdir=str(tmp_path / cp), net_init_func=init_fn,
                              net_apply_func=apply_fn)
        hist, _ = model.fit(fixture_paths, shape_trn=(48, 48),
                            shape_val=(96, 96), batch_size_trn=4,
                            nb_steps_trn=4, nb_epochs=1, seed=11)
        return hist

    h1, h2 = run("cp_a"), run("cp_b")
    np.testing.assert_allclose(h1["loss"], h2["loss"], rtol=1e-6)
    np.testing.assert_allclose(h1["val_nf_f1_mean"], h2["val_nf_f1_mean"])


def test_prefetcher_stops_cleanly():
    """Regression: a finite generator must raise StopIteration, not hang."""
    from deepcalcium_tpu.train.sampler import Prefetcher

    pf = Prefetcher(iter([1, 2, 3]))
    assert list(pf) == [1, 2, 3]
    with pytest.raises(StopIteration):
        next(pf)


def test_predict_non_square_images(tmp_path, tiny_model):
    """Neurofinder images are non-square (e.g. 463x472); the pad->TTA->crop
    chain must round-trip their shapes."""
    from deepcalcium_tpu.train.evaluate import predict_batched, predict_tta
    from deepcalcium_tpu.train import trainer as T

    init_fn, apply_fn = tiny_model
    params, state = init_fn(jax.random.PRNGKey(0))
    fwd = T.make_eval_forward(apply_fn)
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((48, 64)).astype(np.float32),
              rng.standard_normal((64, 48)).astype(np.float32),
              rng.standard_normal((64, 64)).astype(np.float32)]
    for predictor in (predict_batched, predict_tta):
        out = predictor(fwd, params, state, images, window=(64, 64))
        assert [o.shape for o in out] == [(48, 64), (64, 48), (64, 64)]
        for o in out:
            assert np.isfinite(o).all()


def test_epoch_callbacks_invoked(fixture_paths, tmp_path, tiny_model):
    init_fn, apply_fn = tiny_model
    model = UNet2DSummary(cpdir=str(tmp_path / "cp"), net_init_func=init_fn,
                          net_apply_func=apply_fn)
    seen = []
    model.fit(fixture_paths, shape_trn=(48, 48), shape_val=(96, 96),
              batch_size_trn=4, nb_steps_trn=2, nb_epochs=2, seed=5,
              epoch_callbacks=[lambda e, logs: seen.append((e, logs["loss"]))])
    assert [e for e, _ in seen] == [0, 1]
    assert all(np.isfinite(l) for _, l in seen)


def test_fit_ema_lag_warning(fixture_paths, tmp_path, tiny_model, caplog):
    """An EMA decay too slow for the step budget must warn loudly (measured
    pitfall: decay .999 over 800 steps keeps ~45% init weights)."""
    import logging as _logging

    init_fn, apply_fn = tiny_model
    model = UNet2DSummary(cpdir=str(tmp_path / "cp"), net_init_func=init_fn,
                          net_apply_func=apply_fn)
    with caplog.at_level(_logging.WARNING):
        model.fit(fixture_paths, shape_trn=(48, 48), shape_val=(96, 96),
                  batch_size_trn=4, nb_steps_trn=2, nb_epochs=1, seed=5,
                  ema_decay=0.999)
    assert any("INIT weights" in r.message for r in caplog.records)


def test_fit_with_ema(fixture_paths, tmp_path, tiny_model):
    init_fn, apply_fn = tiny_model
    model = UNet2DSummary(cpdir=str(tmp_path / "cp"), net_init_func=init_fn,
                          net_apply_func=apply_fn)
    hist, best = model.fit(fixture_paths, shape_trn=(48, 48),
                           shape_val=(96, 96), batch_size_trn=4,
                           nb_steps_trn=3, nb_epochs=1, seed=5,
                           ema_decay=0.9)
    assert best is not None and np.isfinite(hist["loss"]).all()
    # The checkpointed EMA weights drive predict without issue.
    Mp, _ = model.predict(fixture_paths, best, window_shape=(96, 96))
    assert Mp[0].shape == (96, 96)


def test_predict_tiled_large_image(tiny_model):
    """Images larger than the window tile + blend (beyond-reference)."""
    from deepcalcium_tpu.train.evaluate import predict_batched, predict_tiled
    from deepcalcium_tpu.train import trainer as T

    init_fn, apply_fn = tiny_model
    params, state = init_fn(jax.random.PRNGKey(0))
    fwd = T.make_eval_forward(apply_fn)
    rng = np.random.default_rng(3)
    big = rng.standard_normal((112, 160)).astype(np.float32)

    out = predict_tiled(fwd, params, state, big, window=(64, 64), overlap=16)
    assert out.shape == (112, 160)
    assert np.isfinite(out).all() and 0 <= out.min() and out.max() <= 1

    # Exact indexing oracle: with an identity "network" every tile carries
    # the original pixel values, so tile + overlap-average must reconstruct
    # the image EXACTLY — any tiling/blending offset error breaks this
    # (the previous median-distance check against a real net would have
    # passed for fairly wrong blends).
    ident = lambda params, state, x: x
    rec = predict_tiled(ident, params, state, big, window=(64, 64),
                        overlap=16)
    np.testing.assert_allclose(rec, big, atol=1e-6, rtol=0)
    # ... including ragged tile edges (window does not divide the image).
    rec2 = predict_tiled(ident, params, state, big, window=(64, 64),
                         overlap=24)
    np.testing.assert_allclose(rec2, big, atol=1e-6, rtol=0)

    # And the real net agrees with a single big-window pass away from the
    # borders (receptive-field effects live near tile seams).
    whole = predict_batched(fwd, params, state, [big], window=(112, 160))[0]
    diff = np.abs(out - whole)
    assert np.median(diff) < 0.25


def test_predict_tiled_tta_single_tile_matches_predict_tta(tiny_model):
    """predict_tiled(tta=True) is the tiled generalization of predict_tta:
    when the image fits ONE tile they must agree exactly (same pad, same
    8-view batch, same collapse)."""
    from deepcalcium_tpu.train.evaluate import predict_tiled, predict_tta

    init_fn, apply_fn = tiny_model
    params, state = init_fn(jax.random.PRNGKey(0))
    fwd = T.make_eval_forward(apply_fn)
    img = np.random.default_rng(7).standard_normal((50, 61)).astype(np.float32)

    tiled = predict_tiled(fwd, params, state, img, window=(64, 64), tta=True)
    ref = predict_tta(fwd, params, state, [img], window=(64, 64))[0]
    np.testing.assert_allclose(tiled, ref, atol=1e-6, rtol=0)


def test_evaluate_movie_tiled_backend_threading(tiny_model):
    """The tiled movie evaluator must honor an explicit summary backend
    (round-5 review: it hardcoded StreamingSummary's default, so the
    thin-link host routing evaluate_movie probes for could not be forced
    on the oversized path) and produce the same result either way."""
    from deepcalcium_tpu.train.evaluate import evaluate_movie_tiled

    init_fn, apply_fn = tiny_model
    params, state = init_fn(jax.random.PRNGKey(0))
    movie = np.random.default_rng(11).standard_normal(
        (12, 96, 130)).astype(np.float32)

    outs = {}
    for backend in ("host", "device"):
        mask, prob, mean = evaluate_movie_tiled(
            apply_fn, params, state, movie, window=(64, 64), tta=False,
            backend=backend)
        assert mask.shape == prob.shape == mean.shape == (96, 130)
        outs[backend] = (mask, prob, mean)
    np.testing.assert_allclose(outs["host"][2], outs["device"][2],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs["host"][1], outs["device"][1],
                               rtol=1e-4, atol=1e-4)


def test_predict_public_dispatch_oversized(tmp_path, tiny_model):
    """Oversized fields of view must work through the
    PUBLIC UNet2DSummary.predict — mixed with in-window datasets in one
    call, with and without TTA — instead of raising in reflect_pad_to."""
    from deepcalcium_tpu.data.fixtures import make_neurons_hdf5 as mk

    big = mk(str(tmp_path / "big" / "dataset.hdf5"), name="synthetic.big",
             shape=(112, 160), nb_frames=24, nb_neurons=10, seed=3)
    small = mk(str(tmp_path / "small" / "dataset.hdf5"), name="synthetic.sm",
               shape=(96, 96), nb_frames=24, nb_neurons=8, seed=4)

    init_fn, apply_fn = tiny_model
    model = UNet2DSummary(cpdir=str(tmp_path / "cp"), net_init_func=init_fn,
                          net_apply_func=apply_fn)
    params, state = init_fn(jax.random.PRNGKey(0))
    ckpt = str(tmp_path / "cp" / "m.ckpt")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    from deepcalcium_tpu.train.checkpoints import save_checkpoint
    save_checkpoint(ckpt, params, state)

    for aug in (False, True):
        Mp, names = model.predict([big, small], ckpt, window_shape=(96, 96),
                                  augmentation=aug)
        assert Mp[0].shape == (112, 160) and Mp[1].shape == (96, 96)
        assert all(np.isfinite(m).all() for m in Mp)
        assert set(np.unique(Mp[0])) <= {0, 1}


def test_evaluate_movie_oversized(tiny_model):
    """evaluate_movie on frames larger than the window dispatches to the
    tiled path (streaming summary + sliding-window forward)."""
    init_fn, apply_fn = tiny_model
    params, state = init_fn(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    movie = rng.integers(0, 800, (6, 112, 160)).astype(np.int16)

    model = UNet2DSummary(cpdir="/tmp/dc_tpu_test_emov", net_init_func=init_fn,
                          net_apply_func=apply_fn)
    mask, prob = model.evaluate_movie(movie, params=params, state=state,
                                      window_shape=(96, 96), tta=False)
    assert mask.shape == (112, 160) and prob.shape == (112, 160)
    assert np.isfinite(prob).all() and 0 <= prob.min() and prob.max() <= 1


def test_resume_latest_empty_dir_raises(fixture_paths, tmp_path, tiny_model):
    init_fn, apply_fn = tiny_model
    model = UNet2DSummary(cpdir=str(tmp_path / "empty"), net_init_func=init_fn,
                          net_apply_func=apply_fn)
    with pytest.raises(FileNotFoundError):
        model.fit(fixture_paths, model_path="latest", proceed=True,
                  shape_trn=(48, 48), shape_val=(96, 96), nb_epochs=1)


def test_predict_latest_resolution(tmp_path, tiny_model):
    """predict/_load_params accept model_path='latest' like fit does."""
    init_fn, apply_fn = tiny_model
    model = UNet2DSummary(cpdir=str(tmp_path / "cp"), net_init_func=init_fn,
                          net_apply_func=apply_fn)
    # Empty cpdir: loud error, same contract as fit's resume.
    with pytest.raises(FileNotFoundError):
        model._load_params("latest")
    # Save one checkpoint, then 'latest' resolves to it.
    from deepcalcium_tpu.train.checkpoints import save_checkpoint

    params0, state0 = init_fn(jax.random.PRNGKey(0))
    os.makedirs(model.cpdir, exist_ok=True)
    save_checkpoint(os.path.join(model.cpdir, "model_00_0.500.ckpt"),
                    params0, state0)
    params, state = model._load_params("latest")
    a = jax.tree_util.tree_leaves(params)
    b = jax.tree_util.tree_leaves(params0)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y))


def test_cosine_decay_endpoints():
    """Cosine schedule: starts at base_lr, ends at min_lr, monotone."""
    cos = T.CosineDecay(2e-3, total_epochs=10, min_lr=1e-4)
    lrs = [cos.lr_at(e) for e in range(11)]
    assert lrs[0] == pytest.approx(2e-3)
    assert lrs[-1] == pytest.approx(1e-4)
    assert all(a >= b for a, b in zip(lrs, lrs[1:]))
    # Past the horizon it clamps at the floor.
    assert cos.lr_at(99) == pytest.approx(1e-4)


def test_fit_cosine_schedule_and_remat(fixture_paths, tmp_path, tiny_model):
    """lr_schedule='cosine' anneals the recorded lr; remat=True trains the
    same recipe (big-window knob) without changing mechanics."""
    init_fn, apply_fn = tiny_model
    model = UNet2DSummary(cpdir=str(tmp_path / "cp"), net_init_func=init_fn,
                          net_apply_func=apply_fn, remat=True)
    hist, best = model.fit(fixture_paths, shape_trn=(48, 48),
                           shape_val=(96, 96), batch_size_trn=4,
                           nb_steps_trn=2, nb_epochs=3, seed=5,
                           lr_schedule="cosine")
    assert best is not None and np.isfinite(hist["loss"]).all()
    # lr is logged per-epoch BEFORE the end-of-epoch schedule step: epoch 0
    # runs at base lr, later epochs at the annealed values.
    cos = T.CosineDecay(2e-3, 3, min_lr=1e-4)
    assert hist["lr"][0] == pytest.approx(2e-3)
    assert hist["lr"][1] == pytest.approx(cos.lr_at(1), rel=1e-5)
    assert hist["lr"][2] == pytest.approx(cos.lr_at(2), rel=1e-5)


def test_fit_rejects_unknown_lr_schedule(fixture_paths, tmp_path, tiny_model):
    init_fn, apply_fn = tiny_model
    model = UNet2DSummary(cpdir=str(tmp_path / "cp"), net_init_func=init_fn,
                          net_apply_func=apply_fn)
    with pytest.raises(ValueError, match="lr_schedule"):
        model.fit(fixture_paths, shape_trn=(48, 48), shape_val=(96, 96),
                  nb_epochs=1, lr_schedule="warmup???")


def test_predict_tiled_rejects_bad_overlap(tiny_model):
    from deepcalcium_tpu.train.evaluate import predict_tiled
    from deepcalcium_tpu.train import trainer as T

    init_fn, apply_fn = tiny_model
    params, state = init_fn(jax.random.PRNGKey(0))
    fwd = T.make_eval_forward(apply_fn)
    big = np.zeros((112, 112), np.float32)
    with pytest.raises(ValueError, match="overlap"):
        predict_tiled(fwd, params, state, big, window=(64, 64), overlap=64)


def test_tile_grid_geometry():
    """tile_grid is the single source of the sliding-window geometry
    (predict_tiled's tiles AND predict's views/s accounting)."""
    from deepcalcium_tpu.train.evaluate import tile_grid

    # In-window dims: one corner at 0 per axis.
    assert tile_grid((96, 96), (128, 128)) == ([0], [0])
    # Exact stride multiple: no appended edge tile. window 96, default
    # overlap min(64, 48) = 48 -> stride 48; h=144 -> corners [0, 48].
    assert tile_grid((144, 96), (96, 96)) == ([0, 48], [0])
    # Non-multiple: the edge tile is appended at ph - hw.
    assert tile_grid((150, 96), (96, 96)) == ([0, 48, 54], [0])
    # Every grid covers the (padded) image exactly to the far edge.
    for shape in ((150, 203), (96, 700), (512, 512), (700, 600)):
        ys, xs = tile_grid(shape, (96, 96))
        assert ys[-1] + 96 == max(shape[0], 96)
        assert xs[-1] + 96 == max(shape[1], 96)
        assert ys == sorted(set(ys)) and xs == sorted(set(xs))
    with pytest.raises(ValueError, match="overlap"):
        tile_grid((112, 112), (64, 64), overlap=64)


def test_fit_and_evaluate_movie_reject_bad_knobs(tmp_path, tiny_model):
    """Early ValueErrors (review r5c): window sides not %16 fail BEFORE
    the disk-bound dataset summaries (the paths here don't even exist),
    and params-without-state fails at the call, not at trace time inside
    fold_bn with a NoneType subscript."""
    init_fn, apply_fn = tiny_model
    model = UNet2DSummary(cpdir=str(tmp_path / "cpV"), net_init_func=init_fn,
                          net_apply_func=apply_fn)
    with pytest.raises(ValueError, match="multiples of 16"):
        model.fit(["/nonexistent.hdf5"], shape_trn=(100, 100),
                  shape_val=(96, 96))
    with pytest.raises(ValueError, match="multiples of 16"):
        model.fit(["/nonexistent.hdf5"], shape_trn=(32, 32),
                  shape_val=(100, 100))
    with pytest.raises(ValueError, match="without state"):
        model.evaluate_movie(np.zeros((4, 96, 96), np.float32),
                             params={"enc0a": None})


def test_run_batched_pads_to_one_compiled_shape():
    """_run_batched's contract: every slab reaches fwd at the SAME batch
    shape (ragged tails and small inputs zero-pad up; outputs crop back)
    — one compiled shape per (max_batch, item-shape), never per dataset
    size."""
    from deepcalcium_tpu.train.evaluate import _run_batched

    seen = []

    def fwd(params, state, x):
        seen.append(x.shape)
        return np.asarray(x) * 2.0

    data = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    out = _run_batched(fwd, None, None, data, max_batch=4)
    assert [s[0] for s in seen] == [4, 4, 4]  # 10 -> 4+4+2pad
    np.testing.assert_array_equal(out, data * 2.0)

    seen.clear()
    out = _run_batched(fwd, None, None, data[:2], max_batch=4)
    assert [s[0] for s in seen] == [4]  # n < max_batch pads up too
    np.testing.assert_array_equal(out, data[:2] * 2.0)


def test_stack_batches_slabs_consecutive():
    """stack_batches(gen, k) must emit (k, B, ...) slabs of k CONSECUTIVE
    batches, preserving order across calls (the K-scan dispatch feeder —
    trainer.make_multi_step consumes one slab per dispatch)."""
    from deepcalcium_tpu.train.sampler import stack_batches

    def gen():
        i = 0
        while True:
            yield (np.full((2, 3), i, np.float32),
                   np.full((2,), -float(i), np.float32))
            i += 1

    g = stack_batches(gen(), 3)
    x, y = next(g)
    assert x.shape == (3, 2, 3) and y.shape == (3, 2)
    assert [int(x[j, 0, 0]) for j in range(3)] == [0, 1, 2]
    x2, y2 = next(g)
    assert [int(x2[j, 0, 0]) for j in range(3)] == [3, 4, 5]
    assert float(y2[0, 0]) == -3.0


def test_make_put_fn_sharding():
    """make_put_fn must shard the batch axis over the mesh's data axis:
    dim 1 for (K, B, ...) K-dispatch slabs, dim 0 for plain batches, and a
    plain device_put without a mesh (the shared 1-D/2-D fit feeder)."""
    from deepcalcium_tpu.parallel.mesh import get_mesh
    from deepcalcium_tpu.train.sampler import make_put_fn

    mesh = get_mesh()
    x = np.zeros((4, 8, 6), np.float32)
    (xk,) = make_put_fn(mesh, kdisp=2)((x,))
    assert not xk.sharding.is_fully_replicated
    assert xk.sharding.shard_shape(xk.shape)[1] == 8 // len(jax.devices())
    (x0,) = make_put_fn(mesh, kdisp=1)((x[0],))
    assert x0.sharding.shard_shape(x0.shape)[0] == 8 // len(jax.devices())
    (xp,) = make_put_fn(None)((x,))
    assert xp.shape == x.shape


def test_shard_batch_scalar_leaf_replicates():
    """Rank-0 leaves in a batch pytree must replicate (P() on a scalar),
    not raise a sharding rank error."""
    from deepcalcium_tpu.parallel.mesh import get_mesh, shard_batch

    mesh = get_mesh()
    out = shard_batch(mesh, {"x": np.zeros((8, 4), np.float32),
                             "w": np.float32(2.5)})
    assert float(out["w"]) == 2.5
    assert out["x"].sharding.shard_shape(out["x"].shape)[0] == \
        8 // len(jax.devices())
