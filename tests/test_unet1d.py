"""UNet1D model + UNet1DSegmentation wrapper on synthetic spike data."""

import jax
import numpy as np
import pytest

from deepcalcium_tpu.data.fixtures import make_spikes_hdf5
from deepcalcium_tpu.models import unet1d
from deepcalcium_tpu.models.unet_1d_segmentation import (
    UNet1DSegmentation,
    get_dataset_traces,
    maxpool_labels,
)


@pytest.fixture(scope="module")
def tiny1d():
    return unet1d.init(jax.random.PRNGKey(0), nfb=4)


def test_output_shape_and_range(tiny1d):
    params, state = tiny1d
    x = np.random.default_rng(0).standard_normal((3, 128)).astype(np.float32)
    probs, _ = unet1d.apply(params, state, x)
    assert probs.shape == (3, 128)
    assert np.asarray(probs).min() >= 0 and np.asarray(probs).max() <= 1


def test_length_polymorphism(tiny1d):
    params, state = tiny1d
    for t in (64, 256):
        probs, _ = unet1d.apply(params, state, np.zeros((1, t), np.float32))
        assert probs.shape == (1, t)


def test_margin_head_dilates_positives(tiny1d):
    """A larger margin must produce wider positive stripes (the pre-softmax
    max-pool; reference unet_1d_segmentation.py:139-141)."""
    params, state = tiny1d
    x = np.random.default_rng(1).standard_normal((2, 128)).astype(np.float32)
    p0, _ = unet1d.apply(params, state, x, margin=0)
    p8, _ = unet1d.apply(params, state, x, margin=8)
    # STRICTLY greater: a tolerance-padded >= passes even if margin becomes
    # a silent no-op (p8 == p0), which is the regression this test guards.
    assert float(np.asarray(p8).mean()) > float(np.asarray(p0).mean())
    assert not np.array_equal(np.asarray(p8), np.asarray(p0))


def test_maxpool_labels_oracle():
    s = np.zeros((1, 20), np.float32)
    s[0, 10] = 1
    out = maxpool_labels(s, margin=4)  # window 5, SAME
    (xx,) = np.where(out[0] == 1)
    np.testing.assert_array_equal(xx, [8, 9, 10, 11, 12])
    np.testing.assert_array_equal(maxpool_labels(s, margin=0), s)


def test_maxpool_labels_matches_reduce_window():
    """Host sliding-window max == lax.reduce_window SAME — window
    placement parity for odd AND even windows on ragged lengths.

    maxpool_labels is host numpy on purpose (a device pool specializes on
    every distinct trace length — one compile per length with ragged
    datasets); this pins it to the XLA SAME semantics it replaced."""
    import jax.numpy as jnp
    from jax import lax

    rng = np.random.default_rng(0)
    for margin in (1, 2, 4, 7):  # windows 2 (even), 3, 5, 8 (even)
        for t in (15, 16, 33):
            s = (rng.random((3, t)) < 0.2).astype(np.float32)
            got = maxpool_labels(s, margin)
            want = lax.reduce_window(
                jnp.asarray(s)[..., None], -jnp.inf, lax.max,
                (1, margin + 1, 1), (1, 1, 1), "SAME")[..., 0]
            np.testing.assert_array_equal(got, np.asarray(want))
            assert got.dtype == np.float32


def test_fit_rejects_bad_knobs_before_io(tmp_path):
    """Knob typos fail IMMEDIATELY (paths here don't exist — validation
    must fire before any dataset IO), not minutes later at trace time."""
    model = UNet1DSegmentation(cpdir=str(tmp_path / "cp"))
    with pytest.raises(ValueError, match="multiple of 16"):
        model.fit(["/nonexistent.hdf5"], shape=(1000,))
    with pytest.raises(ValueError, match="lie in"):
        model.fit(["/nonexistent.hdf5"], shape=(128,),
                  prop_trn=1.0, prop_val=0.0)


def test_traces_z_normalized(tmp_path):
    p = make_spikes_hdf5(str(tmp_path / "sp.hdf5"), nb_traces=4, trace_len=256)
    tr = get_dataset_traces(p)
    np.testing.assert_allclose(tr.mean(axis=1), 0, atol=1e-9)
    np.testing.assert_allclose(tr.std(axis=1), 1, atol=1e-6)


def test_fit_predict_random_split(tmp_path):
    paths = [make_spikes_hdf5(str(tmp_path / f"sp{i}.hdf5"),
                              name=f"spikes.{i}", nb_traces=8, trace_len=256,
                              seed=i) for i in range(2)]
    import functools

    model = UNet1DSegmentation(
        cpdir=str(tmp_path / "cp"),
        net_init_func=functools.partial(unet1d.init, nfb=4))
    mt, mv, best = model.fit(paths, shape=(128,), error_margin=4, batch=8,
                             nb_epochs=2, val_type="random_split", seed=3)
    assert best is not None
    assert set(mt) == set(mv) == {"F2", "prec", "reca", "ytspks", "ypspks"}

    preds, names = model.predict(paths, best, batch=8)
    assert names == ["spikes.0", "spikes.1"]
    assert preds[0].shape == (8, 256)
    assert preds[0].dtype == np.uint8

    # Batch size must not change predictions: batch=32 > n pads the slab
    # to the fixed compiled shape (evaluate._run_batched policy).
    preds32, _ = model.predict(paths, best, batch=32)
    np.testing.assert_array_equal(preds32[0], preds[0])
    np.testing.assert_array_equal(preds32[1], preds[1])


def test_fit_k_step_dispatch(tmp_path, caplog):
    """steps_per_dispatch=2: K batches fold through one lax.scan dispatch
    (the 2-D loop's dispatch-gap fix, carried to the 1-D fit); training
    must complete with finite metrics, and predict(fast='auto') must log
    the T-packed dispatch."""
    import functools
    import logging

    paths = [make_spikes_hdf5(str(tmp_path / f"sp{i}.hdf5"),
                              name=f"spikes.{i}", nb_traces=8, trace_len=256,
                              seed=10 + i) for i in range(2)]
    model = UNet1DSegmentation(
        cpdir=str(tmp_path / "cp"),
        net_init_func=functools.partial(unet1d.init, nfb=4))
    # 16 traces * 0.8 = 12 train -> ceil(12/8) = 2 steps/epoch; K=2 divides.
    mt, mv, best = model.fit(paths, shape=(128,), error_margin=4, batch=8,
                             nb_epochs=2, val_type="random_split", seed=3,
                             steps_per_dispatch=2)
    assert best is not None
    assert all(np.isfinite(v) for v in mv.values())

    # K must divide the per-epoch step count.
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        model.fit(paths, shape=(128,), error_margin=4, batch=8, nb_epochs=1,
                  val_type="random_split", seed=3, steps_per_dispatch=3)

    with caplog.at_level(logging.INFO):
        model.predict(paths, best, batch=8, fast="auto")
    assert any("T-packed" in r.message for r in caplog.records)


def test_fit_preset_perf(tmp_path, caplog):
    """preset='perf' = auto K-scan dispatch (the measured 1-D throughput
    lever; the PRNG stays as given). The preset must resolve K to the
    largest of (4, 2, 1) dividing the split's per-epoch step count — here
    16*0.8=12 train traces / batch 8 -> 2 steps/epoch -> K=2 — and train
    to finite metrics."""
    import functools
    import logging

    paths = [make_spikes_hdf5(str(tmp_path / f"sp{i}.hdf5"),
                              name=f"spikes.{i}", nb_traces=8, trace_len=256,
                              seed=20 + i) for i in range(2)]
    model = UNet1DSegmentation(
        cpdir=str(tmp_path / "cp"),
        net_init_func=functools.partial(unet1d.init, nfb=4))
    with caplog.at_level(logging.INFO):
        mt, mv, best = model.fit(paths, shape=(128,), error_margin=4,
                                 batch=8, nb_epochs=1,
                                 val_type="random_split", seed=3,
                                 preset="perf")
    assert best is not None
    assert all(np.isfinite(v) for v in mv.values())
    msgs = [r.message for r in caplog.records]
    assert not any("rbg" in m for m in msgs)
    assert any("steps_per_dispatch=2" in m for m in msgs)

    with pytest.raises(ValueError, match="preset"):
        model.fit(paths, shape=(128,), error_margin=4, batch=8, nb_epochs=1,
                  val_type="random_split", seed=3, preset="fastest")
    # steps_per_dispatch=0 must stay a user error — it must NOT collide
    # with the preset's internal auto-K sentinel (review finding, round 5).
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        model.fit(paths, shape=(128,), error_margin=4, batch=8, nb_epochs=1,
                  val_type="random_split", seed=3, steps_per_dispatch=0)


def test_slope_train1d_ab_helper_cpu():
    """The interleaved 1-D A/B timer returns one positive per-step time
    per PRNG impl from ONE shared setup (tiny shapes; numerics-only —
    real timings come from bench.py on a GPU)."""
    from deepcalcium_tpu.utils.benchtools import slope_train1d_step_time_ab

    out = slope_train1d_step_time_ab(2, 64, k=3, kmin=1, reps=1, nfb=4,
                                     rng_impls=("threefry2x32", "rbg"))
    assert set(out) == {"threefry2x32", "rbg"}
    # CPU timings are noise; the contract is presence + sane type. A
    # negative slope is possible in noise at reps=1, so only finiteness
    # is asserted.
    assert all(np.isfinite(v) for v in out.values())


def test_fit_cross_validate(tmp_path):
    import functools

    path = make_spikes_hdf5(str(tmp_path / "sp.hdf5"), nb_traces=10,
                            trace_len=128, seed=5)
    model = UNet1DSegmentation(
        cpdir=str(tmp_path / "cp"),
        net_init_func=functools.partial(unet1d.init, nfb=4))
    agg = model.fit([path], shape=(64,), error_margin=2, batch=4, nb_epochs=1,
                    val_type="cross_validate", nb_folds=2, seed=3)
    assert "F2" in agg and "val_mean" in agg["F2"]


def test_glm_baseline_learns(tmp_path):
    """The C2S-capability GLM baseline must beat chance on clean synthetic
    traces (spikes produce a sharp kernel the linear filter can match)."""
    from deepcalcium_tpu.models.glm_spikes import GLMSegmentation

    paths = [make_spikes_hdf5(str(tmp_path / f"g{i}.hdf5"), name=f"g.{i}",
                              nb_traces=16, trace_len=512, seed=i)
             for i in range(2)]
    model = GLMSegmentation(cpdir=str(tmp_path / "cp"), filter_len=21)
    mt, mv, ckpt = model.fit(paths, nb_epochs=150, error_margin=4, seed=1)
    assert mv["F2"] > 0.3, mv
    preds, names = model.predict(paths, ckpt)
    assert names == ["g.0", "g.1"]
    assert preds[0].shape == (16, 512) and preds[0].dtype == np.uint8


def test_stm_learns_and_predicts_rates(tmp_path):
    """The STM (quadratic feature mixture + exponential nonlinearity +
    Poisson likelihood — the c2s STM semantics) must learn the synthetic
    spike kernel at least as well as chance, expose Poisson rates, and
    refuse checkpoints of the wrong arch."""
    from deepcalcium_tpu.models.glm_spikes import GLMSegmentation

    paths = [make_spikes_hdf5(str(tmp_path / f"s{i}.hdf5"), name=f"s.{i}",
                              nb_traces=16, trace_len=512, seed=10 + i)
             for i in range(2)]
    model = GLMSegmentation(cpdir=str(tmp_path / "cps"), filter_len=21,
                            arch="stm")
    mt, mv, ckpt = model.fit(paths, nb_epochs=250, error_margin=4, seed=1)
    assert np.isfinite(mv["F2"]) and mv["F2"] > 0.3, mv

    preds, names = model.predict(paths, ckpt)
    assert preds[0].shape == (16, 512) and preds[0].dtype == np.uint8
    rates, _ = model.predict_rates(paths, ckpt)
    assert rates[0].shape == (16, 512)
    assert (rates[0] >= 0).all() and np.isfinite(rates[0]).all()

    # Arch guard: a GLM wrapper must refuse the STM checkpoint.
    glm = GLMSegmentation(cpdir=str(tmp_path / "cpg"), filter_len=21)
    with pytest.raises(Exception):
        glm.predict(paths, ckpt)
    with pytest.raises(ValueError, match="stm"):
        glm.predict_rates(paths, ckpt)


def test_margin_metrics_helper():
    from deepcalcium_tpu.models.unet_1d_segmentation import margin_metrics

    yt = np.zeros((1, 30), np.float32)
    yt[0, 10] = 1
    yp = np.zeros((1, 30), np.float32)
    yp[0, 12] = 1  # off by 2 — inside margin 4
    m = margin_metrics(yt, yp, margin=4)
    assert m["prec"] == pytest.approx(1.0, abs=1e-5)
    m0 = margin_metrics(yt, yp, margin=0)
    assert m0["prec"] == pytest.approx(0.0, abs=1e-5)


def test_glm_ragged_datasets_and_guards(tmp_path):
    """GLM fit must (a) accept datasets with DIFFERENT trace lengths
    (padded + loss-masked), (b) reject a split that leaves zero train or
    val traces, and (c) reject nb_epochs < 1 — previously (a) crashed in
    np.concatenate and (b) silently checkpointed an untrained init with
    NaN metrics."""
    from deepcalcium_tpu.data.fixtures import make_spikes_hdf5
    from deepcalcium_tpu.models.glm_spikes import GLMSegmentation

    p1 = make_spikes_hdf5(str(tmp_path / "a.hdf5"), nb_traces=8,
                          trace_len=256, seed=1)
    p2 = make_spikes_hdf5(str(tmp_path / "b.hdf5"), nb_traces=8,
                          trace_len=384, seed=2)
    model = GLMSegmentation(cpdir=str(tmp_path / "cp"), filter_len=21)
    mt, mv, ckpt = model.fit([p1, p2], nb_epochs=60, seed=3)
    assert np.isfinite(mv["F2"]) and ckpt

    one = make_spikes_hdf5(str(tmp_path / "one.hdf5"), nb_traces=1,
                           trace_len=128, seed=4)
    with pytest.raises(ValueError, match="empty split"):
        model.fit([one])
    with pytest.raises(ValueError, match="nb_epochs"):
        model.fit([p1], nb_epochs=0)


def test_forward_flops_matches_param_shapes():
    """Analytic FLOPs (bench.py's 1-D MFU accounting) recomputed from the
    ACTUAL init param shapes x each layer's temporal length — an
    independent census of the fan-ins, including the UpSampling-keeps-
    channels concat quirk (_CONCAT_CIN)."""
    t = 256
    params, _ = unet1d.init(jax.random.PRNGKey(0), nfb=32)
    level_t = {"enc0": t, "dec0": t, "head": t,
               "enc1": t // 2, "dec1": t // 2,
               "enc2": t // 4, "dec2": t // 4,
               "enc3": t // 8, "dec3": t // 8,
               "mid": t // 16}
    expected = 0
    for name, p in params.items():
        if not name.endswith("_conv"):
            continue
        k, cin, cout = p["kernel"].shape
        prefix = name[:-5].rstrip("ab")
        expected += 2 * k * cin * cout * level_t[prefix]
    assert unet1d.forward_flops(t) == expected
    # Fully convolutional: FLOPs are linear in T.
    assert unet1d.forward_flops(2 * t) == 2 * expected


def test_pool2_axis_matches_reduce_window_1d():
    """The 1-D T-pool (blocks.pool2_axis) == reduce_window fwd+bwd
    including tie routing on (B, T, C) activations."""
    import jax.numpy as jnp
    import numpy as np

    from deepcalcium_tpu.models import blocks as B

    def ref(z):
        return jax.lax.reduce_window(z, -jnp.inf, jax.lax.max,
                                     (1, 2, 1), (1, 2, 1), "VALID")

    rng = np.random.default_rng(7)
    z = jnp.maximum(jnp.asarray(rng.standard_normal((3, 32, 4)),
                                jnp.float32), 0.0)
    z = z.at[:, 0::4].set(z[:, 1::4])  # forced exact ties

    o_ref, vjp_ref = jax.vjp(ref, z)
    o_new, vjp_new = jax.vjp(lambda h: B.pool2_axis(h, 1), z)
    np.testing.assert_array_equal(np.asarray(o_ref), np.asarray(o_new))
    ct = jnp.asarray(rng.standard_normal(o_ref.shape), jnp.float32)
    np.testing.assert_array_equal(np.asarray(vjp_ref(ct)[0]),
                                  np.asarray(vjp_new(ct)[0]))


def test_pool2_axis_rejects_negative_axis():
    """A negative axis would silently corrupt the backward interleave
    (the vjp stacks the window pair at axis+1, which lands at the wrong
    position for axis<0 while the reshape still succeeds) — so it must
    raise, on the forward AND under differentiation (custom_vjp calls
    the fwd rule directly)."""
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from deepcalcium_tpu.models import blocks as B

    z = jnp.asarray(np.arange(24, dtype=np.float32).reshape(2, 4, 3))
    with pytest.raises(ValueError, match="non-negative"):
        B.pool2_axis(z, -2)
    with pytest.raises(ValueError, match="non-negative"):
        jax.vjp(lambda h: B.pool2_axis(h, -2), z)
    # The equivalent non-negative axis stays exact.
    np.testing.assert_array_equal(
        np.asarray(B.pool2_axis(z, 1)),
        np.asarray(jnp.maximum(z[:, 0::2], z[:, 1::2])))
