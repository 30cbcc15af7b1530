"""apply_fast_t (T-packed UNet1D inference rewrite) vs the parity forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepcalcium_tpu.models import unet1d
from deepcalcium_tpu.models.unet1d_fast import apply_fast_t, tpack_conv5_kernel


@pytest.fixture(scope="module")
def net():
    params, state = unet1d.init(jax.random.PRNGKey(0), nfb=4)
    # Randomize BN state so the folding is actually exercised.
    k = jax.random.PRNGKey(9)
    state = jax.tree.map(
        lambda v: v + 0.3 * jax.random.uniform(k, v.shape), state)
    return params, state


@pytest.mark.parametrize("t", [64, 80])
@pytest.mark.parametrize("margin", [4, 2])
def test_matches_parity_forward_f32(net, t, margin):
    params, state = net
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, t)), jnp.float32)
    ref, _ = unet1d.apply(params, state, x, train=False, margin=margin)
    fast, _ = apply_fast_t(params, state, x, margin=margin,
                           compute_dtype=None)
    assert fast.shape == ref.shape
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref),
                               atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("r", [2, 4])
def test_tpack_kernel_exactness(r):
    """The T-packed kernel reproduces a stride-1 k=5 SAME Conv1D exactly."""
    rng = np.random.default_rng(1)
    cin, cout, t = 3, 5, 16
    x = jnp.asarray(rng.standard_normal((2, t, cin)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((5, cin, cout)), jnp.float32)

    dn = ("NWC", "WIO", "NWC")
    ref = jax.lax.conv_general_dilated(x, k, (1,), "SAME",
                                       dimension_numbers=dn)
    z = x.reshape(2, t // r, r * cin)  # free reshape, (q, c)-major
    zy = jax.lax.conv_general_dilated(z, tpack_conv5_kernel(k, r), (1,),
                                      "SAME", dimension_numbers=dn)
    np.testing.assert_allclose(np.asarray(zy.reshape(2, t, cout)),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_rejects_training(net):
    params, state = net
    with pytest.raises(ValueError, match="inference-only"):
        apply_fast_t(params, state, jnp.zeros((1, 32)), train=True)


def test_predict_fast_matches_slow(tmp_path):
    """UNet1DSegmentation.predict(fast=True) == fast=False on the stock
    net, through the public API with a written checkpoint + fixture data."""
    import functools

    import h5py

    from deepcalcium_tpu.models.unet_1d_segmentation import UNet1DSegmentation
    from deepcalcium_tpu.train.checkpoints import save_checkpoint

    init_fn = functools.partial(unet1d.init, nfb=4)
    params, state = init_fn(jax.random.PRNGKey(5))
    ckpt = str(tmp_path / "m1d.ckpt")
    save_checkpoint(ckpt, params, state)

    rng = np.random.default_rng(3)
    p = str(tmp_path / "spikes.hdf5")
    with h5py.File(p, "w") as fp:
        fp.attrs["name"] = "sp.0"
        fp.create_dataset("traces",
                          data=rng.standard_normal((6, 100)).astype(
                              np.float32))
        fp.create_dataset("spikes",
                          data=(rng.random((6, 100)) < 0.05).astype(np.int8))

    model = UNet1DSegmentation(cpdir=str(tmp_path / "cp"),
                               net_init_func=init_fn)
    pf, _ = model.predict([p], ckpt, fast=True)
    ps, _ = model.predict([p], ckpt, fast=False)
    # Float reassociation between the two exact-rewrite paths can flip
    # pixels sitting exactly at the 0.5 threshold on a random-init net —
    # tolerate a sub-percent fraction instead of demanding bit equality.
    assert np.mean(pf[0] != ps[0]) < 0.005


def test_predict_is_thresholded_predict_proba(net, tmp_path):
    """predict's decisions are predict_proba's probabilities thresholded,
    at the full trace length (cropped back from the multiple-of-16 pad),
    with in-memory dataset functions."""
    import functools

    from deepcalcium_tpu.models.unet_1d_segmentation import UNet1DSegmentation
    from deepcalcium_tpu.train.checkpoints import save_checkpoint

    params, state = net
    ckpt = str(tmp_path / "m1d.ckpt")
    save_checkpoint(ckpt, params, state)
    traces = np.random.default_rng(4).standard_normal((5, 100)).astype(
        np.float32)
    model = UNet1DSegmentation(
        cpdir=str(tmp_path / "cp"),
        net_init_func=functools.partial(unet1d.init, nfb=4),
        dataset_attrs_func=lambda p: {"name": p},
        dataset_traces_func=lambda p: traces,
        dataset_spikes_func=lambda p: None)
    probs, names = model.predict_proba(["sp.0"], ckpt, batch=2)
    assert names == ["sp.0"]
    assert probs[0].shape == (5, 100) and probs[0].dtype == np.float32
    assert ((probs[0] > 0) & (probs[0] < 1)).all()
    thr = float(np.median(probs[0]))
    dec, _ = model.predict(["sp.0"], ckpt, batch=2, threshold=thr)
    assert dec[0].dtype == np.uint8
    np.testing.assert_array_equal(dec[0], (probs[0] > thr).astype(np.uint8))
