"""Fused movie evaluator: the public-API form of the benchmark pipeline.

Verifies that make_movie_evaluator / UNet2DSummary.evaluate_movie — the
single-dispatch summary -> z-norm -> pad -> TTA -> threshold graph — agrees
with the discrete library path (summary image + predict_tta) it fuses.
"""

import functools

import jax
import numpy as np
import pytest

from deepcalcium_tpu.models import unet2d
from deepcalcium_tpu.train import trainer as T
from deepcalcium_tpu.train.evaluate import make_movie_evaluator, predict_tta


@pytest.fixture(scope="module")
def tiny_net():
    return unet2d.init(jax.random.PRNGKey(3), nfb=4)


@pytest.fixture(scope="module")
def movie():
    rng = np.random.default_rng(7)
    return rng.integers(0, 1500, (20, 48, 48)).astype(np.int16)


def test_evaluator_matches_discrete_path(tiny_net, movie):
    params, state = tiny_net
    apply_fn = functools.partial(unet2d.apply, compute_dtype=None)
    evaluate = make_movie_evaluator(apply_fn, movie.shape, window=(48, 48),
                                    tta=True, threshold=0.5)
    mask, prob, mean = jax.tree.map(np.asarray,
                                    evaluate(params, state, movie))

    # Discrete path: host mean/z-norm, then the fused-TTA batched predict.
    mean_ref = movie.astype(np.float32).mean(axis=0)
    z = (mean_ref - mean_ref.mean()) / mean_ref.std()
    fwd = T.make_eval_forward(apply_fn)
    prob_ref = predict_tta(fwd, params, state, [z], window=(48, 48))[0]

    np.testing.assert_allclose(mean, mean_ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(prob, prob_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(mask, (prob_ref > 0.5).astype(np.uint8))


def test_evaluator_pads_smaller_frames(tiny_net):
    """Frames below the window reflect-pad up and crop back."""
    params, state = tiny_net
    rng = np.random.default_rng(1)
    mv = rng.integers(0, 1000, (8, 40, 44)).astype(np.int16)
    apply_fn = functools.partial(unet2d.apply, compute_dtype=None)
    evaluate = make_movie_evaluator(apply_fn, mv.shape, window=(48, 48),
                                    tta=False)
    mask, prob, mean = evaluate(params, state, mv)
    assert mask.shape == (40, 44) and prob.shape == (40, 44)
    assert np.isfinite(np.asarray(prob)).all()


def test_evaluator_rejects_oversized_frames(tiny_net):
    params, state = tiny_net
    apply_fn = functools.partial(unet2d.apply, compute_dtype=None)
    with pytest.raises(ValueError, match="larger than window"):
        make_movie_evaluator(apply_fn, (4, 64, 64), window=(48, 48))


def test_unet2dsummary_evaluate_movie_from_hdf5(tmp_path, tiny_net):
    """The wrapper accepts a contract-HDF5 path and params directly."""
    from deepcalcium_tpu.data.fixtures import make_neurons_hdf5
    from deepcalcium_tpu.models.unet_2d_summary import UNet2DSummary

    params, state = tiny_net
    ds = make_neurons_hdf5(str(tmp_path / "d" / "dataset.hdf5"),
                           name="ev.0", shape=(48, 48), nb_frames=12)
    model = UNet2DSummary(
        cpdir=str(tmp_path / "cp"),
        net_init_func=functools.partial(unet2d.init, nfb=4))
    mask, prob = model.evaluate_movie(ds, params=params, state=state,
                                      window_shape=(48, 48), tta=True)
    assert mask.shape == (48, 48) and mask.dtype == np.uint8
    assert prob.shape == (48, 48)

    with pytest.raises(ValueError, match="model_path or params"):
        model.evaluate_movie(ds)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_streaming_matches_fused(tiny_net, movie, backend):
    """evaluate_movie_streaming (chunked host summary + eval-from-image
    graph) agrees with the fused single-dispatch evaluator."""
    from deepcalcium_tpu.train.evaluate import evaluate_movie_streaming

    params, state = tiny_net
    apply_fn = functools.partial(unet2d.apply, compute_dtype=None)
    evaluate = make_movie_evaluator(apply_fn, movie.shape, window=(48, 48),
                                    tta=True, threshold=0.5)
    mask_f, prob_f, mean_f = jax.tree.map(np.asarray,
                                          evaluate(params, state, movie))
    mask_s, prob_s, mean_s = evaluate_movie_streaming(
        apply_fn, params, state, movie, window=(48, 48), tta=True,
        chunk=7, backend=backend)  # ragged chunking on purpose
    np.testing.assert_allclose(mean_s, mean_f, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(prob_s, prob_f, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(mask_s, mask_f)


def test_streaming_accepts_h5_dataset(tmp_path, tiny_net):
    """An open h5py dataset streams chunk-wise without full materialization
    (the UNet2DSummary.evaluate_movie path for HDF5 inputs)."""
    import h5py

    from deepcalcium_tpu.train.evaluate import evaluate_movie_streaming

    params, state = tiny_net
    rng = np.random.default_rng(2)
    mv = rng.integers(0, 1200, (15, 48, 48)).astype(np.int16)
    p = str(tmp_path / "m.h5")
    with h5py.File(p, "w") as fp:
        fp.create_dataset("series/raw", data=mv)
    apply_fn = functools.partial(unet2d.apply, compute_dtype=None)
    with h5py.File(p, "r") as fp:
        mask, prob, mean = evaluate_movie_streaming(
            apply_fn, params, state, fp["series/raw"], window=(48, 48),
            chunk=4, backend="host")
    np.testing.assert_allclose(mean, mv.astype(np.float32).mean(0),
                               rtol=1e-5, atol=1e-4)
    assert mask.shape == (48, 48) and prob.shape == (48, 48)


def test_forward_flops_matches_xla_cost_analysis(tiny_net):
    """Analytic FLOPs (bench MFU accounting) vs XLA's own cost model on the
    compiled forward — agreement within 2% says neither is fantasy."""
    params, state = tiny_net

    def fwd(p, s, x):
        probs, _ = unet2d.apply(p, s, x, train=False)
        return probs

    x = np.zeros((2, 32, 32), np.float32)
    compiled = jax.jit(fwd).lower(params, state, x).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    if not ca or "flops" not in ca:
        pytest.skip("cost_analysis unavailable on this backend")
    analytic = 2 * unet2d.forward_flops(32, 32, nfb=4)  # batch 2
    # XLA skips the zero taps of SAME padding at image borders; the analytic
    # count includes them. The border fraction of a 3x3 conv on (h, w) is
    # (2h + 2w - 4)/(h*w) — ~12% at 32², <1% at the 512² bench shape — so
    # analytic must be an upper bound within that fraction.
    h = w = 32
    border = (2 * h + 2 * w - 4) / (h * w)
    assert ca["flops"] <= analytic, (ca["flops"], analytic)
    assert (analytic - ca["flops"]) / analytic < border + 0.02, (
        ca["flops"], analytic)


def test_evaluate_constant_movie_no_nan(tiny_net):
    """A constant (dead-recording) movie has std=0; the z-norm guard must
    yield finite probs and a valid mask instead of NaN -> silent all-zero."""
    import jax.numpy as jnp

    from deepcalcium_tpu.train.evaluate import make_movie_evaluator

    params, state = tiny_net
    apply_fn = functools.partial(unet2d.apply, compute_dtype=None)
    cmovie = np.full((12, 32, 32), 7, np.int16)
    ev = make_movie_evaluator(apply_fn, cmovie.shape, window=(32, 32),
                              tta=True)
    mask, prob, summ = ev(params, state, jnp.asarray(cmovie))
    assert np.isfinite(np.asarray(prob)).all()


def test_device_path_needs_no_h5py_or_flax(tmp_path):
    """The wrappers, trainer and checkpoints import with only jax, numpy,
    scipy and optax: with h5py and flax unimportable, a tiny in-memory
    evaluate_movie runs and a checkpoint round-trips."""
    import os
    import subprocess
    import sys

    code = """
import sys
sys.modules["h5py"] = sys.modules["flax"] = None
import functools, jax, numpy as np
from deepcalcium_tpu.models import unet2d
from deepcalcium_tpu.models.unet_2d_summary import UNet2DSummary
from deepcalcium_tpu.models.unet_1d_segmentation import UNet1DSegmentation
from deepcalcium_tpu.train import checkpoints, evaluate, sampler, trainer
params, state = unet2d.init(jax.random.PRNGKey(0), nfb=4)
model = UNet2DSummary(cpdir=sys.argv[1] + "/cp",
                      net_init_func=functools.partial(unet2d.init, nfb=4))
movie = np.random.default_rng(0).integers(0, 900, (6, 32, 32)).astype(np.int16)
mask, prob = model.evaluate_movie(movie, params=params, state=state,
                                  window_shape=(32, 32), tta=True)
assert mask.shape == (32, 32) and np.isfinite(prob).all()
path = checkpoints.save_checkpoint(sys.argv[1] + "/m.ckpt", params, state)
p, s, _, _ = checkpoints.load_checkpoint(path, params, state)
assert all(np.array_equal(a, b) for a, b in
           zip(jax.tree.leaves(params), jax.tree.leaves(p)))
print("device path ok")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "device path ok" in out.stdout
