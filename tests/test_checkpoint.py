"""Checkpoint save/load roundtrip and shape-polymorphic restore."""

import os

import jax
import numpy as np

from deepcalcium_tpu.models import unet2d
from deepcalcium_tpu.train import trainer as T
from deepcalcium_tpu.train.checkpoints import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)


def test_roundtrip_with_opt_state(tmp_path):
    params, state = unet2d.init(jax.random.PRNGKey(0), nfb=4)
    opt = T.make_optimizer(2e-3)
    opt_state = opt.init(params)
    meta = {"epoch": 3, "val_nf_f1_mean": 0.5}
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, params, state, opt_state, meta)

    p0, s0 = unet2d.init(jax.random.PRNGKey(99), nfb=4)
    o0 = opt.init(p0)
    p, s, o, m = load_checkpoint(path, p0, s0, o0)
    assert m["epoch"] == 3
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(opt_state), jax.tree.leaves(o)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_serves_any_input_shape(tmp_path):
    """Train@48, restore, run@96: no shape metadata in the checkpoint
    (replaces keras_helpers.py:24-68 entirely)."""
    params, state = unet2d.init(jax.random.PRNGKey(0), nfb=4)
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, params, state)
    p0, s0 = unet2d.init(jax.random.PRNGKey(1), nfb=4)
    p, s, _, _ = load_checkpoint(path, p0, s0)
    for hw in (48, 96):
        probs, _ = unet2d.apply(p, s, np.zeros((1, hw, hw), np.float32))
        assert probs.shape == (1, hw, hw)


def test_latest_checkpoint_by_mtime(tmp_path):
    params, state = unet2d.init(jax.random.PRNGKey(0), nfb=4)
    a = save_checkpoint(str(tmp_path / "a.ckpt"), params, state)
    b = save_checkpoint(str(tmp_path / "b.ckpt"), params, state)
    os.utime(a, (0, 0))
    assert latest_checkpoint(str(tmp_path)) == b
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_roundtrip_bf16_int_leaves_and_meta(tmp_path):
    """The npz format keeps every leaf's dtype (bfloat16 as raw bits, ints
    as ints) and the JSON meta, with no pickle on load."""
    import jax.numpy as jnp

    params = {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3,
              "n": np.arange(4, dtype=np.int32)}
    state = {"step": np.int64(7), "flag": np.array([True, False])}
    meta = {"epoch": 2, "name": "x", "score": 0.25}
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, params, state, meta=meta)
    like = jax.tree.map(np.zeros_like, (params, state))
    p, s, o, m = load_checkpoint(path, *like)
    assert o is None and m == meta
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves((p, s))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(path, allow_pickle=False) as npz:
        assert "params/['w']" in npz.files
