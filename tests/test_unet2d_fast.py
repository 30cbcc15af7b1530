"""apply_fast (channel-packed inference rewrite) vs the parity forward.

The fast path — space-to-depth level 0 with exactly-transformed kernels,
inference-BN folding, sigmoid-difference head — must be numerically
EQUIVALENT to unet2d.apply(train=False): same weights, same outputs to
float32 tolerance. These tests pin that equivalence plus the guard rails.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepcalcium_tpu.models import unet2d
from deepcalcium_tpu.models.unet2d_fast import (apply_fast, apply_fast_w,
                                                apply_fast_w_train, fold_bn,
                                                s2d_conv3_kernel,
                                                wpack_conv3_kernel)


@pytest.fixture(scope="module")
def net():
    params, state = unet2d.init(jax.random.PRNGKey(0), nfb=4)
    # Randomize BN state so the folding is actually exercised (fresh init
    # has mean=0/var=1, which folding could get wrong and still pass).
    k = jax.random.PRNGKey(9)
    state = jax.tree.map(
        lambda v: v + 0.3 * jax.random.uniform(k, v.shape), state)
    return params, state


@pytest.mark.parametrize("impl", [apply_fast, apply_fast_w],
                         ids=["s2d2x2", "wpack"])
@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_matches_parity_forward_f32(net, hw, impl):
    params, state = net
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2,) + hw), jnp.float32)
    ref, _ = unet2d.apply(params, state, x, train=False)
    fast, _ = impl(params, state, x, compute_dtype=None)
    assert fast.shape == ref.shape
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref),
                               atol=2e-6, rtol=1e-5)


def test_s2d_kernel_exactness():
    """The transformed kernel reproduces a stride-1 3x3 SAME conv exactly
    on the packed representation, independent of the net."""
    rng = np.random.default_rng(1)
    cin, cout, h, w = 3, 5, 16, 12
    x = jnp.asarray(rng.standard_normal((2, h, w, cin)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((3, 3, cin, cout)), jnp.float32)

    dn = ("NHWC", "HWIO", "NHWC")
    ref = jax.lax.conv_general_dilated(x, k, (1, 1), "SAME",
                                       dimension_numbers=dn)

    z = x.reshape(2, h // 2, 2, w // 2, 2, cin).transpose(
        0, 1, 3, 2, 4, 5).reshape(2, h // 2, w // 2, 4 * cin)
    zk = s2d_conv3_kernel(k)
    zy = jax.lax.conv_general_dilated(z, zk, (1, 1), "SAME",
                                      dimension_numbers=dn)
    y = zy.reshape(2, h // 2, w // 2, 2, 2, cout).transpose(
        0, 1, 3, 2, 4, 5).reshape(2, h, w, cout)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("r", [2, 4])
def test_wpack_kernel_exactness(r):
    """The W-only transformed kernel reproduces a stride-1 3x3 SAME conv
    exactly on the width-packed representation."""
    rng = np.random.default_rng(4)
    cin, cout, h, w = 3, 5, 10, 16
    x = jnp.asarray(rng.standard_normal((2, h, w, cin)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((3, 3, cin, cout)), jnp.float32)

    dn = ("NHWC", "HWIO", "NHWC")
    ref = jax.lax.conv_general_dilated(x, k, (1, 1), "SAME",
                                       dimension_numbers=dn)

    z = x.reshape(2, h, w // r, r * cin)  # free reshape, (q, c)-major
    zy = jax.lax.conv_general_dilated(z, wpack_conv3_kernel(k, r), (1, 1),
                                      "SAME", dimension_numbers=dn)
    y = zy.reshape(2, h, w, cout)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_train_forward_matches_parity(net):
    """The W-packed TRAINING forward (live grouped BN) matches
    unet2d.apply(train=True) at drp=0: probs, BN state updates, AND
    parameter gradients."""
    params, state = net
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, 48, 80)), jnp.float32)
    r = jax.random.PRNGKey(42)

    ref, st_ref = unet2d.apply(params, state, x, train=True, rng=r, drp=0.0)
    fw, st_fw = apply_fast_w_train(params, state, x, train=True, rng=r,
                                   drp=0.0, compute_dtype=None)
    np.testing.assert_allclose(np.asarray(fw), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)
    for name in st_ref:
        for k in ("mean", "var"):
            np.testing.assert_allclose(np.asarray(st_fw[name][k]),
                                       np.asarray(st_ref[name][k]),
                                       atol=1e-5, rtol=1e-4)

    def loss_a(p):
        return jnp.mean((unet2d.apply(p, state, x, train=True, rng=r,
                                      drp=0.0)[0] - 0.3) ** 2)

    def loss_b(p):
        return jnp.mean((apply_fast_w_train(p, state, x, train=True, rng=r,
                                            drp=0.0,
                                            compute_dtype=None)[0]
                         - 0.3) ** 2)

    ga = jax.grad(loss_a)(params)
    gb = jax.grad(loss_b)(params)
    # Tolerance floor: both paths round BN batch statistics to float32
    # (blocks.batch_norm / bn_grouped) after DIFFERENT reduction orders
    # (grouped (q,c) vs plain channel), so grads agree only to f32-stat
    # eps amplified through 23 BN layers — measured ~1.3e-5 abs at this
    # seed. The math itself is exact: with the f32 casts stripped and
    # pure-f64 compute, grads match to 1.2e-15 (verified 2026-08-17,
    # scratch f64 build of blocks/unet2d/unet2d_fast).
    for name in ga:
        for k in ga[name]:
            np.testing.assert_allclose(np.asarray(gb[name][k]),
                                       np.asarray(ga[name][k]),
                                       atol=5e-5, rtol=1e-3)


def test_train_forward_dropout_and_delegation(net):
    """drp>0 runs finite; train=False delegates to the folded inference
    path; missing rng is rejected."""
    params, state = net
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((2, 32, 32)), jnp.float32)
    p, st = apply_fast_w_train(params, state, x, train=True,
                               rng=jax.random.PRNGKey(1), drp=0.5,
                               compute_dtype=None)
    assert np.isfinite(np.asarray(p)).all()
    p2, _ = apply_fast_w_train(params, state, x, train=False,
                               compute_dtype=None)
    ref, _ = apply_fast_w(params, state, x, compute_dtype=None)
    np.testing.assert_array_equal(np.asarray(p2), np.asarray(ref))
    with pytest.raises(ValueError, match="rng"):
        apply_fast_w_train(params, state, x, train=True)


def test_fused_dropout_masks_unit():
    """blocks.fused_dropout_masks: shapes, rate-0 sites, exact-u8
    thresholding (production rates), and the f32 fallback."""
    from deepcalcium_tpu.models import blocks as B

    key = jax.random.PRNGKey(3)
    shapes = [(4, 8, 8, 16), (4, 4, 4, 32), (2, 2, 2, 2)]
    rates = [0.25, 0.5, 0.0]
    masks = B.fused_dropout_masks(key, shapes, rates)
    assert masks[0].shape == shapes[0] and masks[0].dtype == jnp.bool_
    assert masks[1].shape == shapes[1]
    assert masks[2] is None
    # Exact-u8 path: reproduce the stream and thresholds by hand
    # (P(u8 < 256*keep) = keep exactly for keep in {0.75, 0.5}).
    n0, n1 = 4 * 8 * 8 * 16, 4 * 4 * 4 * 32
    bits = jax.random.bits(key, (n0 + n1,), dtype=jnp.uint8)
    np.testing.assert_array_equal(
        np.asarray(masks[0]).ravel(), np.asarray(bits[:n0] < 192))
    np.testing.assert_array_equal(
        np.asarray(masks[1]).ravel(), np.asarray(bits[n0:] < 128))
    # Non-1/256 keep falls back to one f32 uniform stream; frequency is
    # still Bernoulli(keep) (binomial 5-sigma bound at n=16384).
    m = B.fused_dropout_masks(jax.random.PRNGKey(4), [(128, 128)], [0.3])[0]
    freq = float(jnp.mean(m))
    assert abs(freq - 0.7) < 5 * np.sqrt(0.7 * 0.3 / m.size)
    # dropout_with_mask: inverted-dropout semantics from the mask.
    x = jnp.ones((128, 128), jnp.float32)
    y = B.dropout_with_mask(x, 0.3, m)
    np.testing.assert_allclose(
        np.asarray(y), np.where(np.asarray(m), 1.0 / 0.7, 0.0), rtol=1e-6)
    assert B.dropout_with_mask(x, 0.0, None) is x


def test_train_forward_fused_dropout(net):
    """DROPOUT_FUSED_DRAW: bitwise-equal to the per-site path at drp=0
    (no masks drawn either way), runs finite with live masks at drp=0.5,
    and the masks demonstrably bite (output differs from drp=0)."""
    from deepcalcium_tpu.models import blocks as B

    params, state = net
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((2, 32, 32)), jnp.float32)
    r = jax.random.PRNGKey(11)

    ref0, st0 = apply_fast_w_train(params, state, x, train=True, rng=r,
                                   drp=0.0, compute_dtype=None)
    try:
        B.DROPOUT_FUSED_DRAW = True
        f0, sf0 = apply_fast_w_train(params, state, x, train=True, rng=r,
                                     drp=0.0, compute_dtype=None)
        np.testing.assert_array_equal(np.asarray(f0), np.asarray(ref0))
        # drp=0.25 is the production rate (interior sites 2*drp=0.5; at
        # drp=0.5 the interior keep hits 0 and grads are non-finite on
        # the per-site path too — degenerate, not a fused-path property).
        p, st = apply_fast_w_train(params, state, x, train=True, rng=r,
                                   drp=0.25, compute_dtype=None)
        assert np.isfinite(np.asarray(p)).all()
        assert not np.array_equal(np.asarray(p), np.asarray(f0))

        def loss(pp):
            return jnp.mean(apply_fast_w_train(
                pp, state, x, train=True, rng=r, drp=0.25,
                compute_dtype=None)[0] ** 2)

        g = jax.grad(loss)(params)
        leaves = jax.tree.leaves(g)
        assert all(np.isfinite(np.asarray(l)).all() for l in leaves)
        assert any(float(jnp.max(jnp.abs(l))) > 0 for l in leaves)
    finally:
        B.DROPOUT_FUSED_DRAW = False


def test_rejects_w_variant_guards(net):
    params, state = net
    x = jnp.zeros((1, 32, 32), jnp.float32)
    with pytest.raises(ValueError, match="inference-only"):
        apply_fast_w(params, state, x, train=True)
    pu, su = unet2d.init(jax.random.PRNGKey(0), nfb=4, up_mode="upsampling")
    with pytest.raises(ValueError, match="transpose"):
        apply_fast_w(pu, su, x)


def test_fold_bn_exactness():
    from deepcalcium_tpu.models import blocks as B

    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 3)), jnp.float32)
    conv_p = {"kernel": jnp.asarray(rng.standard_normal((3, 3, 3, 4)),
                                    jnp.float32),
              "bias": jnp.asarray(rng.standard_normal((4,)), jnp.float32)}
    bn_p = {"gamma": jnp.asarray(rng.random(4) + 0.5, jnp.float32),
            "beta": jnp.asarray(rng.standard_normal(4), jnp.float32)}
    bn_s = {"mean": jnp.asarray(rng.standard_normal(4), jnp.float32),
            "var": jnp.asarray(rng.random(4) + 0.5, jnp.float32)}

    y_ref, _ = B.batch_norm(B.conv2d(x, conv_p), bn_p, bn_s, False, 0.99)
    k, b = fold_bn(conv_p, bn_p, bn_s)
    y = B.conv2d(x, {"kernel": k, "bias": b})
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               atol=1e-5, rtol=1e-5)


def test_rejects_training_and_upsampling(net):
    params, state = net
    x = jnp.zeros((1, 32, 32), jnp.float32)
    with pytest.raises(ValueError, match="inference-only"):
        apply_fast(params, state, x, train=True)
    pu, su = unet2d.init(jax.random.PRNGKey(0), nfb=4, up_mode="upsampling")
    with pytest.raises(ValueError, match="transpose"):
        apply_fast(pu, su, x)


def test_evaluate_movie_fast_matches_slow(tmp_path, net):
    """The wrapper's fast='auto'/True path returns the same mask as
    fast=False on the stock net (f32)."""
    from deepcalcium_tpu.models.unet_2d_summary import UNet2DSummary

    params, state = net
    rng = np.random.default_rng(3)
    movie = rng.integers(0, 1500, (10, 48, 48)).astype(np.int16)
    model = UNet2DSummary(
        cpdir=str(tmp_path / "cp"),
        net_init_func=functools.partial(unet2d.init, nfb=4))
    m_fast, p_fast = model.evaluate_movie(movie, params=params, state=state,
                                          window_shape=(48, 48), fast=True)
    m_slow, p_slow = model.evaluate_movie(movie, params=params, state=state,
                                          window_shape=(48, 48), fast=False)
    np.testing.assert_allclose(p_fast, p_slow, atol=2e-6, rtol=1e-5)
    np.testing.assert_array_equal(m_fast, m_slow)


def test_hpool2_matches_reduce_window_incl_ties():
    """hpool2's dense gradient must equal select_and_scatter routing —
    first maximal element per window wins — INCLUDING exact ties."""
    from deepcalcium_tpu.models.unet2d_fast import hpool2

    def ref(z):
        return jax.lax.reduce_window(z, -jnp.inf, jax.lax.max,
                                     (1, 2, 1, 1), (1, 2, 1, 1), "VALID")

    rng = np.random.default_rng(11)
    z = jnp.asarray(rng.standard_normal((2, 16, 8, 4)), jnp.float32)
    # Force ties in ~half the windows (and runs of equal values).
    z = z.at[:, 0::4].set(z[:, 1::4])
    z = z.at[0, 2:6].set(1.5)

    o_ref, vjp_ref = jax.vjp(ref, z)
    o_new, vjp_new = jax.vjp(hpool2, z)
    np.testing.assert_array_equal(np.asarray(o_ref), np.asarray(o_new))

    ct = jnp.asarray(rng.standard_normal(o_ref.shape), jnp.float32)
    g_ref, = vjp_ref(ct)
    g_new, = vjp_new(ct)
    np.testing.assert_array_equal(np.asarray(g_ref), np.asarray(g_new))
