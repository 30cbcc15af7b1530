"""Shared functional building blocks for the U-Net family.

Design: no layer objects, no framework — params and BN state are plain dict
pytrees; every block is a pure function. BN/conv semantics follow Keras 2.0.6
defaults exactly (the reference nets are built from Keras defaults:
``unet_2d_summary.py:154-167``, ``unet_1d_segmentation.py:78-84``) so that
released Keras checkpoints can be imported weight-for-weight:

- Conv2D/Conv1D: SAME padding, stride 1, bias, he_normal kernels.
- BatchNormalization: axis=-1, eps=1e-3, momentum=0.99 (conv blocks) or 0.5
  (transpose-up blocks); training normalizes by biased batch stats and
  updates ``moving = momentum * moving + (1 - momentum) * batch``.
- Conv2DTranspose(k=2, s=2, VALID): each input pixel emits a 2x2 output
  block — implemented as one einsum + reshape (a pure matmul) instead of
  a gradient-of-conv, which is exact.
- Dropout: inverted scaling, train-only.

Compute dtype is a parameter: convolutions can run in bfloat16 on the
tensor cores while params and BN statistics stay float32.
"""

import functools
import math

import jax
import jax.numpy as jnp

BN_EPS = 1e-3  # Keras 2.0.6 BatchNormalization default epsilon.


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _truncated_normal(key, shape, stddev):
    """Keras-2.0.6 ``K.truncated_normal``: standard normal truncated at
    ±2σ, scaled by ``stddev``. The reference pins Keras 2.0.6, whose
    VarianceScaling draws ``truncated_normal(0, sqrt(scale/fan))`` with NO
    stddev correction — the 1/0.8796 truncation-variance compensation is a
    later-Keras (2.2.x) change and deliberately absent here."""
    return jax.random.truncated_normal(key, -2.0, 2.0, shape,
                                       jnp.float32) * stddev


def he_normal(key, shape, fan_in):
    return _truncated_normal(key, shape, jnp.sqrt(2.0 / fan_in))


def kernel_init(key, shape, fan_in, fan_out, scheme: str = "he_normal"):
    """Kernel initializer by scheme name — the init axis the reference's
    hyperparameter search swept over Keras initializers
    (``notebooks/unet2ds_random_hyperparameter_search.ipynb``).

    Schemes (Keras-2.0.6-faithful: normal schemes are ±2σ TRUNCATED
    normals — see :func:`_truncated_normal`): ``he_normal`` (the
    reference model default, ``unet_2d_summary.py``), ``he_uniform``,
    ``glorot_uniform``, ``glorot_normal``.
    """
    if scheme == "he_normal":
        return he_normal(key, shape, fan_in)
    if scheme == "he_uniform":
        lim = jnp.sqrt(6.0 / fan_in)
        return jax.random.uniform(key, shape, jnp.float32, -lim, lim)
    if scheme == "glorot_uniform":
        lim = jnp.sqrt(6.0 / (fan_in + fan_out))
        return jax.random.uniform(key, shape, jnp.float32, -lim, lim)
    if scheme == "glorot_normal":
        return _truncated_normal(key, shape,
                                 jnp.sqrt(2.0 / (fan_in + fan_out)))
    raise ValueError(f"unknown init scheme: {scheme!r}")


def init_conv(key, ksize, cin, cout, init_scheme: str = "he_normal"):
    """2-D conv params; kernel layout HWIO (matches Keras)."""
    kh, kw = ksize
    return {
        "kernel": kernel_init(key, (kh, kw, cin, cout), kh * kw * cin,
                              kh * kw * cout, init_scheme),
        "bias": jnp.zeros((cout,), jnp.float32),
    }


def init_conv1d(key, ksize, cin, cout):
    """1-D conv params; kernel layout WIO (matches Keras Conv1D)."""
    return {
        "kernel": he_normal(key, (ksize, cin, cout), ksize * cin),
        "bias": jnp.zeros((cout,), jnp.float32),
    }


def init_tconv(key, cin, cout, init_scheme: str = "he_normal"):
    """2x2-stride-2 transpose conv; kernel stored HWOI like Keras
    Conv2DTranspose (kh, kw, out_channels, in_channels).

    Fan convention: Keras ``_compute_fans`` reads the raw kernel shape
    without knowing transpose semantics, so on the HWOI layout
    fan_in = rf * out_channels and fan_out = rf * in_channels — NOT the
    dataflow fans. Reproduced as-is (the reference inits its
    Conv2DTranspose with Keras ``he_normal``, ``unet_2d_summary.py:156``),
    so ``he_*`` tconv scales match Keras exactly; the quirk is
    deliberate, not a bug."""
    return {
        "kernel": kernel_init(key, (2, 2, cout, cin), 2 * 2 * cout,
                              2 * 2 * cin, init_scheme),
        "bias": jnp.zeros((cout,), jnp.float32),
    }


def init_bn(c):
    params = {"gamma": jnp.ones((c,), jnp.float32), "beta": jnp.zeros((c,), jnp.float32)}
    state = {"mean": jnp.zeros((c,), jnp.float32), "var": jnp.ones((c,), jnp.float32)}
    return params, state


# ---------------------------------------------------------------------------
# Forward ops
# ---------------------------------------------------------------------------

def conv2d(x, p, dtype=None, precision=None):
    """SAME conv, NHWC x HWIO -> NHWC.

    ``dtype``: compute dtype (e.g. bfloat16). When set, inputs/kernel/bias
    are cast and the conv output stays in that dtype — the matrix units
    still accumulate partial products in float32; BN recomputes
    statistics in float32 downstream. (Forcing preferred_element_type=f32 on
    a bf16 conv breaks the gradient transpose: the f32 cotangent meets the
    bf16 kernel in the transposed conv.)
    ``precision``: jax.lax.Precision; HIGHEST for bit-parity paths
    (weight-import verification) — backend default otherwise.
    """
    k, b = p["kernel"], p["bias"]
    if dtype is not None:
        x, k, b = x.astype(dtype), k.astype(dtype), b.astype(dtype)
    y = jax.lax.conv_general_dilated(
        x, k, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=precision,
    )
    return y + b


def conv1d(x, p, dtype=None, precision=None):
    """SAME conv, NWC x WIO -> NWC."""
    k, b = p["kernel"], p["bias"]
    if dtype is not None:
        x, k, b = x.astype(dtype), k.astype(dtype), b.astype(dtype)
    y = jax.lax.conv_general_dilated(
        x, k, window_strides=(1,), padding="SAME",
        dimension_numbers=("NWC", "WIO", "NWC"),
        precision=precision,
    )
    return y + b


def tconv2x2(x, p, dtype=None, precision=None):
    """Conv2DTranspose(k=2, s=2, VALID) as einsum+reshape (exact).

    out[b, 2i+p, 2j+q, o] = sum_c x[b,i,j,c] * K[p,q,o,c] + bias[o]
    """
    k, b = p["kernel"], p["bias"]
    if dtype is not None:
        x, k, b = x.astype(dtype), k.astype(dtype), b.astype(dtype)
    bsz, h, w, _ = x.shape
    o = k.shape[2]
    y = jnp.einsum("bhwc,pqoc->bhpwqo", x, k, precision=precision)
    y = y.reshape(bsz, 2 * h, 2 * w, o)
    return y + b


def maxpool2(x):
    """MaxPooling2D(2, strides=2) on NHWC — dense-grad implementation.

    Forward is bitwise-equal to ``reduce_window(max, (1,2,2,1))``; the
    backward routes the cotangent to the FIRST maximal element of each
    2x2 window (row-major window order) computed densely, which is
    exactly ``select_and_scatter``'s semantics but without the serial
    scatter. Tie routing pinned by
    tests/test_unet2d.py::test_maxpool2_dense_grad_matches_reduce_window.
    (NOT two cascaded 2-element pools — that routes (1,2;2,0)-style tied
    windows to the column-then-row winner, not the row-major first max.)
    """
    a, b, c, d = _quads(x)
    return jnp.maximum(jnp.maximum(a, b), jnp.maximum(c, d))


def _quads(x):
    """Row-major 2x2 window elements of NHWC: (0,0),(0,1),(1,0),(1,1)."""
    return (x[:, 0::2, 0::2], x[:, 0::2, 1::2],
            x[:, 1::2, 0::2], x[:, 1::2, 1::2])


def _maxpool2_fwd(x):
    a, b, c, d = _quads(x)
    m = jnp.maximum(jnp.maximum(a, b), jnp.maximum(c, d))
    # 2-bit index of the FIRST maximal element in row-major order.
    idx = jnp.where(a == m, 0, jnp.where(b == m, 1,
                    jnp.where(c == m, 2, 3))).astype(jnp.int8)
    return m, idx


def _maxpool2_bwd(idx, g):
    z = jnp.zeros_like(g)
    q = [jnp.where(idx == k, g, z) for k in range(4)]
    # (B,H',W',C) quads -> (B,H',2,W',2,C) -> (B,2H',2W',C)
    row0 = jnp.stack([q[0], q[1]], axis=3)
    row1 = jnp.stack([q[2], q[3]], axis=3)
    s = jnp.stack([row0, row1], axis=2)
    bsz, hp, _, wp, _, ch = s.shape
    return (s.reshape(bsz, 2 * hp, 2 * wp, ch),)


maxpool2 = jax.custom_vjp(maxpool2)
maxpool2.defvjp(_maxpool2_fwd, _maxpool2_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def pool2_axis(z, axis):
    """Window-2 stride-2 max along ``axis`` with a dense gradient.

    The 2-element-window specialization of max-pool: first-match routing
    is just ``a >= b``, so the vjp is an elementwise select + interleave
    instead of XLA's ``select_and_scatter``. ``axis`` must be static and
    NON-NEGATIVE: the backward stacks the window pair at ``axis + 1``,
    which lands in the wrong place for a negative axis while the final
    reshape still succeeds — a silently scrambled gradient — so negative
    axes are rejected up front (both here and in the vjp rules, which
    custom_vjp calls directly under differentiation).
    """
    _check_pool_axis(z, axis)
    a, b = _pool2_halves(z, axis)
    return jnp.maximum(a, b)


def _check_pool_axis(z, axis):
    if not 0 <= axis < z.ndim:
        raise ValueError(
            f"pool2_axis: axis must be a non-negative index in "
            f"[0, {z.ndim}); got {axis} (negative axes would corrupt "
            f"the backward interleave)")


def _pool2_halves(z, axis):
    sl = [slice(None)] * z.ndim
    sl[axis] = slice(0, None, 2)
    a = z[tuple(sl)]
    sl[axis] = slice(1, None, 2)
    return a, z[tuple(sl)]


def _pool2_axis_fwd(z, axis):
    _check_pool_axis(z, axis)
    a, b = _pool2_halves(z, axis)
    return jnp.maximum(a, b), (a >= b)


def _pool2_axis_bwd(axis, first_wins, g):
    ga = jnp.where(first_wins, g, jnp.zeros_like(g))
    gb = jnp.where(first_wins, jnp.zeros_like(g), g)
    s = jnp.stack([ga, gb], axis=axis + 1)
    shape = list(g.shape)
    shape[axis] *= 2
    return (s.reshape(shape),)


pool2_axis.defvjp(_pool2_axis_fwd, _pool2_axis_bwd)


def maxpool1d(x, window, stride=1, padding="SAME"):
    """MaxPooling1D on NWC with arbitrary window/stride."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, window, 1), (1, stride, 1), padding
    )


def upsample1d(x):
    """UpSampling1D(2): repeat along the length axis (NWC)."""
    return jnp.repeat(x, 2, axis=1)


# Experiment knob: when False, BN batch stats reduce in the COMPUTE dtype (bf16) instead of upcasting every
# activation to f32 first — saving the f32 temp's bandwidth at the cost of
# stat precision. Read at TRACE time: flip it only around constructing a
# fresh train step (jit caches do not key on module globals). Production
# keeps True (Keras-faithful f32 stats; moving state stays f32 either way).
BN_STATS_F32 = True


def batch_norm(x, p, s, train: bool, momentum: float):
    """Keras-semantics BN over the channel (last) axis.

    Returns (y, new_state). Stats are computed/updated in float32 whatever
    the compute dtype (modulo the BN_STATS_F32 experiment knob above).
    """
    if train:
        axes = tuple(range(x.ndim - 1))
        xs = x.astype(jnp.float32) if BN_STATS_F32 else x
        mean = jnp.mean(xs, axis=axes).astype(jnp.float32)
        var = jnp.var(xs, axis=axes).astype(jnp.float32)
        new_s = {
            "mean": momentum * s["mean"] + (1.0 - momentum) * mean,
            "var": momentum * s["var"] + (1.0 - momentum) * var,
        }
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = jax.lax.rsqrt(var + BN_EPS) * p["gamma"]
    y = (x - mean.astype(x.dtype)) * inv.astype(x.dtype) + p["beta"].astype(x.dtype)
    return y, new_s


# Experiment knob: when True, dropout uses a custom_vjp whose BACKWARD regenerates the mask from the
# PRNG key instead of letting AD carry the mask as a residual. Forward
# values and gradients are bitwise-identical either way (same key -> same
# bernoulli draw); what changes is the HLO handed to XLA — the residual
# form can force mask materialization at fusion boundaries, the remat
# form presents two independent cheap draws XLA may fuse into each
# consumer. Read at TRACE time (flip only around building a fresh step).
# Off by default; no H100 measurement has shown it to win.
DROPOUT_REMAT_BWD = False


def _dropout_apply(x, rate: float, key):
    keep = 1.0 - rate
    mask = jax.random.bernoulli(key, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0).astype(x.dtype)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _dropout_remat(x, rate: float, key):
    return _dropout_apply(x, rate, key)


def _dropout_remat_fwd(x, rate: float, key):
    # Residual is the KEY (a few words), not the mask (a full activation-
    # sized tensor): the backward redraws the identical bernoulli mask.
    return _dropout_apply(x, rate, key), key


def _dropout_remat_bwd(rate: float, key, g):
    keep = 1.0 - rate
    mask = jax.random.bernoulli(key, keep, g.shape)
    return (jnp.where(mask, g / keep, 0.0).astype(g.dtype), None)


_dropout_remat.defvjp(_dropout_remat_fwd, _dropout_remat_bwd)


def dropout(x, rate: float, train: bool, key):
    """Inverted dropout (Keras semantics)."""
    if not train or rate == 0.0:
        return x
    if DROPOUT_REMAT_BWD:
        return _dropout_remat(x, rate, key)
    return _dropout_apply(x, rate, key)


# Experiment knob: when True, the W-packed training forward draws ALL of a step's dropout masks in ONE
# PRNG call (fused_dropout_masks) instead of seven per-site bernoulli
# draws. Same per-element Bernoulli(keep) distribution (the reshape of a
# counter-mode stream is bijective); what changes is the HLO — one big
# random-bits kernel + seven slice/compares vs seven independent draws,
# each a potential fusion boundary in the backward graph. Read at TRACE
# time, like DROPOUT_REMAT_BWD. Off by default; no H100 measurement has
# shown it to win.
DROPOUT_FUSED_DRAW = False


def fused_dropout_masks(key, shapes, rates):
    """Draw every dropout mask of a training step in one PRNG call.

    Returns one boolean keep-mask per ``(shape, rate)`` site (``None``
    where ``rate == 0``). When every keep probability is an exact multiple
    of 1/256 (the production rates 0.25 and 0.5 are), a single uint8
    random-bits stream is thresholded — 4x less random-bit HBM traffic
    than f32 uniforms with an exactly-Bernoulli(keep) result
    (P(u8 < 256*keep) = keep). Otherwise falls back to one f32 uniform
    stream.
    """
    keeps = [1.0 - r for r in rates]
    sizes = [math.prod(s) if r else 0 for s, r in zip(shapes, rates)]
    total = sum(sizes)
    live = [k for k, r in zip(keeps, rates) if r]
    exact_u8 = all(float(k * 256).is_integer() for k in live)
    if exact_u8:
        bits = jax.random.bits(key, (total,), dtype=jnp.uint8)
        segment_mask = [
            (lambda seg, t=int(round(k * 256)): seg < jnp.uint8(t))
            for k in keeps]
    else:
        bits = jax.random.uniform(key, (total,), dtype=jnp.float32)
        segment_mask = [(lambda seg, k=k: seg < k) for k in keeps]
    masks, off = [], 0
    for cmp, shape, n in zip(segment_mask, shapes, sizes):
        if n == 0:
            masks.append(None)
            continue
        masks.append(cmp(bits[off:off + n]).reshape(shape))
        off += n
    return masks


def dropout_with_mask(x, rate: float, mask):
    """Inverted dropout from a precomputed keep-mask (fused-draw path)."""
    if mask is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    return jnp.where(mask, x / keep, 0.0).astype(x.dtype)
