"""UNet2DS: the 2-D summary-image segmentation U-Net, pure-functional JAX.

Behavioral mirror of the reference Keras builder ``unet`` (reference
``models/neurons/unet_2d_summary.py:123-224``):

- Input (B, H, W) -> channel dim added (the Keras expand_dims Lambda, :170).
- 4 down blocks of [Conv3x3 -> BN -> ReLU] x2 with MaxPool2 between, filter
  schedule 32/64/128/256, dropout 0.25 after block 1 and 0.5 after blocks
  2-3 (:172-192).
- Bottleneck Conv x2 at 512 filters (:194-196).
- 4 up blocks: Conv2DTranspose(k=2, s=2) -> BN(momentum .5) -> ReLU, dropout,
  skip concat as [up, skip] (:154-159, :197-218), conv pairs back down the
  schedule.
- Head: Conv1x1 -> 2-channel softmax -> take channel -1 as the foreground
  probability map (:221-222).

Differences (behavior preserved, mechanics changed):
- Fully convolutional with no baked input shape: ONE ``apply`` serves
  training at 128² and inference at 512², replacing the reference's
  two-models-plus-HDF5-config-rewrite machinery
  (``utils/keras_helpers.py:24-68``).
- Transpose conv is an einsum (exact for k=s=2) — one matmul.
- ``compute_dtype=bfloat16`` runs convolutions on the tensor cores in bf16 with
  float32 params/statistics/softmax (off by default for parity tests).

Params/state are flat dicts keyed by layer names in Keras build order
(`LAYER_ORDER`), which the Keras-HDF5 import shim walks one-to-one.
"""

import functools

import jax
import jax.numpy as jnp

from deepcalcium_tpu.models import blocks as B

# (name, kind, cout) in the exact Keras build order of the reference
# builder (weights-bearing layers only). kind: conv3 | conv1 | tconv | bn.
_F = 32


def layer_order(nfb: int = _F, up_mode: str = "transpose"):
    """Weight-bearing layers in Keras build order.

    ``up_mode``: 'transpose' (Conv2DTranspose+BN up path, the published
    recipe) or 'upsampling' (weight-free UpSampling2D, the reference's
    alternative — ``unet_2d_summary.py:154-161``).
    """
    assert up_mode in ("transpose", "upsampling")
    f = nfb
    order = []

    def cbr(name, cout):
        order.append((f"{name}_conv", "conv3", cout))
        order.append((f"{name}_bn", "bn", cout))

    def up(name, cout):
        if up_mode == "transpose":
            order.append((f"{name}_tconv", "tconv", cout))
            order.append((f"{name}_bn", "bn", cout))

    cbr("enc0a", f)
    cbr("enc0b", f)
    cbr("enc1a", f * 2)
    cbr("enc1b", f * 2)
    cbr("enc2a", f * 4)
    cbr("enc2b", f * 4)
    cbr("enc3a", f * 8)
    cbr("enc3b", f * 8)
    cbr("mida", f * 16)
    cbr("midb", f * 16)
    up("up3", f * 8)
    cbr("dec3a", f * 8)
    cbr("dec3b", f * 8)
    up("up2", f * 4)
    cbr("dec2a", f * 4)
    cbr("dec2b", f * 4)
    up("up1", f * 2)
    cbr("dec1a", f * 2)
    cbr("dec1b", f * 2)
    up("up0", f)
    cbr("dec0a", f)
    cbr("dec0b", f)
    order.append(("head_conv", "conv1", 2))
    return order


LAYER_ORDER = layer_order()


def init(key, nfb: int = _F, up_mode: str = "transpose",
         init_scheme: str = "he_normal"):
    """Initialize (params, state) pytrees. he_normal kernels (the reference
    default; ``init_scheme`` selects the alternatives the reference's
    hyperparameter search swept — see ``blocks.kernel_init``), BN γ=1 β=0."""
    params, state = {}, {}
    cin = 1
    for name, kind, cout in layer_order(nfb, up_mode):
        key, sub = jax.random.split(key)
        if kind == "conv3":
            params[name] = B.init_conv(sub, (3, 3), cin, cout, init_scheme)
            cin = cout
        elif kind == "conv1":
            params[name] = B.init_conv(sub, (1, 1), cin, cout, init_scheme)
            cin = cout
        elif kind == "tconv":
            params[name] = B.init_tconv(sub, cin, cout, init_scheme)
            cin = cout
        elif kind == "bn":
            params[name], state[name] = B.init_bn(cout)
    # The four post-concat convs see concatenated channels; re-init with the
    # true fan-in: transpose up halves channels first ([cmul, cmul] concat =
    # 2*cmul), weight-free upsampling keeps them ([2*cmul, cmul] = 3*cmul).
    f = nfb
    mult = 2 if up_mode == "transpose" else 3
    for name, cmul in [("dec3a_conv", 8), ("dec2a_conv", 4), ("dec1a_conv", 2), ("dec0a_conv", 1)]:
        key, sub = jax.random.split(key)
        params[name] = B.init_conv(sub, (3, 3), f * cmul * mult, f * cmul,
                                   init_scheme)
    return params, state


def apply(params, state, x, train: bool = False, rng=None,
          drp: float = 0.25, compute_dtype=None, precision=None,
          up_mode: str = "transpose", capture=None, remat: bool = False):
    """Forward pass.

    # Arguments
        x: (B, H, W) float input; H, W divisible by 16.
        train: batch-stat BN + dropout when True.
        rng: PRNGKey, required when train=True.
        drp: base dropout proportion (reference default 0.25).
        compute_dtype: e.g. jnp.bfloat16 for bf16 convs; None = x.dtype.
        precision: lax.Precision for convs; HIGHEST for parity testing.
        capture: optional dict; when given, per-block activations are stored
            into it (for inspection tooling — the reference's
            unet2ds_inspection notebook counterpart).
        remat: rematerialize conv-BN-ReLU blocks on the backward pass
            (jax.checkpoint) — trades ~1 extra forward of FLOPs for O(depth)
            less activation HBM; enables big batches at 512² windows.

    # Returns
        (probs, new_state): (B, H, W) foreground probabilities and updated
        BN state (unchanged when train=False).
    """
    if train and rng is None:
        raise ValueError("training forward requires rng for dropout")
    dt = compute_dtype
    new_state = dict(state)
    rngs = iter(jax.random.split(rng, 16)) if rng is not None else None

    def _cbr_pure(p_conv, p_bn, s_bn, h):
        y = B.conv2d(h, p_conv, dtype=dt, precision=precision)
        y, s = B.batch_norm(y, p_bn, s_bn, train, 0.99)
        return jax.nn.relu(y), s

    cbr_fn = jax.checkpoint(_cbr_pure) if remat else _cbr_pure

    def cbr(name, h):
        y, s = cbr_fn(params[f"{name}_conv"], params[f"{name}_bn"],
                      state[f"{name}_bn"], h)
        new_state[f"{name}_bn"] = s
        if capture is not None:
            capture[name] = y
        return y

    def up(name, h):
        if up_mode == "upsampling":
            # UpSampling2D: nearest-neighbor repeat, no weights (:160-161).
            return jnp.repeat(jnp.repeat(h, 2, axis=1), 2, axis=2)
        y = B.tconv2x2(h, params[f"{name}_tconv"], dtype=dt, precision=precision)
        y, s = B.batch_norm(y, params[f"{name}_bn"], state[f"{name}_bn"], train, 0.5)
        new_state[f"{name}_bn"] = s
        return jax.nn.relu(y)

    def drop(h, rate):
        return B.dropout(h, rate, train, next(rngs) if rngs else None)

    h = x[..., None].astype(dt or x.dtype)

    h = cbr("enc0b", cbr("enc0a", h))
    skip0 = h
    h = B.maxpool2(h)
    h = drop(cbr("enc1b", cbr("enc1a", h)), drp)
    skip1 = h
    h = B.maxpool2(h)
    h = drop(cbr("enc2b", cbr("enc2a", h)), drp * 2)
    skip2 = h
    h = B.maxpool2(h)
    h = drop(cbr("enc3b", cbr("enc3a", h)), drp * 2)
    skip3 = h
    h = B.maxpool2(h)

    h = cbr("midb", cbr("mida", h))
    h = drop(up("up3", h), drp * 2)

    h = jnp.concatenate([h, skip3], axis=-1)
    h = cbr("dec3b", cbr("dec3a", h))
    h = drop(up("up2", h), drp * 2)

    h = jnp.concatenate([h, skip2], axis=-1)
    h = cbr("dec2b", cbr("dec2a", h))
    h = drop(up("up1", h), drp * 2)

    h = jnp.concatenate([h, skip1], axis=-1)
    h = cbr("dec1b", cbr("dec1a", h))
    h = drop(up("up0", h), drp)

    h = jnp.concatenate([h, skip0], axis=-1)
    h = cbr("dec0b", cbr("dec0a", h))

    logits = B.conv2d(h, params["head_conv"], dtype=dt, precision=precision)
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)[..., -1]
    return probs, new_state


@functools.partial(jax.jit, static_argnames=("compute_dtype", "precision"))
def infer(params, state, x, compute_dtype=None, precision=None):
    """Jitted inference forward: (B, H, W) -> (B, H, W) probabilities."""
    probs, _ = apply(
        params, state, x, train=False, compute_dtype=compute_dtype,
        precision=precision,
    )
    return probs


def param_count(params) -> int:
    return sum(int(p.size) for p in jax.tree.leaves(params))


def forward_flops(h: int, w: int, nfb: int = _F,
                  up_mode: str = "transpose") -> int:
    """Analytic FLOPs (2·MACs) of ONE forward pass on one (h, w) image.

    Counts the conv / transpose-conv matmuls only — BN, ReLU, pooling,
    softmax and concatenation are bandwidth-bound elementwise ops
    contributing <1% of arithmetic. Mirrors the architecture in
    :func:`apply`; used by bench.py for TFLOP/s + MFU accounting.
    """
    assert h % 16 == 0 and w % 16 == 0, (h, w)
    f = nfb
    fl = 0

    def conv(hh, ww, k, cin, cout):
        nonlocal fl
        fl += 2 * k * k * cin * cout * hh * ww

    # Encoder + bottleneck: conv pairs at h/2^i with the filter doubling.
    hh, ww = h, w
    enc = [(1, f), (f, 2 * f), (2 * f, 4 * f), (4 * f, 8 * f), (8 * f, 16 * f)]
    for i, (cin, cout) in enumerate(enc):
        conv(hh, ww, 3, cin, cout)
        conv(hh, ww, 3, cout, cout)
        if i < len(enc) - 1:
            hh, ww = hh // 2, ww // 2

    # Decoder: up (tconv k=s=2: each output pixel = cin-vector x (cin, cout)
    # slice => 2*4*cin*cout*hh*ww FLOPs at the PRE-upsample resolution),
    # then the conv pair on the concatenated tensor.
    cup = 16 * f
    for cout in (8 * f, 4 * f, 2 * f, f):
        if up_mode == "transpose":
            fl += 2 * 4 * cup * cout * hh * ww
            cat = cout + cout
        else:
            cat = cup + cout
        hh, ww = hh * 2, ww * 2
        conv(hh, ww, 3, cat, cout)
        conv(hh, ww, 3, cout, cout)
        cup = cout
    conv(hh, ww, 1, f, 2)  # softmax head
    return fl
