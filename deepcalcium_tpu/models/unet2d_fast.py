"""Channel-packed inference path for UNet2DS: exact rewrites, same weights.

The plain forward spends much of its time in the level-0/1 blocks, whose
channel counts (1/2/32/64) are thin for the wide matrix tiles the
convolutions run on. Three *mathematically exact* transformations reshape
those layers without touching the weights:

1. **Space-to-depth at level 0** — every 512^2 tensor is held as its
   (256^2, 4C) space-to-depth packing ((p, q) major, c minor). A stride-1
   3x3 conv on the original image is exactly a 3x3 conv on the packing with
   a sparse (4cin, 4cout) kernel built from the original by
   :func:`s2d_conv3_kernel` (4x the FLOPs on 4x wider channels);
   MaxPool2 becomes a channel-group max (no spatial window); the k=2 s=2
   transpose conv becomes a 1x1 conv (pure matmul, no interleave).
2. **BN folding** — inference BN is per-channel affine; its scale/shift
   fold into the preceding conv's kernel/bias (:func:`fold_bn`), removing
   every BN from the graph.
3. **Sigmoid head** — softmax([a, b])[1] == sigmoid(b - a), so the
   2-channel 1x1 conv + softmax becomes a single channel-reduction dot.

`apply_fast(params, state, x)` matches `unet2d.apply(..., train=False)` to
float tolerance (tests/test_unet2d_fast.py). Training keeps the
reference-parity path in models/unet2d.py.

``apply_fast_w`` below supersedes it for dispatch: width-only packing whose
seams are all layout-preserving reshapes. It is what
``UNet2DSummary.evaluate_movie(fast="auto")`` and ``bench.py`` use: on an
H100 (700 W) it runs the bf16 8-view 512² TTA forward in 3.6-3.9 ms against
4.6-4.7 ms for the plain ``unet2d.apply``. Its training twin
``apply_fast_w_train`` is SLOWER than the plain step there (6.1 vs 4.2 ms
at batch 20 @ 128², bf16), so ``fit(fast_train="auto")`` keeps the plain
net and the packed step is reachable only through ``fast_train=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np

from deepcalcium_tpu.models import blocks

__all__ = ["apply_fast", "apply_fast_w", "apply_fast_w_train", "fold_bn",
           "s2d_conv3_kernel", "wpack_conv3_kernel"]


def fold_bn(conv_p, bn_p, bn_s):
    """Fold inference-mode BN into the preceding conv's kernel/bias.

    y = (conv(x) + b - mean) * gamma/sqrt(var+eps) + beta
      = conv_scaled(x) + b'
    Kernel layouts: last axis is the output channel for both HWIO convs and
    HWOI tconvs? No — HWOI has out at axis 2; pass ``out_axis`` via shape.
    Here we require HWIO (out last); tconv kernels are pre-transformed to
    1x1 HWIO form before folding.
    """
    from deepcalcium_tpu.models.blocks import BN_EPS

    scale = bn_p["gamma"] * jax.lax.rsqrt(bn_s["var"] + BN_EPS)
    kernel = conv_p["kernel"] * scale  # broadcast over the last (out) axis
    bias = (conv_p["bias"] - bn_s["mean"]) * scale + bn_p["beta"]
    return kernel, bias


def s2d_conv3_kernel(k):
    """Exact space-to-depth transform of a stride-1 3x3 SAME conv kernel.

    With Z[i, j, (p, q, c)] = X[2i + p, 2j + q, c] ((p, q) major), the conv
    Y = K * X satisfies s2d(Y) = K' * Z where K' is the (3, 3, 4cin, 4cout)
    kernel built here:

        out[u', o] at offset (p', q') sums K[du, dv, c, o] X[u'+du-1, ...];
        writing u' = 2i' + p' and u = 2i + p gives p = (p'+du-1) mod 2 and
        di = (p'+du-1-p)/2 in {-1, 0, 1} — a 3x3 neighborhood in packed
        space. 25% dense; the dense matmul trades 4x FLOPs for 4x wider
        channel dims.
    """
    kh, kw, cin, cout = k.shape
    assert (kh, kw) == (3, 3), (kh, kw)
    out = jnp.zeros((3, 3, 4 * cin, 4 * cout), k.dtype)
    for pp in (0, 1):
        for qq in (0, 1):
            for du in range(3):
                for dv in range(3):
                    p = (pp + du - 1) % 2
                    di = (pp + du - 1 - p) // 2
                    q = (qq + dv - 1) % 2
                    dj = (qq + dv - 1 - q) // 2
                    gi, go = p * 2 + q, pp * 2 + qq
                    out = out.at[
                        di + 1, dj + 1,
                        gi * cin : (gi + 1) * cin,
                        go * cout : (go + 1) * cout,
                    ].set(k[du, dv])
    return out


def _s2d(x):
    """(B, H, W, C) -> (B, H/2, W/2, 4C), (p, q) major / c minor."""
    b, h, w, c = x.shape
    z = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return z.transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def _inv_s2d(z, c):
    b, h2, w2, c4 = z.shape
    y = z.reshape(b, h2, w2, 2, 2, c)
    return y.transpose(0, 1, 3, 2, 4, 5).reshape(b, h2 * 2, w2 * 2, c)


def _conv(x, kernel, bias, dt):
    y = jax.lax.conv_general_dilated(
        x.astype(dt), kernel.astype(dt), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y + bias.astype(dt)


def _tile4(v):
    """Per-channel BN vector -> its (p, q)-major s2d replication."""
    return jnp.tile(v, 4)


def up_w2_kernel(kt):
    """(2, 2, o, c) [p, q, o, c] k=2 s=2 tconv kernel -> HWIO (2, 1, c, 2o)
    for the ``lhs_dilation=(2, 1)`` lowering of the std->W2 upsample.

    Derivation: out[b, 2i+p, j, (q, o)] = sum_c hh[b, i, j, c]*kt[p, q, o, c].
    With the input H-dilated by 2 and padding (1, 0), dilated position
    r = 2i+p receives kernel tap t = 1-p — the kernel H axis is FLIPPED.
    W stays in the minor (channel) dim: output channel layout (q, o)
    q-major == W2 packing. XLA lowers this dilated conv natively, with no
    6-D strided-copy intermediate of the einsum form.
    """
    k = jnp.flip(kt, axis=0).transpose(0, 3, 1, 2)   # (1-p, c, q, o)
    p, c, q, o = k.shape
    return k.reshape(p, 1, c, q * o)


def up_w4_kernel(kt):
    """(2, 2, o, c) tconv kernel -> dense block-diagonal HWIO
    (2, 1, 2c, 4o) for the W2->W4 upsample as ONE ``lhs_dilation=(2, 1)``
    conv.

    The W2 input group q1 (channels (q1, c)) maps to W4 output group
    q = 2*q1 + L (channels (q1, L, o)) — channel mixing is block-diagonal
    in q1. Writing the two 64->64 groups as one dense 128x128 kernel (zeros
    off-diagonal) doubles the FLOPs of a tiny op but keeps it on XLA's
    dense-conv schedule instead of a ``feature_group_count=2`` conv.
    """
    kb = up_w2_kernel(kt)                            # (2, 1, c, 2o)
    p, _, c, o2 = kb.shape
    z = jnp.zeros((p, 1, c, o2), kb.dtype)
    return jnp.concatenate([jnp.concatenate([kb, z], axis=-1),
                            jnp.concatenate([z, kb], axis=-1)], axis=2)


def _up_dilated(hh, k):
    """H-upsampling tconv core shared by the W2/W4 packed upsamples."""
    return jax.lax.conv_general_dilated(
        hh, k, (1, 1), ((1, 1), (0, 0)), lhs_dilation=(2, 1),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def hpool2(z):
    """Window-2 stride-2 max-pool along H (axis 1) with a DENSE gradient.

    Forward is bitwise-equal to ``lax.reduce_window(z, -inf, max,
    (1,2,1,1), (1,2,1,1), "VALID")``. The backward replaces XLA's
    ``select_and_scatter`` with first-match routing computed densely: for
    a 2-element window, select_and_scatter's "first maximal element wins"
    is exactly ``a >= b`` — identical gradients INCLUDING ties (pinned by
    tests). Implementation shared with the 1-D T-pools:
    blocks.pool2_axis.
    """
    return blocks.pool2_axis(z, 1)


def apply_fast(params, state, x, train: bool = False, rng=None,
               compute_dtype=jnp.bfloat16, **_ignored):
    """Inference forward, numerically equivalent to
    ``unet2d.apply(..., train=False)``; requires H, W divisible by 16 and
    the 'transpose' up mode. Signature-compatible with ``apply`` so it can
    be swapped into evaluators; ``train=True`` is rejected (the parity path
    owns training).

    # Returns
        (probs (B, H, W) float32, state) — state passes through unchanged.
    """
    if train:
        raise ValueError("apply_fast is inference-only; use unet2d.apply "
                         "for training")
    if "up0_tconv" not in params:
        raise ValueError("apply_fast supports the 'transpose' up mode only "
                         "(the published recipe); use unet2d.apply for "
                         "upsampling-mode checkpoints")
    b, h, w = x.shape
    assert h % 16 == 0 and w % 16 == 0, (
        f"apply_fast needs H, W % 16 == 0, got {(h, w)}; "
        f"use unet2d.apply for odd shapes")
    dt = compute_dtype or jnp.float32
    from deepcalcium_tpu.models import blocks as B

    def fold(name):
        return fold_bn(params[f"{name}_conv"], params[f"{name}_bn"],
                       state[f"{name}_bn"])

    def cbr(name, hh):
        k, bb = fold(name)
        return jax.nn.relu(_conv(hh, k, bb, dt))

    def cbr_s2d(name, hh):
        k, bb = fold(name)
        return jax.nn.relu(_conv(hh, s2d_conv3_kernel(k), _tile4(bb), dt))

    def up(name, hh):
        kt = params[f"{name}_tconv"]["kernel"]  # (2,2,out,in) HWOI
        # einsum tconv (blocks.tconv2x2) with folded BN(momentum .5).
        scale = params[f"{name}_bn"]["gamma"] * jax.lax.rsqrt(
            state[f"{name}_bn"]["var"] + B.BN_EPS)
        bias = ((params[f"{name}_tconv"]["bias"] - state[f"{name}_bn"]["mean"])
                * scale + params[f"{name}_bn"]["beta"])
        k = kt * scale[None, None, :, None]
        y = jnp.einsum("bhwc,pqoc->bhpwqo", hh.astype(dt), k.astype(dt))
        bsz, hh_, _, ww_, _, o = y.shape
        y = y.reshape(bsz, 2 * hh_, 2 * ww_, o) + bias.astype(dt)
        return jax.nn.relu(y)

    def up_s2d(name, hh):
        # k=2 s=2 tconv == a 1x1 conv in s2d space: out group (p, q) channel
        # o reads Kt[p, q, o, :]. Fold BN(momentum .5) per output channel.
        kt = params[f"{name}_tconv"]["kernel"]  # (2,2,o,c)
        scale = params[f"{name}_bn"]["gamma"] * jax.lax.rsqrt(
            state[f"{name}_bn"]["var"] + B.BN_EPS)
        bias = ((params[f"{name}_tconv"]["bias"] - state[f"{name}_bn"]["mean"])
                * scale + params[f"{name}_bn"]["beta"])
        kt = kt * scale[None, None, :, None]
        _, _, o, c = kt.shape
        k1 = kt.transpose(3, 0, 1, 2).reshape(c, 4 * o)  # (c, (p,q,o))
        y = hh.astype(dt) @ k1.astype(dt) + _tile4(bias).astype(dt)
        return jax.nn.relu(y)

    def pool_s2d(z, c):
        """MaxPool2 of the un-packed tensor == max over the 4 (p, q) groups;
        emits a STANDARD (B, H/2, W/2, c) tensor."""
        return z.reshape(*z.shape[:3], 4, c).max(axis=3)

    def concat_s2d(a, ca, bzz, cb):
        """Channel concat of two (p, q)-major s2d tensors so the result is
        the s2d of the per-pixel concat."""
        bs, hh, ww = a.shape[:3]
        a = a.reshape(bs, hh, ww, 4, ca)
        bzz = bzz.reshape(bs, hh, ww, 4, cb)
        return jnp.concatenate([a, bzz], axis=-1).reshape(
            bs, hh, ww, 4 * (ca + cb))

    nfb = params["enc0a_conv"]["kernel"].shape[-1]

    # ---- level 0 in space-to-depth form (no thin-channel 512^2 convs) ----
    z = _s2d(x[..., None].astype(dt))               # (B, H/2, W/2, 4)
    z = cbr_s2d("enc0a", z)
    z = cbr_s2d("enc0b", z)                          # skip0, s2d (4*nfb)
    skip0 = z
    hh = pool_s2d(z, nfb)                            # (B, H/2, W/2, nfb)

    # ---- levels 1..4: standard path with folded BN (unlike level 0,
    # whose packing boundaries are free reshapes, an s2d level 1 would pay
    # real minor-dim transposes at the _s2d/_inv_s2d seams) ----
    hh = cbr("enc1b", cbr("enc1a", hh))
    skip1 = hh
    hh = B.maxpool2(hh)
    hh = cbr("enc2b", cbr("enc2a", hh))
    skip2 = hh
    hh = B.maxpool2(hh)
    hh = cbr("enc3b", cbr("enc3a", hh))
    skip3 = hh
    hh = B.maxpool2(hh)
    hh = cbr("midb", cbr("mida", hh))
    hh = up("up3", hh)
    hh = cbr("dec3b", cbr("dec3a", jnp.concatenate([hh, skip3], axis=-1)))
    hh = up("up2", hh)
    hh = cbr("dec2b", cbr("dec2a", jnp.concatenate([hh, skip2], axis=-1)))
    hh = up("up1", hh)
    hh = cbr("dec1b", cbr("dec1a", jnp.concatenate([hh, skip1], axis=-1)))

    # ---- decoder level 0 in s2d ----
    zu = up_s2d("up0", hh)                           # s2d, 4*nfb channels
    z = concat_s2d(zu, nfb, skip0, nfb)              # s2d of [up, skip]
    z = cbr_s2d("dec0a", z)
    z = cbr_s2d("dec0b", z)

    # ---- head: softmax([a, b])[1] == sigmoid(b - a), one dot ----
    hk = params["head_conv"]["kernel"][0, 0]         # (nfb, 2)
    wd = (hk[:, 1] - hk[:, 0]).astype(jnp.float32)
    bd = (params["head_conv"]["bias"][1]
          - params["head_conv"]["bias"][0]).astype(jnp.float32)
    zz = z.reshape(*z.shape[:3], 4, nfb).astype(jnp.float32)
    logit = jnp.einsum("bhwgc,c->bhwg", zz, wd) + bd
    prob = jax.nn.sigmoid(logit)                     # (B, H/2, W/2, 4)
    prob = _inv_s2d(prob, 1)[..., 0]                 # -> (B, H, W)
    return prob, state


# ---------------------------------------------------------------------------
# W-packed variant: width-only space-to-depth with FREE seams
# ---------------------------------------------------------------------------
#
# The 2x2 s2d above packs level 0 but not level 1: its pack/unpack seams
# are real minor-dim transposes, and at C >= 64 the 4x FLOP inflation buys
# little. Packing along W ALONE dodges both problems:
#
# - W and C are ADJACENT axes of an NHWC tensor, so the factor-r pack
#   (B, H, W, C) -> (B, H, W/r, rC) with (q, c)-major channels is a
#   row-major-contiguous reshape: the seam is free (L0: 4x32, L1: 2x64
#   channels at the published nfb=32). The 2x2 scheme's seams shuffle the
#   minor dim; these don't.
# - The FLOP inflation is only r-fold, and r=2 suffices at level 1.
# - Pools halve W, which exactly halves the pack factor at CONSTANT
#   packed width: L0 (W/4 cols, r=4) -> L1 (W/4 cols, r=2) -> L2
#   (W/4 cols, r=1). pool0/pool1 become a channel-group max (the W half)
#   + a plain H-window reduction; no repacking ever happens.
# - Transpose convs write (i, p, j, (q, o)) einsum outputs whose merges
#   (i,p)->H and (q,o)->channels are layout-preserving, killing the up1
#   interleave.
# - Skip concats are replaced by SPLIT convs (conv(concat(a,b), K) ==
#   conv(a, K_a) + conv(b, K_b)), so no concat tensor is materialized.
#
# Replaces the same reference path as apply_fast (reference
# deepcalcium/models/unet_2d_summary.py:532-625 predict).


def wpack_conv3_kernel(k, r):
    """Width-only factor-``r`` space-to-depth transform of a stride-1 3x3
    SAME conv kernel.

    With Z[i, j, (q, c)] = X[i, r*j + q, c] (q-major), the conv Y = K * X
    satisfies wpack(Y) = K' * Z where K' is the (3, 3, r*cin, r*cout)
    kernel built here: output column r*j' + q' tap dv reads original
    column r*j' + q' + dv - 1 = r*(j' + dj) + q with q = (q'+dv-1) mod r
    and dj = (q'+dv-1-q)/r in {-1, 0, 1} for r >= 2.
    """
    kh, kw, cin, cout = k.shape
    assert (kh, kw) == (3, 3) and r >= 2, (kh, kw, r)
    out = jnp.zeros((3, 3, r * cin, r * cout), k.dtype)
    for qq in range(r):
        for dv in range(3):
            t = qq + dv - 1
            q = t % r
            dj = (t - q) // r
            out = out.at[:, dj + 1, q * cin:(q + 1) * cin,
                         qq * cout:(qq + 1) * cout].set(k[:, dv])
    return out


def apply_fast_w(params, state, x, train: bool = False, rng=None,
                 compute_dtype=jnp.bfloat16, **_ignored):
    """W-packed inference forward, numerically equivalent to
    ``unet2d.apply(..., train=False)``; requires H, W % 16 == 0 and the
    'transpose' up mode. See the block comment above for the layout scheme.

    # Returns
        (probs (B, H, W) float32, state) — state passes through unchanged.
    """
    if train:
        raise ValueError("apply_fast_w is inference-only; use unet2d.apply "
                         "for training")
    if "up0_tconv" not in params:
        raise ValueError("apply_fast_w supports the 'transpose' up mode only "
                         "(the published recipe); use unet2d.apply for "
                         "upsampling-mode checkpoints")
    b, h, w = x.shape
    assert h % 16 == 0 and w % 16 == 0, (
        f"apply_fast_w needs H, W % 16 == 0, got {(h, w)}; "
        f"use unet2d.apply for odd shapes")
    dt = compute_dtype or jnp.float32
    from deepcalcium_tpu.models import blocks as B

    wp = w // 4  # packed width, constant across levels 0..2

    def fold(name):
        return fold_bn(params[f"{name}_conv"], params[f"{name}_bn"],
                       state[f"{name}_bn"])

    def tilebias(v, r):
        return jnp.tile(v, r)

    def cbr(name, hh):
        k, bb = fold(name)
        return jax.nn.relu(_conv(hh, k, bb, dt))

    def cbr_w(name, hh, r):
        k, bb = fold(name)
        return jax.nn.relu(_conv(hh, wpack_conv3_kernel(k, r),
                                 tilebias(bb, r), dt))

    def cbr_w_split(name, up_part, skip_part, r, c_up):
        """conv(concat([up, skip])) as two convs summed — no concat tensor.
        ``c_up`` is the UNPACKED channel count of the up part."""
        k, bb = fold(name)
        ka = wpack_conv3_kernel(k[:, :, :c_up, :], r)
        kb = wpack_conv3_kernel(k[:, :, c_up:, :], r)
        ya = jax.lax.conv_general_dilated(
            up_part.astype(dt), ka.astype(dt), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        yb = jax.lax.conv_general_dilated(
            skip_part.astype(dt), kb.astype(dt), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jax.nn.relu(ya + yb + tilebias(bb, r).astype(dt))

    def fold_up(name):
        """Folded-BN (momentum .5) k=2 s=2 tconv kernel/bias, HWOI."""
        kt = params[f"{name}_tconv"]["kernel"]  # (2, 2, out, in)
        scale = params[f"{name}_bn"]["gamma"] * jax.lax.rsqrt(
            state[f"{name}_bn"]["var"] + B.BN_EPS)
        bias = ((params[f"{name}_tconv"]["bias"]
                 - state[f"{name}_bn"]["mean"]) * scale
                + params[f"{name}_bn"]["beta"])
        return kt * scale[None, None, :, None], bias

    def up_std(name, hh, staged=False):
        k, bias = fold_up(name)
        y = jnp.einsum("bijc,pqoc->bipjqo", hh.astype(dt), k.astype(dt))
        bsz, hh_, _, ww_, _, o = y.shape
        if staged:
            # Two-step merge: first to the W2 form ((q,o) -> channels,
            # free), then split back to standard; the barrier stops XLA
            # from folding the staging away.
            y = y.reshape(bsz, 2 * hh_, ww_, 2 * o)
            y = jax.lax.optimization_barrier(y)
            y = y.reshape(bsz, 2 * hh_, 2 * ww_, o)
        else:
            y = y.reshape(bsz, 2 * hh_, 2 * ww_, o)
        return jax.nn.relu(y + bias.astype(dt))

    def up_to_w2(name, hh):
        """k=2 s=2 tconv from a STANDARD tensor into W2-packed layout:
        one lhs_dilation=(2, 1) conv (H upsample; (q, o)->channels is the
        kernel's channel layout). See :func:`up_w2_kernel`."""
        k, bias = fold_up(name)
        y = _up_dilated(hh.astype(dt), up_w2_kernel(k).astype(dt))
        return jax.nn.relu(y + tilebias(bias, 2).astype(dt))

    def up_w2_to_w4(name, hh):
        """k=2 s=2 tconv from W2-packed input into W4-packed output.
        Original column of input (i, j, (q1, c)) is 2j + q1; its two output
        columns are 4j + 2*q1 + L, i.e. W4 group q = 2*q1 + L — block-
        diagonal channel mixing, one dense lhs_dilation=(2, 1) conv. See
        :func:`up_w4_kernel`."""
        k, bias = fold_up(name)
        y = _up_dilated(hh.astype(dt), up_w4_kernel(k).astype(dt))
        return jax.nn.relu(y + tilebias(bias, 4).astype(dt))

    # The W4/W2 packing is exact for any nfb; at the published nfb=32 it
    # gives 128 channels at levels 0 and 1 (4x32 / 2x64).
    nfb = params["enc0a_conv"]["kernel"].shape[-1]

    # ---- level 0, W4-packed (free reshape from the raw image) ----
    # Cast on the 3-D (minor dim = W) form BEFORE the packing reshape, so
    # no thin-minor-dim (..., 1) or (..., 4) intermediate is cast.
    z = x.astype(dt).reshape(b, h, wp, 4)
    k0, b0 = fold("enc0a")
    z = jax.nn.relu(_conv(z, wpack_conv3_kernel(k0, 4), tilebias(b0, 4), dt))
    z = cbr_w("enc0b", z, 4)
    skip0 = z                                        # (B, H, W/4, 128)

    # pool0: W-halves are adjacent (q_lo) channel groups; H by the
    # dense-grad window pool (bitwise == reduce_window — see hpool2).
    m = z.reshape(b, h, wp, 2, 2, nfb).max(axis=4).reshape(b, h, wp, 2 * nfb)
    hh = hpool2(m)

    # ---- level 1, W2-packed ----
    hh = cbr_w("enc1a", hh, 2)
    hh = cbr_w("enc1b", hh, 2)
    skip1 = hh                                       # (B, H/2, W/4, 128)

    # pool1: W half = q group max; H by the dense-grad window pool.
    # Lands on STANDARD level 2.
    m = jnp.maximum(hh[..., :2 * nfb], hh[..., 2 * nfb:])
    hh = hpool2(m)

    # ---- levels 2..4: standard path with folded BN ----
    hh = cbr("enc2b", cbr("enc2a", hh))
    skip2 = hh
    hh = B.maxpool2(hh)
    hh = cbr("enc3b", cbr("enc3a", hh))
    skip3 = hh
    hh = B.maxpool2(hh)

    # Mid block with the batch folded into H (2 zero gap rows per image,
    # re-zeroed between the convs): at the 32x32 mid grid the per-image
    # spatial extent is small, so one tall image gives the conv more rows
    # to tile. Exact: gap zeros reproduce each image's SAME zero padding,
    # and gap rows are dropped at the end.
    bs, hm, wm, cm = hh.shape
    xf = jnp.pad(hh, ((0, 0), (0, 2), (0, 0), (0, 0))).reshape(
        1, bs * (hm + 2), wm, cm)
    gap = (jnp.arange(bs * (hm + 2)) % (hm + 2) < hm).astype(dt)
    y = cbr("mida", xf) * gap[None, :, None, None]
    y = cbr("midb", y)
    hh = y.reshape(bs, hm + 2, wm, -1)[:, :hm]

    hh = up_std("up3", hh)
    # dec3a as split convs (no concat tensor); dec2a keeps the concat.
    k3, b3 = fold("dec3a")
    cu = hh.shape[-1]
    hh = jax.nn.relu(
        jax.lax.conv_general_dilated(
            hh, k3[:, :, :cu].astype(dt), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        + jax.lax.conv_general_dilated(
            skip3.astype(dt), k3[:, :, cu:].astype(dt), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        + b3.astype(dt))
    hh = cbr("dec3b", hh)
    hh = up_std("up2", hh, staged=True)
    hh = cbr("dec2b", cbr("dec2a", jnp.concatenate([hh, skip2], axis=-1)))

    # ---- decoder level 1, W2-packed; split convs instead of concat ----
    zu = up_to_w2("up1", hh)                         # (B, H/2, W/4, 128)
    hh = cbr_w_split("dec1a", zu, skip1, 2, 2 * nfb)
    hh = cbr_w("dec1b", hh, 2)

    # ---- decoder level 0, W4-packed ----
    zu = up_w2_to_w4("up0", hh)                      # (B, H, W/4, 128)
    z = cbr_w_split("dec0a", zu, skip0, 4, nfb)
    z = cbr_w("dec0b", z, 4)

    # ---- head: softmax([a, b])[1] == sigmoid(b - a), one dot ----
    hk = params["head_conv"]["kernel"][0, 0]         # (nfb, 2)
    wd = (hk[:, 1] - hk[:, 0]).astype(jnp.float32)
    bd = (params["head_conv"]["bias"][1]
          - params["head_conv"]["bias"][0]).astype(jnp.float32)
    zz = z.reshape(b, h, wp, 4, nfb).astype(jnp.float32)
    logit = jnp.einsum("bhwqc,c->bhwq", zz, wd) + bd
    prob = jax.nn.sigmoid(logit)                     # (B, H, W/4, 4)
    return prob.reshape(b, h, w), state


def apply_fast_w_train(params, state, x, train: bool = True, rng=None,
                       drp: float = 0.25, compute_dtype=jnp.bfloat16,
                       remat: bool = False, **_ignored):
    """W-packed TRAINING forward, numerically equivalent to
    ``unet2d.apply(..., train=True)`` up to float reassociation and dropout
    randomness (exactly equivalent at drp=0, including the BN state
    updates — tests/test_unet2d_fast.py).

    Same layout scheme as :func:`apply_fast_w` (W4@L0 / W2@L1, free seams,
    split convs) but BatchNorm stays LIVE: batch statistics are computed
    per ORIGINAL channel by reducing over the packed (q, c) groups as well
    as (B, H, Wp) — the identical sum over identical elements, so training
    dynamics match the parity path. Dropout masks are drawn directly in
    packed layout (the reshape is bijective, so the distribution over
    pixels is identical to the standard draw). The mid-block batch-fold and
    BN folding are inference-only tricks and are NOT used here.

    Signature-compatible with ``unet2d.apply`` so ``UNet2DSummary.fit``
    can dispatch it for the gradient step (``fast_train='auto'``);
    ``train=False`` delegates to :func:`apply_fast_w`.
    """
    if not train:
        return apply_fast_w(params, state, x,
                            compute_dtype=compute_dtype)
    if rng is None:
        raise ValueError("training forward requires rng for dropout")
    if "up0_tconv" not in params:
        raise ValueError("apply_fast_w_train supports the 'transpose' up "
                         "mode only; use unet2d.apply otherwise")
    b, h, w = x.shape
    assert h % 16 == 0 and w % 16 == 0, (
        f"apply_fast_w_train needs H, W % 16 == 0, got {(h, w)}")
    dt = compute_dtype or x.dtype
    from deepcalcium_tpu.models import blocks as B

    wp = w // 4
    new_state = dict(state)
    rngs = iter(jax.random.split(rng, 16))

    def bn_grouped(y, p_bn, s_bn, momentum, r):
        """Keras-semantics BN with per-ORIGINAL-channel statistics on an
        (…, r*c) packed tensor ((q, c)-major)."""
        c = y.shape[-1] // r
        # Honor blocks.BN_STATS_F32 exactly like blocks.batch_norm does:
        # the packed layers carry the LARGEST activations (enc0*/dec0* at
        # full resolution), so ignoring it here would leave an ablation
        # comparing mostly-unchanged graphs.
        ys = y.astype(jnp.float32) if B.BN_STATS_F32 else y
        y5 = ys.reshape(*y.shape[:-1], r, c)
        mean = jnp.mean(y5, axis=tuple(range(y5.ndim - 1))).astype(jnp.float32)
        var = jnp.var(y5, axis=tuple(range(y5.ndim - 1))).astype(jnp.float32)
        new_s = {"mean": momentum * s_bn["mean"] + (1.0 - momentum) * mean,
                 "var": momentum * s_bn["var"] + (1.0 - momentum) * var}
        inv = jax.lax.rsqrt(var + B.BN_EPS) * p_bn["gamma"]
        yn = ((y - jnp.tile(mean, r).astype(y.dtype))
              * jnp.tile(inv, r).astype(y.dtype)
              + jnp.tile(p_bn["beta"], r).astype(y.dtype))
        return yn, new_s

    def _cbr_w_pure(p_conv, p_bn, s_bn, hh, r):
        k = wpack_conv3_kernel(p_conv["kernel"], r)
        y = _conv(hh, k, jnp.tile(p_conv["bias"], r), dt)
        y, s = bn_grouped(y, p_bn, s_bn, 0.99, r)
        return jax.nn.relu(y), s

    cbr_w_fn = jax.checkpoint(_cbr_w_pure, static_argnums=(4,)) if remat \
        else _cbr_w_pure

    def cbr_w(name, hh, r):
        y, s = cbr_w_fn(params[f"{name}_conv"], params[f"{name}_bn"],
                        state[f"{name}_bn"], hh, r)
        new_state[f"{name}_bn"] = s
        return y

    def _cbr_pure(p_conv, p_bn, s_bn, hh):
        y = B.conv2d(hh, p_conv, dtype=dt)
        y, s = B.batch_norm(y, p_bn, s_bn, True, 0.99)
        return jax.nn.relu(y), s

    cbr_fn = jax.checkpoint(_cbr_pure) if remat else _cbr_pure

    def cbr(name, hh):
        y, s = cbr_fn(params[f"{name}_conv"], params[f"{name}_bn"],
                      state[f"{name}_bn"], hh)
        new_state[f"{name}_bn"] = s
        return y

    def _split_pure(p_conv, p_bn, s_bn, up_part, skip_part, r, c_up):
        """conv(concat([up, skip])) as two packed convs summed, then BN."""
        ka = wpack_conv3_kernel(p_conv["kernel"][:, :, :c_up, :], r)
        kb = wpack_conv3_kernel(p_conv["kernel"][:, :, c_up:, :], r)
        dn = ("NHWC", "HWIO", "NHWC")
        ya = jax.lax.conv_general_dilated(
            up_part.astype(dt), ka.astype(dt), (1, 1), "SAME",
            dimension_numbers=dn)
        yb = jax.lax.conv_general_dilated(
            skip_part.astype(dt), kb.astype(dt), (1, 1), "SAME",
            dimension_numbers=dn)
        y = ya + yb + jnp.tile(p_conv["bias"], r).astype(dt)
        y, s = bn_grouped(y, p_bn, s_bn, 0.99, r)
        return jax.nn.relu(y), s

    split_fn = jax.checkpoint(_split_pure, static_argnums=(5, 6)) if remat \
        else _split_pure

    def cbr_w_split(name, up_part, skip_part, r, c_up):
        y, s = split_fn(params[f"{name}_conv"], params[f"{name}_bn"],
                        state[f"{name}_bn"], up_part, skip_part, r, c_up)
        new_state[f"{name}_bn"] = s
        return y

    def _up_pure(p_tconv, p_bn, s_bn, hh, mode):
        """k=2 s=2 tconv + BN(momentum .5) + relu; ``mode``: 'std' emits
        the standard layout, 'w2'/'w4' the packed ones (free merges)."""
        kt = p_tconv["kernel"]  # (2, 2, out, in)
        if mode == "std":
            y = B.tconv2x2(hh, p_tconv, dtype=dt)
            y, s = B.batch_norm(y, p_bn, s_bn, True, 0.5)
            return jax.nn.relu(y), s
        if mode == "w2":
            y = (_up_dilated(hh.astype(dt), up_w2_kernel(kt).astype(dt))
                 + jnp.tile(p_tconv["bias"], 2).astype(dt))
            r = 2
        else:  # w4 from a W2-packed input (block-diagonal dense kernel)
            y = (_up_dilated(hh.astype(dt), up_w4_kernel(kt).astype(dt))
                 + jnp.tile(p_tconv["bias"], 4).astype(dt))
            r = 4
        y, s = bn_grouped(y, p_bn, s_bn, 0.5, r)
        return jax.nn.relu(y), s

    up_fn = jax.checkpoint(_up_pure, static_argnums=(4,)) if remat \
        else _up_pure

    def up(name, hh, mode):
        y, s = up_fn(params[f"{name}_tconv"], params[f"{name}_bn"],
                     state[f"{name}_bn"], hh, mode)
        new_state[f"{name}_bn"] = s
        return y

    def up_std(name, hh):
        return up(name, hh, "std")

    def up_to_w2(name, hh):
        return up(name, hh, "w2")

    def up_w2_to_w4(name, hh):
        return up(name, hh, "w4")

    nfb = params["enc0a_conv"]["kernel"].shape[-1]

    if B.DROPOUT_FUSED_DRAW:
        # One PRNG call for the whole step (blocks.fused_dropout_masks):
        # the seven mask shapes below are the drop-site activations in
        # application order, all derivable from (b, h, w, nfb) upfront —
        # each consumption asserts the shape so a topology change can't
        # silently misalign the slices.
        _shapes = [(b, h // 2, wp, 4 * nfb),        # enc1  (W2)
                   (b, h // 4, w // 4, 4 * nfb),    # enc2
                   (b, h // 8, w // 8, 8 * nfb),    # enc3
                   (b, h // 8, w // 8, 8 * nfb),    # up3
                   (b, h // 4, w // 4, 4 * nfb),    # up2
                   (b, h // 2, wp, 4 * nfb),        # up1  (W2)
                   (b, h, wp, 4 * nfb)]             # up0  (W4)
        _rates = [drp, 2 * drp, 2 * drp, 2 * drp, 2 * drp, 2 * drp, drp]
        _masks = iter(B.fused_dropout_masks(next(rngs), _shapes, _rates))

        def drop(hh, rate):
            m = next(_masks)
            assert m is None or m.shape == hh.shape, (m.shape, hh.shape)
            return B.dropout_with_mask(hh, rate, m)
    else:
        def drop(hh, rate):
            return B.dropout(hh, rate, True, next(rngs))

    # ---- level 0, W4 ----
    z = x.astype(dt).reshape(b, h, wp, 4)
    z = cbr_w("enc0b", cbr_w("enc0a", z, 4), 4)
    skip0 = z
    m = z.reshape(b, h, wp, 2, 2, nfb).max(axis=4).reshape(b, h, wp, 2 * nfb)
    hh = hpool2(m)  # dense-grad H pool

    # ---- level 1, W2 ----
    hh = drop(cbr_w("enc1b", cbr_w("enc1a", hh, 2), 2), drp)
    skip1 = hh
    m = jnp.maximum(hh[..., :2 * nfb], hh[..., 2 * nfb:])
    hh = hpool2(m)

    # ---- levels 2..4, standard ----
    hh = drop(cbr("enc2b", cbr("enc2a", hh)), drp * 2)
    skip2 = hh
    hh = B.maxpool2(hh)
    hh = drop(cbr("enc3b", cbr("enc3a", hh)), drp * 2)
    skip3 = hh
    hh = B.maxpool2(hh)
    hh = cbr("midb", cbr("mida", hh))
    hh = drop(up_std("up3", hh), drp * 2)
    hh = cbr("dec3b", cbr("dec3a", jnp.concatenate([hh, skip3], axis=-1)))
    hh = drop(up_std("up2", hh), drp * 2)
    hh = cbr("dec2b", cbr("dec2a", jnp.concatenate([hh, skip2], axis=-1)))

    # ---- decoder level 1, W2 ----
    zu = drop(up_to_w2("up1", hh), drp * 2)
    hh = cbr_w_split("dec1a", zu, skip1, 2, 2 * nfb)
    hh = cbr_w("dec1b", hh, 2)

    # ---- decoder level 0, W4 ----
    zu = drop(up_w2_to_w4("up0", hh), drp)
    z = cbr_w_split("dec0a", zu, skip0, 4, nfb)
    z = cbr_w("dec0b", z, 4)

    # ---- head ----
    hk = params["head_conv"]["kernel"][0, 0]
    wd = (hk[:, 1] - hk[:, 0]).astype(jnp.float32)
    bd = (params["head_conv"]["bias"][1]
          - params["head_conv"]["bias"][0]).astype(jnp.float32)
    zz = z.reshape(b, h, wp, 4, nfb).astype(jnp.float32)
    logit = jnp.einsum("bhwqc,c->bhwq", zz, wd) + bd
    prob = jax.nn.sigmoid(logit)
    return prob.reshape(b, h, w), new_state
