"""Channel-packed inference path for UNet1D: T-axis packing, exact rewrites.

The 1-D analog of ``unet2d_fast.apply_fast_w`` (see that module's block
comment for the theory). A (B, T, C) trace tensor's last two axes are
adjacent, so packing time into channels — (B, T/r, rC) with (q, c)-major
channels — is a row-major-contiguous (free) reshape, and rC is 128 at the
thin levels (L0: 4x32, L1: 2x64 at nfb=32). A k=5 SAME
conv on the original trace is exactly a 3-tap conv on the packing with the
(3, r*cin, r*cout) kernel built by :func:`tpack_conv5_kernel`; MaxPool1D(2)
becomes a channel-group max (no windowing at the packed levels at all);
UpSampling1D(repeat x2) becomes channel duplication; skip concats become
split convs; inference BN folds away; the 2-channel softmax head becomes
two channel-dots + the pre-softmax margin max-pool + a sigmoid of their
difference (softmax([a, b])[1] == sigmoid(b - a), applied after the
per-channel max-pool exactly as the reference orders it).

``apply_fast_t(params, state, x)`` matches ``unet1d.apply(train=False)``
to float tolerance (tests/test_unet1d_fast.py) and is what
``UNet1DSegmentation.predict(fast="auto")`` dispatches. Replaces the same
reference path as unet1d.apply (reference
``models/spikes/unet_1d_segmentation.py:422-459`` full-trace predict).
"""

import jax
import jax.numpy as jnp

from deepcalcium_tpu.models.unet2d_fast import fold_bn

__all__ = ["apply_fast_t", "tpack_conv5_kernel"]


def tpack_conv5_kernel(k, r):
    """Time-axis factor-``r`` packing transform of a k=5 SAME Conv1D kernel.

    With Z[j, (q, c)] = X[r*j + q, c] (q-major), Y = K * X satisfies
    tpack(Y) = K' * Z where K' is the (3, r*cin, r*cout) kernel built here:
    output column r*j + q' tap dv reads original column r*j + q' + dv - 2 =
    r*(j + dj) + q with q = (q'+dv-2) mod r and dj = (q'+dv-2-q)/r in
    {-1, 0, 1} for r >= 2; the packed SAME padding of one column supplies
    exactly the original's two zero columns per side.
    """
    kw, cin, cout = k.shape
    assert kw == 5 and r >= 2, (kw, r)
    out = jnp.zeros((3, r * cin, r * cout), k.dtype)
    for qq in range(r):
        for dv in range(5):
            t = qq + dv - 2
            q = t % r
            dj = (t - q) // r
            out = out.at[dj + 1, q * cin:(q + 1) * cin,
                         qq * cout:(qq + 1) * cout].set(k[dv])
    return out


def _conv1(x, kernel, bias, dt):
    y = jax.lax.conv_general_dilated(
        x.astype(dt), kernel.astype(dt), (1,), "SAME",
        dimension_numbers=("NWC", "WIO", "NWC"))
    return y + bias.astype(dt)


def apply_fast_t(params, state, x, train: bool = False, rng=None,
                 margin: int = 4, compute_dtype=jnp.bfloat16, **_ignored):
    """T-packed inference forward, numerically equivalent to
    ``unet1d.apply(..., train=False)``; requires T % 16 == 0.

    # Returns
        (probs (B, T) float32, state) — state passes through unchanged.
    """
    if train:
        raise ValueError("apply_fast_t is inference-only; use unet1d.apply "
                         "for training")
    b, t = x.shape
    assert t % 16 == 0, (
        f"apply_fast_t needs T % 16 == 0, got {t}; use unet1d.apply "
        f"for odd lengths")
    dt = compute_dtype or jnp.float32
    from deepcalcium_tpu.models import blocks as B

    tp = t // 4  # packed length, constant across levels 0..2
    nfb = params["enc0a_conv"]["kernel"].shape[-1]

    def fold(name):
        return fold_bn(params[f"{name}_conv"], params[f"{name}_bn"],
                       state[f"{name}_bn"])

    def cbr(name, hh):
        k, bb = fold(name)
        return jax.nn.relu(_conv1(hh, k, bb, dt))

    def cbr_t(name, hh, r):
        k, bb = fold(name)
        return jax.nn.relu(_conv1(hh, tpack_conv5_kernel(k, r),
                                  jnp.tile(bb, r), dt))

    def cbr_t_split(name, up_part, skip_part, r, c_up):
        """conv(concat([up, skip])) as two packed convs summed."""
        k, bb = fold(name)
        ka = tpack_conv5_kernel(k[:, :c_up, :], r)
        kb = tpack_conv5_kernel(k[:, c_up:, :], r)
        dn = ("NWC", "WIO", "NWC")
        ya = jax.lax.conv_general_dilated(
            up_part.astype(dt), ka.astype(dt), (1,), "SAME",
            dimension_numbers=dn)
        yb = jax.lax.conv_general_dilated(
            skip_part.astype(dt), kb.astype(dt), (1,), "SAME",
            dimension_numbers=dn)
        return jax.nn.relu(ya + yb + jnp.tile(bb, r).astype(dt))

    def pool_std(hh):
        # Strided-slice max == reduce_window bitwise (blocks.pool2_axis).
        return B.pool2_axis(hh, 1)

    # ---- encoder: level 0 T4-packed, level 1 T2-packed, then standard ----
    z = x.astype(dt).reshape(b, tp, 4)
    z = cbr_t("enc0b", cbr_t("enc0a", z, 4), 4)
    skip0 = z                                        # (B, T/4, 4*nfb)

    # pool0: T-halves are adjacent (q_lo) channel groups — a pure group max.
    hh = z.reshape(b, tp, 2, 2, nfb).max(axis=3).reshape(b, tp, 2 * nfb)

    hh = cbr_t("enc1b", cbr_t("enc1a", hh, 2), 2)
    skip1 = hh                                       # (B, T/4, 4*nfb)
    hh = jnp.maximum(hh[..., :2 * nfb], hh[..., 2 * nfb:])  # pool1 -> std L2

    hh = cbr("enc2b", cbr("enc2a", hh))
    skip2 = hh
    hh = pool_std(hh)
    hh = cbr("enc3b", cbr("enc3a", hh))
    skip3 = hh
    hh = pool_std(hh)
    hh = cbr("midb", cbr("mida", hh))

    # ---- decoder: standard until level 1 ----
    hh = B.upsample1d(hh)
    hh = cbr("dec3b", cbr("dec3a", jnp.concatenate([hh, skip3], axis=-1)))
    hh = B.upsample1d(hh)
    hh = cbr("dec2b", cbr("dec2a", jnp.concatenate([hh, skip2], axis=-1)))

    # UpSampling into the T2 packing: out col 2j+q = in col j for both q —
    # channel duplication of the whole block (q-major layout).
    zu = jnp.concatenate([hh, hh], axis=-1)          # (B, T/4, 2*4*nfb)
    hh = cbr_t_split("dec1a", zu, skip1, 2, 4 * nfb)
    hh = cbr_t("dec1b", hh, 2)                       # (B, T/4, 4*nfb) T2

    # UpSampling T2 -> T4: out col 4j+q reads in col 2j + q//2, i.e. each
    # T2 half duplicates into two adjacent T4 groups.
    lo, hi = hh[..., :2 * nfb], hh[..., 2 * nfb:]
    zu = jnp.concatenate([lo, lo, hi, hi], axis=-1)  # (B, T/4, 8*nfb)
    z = cbr_t_split("dec0a", zu, skip0, 4, 2 * nfb)
    z = cbr_t("dec0b", z, 4)                         # (B, T/4, 4*nfb) T4

    # ---- head: per-channel logits -> margin max-pool -> sigmoid diff ----
    hk = params["head_conv"]["kernel"][0]            # (nfb, 2)
    hb = params["head_conv"]["bias"]
    zz = z.reshape(b, tp, 4, nfb).astype(jnp.float32)
    logits = jnp.einsum("btqc,co->btqo", zz, hk.astype(jnp.float32))
    logits = logits.reshape(b, t, 2) + hb.astype(jnp.float32)
    # The reference max-pools the 2-channel LOGITS (window margin+1, SAME)
    # before the softmax; sigmoid(b - a) of the pooled logits is exact.
    logits = B.maxpool1d(logits, margin + 1, 1, "SAME")
    probs = jax.nn.sigmoid(logits[..., 1] - logits[..., 0])
    return probs, state
