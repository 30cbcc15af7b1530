"""C2S spike-inference baseline — deprecated, documented for inventory parity.

The reference's ``C2SSegmentation`` (``models/spikes/c2s_segmentation.py``)
wraps the external ``c2s`` package (C++ CMT/liblbfgs STM models). It is
non-functional in the reference itself: it imports metrics that do not exist
(``c2s_segmentation.py:14`` vs ``utils/spikes.py``), contains two live
``pdb.set_trace()`` calls (``:102-103, :140-141``), and its ``predict`` is a
stub (``:143-157``). Per SURVEY §2 row 29 the rebuild documents it as
deprecated rather than porting the breakage.

The supported spike-inference paths in this framework:
- deep: :class:`deepcalcium_tpu.models.unet_1d_segmentation.UNet1DSegmentation`
- classical (the capability C2S provided): a JAX-native convolutional GLM,
  :class:`deepcalcium_tpu.models.glm_spikes.GLMSegmentation` — the linear
  core of c2s's STM, trained on the device, same fit/predict contract.
"""


class C2SSegmentation:
    """Deprecated. See module docstring; use UNet1DSegmentation (deep) or
    GLMSegmentation (classical) instead."""

    DEPRECATION_REASON = (
        "The reference C2S wrapper is broken upstream (nonexistent metric "
        "imports, live pdb breakpoints, stub predict). Use "
        "UNet1DSegmentation, or GLMSegmentation for a classical baseline "
        "(models/glm_spikes.py)."
    )

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(self.DEPRECATION_REASON)
