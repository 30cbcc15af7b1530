"""deepcalcium-tpu: a JAX calcium-imaging segmentation framework.

A ground-up JAX/XLA rebuild of the capabilities of
``alexklibisz/deep-calcium`` (Keras/TF, single GPU), run on NVIDIA GPUs:

- Dense math (U-Net forward/backward, test-time augmentation, summary-image
  reductions, metric reductions) runs on device under ``jax.jit``.
- Scale-out is expressed with ``jax.sharding.Mesh`` + NamedSharding (GSPMD),
  not host loops: data-parallel training, TTA-sharded evaluation, and
  time-axis-sharded movie reduction all ride the same mesh.
- The reference's composability idiom (injected ``*_summary_func`` /
  ``net_builder_func`` callables; reference ``unet_2d_summary.py:316-324``)
  is preserved as plain-Python callables around a pure-functional core.
"""

__version__ = "0.1.0"
