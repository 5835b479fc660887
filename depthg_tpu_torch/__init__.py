"""PyTorch/CUDA port of depthg_tpu's eval/serve prediction path.

Module names follow the JAX package (``depthg_tpu``), which stays the
reference: ``ops.resize``, ``ops.attention`` (+ the hand-written Hopper
kernel in ``csrc/attention.cu``), ``ops.crf``, ``models.vit``,
``models.featurizer``, ``models.probes``, ``utils.metrics``,
``utils.ckpt`` and ``inference``. This package imports torch and never jax.
"""

from depthg_tpu_torch.runtime import configure_numerics, get_device

configure_numerics()

__all__ = ["configure_numerics", "get_device"]
