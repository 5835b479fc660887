"""PyTorch/CUDA port of depthg_tpu's eval/serve prediction path.

Module names follow the JAX package (``depthg_tpu``), which stays the
reference: ``ops.resize``, ``ops.attention`` (+ the hand-written Hopper
kernel in ``csrc/attention.cu``), ``ops.crf``, ``ops.crf_bilateral`` (+
``csrc/crf_bilateral.cu``), ``models.vit``, ``models.featurizer``,
``models.probes``, ``utils.metrics``, ``utils.ckpt``, ``inference`` and the
entry modules ``eval_segmentation``, ``crf_fidelity_study`` and
``profile_eval``. This package imports torch and never jax.
"""

from depthg_tpu_torch.runtime import configure_numerics, get_device

configure_numerics()

__all__ = ["configure_numerics", "get_device"]
