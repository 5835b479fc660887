"""PyTorch/CUDA port of depthg_tpu's eval/serve prediction path, of its
depth-guided contrastive train step, of its serving stack and of its offline
crop + KNN pipeline.

Module names follow the JAX package (``depthg_tpu``), which stays the
reference: ``ops.resize``, ``ops.attention`` (+ the hand-written Hopper
kernel in ``csrc/attention.cu``), ``ops.crf``, ``ops.crf_bilateral`` (+
``csrc/crf_bilateral.cu``), ``ops.zoe_bins`` (+ ``csrc/zoe_bins.cu``,
ZoeDepth's bins tail), ``models.vit``, ``models.featurizer``,
``models.probes``, ``utils.metrics``, ``utils.ckpt``, ``inference``, the
training side (``ops.sampling``, ``ops.depth``, ``ops.correlation``,
``train.losses``, ``train.decay``, ``train.step``), ``serve``,
``parallel.dist`` (torchrun data parallelism), ``parallel.mesh`` (replicas of
one process), ``parallel.knn``, ``utils.checkpoint_io`` (with the orbax
reader), ``utils.figures`` and the entry modules
``eval_segmentation``, ``train_segmentation``, ``serve``, ``serve_loadgen``,
``demo_segmentation``, ``crop_datasets``, ``precompute_knns``,
``crf_fidelity_study``, ``profile_eval``, ``profile_train``,
``profile_serve``, ``profile_knn`` and ``bench`` (with ``utils.profiling``). This package imports torch and never
jax.
"""

from depthg_tpu_torch.runtime import configure_numerics, get_device

configure_numerics()

__all__ = ["configure_numerics", "get_device"]
