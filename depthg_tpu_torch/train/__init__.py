"""The depth-guided contrastive train step of the port: ``losses``, ``decay``
and ``step`` (``depthg_tpu/train/``)."""
