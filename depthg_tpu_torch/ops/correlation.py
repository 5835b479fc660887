"""Feature-normalization primitive (``depthg_tpu/ops/correlation.py:norm``).

The correlation tensors of the training loss belong to the training slice."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def norm(t: torch.Tensor, dim: int = 1, eps: float = 1e-10) -> torch.Tensor:
    """``F.normalize(t, dim=dim, eps=1e-10)``, with the norm taken in f32."""
    return F.normalize(t.float(), dim=dim, eps=eps).to(t.dtype)
