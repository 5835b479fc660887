"""The lower-precision control: the reference with every backbone product's
operands rounded to float8 e4m3 (a per-tensor scale that maps the largest
magnitude to e4m3's largest finite value, 448), the step below the
configuration's bfloat16 backbone. Its readings set the upper end of each
limit that `correct` is judged by.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded through float8 e4m3 at a per-tensor scale, in t's dtype."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)
