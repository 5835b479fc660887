from depthg_tpu_torch.models.zoedepth.model import (
    ZoeConfig,
    ZoeDepth,
    prep_size,
    zoedepth_infer,
)
