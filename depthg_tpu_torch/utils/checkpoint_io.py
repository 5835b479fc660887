"""The one checkpoint loader of the eval, demo and serve entry points
(``depthg_tpu/utils/checkpoint_io.py:load_segmenter``).

A reference Lightning ``.ckpt`` loads into the eval state dict that
``inference.Segmenter.from_state_dict`` takes, with its run config. The JAX
package's native checkpoints are orbax directories; reading one without JAX
needs a reader of that format, which the port does not have yet.
``fcfg_from_run_cfg`` and ``ecfg_from_checkpoint``, the other two functions
of the JAX module, live in ``depthg_tpu_torch/inference.py``.
"""

from __future__ import annotations

import os

from depthg_tpu_torch.config import Config
from depthg_tpu_torch.utils.ckpt import load_lightning_ckpt


def load_segmenter(path: str):
    """Returns (eval state dict, run_cfg: Config) of a Lightning ``.ckpt``
    (hparams embedded). An orbax checkpoint directory raises."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: orbax checkpoint directories need a reader without JAX "
            "(ROADMAP item 3: the orbax reader); the port loads Lightning "
            ".ckpt files")
    sd, hparams = load_lightning_ckpt(path)
    return sd, Config(hparams or {})
