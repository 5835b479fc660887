"""Checkpoints for the port: reference Lightning ``.ckpt`` files and the
weight carry-over from the JAX package (``depthg_tpu/utils/ckpt.py``).

Both end in the reference Lightning key layout (``net.model.*``,
``net.cluster1.0.*``, ``net.cluster2.{0,2}.*``, ``linear_probe.*``,
``cluster_probe.clusters``), which ``inference.Segmenter`` loads with
``strict=True``. The JAX package's numpy-only exporter
``lightning_state_dict`` writes that layout from a JAX param tree, so
random-init parity weights and released checkpoints take one path.
"""

from __future__ import annotations

import numpy as np
import torch

from depthg_tpu.utils.ckpt import lightning_state_dict

# the keys eval consumes; the decoder and training-only probes are dropped
EVAL_PREFIXES = ("net.", "linear_probe.", "cluster_probe.clusters")


def eval_state_dict(sd: dict) -> dict:
    """The eval keys of a Lightning state dict, with a linear probe stored
    as ``nn.Linear`` ([out, in]) reshaped to the 1x1 conv layout."""
    out = {k: v for k, v in sd.items() if k.startswith(EVAL_PREFIXES)}
    w = out.get("linear_probe.weight")
    if w is not None and w.dim() == 2:
        out["linear_probe.weight"] = w[:, :, None, None]
    return out


def state_dict_from_jax(params: dict) -> dict:
    """JAX segmenter param tree (numpy or jax leaves) -> the port's eval
    state dict (float32 torch tensors)."""
    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [host(v) for v in tree]
        return np.array(tree, np.float32)  # writable host copy

    sd = lightning_state_dict(host(params))
    return eval_state_dict({k: v.float() for k, v in sd.items()})


def load_lightning_ckpt(path: str):
    """Reference ``.ckpt`` -> (eval state dict, hparams cfg dict or None)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    hparams = blob.get("hyper_parameters") or blob.get("hparams") or None
    if hparams is not None and not isinstance(hparams, dict):
        hparams = dict(hparams)  # OmegaConf DictConfig in reference checkpoints
    if isinstance(hparams, dict) and "cfg" in hparams:
        cfg = hparams["cfg"]
        hparams = cfg if isinstance(cfg, dict) else {k: cfg[k] for k in cfg}
    return eval_state_dict(blob["state_dict"]), hparams
