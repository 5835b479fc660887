"""Checkpoints for the port: reference Lightning ``.ckpt`` files and the
weight carry-over from the JAX package (``depthg_tpu/utils/ckpt.py``).

Both end in the reference Lightning key layout (``net.model.*``,
``net.cluster1.0.*``, ``net.cluster2.{0,2}.*``, ``linear_probe.*``,
``cluster_probe.clusters``), which ``inference.Segmenter`` loads with
``strict=True``. ``lightning_state_dict`` (the port's own copy of the
exporter in ``depthg_tpu/utils/ckpt.py:146-206``) writes that layout from
the JAX package's parameter tree given as numpy arrays, so random-init
parity weights and released checkpoints take one path.
"""

from __future__ import annotations

import numpy as np
import torch

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


def _torch(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _linear_sd(out: dict, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _torch(np.asarray(p["w"]).T)
    out[prefix + ".bias"] = _torch(p["b"])


def _conv1x1_sd(out: dict, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _torch(np.asarray(p["w"]).T[:, :, None, None])
    out[prefix + ".bias"] = _torch(p["b"])


def _layer_norm_sd(out: dict, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _torch(p["g"])
    out[prefix + ".bias"] = _torch(p["b"])


def vit_state_dict(params: dict, prefix: str = "") -> dict:
    """ViT parameter tree of the JAX package -> DINO ViT torch state dict."""
    out: dict[str, torch.Tensor] = {}
    pw = np.asarray(params["patch_embed"]["w"])  # [3*ps*ps, D], (c, kh, kw) order
    d = pw.shape[1]
    ps = int(round((pw.shape[0] // 3) ** 0.5))
    out[prefix + "patch_embed.proj.weight"] = _torch(pw.T.reshape(d, 3, ps, ps))
    out[prefix + "patch_embed.proj.bias"] = _torch(params["patch_embed"]["b"])
    out[prefix + "cls_token"] = _torch(params["cls_token"])
    out[prefix + "pos_embed"] = _torch(params["pos_embed"])
    _layer_norm_sd(out, prefix + "norm", params["norm"])
    for i, blk in enumerate(params["blocks"]):
        p = f"{prefix}blocks.{i}"
        _layer_norm_sd(out, p + ".norm1", blk["norm1"])
        _linear_sd(out, p + ".attn.qkv", blk["qkv"])
        _linear_sd(out, p + ".attn.proj", blk["proj"])
        _layer_norm_sd(out, p + ".norm2", blk["norm2"])
        _linear_sd(out, p + ".mlp.fc1", blk["fc1"])
        _linear_sd(out, p + ".mlp.fc2", blk["fc2"])
    return out


def lightning_state_dict(params: dict) -> dict:
    """Full segmenter parameter tree -> reference Lightning state_dict."""
    net = params["net"]
    sd = vit_state_dict(net["vit"], prefix="net.model.")
    if "cluster1" in net:
        _conv1x1_sd(sd, "net.cluster1.0", net["cluster1"])
    if "cluster2" in net:
        _conv1x1_sd(sd, "net.cluster2.0", net["cluster2"]["fc1"])
        _conv1x1_sd(sd, "net.cluster2.2", net["cluster2"]["fc2"])
    if "linear_probe" in params:
        _conv1x1_sd(sd, "linear_probe", params["linear_probe"])
    if "cluster_probe" in params:
        sd["cluster_probe.clusters"] = _torch(params["cluster_probe"]["clusters"])
    if "decoder" in params and params["decoder"] is not None:
        # the inline rec-loss decoder (reference train_segmentation.py:115)
        _conv1x1_sd(sd, "decoder", params["decoder"])
    return sd


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
