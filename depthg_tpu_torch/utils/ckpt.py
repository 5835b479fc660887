"""Checkpoints for the port: reference Lightning ``.ckpt`` files and the
weight carry-over from the JAX package (``depthg_tpu/utils/ckpt.py``).

All end in the reference Lightning key layout (``net.model.*``,
``net.cluster1.0.*``, ``net.cluster2.{0,2}.*``, ``linear_probe.*``,
``cluster_probe.clusters``), which ``inference.Segmenter`` loads with
``strict=True``. ``lightning_state_dict`` (the port's own copy of the
exporter in ``depthg_tpu/utils/ckpt.py:146-206``) writes that layout from
the JAX package's parameter tree given as numpy arrays, so random-init
parity weights and released checkpoints take one path.

``state_dict_from_jax`` also carries the variants' trees: the depth
featurizer's pyramid, cross-attention and ``no_depth_embed``, the feature
pyramid's ResNet-50 and head (BatchNorm statistics included) and the LHP
head. The trainer writes the port's own resumable train state
(``save_train_state``: ``torch.save`` of the trainable tensors and
buffers, the three optimizers' ``state_dict()`` and the step) and, for
``arch=dino`` as the JAX trainer, a reference-compatible Lightning
``.ckpt`` (``export_lightning_ckpt``; both packages' eval loaders read it),
and for every arch ``save_segmenter``'s file, the port's counterpart of the
JAX trainer's orbax directory (the eval state dict with the frozen
backbone, the run config and the metrics). The JAX trainer's orbax
directories are read by ``utils.checkpoint_io``; its pickled optax state
needs JAX to unpickle and is neither written nor read.
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


def _heads_sd(sd: dict, params: dict) -> None:
    """The probes and the training side's decoder."""
    if "linear_probe" in params:
        _conv1x1_sd(sd, "linear_probe", params["linear_probe"])
    if "cluster_probe" in params:
        sd["cluster_probe.clusters"] = _torch(params["cluster_probe"]["clusters"])
    if "decoder" in params and params["decoder"] is not None:
        # the inline rec-loss decoder (reference train_segmentation.py:115)
        _conv1x1_sd(sd, "decoder", params["decoder"])


def lightning_state_dict(params: dict) -> dict:
    """Full segmenter parameter tree -> reference Lightning state_dict."""
    net = params["net"]
    sd = vit_state_dict(net["vit"], prefix="net.model.")
    if "cluster1" in net:
        _conv1x1_sd(sd, "net.cluster1.0", net["cluster1"])
    if "cluster2" in net:
        _conv1x1_sd(sd, "net.cluster2.0", net["cluster2"]["fc1"])
        _conv1x1_sd(sd, "net.cluster2.2", net["cluster2"]["fc2"])
    _heads_sd(sd, params)
    return sd


def _conv_sd(out: dict, prefix: str, p: dict) -> None:
    """A convolution stored as torch's OIHW (``zoedepth.layers.conv_init``)."""
    out[prefix + ".weight"] = _torch(p["w"])
    if "b" in p:
        out[prefix + ".bias"] = _torch(p["b"])


def _bn_sd(out: dict, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _torch(p["g"])
    out[prefix + ".bias"] = _torch(p["b"])
    out[prefix + ".running_mean"] = _torch(p["mean"])
    out[prefix + ".running_var"] = _torch(p["var"])
    out[prefix + ".num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _resnet50_sd(out: dict, prefix: str, p: dict) -> None:
    """The JAX package's ResNet-50 tree -> torchvision's keys."""
    _conv_sd(out, prefix + "conv1", p["conv1"])
    _bn_sd(out, prefix + "bn1", p["bn1"])
    for li, layer in enumerate(p["layers"], start=1):
        for bi, blk in enumerate(layer):
            q = f"{prefix}layer{li}.{bi}."
            for ci in (1, 2, 3):
                _conv_sd(out, f"{q}conv{ci}", blk[f"conv{ci}"])
                _bn_sd(out, f"{q}bn{ci}", blk[f"bn{ci}"])
            if "down" in blk:
                _conv_sd(out, q + "downsample.0", blk["down"]["conv"])
                _bn_sd(out, q + "downsample.1", blk["down"]["bn"])


def _pyramid_sd(net: dict) -> dict:
    """``arch=feature-pyramid``: the ResNet under ``net.model``, the head's
    ``cluster*`` and ``conv*`` (``DoubleConv``) with their BatchNorm stats."""
    sd: dict = {}
    _resnet50_sd(sd, "net.model.", net["vit"])
    for name, p in net.items():
        if name.startswith("cluster"):
            _conv_sd(sd, f"net.{name}", p)
        elif name.startswith("conv"):
            for part in ("conv1", "conv2"):
                _conv_sd(sd, f"net.{name}.{part}", p[part])
            for part in ("bn1", "bn2"):
                _bn_sd(sd, f"net.{name}.{part}", p[part])
    return sd


def _depth_featurizer_sd(sd: dict, net: dict) -> None:
    """``arch=dino_depth``'s parts beside the DINO featurizer's."""
    for i, stage in enumerate(net["depth_downscaling"]):
        w = np.asarray(stage["conv"]["w"])  # [in*4, out], (c, kh, kw) order
        sd[f"net.depth_downscaling.{i}.conv.weight"] = _torch(
            w.T.reshape(w.shape[1], w.shape[0] // 4, 2, 2))
        sd[f"net.depth_downscaling.{i}.conv.bias"] = _torch(stage["conv"]["b"])
        if "ln" in stage:
            _layer_norm_sd(sd, f"net.depth_downscaling.{i}.ln", stage["ln"])
    attn = net["cross_attn"]
    sd["net.cross_attn.in_proj_weight"] = _torch(np.asarray(attn["in_proj"]["w"]).T)
    sd["net.cross_attn.in_proj_bias"] = _torch(attn["in_proj"]["b"])
    _linear_sd(sd, "net.cross_attn.out_proj", attn["out_proj"])
    sd["net.no_depth_embed"] = _torch(net["no_depth_embed"])


def lhp_state_dict_from_jax(params: dict) -> dict:
    """The JAX package's LHP head (``lhp_init``) -> ``models.lhp.LHP``'s
    state dict (``proj.fc{1,2}.*``)."""
    sd: dict = {}
    for name in ("fc1", "fc2"):
        _conv1x1_sd(sd, f"proj.{name}", {k: np.array(v, np.float32)
                                          for k, v in params["proj"][name].items()})
    return sd


def state_dict_from_jax(params: dict, keep_decoder: bool = False) -> dict:
    """JAX segmenter param tree (numpy or jax leaves) -> the port's eval
    state dict (float32 torch tensors; BatchNorm's ``num_batches_tracked``
    0); ``keep_decoder=True`` keeps the training side's ``decoder.*``
    beside it. Each featurizer's tree is recognized by its keys: the
    pyramid's ResNet-50 under ``vit``, the depth featurizer's
    ``depth_downscaling``. A frozen LHP head under ``net.lhp`` (the JAX
    trainer's eval tree) comes out as ``lhp.proj.fc{1,2}.*``."""
    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [host(v) for v in tree]
        return np.array(tree, np.float32)  # writable host copy

    params = host(params)
    net = params["net"]
    if "layers" in net["vit"]:
        sd = _pyramid_sd(net)
        _heads_sd(sd, params)
    else:
        sd = lightning_state_dict(params)
        if "depth_downscaling" in net:
            _depth_featurizer_sd(sd, net)
    if "lhp" in net:
        sd.update({"lhp." + k: v for k, v in lhp_state_dict_from_jax(net["lhp"]).items()})
    sd = {k: v if k.endswith("num_batches_tracked") else v.float() for k, v in sd.items()}
    out = eval_state_dict(sd)
    for prefix in ("lhp.",) + (("decoder.",) if keep_decoder else ()):
        out.update({k: v for k, v in sd.items() if k.startswith(prefix)})
    return out


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


def strip_prefixes(sd: dict, prefixes=("module.", "backbone.")) -> dict:
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            k = k.replace(p, "")
        out[k] = v
    return out


def load_dino_pth(path: str) -> dict:
    """A DINO or DINOv2 pretrain ``.pth`` (optionally a {"teacher": ...}
    wrapper with ``module.`` / ``backbone.`` prefixes) -> the ViT's state
    dict in DINO's own keys, which are ``models.vit.VisionTransformer``'s;
    keys of DINO's projection head (``head.*``) and DINOv2's ``mask_token``
    (used only by its masked-image pretraining) are dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "teacher" in sd:
        sd = strip_prefixes(sd["teacher"])
    return {k: v for k, v in sd.items() if not k.startswith("head.") and k != "mask_token"}


def export_lightning_ckpt(path: str, state_dict: dict, cfg: dict | None = None,
                          n_classes: int | None = None, global_step: int = 0,
                          epoch: int = 0) -> None:
    """Write a reference-compatible Lightning ``.ckpt`` from a segmenter
    state dict in the Lightning layout (``Segmenter.state_dict()``).

    ``cfg`` is the reference-style run config (what the reference's
    ``save_hyperparameters()`` would have captured); ``n_classes`` defaults
    to the linear probe's output size."""
    sd = {k: v.detach().cpu().clone() for k, v in state_dict.items()}
    if n_classes is None and "linear_probe.weight" in sd:
        n_classes = int(sd["linear_probe.weight"].shape[0])
    blob = {
        "epoch": epoch,
        "global_step": global_step,
        "pytorch-lightning_version": "1.9.0",
        "state_dict": sd,
        "hyper_parameters": {"n_classes": n_classes, "cfg": dict(cfg or {})},
        "loops": {},
        "callbacks": {},
        "optimizer_states": [],
        "lr_schedulers": [],
    }
    torch.save(blob, path)


SEGMENTER_FORMAT = "depthg_tpu_torch.segmenter"


def _plain(tree):
    """Config values as plain dicts and lists (no ``Config`` objects in the
    pickle)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def save_segmenter(path: str, state_dict: dict, cfg: dict | None = None,
                   metrics: dict | None = None, step: int = 0) -> None:
    """The trainer's checkpoint for every arch (the counterpart of the JAX
    trainer's ``save_native``): the eval state dict, frozen backbone
    included, with the run config and the metrics."""
    torch.save({"format": SEGMENTER_FORMAT,
                "state_dict": {k: v.detach().cpu().clone() for k, v in state_dict.items()},
                "cfg": _plain(dict(cfg or {})), "metrics": _plain(dict(metrics or {})),
                "step": int(step)}, path)


def load_segmenter_file(path: str):
    """``save_segmenter``'s file -> (eval state dict, cfg dict, metrics)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(blob, dict) or blob.get("format") != SEGMENTER_FORMAT:
        raise ValueError(f"{path}: not a checkpoint written by save_segmenter")
    return blob["state_dict"], blob["cfg"], blob["metrics"]


def _trainable_keys(model) -> list:
    """State-dict keys outside the frozen backbone."""
    return [k for k in model.state_dict() if not k.startswith("net.model.")]


def save_train_state(path: str, state) -> None:
    """The port's resumable train state: the trainable tensors, the three
    optimizers' ``state_dict()`` and the step (the frozen backbone comes
    from ``pretrained_weights`` or the seed again)."""
    sd = state.model.state_dict()
    torch.save({
        "model": {k: sd[k].detach().cpu().clone() for k in _trainable_keys(state.model)},
        "opt": {name: opt.state_dict() for name, opt in state.opt.items()},
        "step": int(state.step),
    }, path)


def load_train_state(path: str, state):
    """Load ``save_train_state``'s file into ``state`` in place (the
    optimizer moments land on their parameters' device)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if sorted(blob["model"]) != sorted(_trainable_keys(state.model)):
        raise ValueError(f"{path}: trainable keys {sorted(blob['model'])} do not "
                         f"match the model's {sorted(_trainable_keys(state.model))}")
    state.model.load_state_dict(blob["model"], strict=False)
    for name, opt in state.opt.items():
        opt.load_state_dict(blob["opt"][name])
    state.step = int(blob["step"])
    return state
