"""The feature-pyramid featurizer, ``arch=feature-pyramid``, and the frozen
CNN backbones of ``load_model`` (``depthg_tpu/models/pyramid.py``).

``ResNet50``, ``VGG11`` and ``DenseNet121`` hold torchvision's own
state-dict keys (``conv1``, ``bn1``, ``layer1.0.downsample.1``,
``features.3``, ``features.denseblock1.denselayer1.norm1``, ...), so a
released file loads as it is; ``load_model`` undoes each file's key quirk.
Their BatchNorm always normalizes by the running statistics: the backbones
are frozen, and ``train()`` leaves them in eval mode, so a ``model.train()``
on the segmenter neither switches them to batch statistics nor touches
their running stats.

``FeaturePyramidNet`` is the reference's head over ResNet-50 activations
(layers 2-4 at 1/8, 1/16, 1/32): ``cluster1..4`` 1x1 convs and
``conv2..4`` ``DoubleConv`` (conv-BN-ReLU twice), each level resized to
``out_size`` (56) and averaged, ``continuous`` or ``log_softmax``. Its
BatchNorm uses the batch statistics in train mode (biased variance to
normalize, unbiased into the running stats, momentum 0.1: torch's
``BatchNorm2d``), one update per train-mode forward, and the running
statistics in eval. ``backbone_dtype="bfloat16"`` runs the ResNet's
convolutions in bf16 on a bf16 image (BatchNorm's parameters stay float32)
and returns float32 features; the head is float32.
"""

from __future__ import annotations

import dataclasses
import os
from os.path import join

import torch
import torch.nn.functional as F
from torch import nn

from depthg_tpu_torch.models.featurizer import bf16_parameters
from depthg_tpu_torch.models.zoedepth.layers import init_uniform_
from depthg_tpu_torch.ops.resize import resize_bilinear
from depthg_tpu_torch.parallel import dist


class FrozenBackbone(nn.Module):
    """A backbone whose BatchNorm layers stay in eval mode."""

    def train(self, mode: bool = True) -> "FrozenBackbone":
        return super().train(False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "FrozenBackbone":
        """The JAX package's random init: convolutions uniform(+-1/sqrt(fan_in)),
        BatchNorm scale 1, shift 0, running mean 0 and variance 1."""
        init_uniform_(self, generator)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        return self

    def conv_weights_bf16(self) -> dict:
        """bf16 copies of the convolutions' parameters by name, for
        ``functional_call`` (BatchNorm keeps its float32 parameters)."""
        return bf16_parameters(self, [f"{mod}.{p}" for mod, m in self.named_modules()
                                      if isinstance(m, nn.Conv2d)
                                      for p, _ in m.named_parameters(recurse=False)])


# ---------------- ResNet-50 ----------------

_R50_LAYERS = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2), (3, 512, 2048, 2)]


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, mid: int, out_ch: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(mid)
        self.conv3 = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False), nn.BatchNorm2d(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class ResNet50(FrozenBackbone):
    """torchvision's resnet50 without ``avgpool`` / ``fc``."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        in_ch = 64
        for i, (blocks, mid, out_ch, stride) in enumerate(_R50_LAYERS, start=1):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(in_ch, mid, out_ch, stride if b == 0 else 1))
                in_ch = out_ch
            setattr(self, f"layer{i}", nn.Sequential(*layer))
        self.eval()

    def forward(self, x: torch.Tensor, layer_nums=(7,)) -> dict:
        """Activations by torchvision child index (``NetWithActivations``):
        4 = layer1 (1/4), 5 = layer2 (1/8), 6 = layer3 (1/16), 7 = layer4 (1/32)."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        acts = {}
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            if 4 + i in layer_nums:
                acts[4 + i] = x
        return acts


def feature_map(net: FrozenBackbone, x: torch.Tensor) -> torch.Tensor:
    """The map before pooling: ResNet-50's layer4, the others' ``features``."""
    return net(x)[7] if isinstance(net, ResNet50) else net(x)


# ---------------- VGG-11 ----------------

_VGG11_CFG = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


class VGG11(FrozenBackbone):
    """torchvision's ``vgg11.features`` -> [B, 512, H/32, W/32]."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for v in _VGG11_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(in_ch, v, 3, padding=1), nn.ReLU(inplace=True)]
                in_ch = v
        self.features = nn.Sequential(*layers)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


# ---------------- DenseNet-121 ----------------

_DN121_BLOCKS = (6, 12, 24, 16)
_DN_GROWTH = 32


class _DenseLayer(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(ch)
        self.conv1 = nn.Conv2d(ch, 4 * _DN_GROWTH, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(4 * _DN_GROWTH)
        self.conv2 = nn.Conv2d(4 * _DN_GROWTH, _DN_GROWTH, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.norm1(x)))
        return torch.cat([x, self.conv2(F.relu(self.norm2(h)))], dim=1)


class _Transition(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(ch)
        self.conv = nn.Conv2d(ch, ch // 2, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2)


class DenseNet121(FrozenBackbone):
    """torchvision's ``densenet121.features`` -> [B, 1024, H/32, W/32].

    Reference quirk kept: its ``Sequential(*children[:-1] + [AvgPool])``
    drops the ReLU that torchvision's own ``forward`` applies after
    ``norm5``, so there is none here either."""

    def __init__(self):
        super().__init__()
        f = nn.Module()
        f.conv0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        f.norm0 = nn.BatchNorm2d(64)
        ch = 64
        for bi, n_layers in enumerate(_DN121_BLOCKS, start=1):
            block = nn.Module()
            for li in range(1, n_layers + 1):
                setattr(block, f"denselayer{li}", _DenseLayer(ch))
                ch += _DN_GROWTH
            setattr(f, f"denseblock{bi}", block)
            if bi < len(_DN121_BLOCKS):
                setattr(f, f"transition{bi}", _Transition(ch))
                ch //= 2
        f.norm5 = nn.BatchNorm2d(ch)
        self.features = f
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.features
        x = F.max_pool2d(F.relu(f.norm0(f.conv0(x))), 3, stride=2, padding=1)
        for bi in range(1, len(_DN121_BLOCKS) + 1):
            for layer in getattr(f, f"denseblock{bi}").children():
                x = layer(x)
            if bi < len(_DN121_BLOCKS):
                x = getattr(f, f"transition{bi}")(x)
        return f.norm5(x)


# ---------------- load_model (reference src/utils.py:68-124) ----------------

_MODEL_FILES = {
    "robust_resnet50": "imagenet_l2_3_0.pt",
    "densecl": "densecl_r50_coco_1600ep.pth",
    "mocov2": "moco_v2_800ep_pretrain.pth.tar",
    "resnet50": "resnet50-0676ba61.pth",       # torchvision IMAGENET1K_V1
    "densenet121": "densenet121-a639ec97.pth",
    "vgg11": "vgg11-8a719046.pth",
}

# model_types whose load_model returns the resnet50 layout (n_feats=2048) —
# the only family FeaturePyramidNet's hard-coded channel table accepts
# (reference src/modules.py:703-704)
RESNET50_MODEL_TYPES = frozenset(
    {"robust_resnet50", "densecl", "mocov2", "resnet50"})

_BACKBONES = {"densenet121": (DenseNet121, 1024), "vgg11": (VGG11, 512)}


def backbone_for(model_type: str) -> tuple:
    """(an unloaded backbone module, n_feats) for ``model_type``."""
    if model_type not in _MODEL_FILES:
        raise ValueError(f"No model: {model_type} found")
    cls, n_feats = _BACKBONES.get(model_type, (ResNet50, 2048))
    return cls(), n_feats


def _load_strict(net: nn.Module, sd: dict, path: str) -> None:
    """Load ``sd``; its extra keys (``fc``, ``classifier``) are ignored, but
    every key of ``net`` but ``num_batches_tracked`` must be there."""
    missing, _ = net.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{path}: missing {missing[:5]} (of {len(missing)})")


def load_model(model_type: str, data_dir: str) -> tuple:
    """The reference's ``load_model``: (backbone module in eval mode,
    n_feats); ``feature_map`` gives its map before pooling. The file must
    already be in ``data_dir`` (nothing is downloaded).

    Key quirks: robust_resnet50 stores {"model": {...'model.'...}}, mocov2
    its query encoder under ``module.encoder_q.`` (``fc`` dropped), densecl
    the plain keys under ``state_dict``."""
    if model_type not in _MODEL_FILES:
        # raised before the path join, so an unknown type never becomes a
        # torch.load of the directory or a misleading missing-file message
        raise ValueError(f"No model: {model_type} found")
    path = join(data_dir, _MODEL_FILES[model_type])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{model_type} weights not found at {path}; the reference downloads "
            f"them (src/utils.py:68-124) but nothing is downloaded here: "
            f"place the file there")
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if model_type == "robust_resnet50":
        sd = {name.split("model.")[1]: v for name, v in blob["model"].items()
              if "model" in name}
    elif model_type == "mocov2":
        sd = {k[len("module.encoder_q."):]: v for k, v in blob["state_dict"].items()
              if k.startswith("module.encoder_q") and not k.startswith("module.encoder_q.fc")}
    elif model_type == "densecl":
        sd = blob["state_dict"]
    else:
        sd = blob
    net, n_feats = backbone_for(model_type)
    _load_strict(net, sd, path)
    return net, n_feats


# ---------------- FeaturePyramidNet ----------------

@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    granularity: int = 1
    dim: int = 70
    continuous: bool = True
    layer_nums: tuple = (5, 6, 7)
    feat_channels: tuple = (2048, 1024, 512, 3)
    extra_channels: tuple = (128, 64, 32, 32)
    out_size: int = 56  # the reference's hard-coded interpolation target
    bn_momentum: float = 0.1  # torch BatchNorm2d default

    @property
    def n_feats(self) -> int:
        # reference FeaturePyramidNet.n_feats = self.dim (src/modules.py:707)
        return self.dim


class DoubleConv(nn.Module):
    """conv3x3-BN-ReLU twice; BatchNorm by batch statistics when
    ``train``, by running statistics otherwise."""

    def __init__(self, in_ch: int, out_ch: int, momentum: float):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(out_ch, momentum=momentum)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(out_ch, momentum=momentum)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            if train and dist.world() > 1:
                x = _batch_norm_global(conv(x), bn)
            else:
                x = F.batch_norm(conv(x), bn.running_mean, bn.running_var, bn.weight,
                                 bn.bias, train, bn.momentum, bn.eps)
            if train:
                bn.num_batches_tracked.add_(1)
            x = F.relu(x)
        return x


def _batch_norm_global(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train-mode BatchNorm over the global batch of a process group, as
    the JAX step normalizes by the whole batch under jit: the mean, then
    the biased variance around it, each from an all-reduced sum that
    carries the gradient; every rank updates the running statistics alike
    (the unbiased variance, as ``F.batch_norm``)."""
    dims = (0, 2, 3)
    count = x.numel() // x.shape[1] * dist.world()
    mean = dist.sum_with_grad(x.sum(dims)) / count
    centered = x - mean[None, :, None, None]
    var = dist.sum_with_grad(centered.square().sum(dims)) / count
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1 - m).add_(var.detach() * (count / (count - 1)), alpha=m)
    inv = torch.rsqrt(var + bn.eps)
    return (centered * inv[None, :, None, None] * bn.weight[None, :, None, None]
            + bn.bias[None, :, None, None])


class FeaturePyramidNet(nn.Module):
    """The frozen ResNet-50 under ``model`` and the trainable head."""

    def __init__(self, cfg: PyramidConfig):
        super().__init__()
        self.fcfg = cfg
        fc, ec = cfg.feat_channels, cfg.extra_channels
        self.model = ResNet50()
        self.cluster1 = nn.Conv2d(fc[0], cfg.dim, 1)
        if cfg.granularity >= 2:
            self.conv2 = DoubleConv(fc[0] + fc[1], ec[1], cfg.bn_momentum)
            self.cluster2 = nn.Conv2d(ec[1], cfg.dim, 1)
        if cfg.granularity >= 3:
            self.conv3 = DoubleConv(ec[1] + fc[2], ec[2], cfg.bn_momentum)
            self.cluster3 = nn.Conv2d(ec[2], cfg.dim, 1)
        if cfg.granularity >= 4:
            self.conv4 = DoubleConv(ec[2] + fc[3], ec[3], cfg.bn_momentum)
            self.cluster4 = nn.Conv2d(ec[3], cfg.dim, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "FeaturePyramidNet":
        self.model.init_weights(generator)
        for name, child in self.named_children():
            if name != "model":
                init_uniform_(child, generator)
        return self


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    """``resize_bilinear`` on a channels-last copy: torch's NCHW kernel runs
    one CUDA thread per output pixel over every plane in turn, which at the
    pyramid's small, deep maps ([32, 2048, 7, 7] to 14 x 14: 196 threads x
    65,536 planes) took 50 of a step's 84 device ms on the H100; the
    channels-last kernel runs one thread per output value. Same formula."""
    return resize_bilinear(x.contiguous(memory_format=torch.channels_last), size)


@torch.no_grad()
def backbone_features(net: FeaturePyramidNet, img: torch.Tensor,
                      backbone_dtype: str | None = None) -> dict:
    """The frozen ResNet-50's float32 activations at ``layer_nums``; with
    ``backbone_dtype="bfloat16"`` its convolutions and the image in bf16."""
    layer_nums = net.fcfg.layer_nums
    if backbone_dtype != "bfloat16":
        return net.model(img, layer_nums)
    feats = torch.func.functional_call(net.model, net.model.conv_weights_bf16(),
                                       (img.to(torch.bfloat16), layer_nums))
    return {k: v.float() for k, v in feats.items()}


def pyramid_featurizer_apply(net: FeaturePyramidNet, img: torch.Tensor,
                             backbone_dtype: str | None = None,
                             train: bool = False) -> dict:
    """dict(feats = the ResNet's last map, code = the pyramid's clusters,
    attn = None). In train mode the head's BatchNorm normalizes by the batch
    and updates its running statistics."""
    cfg = net.fcfg
    if backbone_dtype == "int8":
        raise NotImplementedError(
            "backbone_dtype='int8' is the ViT's w8a8 path (models/vit.py "
            "quantize_vit); the ResNet pyramid backbone takes float32 | bfloat16, "
            "as the JAX package's does")
    if backbone_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"unknown backbone_dtype {backbone_dtype!r}")
    feats = backbone_features(net, img, backbone_dtype)
    low = feats[cfg.layer_nums[-1]]

    def clusterer(conv, t):
        return _resize(conv(t), cfg.out_size)

    def up2(t):
        return _resize(t, (t.shape[-2] * 2, t.shape[-1] * 2))

    clusters = [clusterer(net.cluster1, low)]
    if cfg.granularity >= 2:
        f2 = net.conv2(torch.cat([up2(low), feats[cfg.layer_nums[-2]]], dim=1), train)
        clusters.append(clusterer(net.cluster2, f2))
    if cfg.granularity >= 3:
        f3 = net.conv3(torch.cat([up2(f2), feats[cfg.layer_nums[-3]]], dim=1), train)
        clusters.append(clusterer(net.cluster3, f3))
    if cfg.granularity >= 4:
        img_ds = _resize(img, cfg.out_size)
        f4 = net.conv4(torch.cat([up2(f3), img_ds], dim=1), train)
        clusters.append(clusterer(net.cluster4, f4))

    avg_code = torch.stack(clusters, dim=4).mean(dim=4)
    code = avg_code if cfg.continuous else torch.log_softmax(avg_code, dim=1)
    return {"feats": low, "code": code, "attn": None}
