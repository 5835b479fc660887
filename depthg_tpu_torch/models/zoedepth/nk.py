"""ZoeDepth-NK (``depthg_tpu/models/zoedepth/nk.py``) as an ``nn.Module``.

Two metric heads (NYU, KITTI) behind a domain router: BEiT-L + DPT as in
``ZoeDepth``, the bottleneck conv ``conv2``, a patch transformer over the
bottleneck (1x1 patch conv, sinusoidal 1-D encoding, post-norm encoder
layers with ReLU feed-forward, no dropout) whose token 0 feeds a two-layer
classifier, a shared seed projector and projectors, and per domain a
softplus seed-bin regressor, four attractors and a conditional
log-binomial. Against the single-head model: projector and seed-regressor
width ``bin_embedding_dim / 2``, attractor width ``bin_embedding_dim``,
log-binomial bottleneck (32 + emb) / 4, and the log-binomial reads the
decoder's 32 channels without the relative-depth channel.

The batch votes for one domain: softmax of the summed logits, argmax. The
JAX package switches on it inside the program (``lax.switch``); here the
index is read on the host once per forward and only that domain's head
runs (the reference reads it with ``.item()`` too). The result is the same.
As in the JAX package, the patch sequence carries no zero class token
(the reference's ``use_class_token=True`` pads one in front).

Module names follow the released ``ZoeD_M12_NK.pt``: ``core.core.*`` as in
``ZoeDepth``, ``conv2``, ``patch_transformer.{embedding_convPxP,
transformer_encoder.layers.i.{self_attn.in_proj_weight, self_attn.in_proj_bias,
self_attn.out_proj, linear1, linear2, norm1, norm2}}``,
``mlp_classifier.{0,2}``, ``seed_bin_regressors.<domain>``,
``seed_projector``, ``projectors.i``, ``attractors.<domain>.i`` and
``conditional_log_binomial.<domain>``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from depthg_tpu_torch.models.layers import LayerNorm, MultiheadAttention
from depthg_tpu_torch.models.zoedepth import heads
from depthg_tpu_torch.models.zoedepth.beit import BEiT, BEiTConfig
from depthg_tpu_torch.models.zoedepth.dpt import DPT, DPTConfig
from depthg_tpu_torch.models.zoedepth.layers import conv2d, init_uniform_
from depthg_tpu_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class BinConf:
    name: str
    n_bins: int
    min_depth: float
    max_depth: float


@dataclasses.dataclass(frozen=True)
class ZoeNKConfig:
    bin_confs: tuple = (BinConf("nyu", 64, 1e-3, 10.0),
                        BinConf("kitti", 64, 1e-3, 80.0))
    bin_embedding_dim: int = 128
    bin_centers_type: str = "softplus"
    n_attractors: tuple = (16, 8, 4, 1)
    attractor_alpha: float = 1000.0
    attractor_gamma: float = 2.0
    attractor_kind: str = "mean"
    attractor_type: str = "inv"
    min_temp: float = 0.0212
    max_temp: float = 50.0
    router_dim: int = 128
    router_heads: int = 4
    router_layers: int = 4
    beit: BEiTConfig = BEiTConfig()
    dpt: DPTConfig = DPTConfig()


class EncoderLayer(nn.Module):
    """torch ``TransformerEncoderLayer``: post-norm, ReLU feed-forward."""

    def __init__(self, d: int, num_heads: int, ff: int = 1024):
        super().__init__()
        self.self_attn = MultiheadAttention(d, num_heads)
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.norm2 = LayerNorm(d, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


def positional_encoding_1d(s: int, d: int, device=None) -> torch.Tensor:
    """[S, D] sinusoidal encoding: sin of every position x frequency, then cos."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None]
    pe = pos * torch.exp(idx * (-math.log(10000.0) / d))
    return torch.cat([torch.sin(pe), torch.cos(pe)], dim=1)


class PatchTransformer(nn.Module):
    def __init__(self, in_ch: int, cfg: ZoeNKConfig):
        super().__init__()
        self.embedding_convPxP = conv2d(in_ch, cfg.router_dim, 1)
        self.transformer_encoder = nn.Module()
        self.transformer_encoder.layers = nn.ModuleList(
            EncoderLayer(cfg.router_dim, cfg.router_heads) for _ in range(cfg.router_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tok = self.embedding_convPxP(x).flatten(2).transpose(1, 2)  # [B, S, E]
        tok = tok + positional_encoding_1d(tok.shape[1], tok.shape[2], tok.device).to(tok.dtype)
        for layer in self.transformer_encoder.layers:
            tok = layer(tok)
        return tok


def domain_index(domain_logits: torch.Tensor) -> int:
    """The batch's domain: argmax of the softmax of the logits summed over
    the batch (one host read)."""
    return int(torch.argmax(torch.softmax(domain_logits.sum(dim=0), dim=-1)))


class ZoeDepthNK(nn.Module):
    def __init__(self, cfg: ZoeNKConfig):
        super().__init__()
        self.cfg = cfg
        f, emb = cfg.dpt.features, cfg.bin_embedding_dim
        self.core = nn.Module()
        self.core.core = DPT(BEiT(cfg.beit), cfg.dpt)
        self.conv2 = conv2d(f, f, 1)
        self.patch_transformer = PatchTransformer(f, cfg)
        self.mlp_classifier = nn.Sequential(nn.Linear(cfg.router_dim, cfg.router_dim), nn.ReLU(),
                                            nn.Linear(cfg.router_dim, 2))
        self.seed_bin_regressors = nn.ModuleDict(
            {c.name: heads.SeedBinRegressor(f, c.n_bins, mid=emb // 2) for c in cfg.bin_confs})
        self.seed_projector = heads.Projector(f, emb, mid=emb // 2)
        self.projectors = nn.ModuleList(heads.Projector(f, emb, mid=emb // 2)
                                        for _ in cfg.n_attractors)
        self.attractors = nn.ModuleDict(
            {c.name: nn.ModuleList(heads.Attractor(emb, n, mid=emb) for n in cfg.n_attractors)
             for c in cfg.bin_confs})
        last_in = 32
        self.conditional_log_binomial = nn.ModuleDict(
            {c.name: heads.ConditionalLogBinomial(last_in, emb, c.n_bins, (last_in + emb) // 4,
                                                  cfg.min_temp, cfg.max_temp)
             for c in cfg.bin_confs})

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ZoeDepthNK":
        """``zoedepth_nk_init``'s distributions: BEiT and the decoder as in
        ``ZoeDepth``; convolutions, linears and the router's in-projection
        uniform(+-1/sqrt(fan_in)); the router's layer norms stay at their
        construction's (unit scale, zero shift)."""
        dpt = self.core.core
        dpt.pretrained.model.init_weights(generator)
        dpt.init_decoder(generator)
        heads_and_router = [m for name, m in self.named_children() if name != "core"]
        for child in heads_and_router:
            init_uniform_(child, generator)
            for m in child.modules():
                if isinstance(m, (nn.Linear, MultiheadAttention)):
                    w, b = ((m.in_proj_weight, m.in_proj_bias) if isinstance(m, MultiheadAttention)
                            else (m.weight, m.bias))
                    bound = 1.0 / math.sqrt(w.shape[1])
                    w.uniform_(-bound, bound, generator=generator)
                    b.uniform_(-bound, bound, generator=generator)
        return self

    def forward(self, x: torch.Tensor, attn_impl: str | None = None) -> dict:
        """x: prep-normalized [B, 3, H, W], H and W multiples of 32 ->
        dict(rel_depth, metric_depth [B, 1, H, W], domain_logits [B, 2]).
        ``attn_impl`` (auto | xla | fused) defaults to ``cfg.beit.attn_impl``."""
        cfg = self.cfg
        dpt = self.core.core
        taps, grid = dpt.pretrained.model(x, attn_impl)
        rel_depth, hooks = dpt.decode(taps, grid)

        btlnck = self.conv2(hooks["l4_rn"])
        domain_logits = self.mlp_classifier(self.patch_transformer(btlnck)[:, 0])
        name = cfg.bin_confs[domain_index(domain_logits)].name

        _, b_prev = self.seed_bin_regressors[name](btlnck)
        b_centers, prev_emb = b_prev, self.seed_projector(btlnck)
        for proj, attr, blk in zip(self.projectors, self.attractors[name],
                                   (hooks["r4"], hooks["r3"], hooks["r2"], hooks["r1"])):
            emb = proj(blk)
            b_prev, b_centers = attr(emb, b_prev, prev_emb, kind=cfg.attractor_kind,
                                     attractor_type=cfg.attractor_type, normed=False)
            prev_emb = emb
        last = hooks["out_conv"]
        centers_up = resize_bilinear(b_centers, last.shape[-2:], align_corners=True)
        emb_up = resize_bilinear(prev_emb, last.shape[-2:], align_corners=True)
        probs = self.conditional_log_binomial[name](last, emb_up)
        depth = torch.sum(probs * centers_up, dim=1, keepdim=True)
        return {"rel_depth": rel_depth, "metric_depth": depth, "domain_logits": domain_logits}
