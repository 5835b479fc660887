"""Plain PyTorch DepthG train step (the reference `train_segmentation.py`
`training_step` with the COCO-Stuff recipe): the frozen ViT on the image
and on its KNN positive, the projection head under Dropout2d, depth-guided
farthest-point sampling of an S x S grid, STEGO's contrastive correlation
losses (positive intra, positive inter, negatives over random batch
permutations) plus the depth-feature correlation term, the linear and
cluster probes on the detached code, one backward over the total, and
Adam on the three parameter groups (head at `lr`, probes at `probe_lr`).

Random draws follow the program's stated order from one generator seeded
per step: the three channel masks of the image's forward (cluster1's,
cluster2's, the returned features'), the three of the positive's, then
the `neg_samples` permutations. FPS draws nothing. Imports nothing but
torch and this folder.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.vit import head_code, vit_features

TRAINABLE = ("net.cluster1.0.weight", "net.cluster1.0.bias", "net.cluster2.0.weight",
             "net.cluster2.0.bias", "net.cluster2.2.weight", "net.cluster2.2.bias",
             "linear_probe.weight", "linear_probe.bias", "cluster_probe.clusters")


def lr_of(name: str, tc: dict) -> float:
    return tc["lr"] if name.startswith("net.") else tc["probe_lr"]


def _norm(t):
    return F.normalize(t.float(), dim=1, eps=1e-10)


def _corr(a, b):
    """einsum('nchw,ncij->nhwij') in float32."""
    return torch.einsum("nchw,ncij->nhwij", a.float(), b.float())


def _sample(t, coords):
    """The reference `sample`: grid_sample over the transposed grid."""
    return F.grid_sample(t, coords.permute(0, 2, 1, 3).to(t.dtype), mode="bilinear",
                         padding_mode="border", align_corners=True)


def _corr_helper(f1, f2, c1, c2, shift):
    with torch.no_grad():
        fd = _corr(_norm(f1), _norm(f2))
        old_mean = fd.mean()
        fd = fd - fd.mean(dim=(3, 4), keepdim=True)
        fd = fd - fd.mean() + old_mean
    cd = _corr(_norm(c1), _norm(c2))
    return -cd.clamp_min(0.0) * (fd - shift)


def fps_coords(depth: torch.Tensor, h: int, w: int, s: int) -> torch.Tensor:
    """Depth-guided farthest-point sampling: [B, 1, H, W] depth -> [B, s, s, 2]
    (row, col) in [-1, 1). The depth is average-pooled to the (h, w) grid
    and back-projected (the reference's factor 2 tan(90 / 2), the angle read
    as radians); the scan starts at index 0 and takes the first farthest
    point on ties; the chosen indices are sorted row-major."""
    d = F.adaptive_avg_pool2d(depth.float(), (h, w))[:, 0]
    factor = 2.0 * math.tan(90.0 / 2.0)
    yy = torch.arange(h, dtype=d.dtype, device=d.device)[:, None]
    xx = torch.arange(w, dtype=d.dtype, device=d.device)[None, :]
    scaled = factor * d
    y = scaled * (yy - h / 2.0) / torch.full_like(yy, h)
    x = scaled * (xx - w / 2.0) / torch.full_like(xx, w)
    pts = torch.stack([x, y, -d * 5.0], dim=1).flatten(2)  # [B, 3, P]
    b, _, p = pts.shape
    table = None
    for k in range(3):
        diff = pts[:, k, :, None] - pts[:, k, None, :]
        table = diff * diff if table is None else table + diff * diff
    rows = torch.arange(b, device=d.device)
    dist = torch.full((b, p), float("inf"), device=d.device)
    dist[:, 0] = float("-inf")
    picks = [torch.zeros(b, dtype=torch.long, device=d.device)]
    for _ in range(1, s * s):
        dist = torch.minimum(dist, table[rows, picks[-1]])
        nxt = dist.argmax(dim=1)
        picks.append(nxt)
        dist[rows, nxt] = float("-inf")
    inds = torch.stack(picks, dim=1).sort(dim=1).values
    r = torch.div(inds, w, rounding_mode="floor").float()
    c = (inds % w).float()
    size = torch.tensor([h, w], dtype=torch.float32, device=d.device)
    return (torch.stack([r, c], dim=-1) / size).reshape(b, s, s, 2) * 2 - 1


def _super_perm(n, gen):
    perm = torch.randperm(n, generator=gen, device=gen.device)
    fixed = perm == torch.arange(n, device=perm.device)
    return torch.where(fixed, perm + 1, perm) % n


def _dropout2d(x, rate, gen):
    """Zero whole channels of [B, C, H, W], scale the rest by 1 / (1 - rate)."""
    keep = torch.bernoulli(torch.full(x.shape[:2], 1.0 - rate, device=x.device), generator=gen)
    return x * keep[:, :, None, None] / (1.0 - rate)


def loss(params: dict, frozen: dict, cfg: dict, batch: dict, gen: torch.Generator,
         dtype=torch.bfloat16, quantize=None) -> torch.Tensor:
    """The total loss of one step (a graph over ``params``)."""
    tc, bb, head = cfg["train"], cfg["backbone"], cfg["head"]
    sd = {**frozen, **params}
    rate = head["drop_rate"]
    n_cls = cfg["n_classes"]

    def featurize(img):
        with torch.no_grad():
            f = vit_features(sd, bb, img, dtype, quantize)
        f1 = _dropout2d(f, rate, gen)
        code = head_code(sd, f1, _dropout2d(f, rate, gen))
        return _dropout2d(f, rate, gen), code

    feats, code = featurize(batch["img"])
    feats_pos, code_pos = featurize(batch["img_pos"])
    b, _, h, w = feats.shape
    s = tc["feature_samples"]
    coords = fps_coords(torch.cat([batch["depth"], batch["depth_pos"]]), h, w, s)
    c1, c2 = coords[:b], coords[b:]
    fs, cs_ = _sample(feats, c1), _sample(code, c1)
    fps_, cps = _sample(feats_pos, c2), _sample(code_pos, c2)
    pos_intra = _corr_helper(fs, fs, cs_, cs_, tc["pos_intra_shift"]).mean()
    pos_inter = _corr_helper(fs, fps_, cs_, cps, tc["pos_inter_shift"]).mean()
    cd = _corr(_norm(cs_), _norm(cs_))
    with torch.no_grad():
        d = F.interpolate(batch["depth"].float(), size=(s, s), mode="bilinear", align_corners=True)
        dd = _corr(_norm(d), _norm(d))
    depth_feat = (-cd.clamp_min(0.0) * (dd - tc["depth_feat_shift"])).mean()
    perms = [_super_perm(b, gen) for _ in range(tc["neg_samples"])]
    neg = torch.stack([_corr_helper(fs, _sample(feats[p], c2), cs_, _sample(code[p], c2),
                                    tc["neg_inter_shift"]) for p in perms]).mean()
    total = (tc["pos_inter_weight"] * pos_inter + tc["pos_intra_weight"] * pos_intra
             + tc["neg_inter_weight"] * neg + tc["depth_feat_weight"] * depth_feat) \
        * tc["correspondence_weight"]

    dcode = code.detach()
    logits = F.conv2d(dcode, sd["linear_probe.weight"], sd["linear_probe.bias"])
    logits = F.interpolate(logits.float(), size=batch["label"].shape[-2:], mode="bilinear",
                           align_corners=False)
    label = batch["label"]
    valid = (label >= 0) & (label < n_cls)
    picked = logits.gather(1, label.clamp(0, n_cls - 1)[:, None])[:, 0]
    nll = torch.logsumexp(logits, dim=1) - picked
    linear = torch.where(valid, nll, torch.zeros_like(nll)).sum() / valid.sum().clamp_min(1)
    ip = torch.einsum("bchw,nc->bnhw", _norm(dcode), _norm(sd["cluster_probe.clusters"]))
    onehot = F.one_hot(ip.argmax(dim=1), ip.shape[1]).permute(0, 3, 1, 2).float()
    cluster = -(onehot * ip).sum(1).mean()
    return total + linear + cluster


class Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 added to the
    bias-corrected sqrt(v)), in float32."""

    def __init__(self, params: dict, lrs: dict):
        self.lrs = lrs
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = self.v[k].sqrt() / math.sqrt(c2) + 1e-8
            p.addcdiv_(self.m[k], denom, value=-self.lrs[k] / c1)


def run_steps(sd: dict, cfg: dict, batches: list, step_seeds: list, dev,
              dtype=torch.bfloat16, quantize=None) -> dict:
    """len(batches) reference steps from the weights ``sd``: each step's loss,
    the first step's gradients, and the trainable parameters' change."""
    params = {k: sd[k].clone().requires_grad_(True) for k in TRAINABLE}
    start = {k: v.detach().clone() for k, v in params.items()}
    frozen = {k: v for k, v in sd.items() if k not in params}
    opt = Adam(params, {k: lr_of(k, cfg["train"]) for k in TRAINABLE})
    losses, first_grads = [], None
    for batch, seed in zip(batches, step_seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        total = loss(params, frozen, cfg, batch, gen, dtype, quantize)
        grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
        losses.append(float(total.detach()))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
    return {"losses": losses, "grads": first_grads,
            "delta": {k: (params[k].detach() - start[k]) for k in params}}
