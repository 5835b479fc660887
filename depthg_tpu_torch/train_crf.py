"""CRF-loss playground: optimize a per-image code table directly against the
contrastive CRF loss (the port of ``scripts/train_crf.py``; reference
``src/train_crf.py``).

    python -m depthg_tpu_torch.train_crf data_dir=... [n_images=7] [epochs=2000]
        [continuous=True] [dim=70] [res=224] [device=cuda|cpu]

A code table [n_images, dim, res/2, res/2] is optimized with Adam (lr 1e-2;
``torch.optim.Adam`` puts eps outside the square root, as optax's ``adam``)
against ``train.losses.contrastive_crf_loss`` on the first ``n_images``
images of the training set at half resolution, plus, for discrete codes, a
global and a local entropy term. Every 500 steps each image and its code
(PCA to RGB for continuous codes, the first three classes otherwise) are
written as PNGs under ``{output_root}/crf_playground``. The table and the
loss run on the card unless ``device=cpu`` is given.
"""

from __future__ import annotations

import os
import sys
from os.path import join

import numpy as np
import torch
from PIL import Image

from depthg_tpu_torch.config import cli_overrides, load_config
from depthg_tpu_torch.data import ContrastiveSegDataset, DataLoader, get_transform
from depthg_tpu_torch.data.transforms import unnormalize
from depthg_tpu_torch.ops.correlation import norm
from depthg_tpu_torch.runtime import get_device
from depthg_tpu_torch.train.losses import contrastive_crf_loss


def pca3(code_hw_c: np.ndarray) -> np.ndarray:
    """[H, W, C] -> [H, W, 3] PCA projection (numpy SVD)."""
    h, w, c = code_hw_c.shape
    x = code_hw_c.reshape(-1, c)
    x = x - x.mean(0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    proj = x @ vt[:3].T
    proj = proj.reshape(h, w, 3)
    return np.clip((proj + 1) / 2, 0, 1)


def entropy(p: torch.Tensor) -> torch.Tensor:
    p = p.clamp_min(1e-7)
    return -(p * p.log()).sum(dim=1)


def objective(code_space: torch.Tensor, img: torch.Tensor, cfg,
              generator: torch.Generator | None = None, coords=None):
    """(loss, crf term) of the code table against the images: the CRF loss
    on the normalized (continuous) or softmaxed (discrete) codes, minus the
    weighted global and local entropies of discrete codes. ``coords=(rows,
    cols)`` fixes the CRF's sample coordinates, else they are drawn from
    ``generator``."""
    continuous = bool(cfg.continuous)
    code = code_space if continuous else torch.log_softmax(code_space, dim=1)
    prepped = norm(code) if continuous else code.exp()
    crf = contrastive_crf_loss(
        img, prepped, int(cfg.crf_samples), float(cfg.alpha), float(cfg.beta),
        float(cfg.gamma), float(cfg.w1), float(cfg.w2), float(cfg.shift),
        generator=generator, coords=coords).mean()
    if continuous:
        return crf, crf
    probs = code.exp()
    ent_global = entropy(probs.mean(dim=0, keepdim=True)).mean()
    ent_local = entropy(probs).mean()
    reg = (-float(cfg.get("global_ent_weight", 0.01)) * ent_global
           - float(cfg.get("local_ent_weight", 0.01)) * ent_local)
    return crf + reg, crf


def save_pngs(out_dir: str, img: np.ndarray, codes: np.ndarray, step: int,
              continuous: bool) -> None:
    for idx in range(len(codes)):
        rgb = np.clip(unnormalize(img[idx]), 0, 1)
        Image.fromarray((rgb.transpose(1, 2, 0) * 255).astype(np.uint8)).save(
            join(out_dir, f"{idx}_img.png"))
        if continuous:
            vis = pca3(codes[idx].transpose(1, 2, 0))
        else:
            seg = codes[idx].argmax(0)
            vis = (seg[..., None] == np.arange(3)).astype(float)
        Image.fromarray((vis * 255).astype(np.uint8)).save(join(out_dir, f"{idx}_code_{step}.png"))


def main(argv=None) -> dict:
    """The CLI; returns the last step's loss and CRF term and the output
    directory."""
    cfg = load_config("local_config.yml",
                      cli_overrides(argv if argv is not None else sys.argv[1:]))
    device = get_device(cfg.get("device", "cuda"))
    continuous = bool(cfg.continuous)
    dim = int(cfg.dim)
    n_images = int(cfg.get("n_images", 7))
    epochs = int(cfg.get("epochs", 2000))
    small = int(cfg.res) // 2

    dataset = ContrastiveSegDataset(
        cfg.data_dir, cfg.dataset_name, None, cfg.get("image_set", "train"),
        get_transform(small, False, None), get_transform(small, True, None), cfg=cfg)
    loader = DataLoader(dataset, n_images, shuffle=False, num_workers=2)
    pack = next(iter(loader))
    img_np = pack["img"].astype(np.float32)
    img = torch.from_numpy(img_np).to(device)

    gen = torch.Generator(device=device).manual_seed(0)
    code_space = (0.1 * torch.randn((len(img_np), dim, small, small), generator=gen,
                                    device=device)).requires_grad_()
    opt = torch.optim.Adam([code_space], lr=1e-2)

    out_dir = join(cfg.output_root, "crf_playground")
    os.makedirs(out_dir, exist_ok=True)
    for i in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss, crf = objective(code_space, img, cfg, generator=gen)
        loss.backward()
        opt.step()
        if i % 100 == 0:
            print(f"step {i}: loss={float(loss.detach()):.4f} crf={float(crf.detach()):.4f}")
        if i % 500 == 0:
            save_pngs(out_dir, img_np, code_space.detach().cpu().numpy(), i, continuous)
    print(f"done; visualizations in {out_dir}")
    return {"loss": float(loss.detach()), "crf": float(crf.detach()), "out_dir": out_dir,
            "steps": epochs}


if __name__ == "__main__":
    main()
