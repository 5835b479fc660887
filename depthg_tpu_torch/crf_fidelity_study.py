"""The CRF fidelity study of ``scripts/crf_fidelity_study.py`` on the port.

Usage::

    python -m depthg_tpu_torch.crf_fidelity_study [--size 320] [--images 6]
        [--only SUBSTR,...] [--reps 3] [--device cuda] [--out FILE]

Refines the script's synthetic scenes (``make_scene``: Voronoi color
regions, a unary corrupted at feature resolution; the port's own copy, as
is ``miou_acc``) with the port's dense CRF at each configuration of the
script's study (``ROWS``, the same ``CRFConfig`` arguments), all scenes in
one batch as the eval step runs them, and prints one markdown row per
configuration: label agreement with the permutohedral lattice, mIoU and
accuracy against the ground truth, ms per image, and the
``docs/CRF_FIDELITY.md`` row of the JAX package beside them (the rows there
were made at 320 px over 6 images, so compare at those settings).

The lattice is ``native_crf`` (the repository's C++ permutohedral CRF, the
reference's pydensecrf algorithm) on the CPU, one thread per scene, on the
softmax of the bilinearly upsampled unary; a row's agreement is the mean
over scenes of the share of pixels whose argmax label equals the
lattice's, as ``scripts/crf_fidelity_study.py`` defines it. The lattice
runs in every study: if it cannot, the study fails.

Timing: after one untimed run whose labels give the quality, ``--reps``
runs of the whole batch, each ended by a device synchronization; the median
over the batch size. The port runs eagerly, so the first run costs no
compilation.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from depthg_tpu_torch import native_crf
from depthg_tpu_torch.ops.crf import CRFConfig, dense_crf_batch
from depthg_tpu_torch.ops.resize import resize_bilinear
from depthg_tpu_torch.runtime import get_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE = os.path.join(ROOT, "docs", "CRF_FIDELITY.md")

_P8 = dict(downsample=8, splat_phases=4, splat_sigma_factor=1.8, dtype="bfloat16")
_PM = dict(_P8, splat_impl="pool_matmul", kernel_int8=True)
# (name, CRFConfig) of scripts/crf_fidelity_study.py:121-217, in its order
ROWS = [
    ("exact (ds=1)", CRFConfig(downsample=1)),
    ("ds=2 mixed", CRFConfig(downsample=2)),
    ("ds=2 mixed bf16", CRFConfig(downsample=2, dtype="bfloat16")),
    ("ds=2 legacy", CRFConfig(downsample=2, mixed_resolution=False)),
    ("ds=2 jbu1 bf16", CRFConfig(downsample=2, splat_phases=1, dtype="bfloat16")),
    ("ds=4 mixed", CRFConfig(downsample=4)),
    ("ds=4 mixed bf16", CRFConfig(downsample=4, dtype="bfloat16")),
    ("ds=4 legacy bf16", CRFConfig(downsample=4, mixed_resolution=False,
                                   dtype="bfloat16")),
    ("ds=4 jbu2 bf16", CRFConfig(downsample=4, splat_phases=2, dtype="bfloat16")),
    ("ds=4 jbu2 sf1.41 bf16 (quality+)",
     CRFConfig(downsample=4, splat_phases=2, splat_sigma_factor=1.41,
               dtype="bfloat16")),
    ("ds=4 jbu4 bf16", CRFConfig(downsample=4, splat_phases=4, dtype="bfloat16")),
    ("ds=8 jbu4 sf1.8 bf16 (no prefix)", CRFConfig(**_P8)),
    ("ds=8 jbu4 sf1.8 bf16 int8-kernel", CRFConfig(**_P8, kernel_int8=True)),
    ("ds=8 jbu4 sf1.8 cp3 bf16 int8-kernel",
     CRFConfig(**_P8, kernel_int8=True, coarse_prefix=3)),
    ("ds=8 jbu2 sf1.8 bf16", CRFConfig(**dict(_P8, splat_phases=2))),
    ("ds=8 jbu2 sf2.2 bf16",
     CRFConfig(**dict(_P8, splat_phases=2, splat_sigma_factor=2.2))),
    ("ds=8 jbu1 sf2.2 bf16",
     CRFConfig(**dict(_P8, splat_phases=1, splat_sigma_factor=2.2))),
    ("ds=8 jbu4 sf1.8 cp3 bf16 (broadcast legacy)", CRFConfig(**_P8, coarse_prefix=3)),
    ("ds=8 jbu4 sf1.8 cp4 bf16", CRFConfig(**_P8, coarse_prefix=4)),
    ("ds=8 jbu4 sf1.8 cp5 bf16", CRFConfig(**_P8, coarse_prefix=5)),
    ("ds=8 jbu4 sf1.8 cp8 bf16", CRFConfig(**_P8, coarse_prefix=8)),
    ("ds=8 jbu4 sf1.8 cp3 bf16 pm-int8 (quality cp3 point)",
     CRFConfig(**_PM, coarse_prefix=3)),
    ("ds=8 jbu4 sf1.8 cp5 bf16 pm-int8 (cp-only r5 point)",
     CRFConfig(**_PM, coarse_prefix=5)),
    ("ds=8 jbu4 sf1.8 cp5 m3 bf16 pm-int8", CRFConfig(**_PM, coarse_prefix=5,
                                                      mid_prefix=3)),
    ("ds=8 jbu4 sf1.8 cp5 m4 bf16 pm-int8 (eval default + bench)",
     CRFConfig(**_PM, coarse_prefix=5, mid_prefix=4)),
    ("ds=8 jbu4 sf1.8 cp3 m5 bf16 pm-int8", CRFConfig(**_PM, coarse_prefix=3,
                                                      mid_prefix=5)),
    ("ds=8 jbu4 sf1.8 cp3 m4 bf16 pm-int8 (quality-leaning)",
     CRFConfig(**_PM, coarse_prefix=3, mid_prefix=4)),
]


def make_scene(size=320, n_classes=27, n_regions=40, seed=0, feat_stride=8):
    """One synthetic eval scene.

    Returns (image [3,H,W] float32 0..255, gt [H,W] int32,
    logits [C, H/feat_stride, W/feat_stride] float32).

    Voronoi regions with distinct colors model object segments; the unary is
    the ground truth corrupted by spatially-correlated error blobs plus
    logit noise, emitted at feature resolution like the probes produce.
    """
    rng = np.random.default_rng(seed)
    h = w = size

    # Voronoi partition; several regions share a class (like stuff classes)
    pts = rng.uniform(0, size, (n_regions, 2)).astype(np.float32)
    region_cls = rng.integers(0, n_classes, n_regions)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d2 = ((yy[None] - pts[:, 0, None, None]) ** 2
          + (xx[None] - pts[:, 1, None, None]) ** 2)
    region = d2.argmin(0)
    gt = region_cls[region].astype(np.int32)

    # colors: distinct per class + spatially-smooth variation. Real images
    # are locally smooth; iid per-pixel noise would be adversarial to the
    # *exact* kernel specifically (bilateral srgb=3 ≈ the noise scale makes
    # same-region pixels near-orthogonal) while the lattice's barycentric
    # splatting pre-smooths features — smooth noise models photographs.
    colors = rng.uniform(20, 235, (n_classes, 3)).astype(np.float32)
    image = colors[gt].transpose(2, 0, 1)
    lo = rng.normal(0, 10.0, (3, max(2, h // 16), max(2, w // 16))).astype(np.float32)
    reps = (h + lo.shape[1] - 1) // lo.shape[1], (w + lo.shape[2] - 1) // lo.shape[2]
    smooth = np.kron(lo, np.ones((1, reps[0], reps[1]), np.float32))[:, :h, :w]
    image += smooth + rng.normal(0, 1.5, image.shape).astype(np.float32)
    image = np.clip(image, 0, 255)

    # unary at feature resolution: correct logits + correlated error blobs
    hf, wf = h // feat_stride, w // feat_stride
    gt_f = gt[feat_stride // 2::feat_stride, feat_stride // 2::feat_stride]
    logits = np.full((n_classes, hf, wf), -1.0, np.float32)
    np.put_along_axis(logits, gt_f[None], 1.6, axis=0)
    # error blobs: wrong argmax in ~15% of the area, spatially contiguous
    n_blobs = max(1, hf * wf // 120)
    for _ in range(n_blobs):
        cy, cx = rng.integers(0, hf), rng.integers(0, wf)
        r = rng.integers(2, max(3, hf // 8))
        wrong = rng.integers(0, n_classes)
        mask = ((np.arange(hf)[:, None] - cy) ** 2
                + (np.arange(wf)[None, :] - cx) ** 2) < r * r
        logits[:, mask] = -1.0
        logits[wrong, mask] = 1.6
    logits += rng.normal(0, 0.5, logits.shape).astype(np.float32)
    return image, gt, logits


def miou_acc(pred, gt, n_classes):
    """Hungarian-free mIoU/accuracy: classes are already aligned here."""
    ious = []
    for c in range(n_classes):
        inter = ((pred == c) & (gt == c)).sum()
        union = ((pred == c) | (gt == c)).sum()
        if union:
            ious.append(inter / union)
    return float(np.mean(ious)) * 100, float((pred == gt).mean()) * 100


def lattice_labels(scenes, size: int) -> list:
    """Argmax labels [H, W] of the permutohedral lattice on each scene (the
    softmax of the bilinearly upsampled unary), on the CPU, one thread per
    scene (the C call releases the interpreter lock)."""
    probs = [torch.softmax(resize_bilinear(torch.from_numpy(s[2]), (size, size)), dim=0).numpy()
             for s in scenes]
    with ThreadPoolExecutor(max(1, min(len(scenes), os.cpu_count() or 1))) as pool:
        return list(pool.map(lambda a: native_crf.dense_crf_native(a[0][0], a[1]).argmax(0),
                             zip(scenes, probs)))


def agreement(preds, lattice) -> float:
    """Mean over scenes of the share of labels equal to the lattice's."""
    return float(np.mean([(p == lp).mean() for p, lp in zip(preds, lattice)]))


def _key(name: str) -> str:
    """A row's name without its trailing "(...)" note."""
    return re.sub(r"\s*\([^)]*\)\s*$", "", name).strip()


def jax_rows(path: str = TABLE) -> dict:
    """{row name without its note: (mIoU, accuracy, label agreement with the
    lattice in % or None)} of the JAX table."""
    rows = {}
    with open(path) as f:
        for line in f:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if len(cells) == 5 and re.fullmatch(r"\d+\.\d+", cells[2]):
                agree = re.fullmatch(r"(\d+\.\d+)%", cells[1])
                rows[_key(cells[0])] = (float(cells[2]), float(cells[3]),
                                        float(agree.group(1)) if agree else None)
    return rows


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rows(names=None, size: int = 320, n_images: int = 6, n_classes: int = 27,
             seed: int = 0, reps: int = 3, device: torch.device | None = None) -> list:
    """Run the rows whose name contains one of ``names`` (all when None);
    returns one dict per row (the unary argmax, then the lattice, first)."""
    device = device or get_device("cuda")
    scenes = [make_scene(size, n_classes, seed=seed + i) for i in range(n_images)]
    imgs = torch.from_numpy(np.stack([s[0] for s in scenes])).to(device)
    lgs = torch.from_numpy(np.stack([s[2] for s in scenes])).to(device)
    ref = jax_rows()

    def quality(preds):
        return np.mean([miou_acc(p, s[1], n_classes)
                        for p, s in zip(preds, scenes)], axis=0)

    t0 = time.perf_counter()
    lattice = lattice_labels(scenes, size)
    lattice_s = time.perf_counter() - t0
    rows = []
    for name, preds, ms in (
            ("no CRF (unary argmax)",
             resize_bilinear(lgs, (size, size)).argmax(1).cpu().numpy(), 0.0),
            ("permutohedral lattice (reference algo, CPU)", lattice,
             lattice_s * 1e3 / n_images)):
        m, a = quality(preds)
        rows.append({"name": name, "agreement": agreement(preds, lattice), "miou": float(m),
                     "accuracy": float(a), "ms_per_image": ms, "jax": ref.get(_key(name))})
    for name, ccfg in ROWS:
        if names and not any(s in name for s in names):
            continue
        preds = dense_crf_batch(imgs, lgs, ccfg).argmax(1).cpu().numpy()
        times = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            dense_crf_batch(imgs, lgs, ccfg).argmax(1)
            _sync(device)
            times.append(time.perf_counter() - t0)
        m, a = quality(preds)
        rows.append({"name": name, "agreement": agreement(preds, lattice),
                     "miou": float(m), "accuracy": float(a),
                     "ms_per_image": float(np.median(times)) * 1e3 / n_images
                     if times else float("nan"),
                     "jax": ref.get(_key(name))})
    return rows


def format_rows(rows, device_name: str) -> str:
    lines = [f"Port on {device_name} (lattice on the CPU):", "",
             "| config | label agreement vs lattice | mIoU | accuracy | ms/img | "
             "JAX agreement | JAX mIoU | JAX accuracy |",
             "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        jm, ja, jg = r["jax"] or (float("nan"), float("nan"), None)
        jg = "—" if jg is None else f"{jg:.2f}%"
        lines.append(f"| {r['name']} | {r['agreement'] * 100:.2f}% | {r['miou']:.2f} | "
                     f"{r['accuracy']:.2f} | {r['ms_per_image']:.2f} | {jg} | {jm:.2f} | "
                     f"{ja:.2f} |")
    return "\n".join(lines)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--images", type=int, default=6)
    ap.add_argument("--classes", type=int, default=27)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default=None,
                    help="comma-separated substrings of the rows to run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the rows as JSON here")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    rows = run_rows(args.only.split(",") if args.only else None, args.size,
                    args.images, args.classes, args.seed, args.reps, device)
    name = "cpu" if device.type == "cpu" else torch.cuda.get_device_name(device)
    print(format_rows(rows, name))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": name, "size": args.size, "images": args.images,
                       "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
