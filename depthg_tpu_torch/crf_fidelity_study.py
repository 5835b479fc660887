"""The CRF fidelity study of ``scripts/crf_fidelity_study.py`` on the port.

Usage::

    python -m depthg_tpu_torch.crf_fidelity_study [--size 320] [--images 6]
        [--only SUBSTR,...] [--reps 3] [--device cuda] [--out FILE]

Refines the script's synthetic scenes (``make_scene``: Voronoi color
regions, a unary corrupted at feature resolution) with the port's dense CRF
at each configuration of the script's study (``ROWS``, the same
``CRFConfig`` arguments), all scenes in one batch as the eval step runs
them, and prints one markdown row per configuration: mIoU and accuracy
against the ground truth (the script's ``miou_acc``), ms per image, and the
``docs/CRF_FIDELITY.md`` row of the JAX package beside them (the rows there
were made at 320 px over 6 images, so compare at those settings).

Timing: after one untimed run whose labels give the quality, ``--reps``
runs of the whole batch, each ended by a device synchronization; the median
over the batch size. The port runs eagerly, so the first run costs no
compilation. The permutohedral-lattice row of the script (a CPU C++
reference) is not repeated here.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import time

import numpy as np
import torch

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


def load_scenes_module():
    """``scripts/crf_fidelity_study.py`` (numpy only at import: its JAX
    imports sit inside ``run_study``), for ``make_scene`` and ``miou_acc``."""
    spec = importlib.util.spec_from_file_location(
        "crf_fidelity_scenes", os.path.join(ROOT, "scripts", "crf_fidelity_study.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _key(name: str) -> str:
    """A row's name without its trailing "(...)" note."""
    return re.sub(r"\s*\([^)]*\)\s*$", "", name).strip()


def jax_rows(path: str = TABLE) -> dict:
    """{row name without its note: (mIoU, accuracy)} of the JAX table."""
    rows = {}
    with open(path) as f:
        for line in f:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if len(cells) == 5 and re.fullmatch(r"\d+\.\d+", cells[2]):
                rows[_key(cells[0])] = (float(cells[2]), float(cells[3]))
    return rows


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rows(names=None, size: int = 320, n_images: int = 6, n_classes: int = 27,
             seed: int = 0, reps: int = 3, device: torch.device | None = None) -> list:
    """Run the rows whose name contains one of ``names`` (all when None);
    returns one dict per row (the unary argmax first)."""
    device = device or get_device("cuda")
    scenes_mod = load_scenes_module()
    scenes = [scenes_mod.make_scene(size, n_classes, seed=seed + i)
              for i in range(n_images)]
    imgs = torch.from_numpy(np.stack([s[0] for s in scenes])).to(device)
    lgs = torch.from_numpy(np.stack([s[2] for s in scenes])).to(device)
    ref = jax_rows()

    def quality(preds):
        return np.mean([scenes_mod.miou_acc(p, s[1], n_classes)
                        for p, s in zip(preds, scenes)], axis=0)

    unary = resize_bilinear(lgs, (size, size)).argmax(1).cpu().numpy()
    m, a = quality(unary)
    rows = [{"name": "no CRF (unary argmax)", "miou": float(m), "accuracy": float(a),
             "ms_per_image": 0.0, "jax": ref.get(_key("no CRF (unary argmax)"))}]
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
        rows.append({"name": name, "miou": float(m), "accuracy": float(a),
                     "ms_per_image": float(np.median(times)) * 1e3 / n_images
                     if times else float("nan"),
                     "jax": ref.get(_key(name))})
    return rows


def format_rows(rows, device_name: str) -> str:
    lines = [f"Port on {device_name}:", "",
             "| config | mIoU | accuracy | ms/img | JAX mIoU | JAX accuracy |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        jm, ja = r["jax"] or (float("nan"), float("nan"))
        lines.append(f"| {r['name']} | {r['miou']:.2f} | {r['accuracy']:.2f} | "
                     f"{r['ms_per_image']:.2f} | {jm:.2f} | {ja:.2f} |")
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
