"""Training-quality study across frozen-backbone dtypes (float32, bf16, int8):
the port of ``scripts/backbone_dtype_study.py``.

    python -m depthg_tpu_torch.backbone_dtype_study [--seeds 3] [--steps 300]
        [--arms float32,bfloat16,int8] [--out FILE] [--device cuda|cpu]

It runs the depth-guided training objective (the paper's COCO-Stuff ViT-S
recipe, ``paper_reproduction.sh:4``: FPS sampling, feature_samples 11,
neg_samples 5, the depth-feature correlation) on a synthetic 6-class
color + depth dataset (``make_dataset``, a copy of the JAX script's) for
each seed and each ``--arms`` backbone dtype, with the same data and batch
schedule per seed, and reports:

* the loss curve (mean total loss per ``--chunk``-step window);
* the held-out linear- and cluster-probe mIoU and accuracy after training
  (Hungarian-matched; ``make_validation_step``'s float32 forward);
* per trained model, the probe predictions of each arm's eval forward on
  the same weights: agreement with the float32 forward and each arm's mIoU.

The dataset lives on the device; KNN positives come from the pooled float32
backbone features (``parallel.knn``). Runs on the card unless ``--device
cpu``. Weights are random (DINO's init from the seed): the study compares
dtypes with each other, not with the paper.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def make_dataset(n, size, n_classes, seed, noise=8.0):
    """Learnable scenes: Voronoi regions, class-consistent colors, depth =
    class-correlated smooth field. Returns imgs [N,3,S,S] (ImageNet-normed),
    depth [N,1,S,S] in [0,1], labels [N,S,S]."""
    rng = np.random.default_rng(seed)
    colors = np.linspace(30, 225, n_classes)[:, None].repeat(3, 1)
    colors += rng.uniform(-25, 25, colors.shape)
    depth_level = rng.permutation(np.linspace(0.15, 0.9, n_classes))
    imgs = np.empty((n, 3, size, size), np.float32)
    depths = np.empty((n, 1, size, size), np.float32)
    labels = np.empty((n, size, size), np.int32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for i in range(n):
        pts = rng.uniform(0, size, (8, 2)).astype(np.float32)
        cls = rng.integers(0, n_classes, 8)
        d2 = ((yy[None] - pts[:, 0, None, None]) ** 2
              + (xx[None] - pts[:, 1, None, None]) ** 2)
        region = d2.argmin(0)
        lab = cls[region]
        img = colors[lab].transpose(2, 0, 1).astype(np.float32)
        img += rng.normal(0, noise, img.shape).astype(np.float32)
        img = np.clip(img, 0, 255) / 255.0
        mean = np.array([0.485, 0.456, 0.406], np.float32)[:, None, None]
        std = np.array([0.229, 0.224, 0.225], np.float32)[:, None, None]
        imgs[i] = (img - mean) / std
        d = depth_level[lab] + rng.normal(0, 0.02, lab.shape)
        depths[i] = np.clip(d, 0, 1)[None]
        labels[i] = lab
    return imgs, depths, labels


def run_one(backbone_dtype, seed, steps, batch, res, n_train, n_val,
            n_classes=6, eval_arms=("float32", "bfloat16"), device="cuda", fcfg=None):
    """Train one arm for ``steps`` steps from ``seed``; returns (losses per
    step, metrics after training, train seconds, per-arm eval metrics and
    agreements)."""
    from depthg_tpu_torch.inference import make_validation_step
    from depthg_tpu_torch.models import featurizer as featurizer_lib
    from depthg_tpu_torch.models.probes import cluster_lookup_apply
    from depthg_tpu_torch.ops.resize import resize_bilinear
    from depthg_tpu_torch.parallel.knn import pooled_features, topk_neighbors
    from depthg_tpu_torch.train import losses as loss_lib
    from depthg_tpu_torch.train import step as step_lib
    from depthg_tpu_torch.utils.metrics import SegMetrics, confusion_update

    fcfg = fcfg or featurizer_lib.FeaturizerConfig(arch="vit_small", patch_size=8, dim=70)
    hp = step_lib.TrainHParams(n_classes=n_classes, backbone_dtype=backbone_dtype)
    # the paper's COCO-Stuff ViT-S recipe (paper_reproduction.sh:4)
    lcfg = loss_lib.CorrLossConfig(feature_samples=11, neg_samples=5,
                                   depth_sampling="fps", depth_feat_correlation_loss=True)

    imgs, depths, labels = make_dataset(n_train + n_val, res, n_classes, 100)
    imgs_d, depths_d = torch.from_numpy(imgs).to(device), torch.from_numpy(depths).to(device)
    labels_d = torch.from_numpy(labels).long().to(device)
    train_img, train_depth, train_label = imgs_d[:n_train], depths_d[:n_train], labels_d[:n_train]

    state = step_lib.init_state(fcfg, hp, torch.Generator().manual_seed(seed), device=device)
    with torch.no_grad():  # KNN positives over the pooled float32 backbone features
        pooled = torch.cat([pooled_features(state.model.net, train_img[i:i + 16])
                            for i in range(0, n_train, 16)])
    nns = torch.from_numpy(np.asarray(topk_neighbors(pooled, k=7, device=device))).long()
    nns = nns.to(device)  # [N, 7], rank 0 = self

    gen = torch.Generator(device=device).manual_seed(1000 + seed)

    def pick_batch():
        idx = torch.randperm(n_train, generator=gen, device=device)[:batch]
        ranks = torch.randint(1, nns.shape[1], (batch,), generator=gen, device=device)
        pos = nns[idx, ranks]
        return {"img": train_img[idx], "img_pos": train_img[pos], "label": train_label[idx],
                "depth": train_depth[idx], "depth_pos": train_depth[pos]}

    losses = []
    t0 = time.time()
    for _ in range(steps):
        logs = step_lib.train_step(state, pick_batch(), hp, lcfg, 0.19, 0.03, generator=gen)
        losses.append(logs["loss/total"])
    losses = torch.stack(losses).float().cpu().numpy()
    train_s = time.time() - t0

    val_step = make_validation_step(n_classes, hp.extra_clusters)
    lin_m = SegMetrics("linear/", n_classes, 0, False)
    clu_m = SegMetrics("cluster/", n_classes, 0, True)
    for i in range(n_train, n_train + n_val, 8):
        ls, cs = val_step(state.model, imgs_d[i:i + 8], labels_d[i:i + 8], res)
        lin_m.add_stats(ls)
        clu_m.add_stats(cs)
    metrics = {**lin_m.compute(), **clu_m.compute()}

    # eval-path dtype arms: the SAME trained weights, each arm's forward
    model = state.model

    @torch.inference_mode()
    def val_preds(img, arm):
        out = featurizer_lib.dispatch_apply(
            model.net, img, backbone_dtype=None if arm == "float32" else arm)
        code = resize_bilinear(out["code"].float(), (res, res))
        lin = model.linear_probe(code).argmax(1)
        _, cp = cluster_lookup_apply(model.cluster_probe.clusters, code, None,
                                     log_probs=False)
        return lin, cp.argmax(1)

    eval_dtype, preds_by_arm = {}, {}
    for arm in eval_arms:
        lm = SegMetrics("linear/", n_classes, 0, False)
        cm = SegMetrics("cluster/", n_classes, 0, True)
        preds = []
        for i in range(n_train, n_train + n_val, 8):
            lin, clu = val_preds(imgs_d[i:i + 8], arm)
            lm.add_stats(confusion_update(lin, labels_d[i:i + 8], n_classes, 0))
            cm.add_stats(confusion_update(clu, labels_d[i:i + 8], n_classes,
                                          hp.extra_clusters))
            preds.append((lin.cpu().numpy(), clu.cpu().numpy()))
        eval_dtype[arm] = {**lm.compute(), **cm.compute()}
        preds_by_arm[arm] = preds
    for arm in eval_arms:
        if arm == "float32":
            continue
        for p, name in ((0, "lin"), (1, "clu")):
            eval_dtype[f"{arm}_{name}_agree"] = float(np.mean(
                [(a[p] == b[p]).mean() for a, b in zip(preds_by_arm["float32"],
                                                       preds_by_arm[arm])]))
    return losses, metrics, train_s, eval_dtype


def report(rows, eval_rows, curves, arms, args, device_name) -> str:
    """The markdown report of the JAX script, over this run's rows."""
    lines = [
        f"# Backbone dtype training-quality study ({' vs '.join(arms)} frozen ViT)",
        "",
        f"Generated by `python -m depthg_tpu_torch.backbone_dtype_study` on "
        f"{device_name}: {args.seeds} seeds x {args.steps} steps, batch {args.batch} @ "
        f"{args.res}px, the paper's COCO-Stuff ViT-S recipe (fps sampling, "
        "feature_samples 11, neg_samples 5, depth-feat correlation) on a synthetic "
        "6-class color+depth dataset (class-consistent colors and depth, KNN positives "
        "from pooled backbone features), random weights. Same data and batch schedule "
        "per seed; only the frozen-backbone dtype differs.",
        "",
        "| dtype | seed | linear mIoU | linear Acc | cluster mIoU | cluster Acc | "
        "final loss (last window) |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(f"| {r['dtype']} | {r['seed']} | {r['lin_miou']:.2f} | "
                     f"{r['lin_acc']:.2f} | {r['clu_miou']:.2f} | "
                     f"{r['clu_acc']:.2f} | {r['final_loss']:.4f} |")
    lines.append("")
    for metric, label in (("lin_miou", "linear mIoU"), ("lin_acc", "linear Acc"),
                          ("clu_miou", "cluster mIoU"), ("clu_acc", "cluster Acc")):
        f32 = np.array([r[metric] for r in rows if r["dtype"] == "float32"])
        parts = [f"f32 {f32.mean():.2f}±{f32.std():.2f}"]
        for arm in arms:
            if arm != "float32":
                a = np.array([r[metric] for r in rows if r["dtype"] == arm])
                parts.append(f"{arm} {a.mean():.2f}±{a.std():.2f} "
                             f"(delta {a.mean() - f32.mean():+.2f})")
        lines.append(f"* {label}: " + ", ".join(parts))
    lines += ["", "## Eval-path dtype (same trained weights, per-arm forward)", "",
              "| train dtype | seed | arm | lin agree | clu agree | lin mIoU f32->arm | "
              "clu mIoU f32->arm |", "|---|---|---|---|---|---|---|"]
    for r in eval_rows:
        for arm in arms:
            if arm != "float32":
                lines.append(
                    f"| {r['dtype']} | {r['seed']} | {arm} | {r[f'{arm}_lin_agree']:.4f} | "
                    f"{r[f'{arm}_clu_agree']:.4f} | {r['float32_linear']:.2f} -> "
                    f"{r[f'{arm}_linear']:.2f} | {r['float32_cluster']:.2f} -> "
                    f"{r[f'{arm}_cluster']:.2f} |")
    lines += ["", f"Loss curves (mean total loss per {args.chunk}-step window):", "", "```"]
    for (dtype, seed), c in curves.items():
        lines.append(f"{dtype} seed {seed}: " + " ".join(f"{v:.3f}" for v in c))
    lines += ["```", ""]
    return "\n".join(lines)


def main(argv=None, fcfg=None) -> dict:
    """The CLI; returns the rows, the eval rows and the report. ``fcfg``
    replaces the ViT-S featurizer (tests)."""
    from depthg_tpu_torch.runtime import get_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=30)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--n-train", type=int, default=96)
    ap.add_argument("--n-val", type=int, default=32)
    ap.add_argument("--out", default=None)
    ap.add_argument("--arms", default="float32,bfloat16",
                    help="comma-separated backbone_dtype arms to train AND eval "
                         "(e.g. float32,bfloat16,int8)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    arms = tuple(args.arms.split(","))
    if "float32" not in arms:
        arms = ("float32",) + arms  # the agreement baseline
    device = get_device(args.device)
    device_name = ("the CPU" if device.type == "cpu"
                   else f"`{torch.cuda.get_device_name(device)}`")

    rows, eval_rows, curves = [], [], {}
    for dtype in arms:
        for seed in range(args.seeds):
            losses, metrics, train_s, eval_dtype = run_one(
                dtype, seed, args.steps, args.batch, args.res,
                args.n_train, args.n_val, eval_arms=arms, device=device, fcfg=fcfg)
            rows.append({"dtype": dtype, "seed": seed,
                         "lin_miou": metrics["linear/mIoU"],
                         "lin_acc": metrics["linear/Accuracy"],
                         "clu_miou": metrics["cluster/mIoU"],
                         "clu_acc": metrics["cluster/Accuracy"],
                         "final_loss": float(losses[-args.chunk:].mean()),
                         "train_s": train_s})
            eval_rows.append({"dtype": dtype, "seed": seed, **{
                f"{arm}_{k.split('/')[0]}": eval_dtype[arm][k]
                for arm in arms for k in ("linear/mIoU", "cluster/mIoU")}, **{
                f"{arm}_{p}_agree": eval_dtype[f"{arm}_{p}_agree"]
                for arm in arms if arm != "float32" for p in ("lin", "clu")}})
            n_win = len(losses) // args.chunk * args.chunk
            curves[(dtype, seed)] = losses[:n_win].reshape(-1, args.chunk).mean(1)
            print(f"{dtype} seed {seed}: lin mIoU {metrics['linear/mIoU']:.2f} "
                  f"Acc {metrics['linear/Accuracy']:.2f} | clu mIoU "
                  f"{metrics['cluster/mIoU']:.2f} Acc {metrics['cluster/Accuracy']:.2f} | "
                  f"loss {rows[-1]['final_loss']:.4f} | {train_s:.0f}s", flush=True)
    table = report(rows, eval_rows, curves, arms, args, device_name)
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    return {"rows": rows, "eval_rows": eval_rows, "report": table}


if __name__ == "__main__":
    main()
