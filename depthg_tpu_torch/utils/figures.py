"""Qualitative eval figures (reference ``src/eval_segmentation.py:19-42,
205-247``): matplotlib prediction grids and the seaborn-style confusion
heatmap with per-class colored tick labels.

Host-side only — consumes numpy arrays the eval CLI already fetched.
"""

from __future__ import annotations

import numpy as np


def get_class_labels(dataset_name: str) -> list[str]:
    """Per-dataset class names (reference ``src/train_segmentation.py:38-68``)."""
    if dataset_name.startswith("cityscapes"):
        return [
            'road', 'sidewalk', 'parking', 'rail track', 'building',
            'wall', 'fence', 'guard rail', 'bridge', 'tunnel',
            'pole', 'polegroup', 'traffic light', 'traffic sign', 'vegetation',
            'terrain', 'sky', 'person', 'rider', 'car',
            'truck', 'bus', 'caravan', 'trailer', 'train',
            'motorcycle', 'bicycle']
    if dataset_name == "cocostuff27":
        return [
            "electronic", "appliance", "food", "furniture", "indoor",
            "kitchen", "accessory", "animal", "outdoor", "person",
            "sports", "vehicle", "ceiling", "floor", "food",
            "furniture", "rawmaterial", "textile", "wall", "window",
            "building", "ground", "plant", "sky", "solid",
            "structural", "water"]
    if dataset_name == "voc":
        return [
            'background',
            'aeroplane', 'bicycle', 'bird', 'boat', 'bottle',
            'bus', 'car', 'cat', 'chair', 'cow',
            'diningtable', 'dog', 'horse', 'motorbike', 'person',
            'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor']
    if dataset_name == "potsdam":
        return [
            'roads and cars',
            'buildings and clutter',
            'trees and vegetation']
    raise ValueError(f"Unknown Dataset {dataset_name}")


def prediction_grid(images: np.ndarray, labels: np.ndarray,
                    cluster_rgb: np.ndarray, linear_rgb: np.ndarray,
                    cmap: np.ndarray, path: str, dark_mode: bool = False,
                    max_cols: int = 10) -> None:
    """Rows = Image / Label / Cluster / Linear, columns = images
    (reference grid at ``eval_segmentation.py:212-243``; the linear row
    replaces the unused PiCIE baseline row)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if dark_mode:
        plt.style.use("dark_background")
    n = min(len(images), max_cols)
    rows = [("Image", images), ("Label", labels),
            ("Cluster", cluster_rgb), ("Linear", linear_rgb)]
    fig, ax = plt.subplots(len(rows), n, figsize=(n * 3, len(rows) * 3),
                           squeeze=False)
    for i in range(n):
        for r, (name, data) in enumerate(rows):
            ax[r, i].imshow(data[i])
            ax[r, i].set_xticks([])
            ax[r, i].set_yticks([])
            if i == 0:
                ax[r, 0].set_ylabel(name, fontsize=26)
    plt.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def confusion_matrix_figure(stats: np.ndarray, dataset_name: str,
                            cmap: np.ndarray, path: str,
                            extra_clusters: int = 0) -> None:
    """Column-normalized confusion heatmap with class-colored tick labels
    (reference ``plot_cm``, ``eval_segmentation.py:19-42``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    hist = np.asarray(stats, np.float64)
    hist = hist / np.clip(hist.sum(axis=0, keepdims=True), 1, None)
    names = get_class_labels(dataset_name)
    if extra_clusters:
        names = names + ["Extra"]

    fig = plt.figure(figsize=(10, 10))
    ax = fig.gca()
    try:
        import seaborn as sns

        sns.heatmap(hist.T, annot=False, fmt="g", ax=ax, cmap="Blues", cbar=False)
    except ImportError:
        ax.imshow(hist.T, cmap="Blues", aspect="auto")
    ax.set_title("Predicted labels", fontsize=28)
    ax.set_ylabel("True labels", fontsize=28)
    k = hist.shape[0]
    ax.set_xticks(np.arange(0, min(len(names), k)) + .5)
    ax.set_yticks(np.arange(0, hist.shape[1]) + .5)
    ax.xaxis.tick_top()
    ax.xaxis.set_ticklabels(names[:k], fontsize=18)
    ax.yaxis.set_ticklabels(names[:hist.shape[1]], fontsize=18)
    colors = [np.asarray(cmap[i], np.float64) / 255.0 for i in range(len(names))]
    for i, t in enumerate(ax.xaxis.get_ticklabels()):
        t.set_color(colors[i])
    for i, t in enumerate(ax.yaxis.get_ticklabels()):
        t.set_color(colors[i])
    plt.xticks(rotation=90)
    plt.yticks(rotation=0)
    ax.vlines(np.arange(0, k + 1), color=[.5, .5, .5], *ax.get_xlim())
    ax.hlines(np.arange(0, hist.shape[1] + 1), color=[.5, .5, .5], *ax.get_ylim())
    plt.tight_layout()
    fig.savefig(path)
    plt.close(fig)
