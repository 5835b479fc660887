"""Unsupervised segmentation metrics (``depthg_tpu/utils/metrics.py``).

``confusion_update`` is the reference's own bincount of
``(n + extra) * actual + pred`` (the JAX package used a one-hot matmul
because scatter-adds are slow on a TPU). The reference quirk is kept: the
mask drops ``pred >= n_classes``, so predictions in extra clusters never
enter the matrix. The Hungarian matching and mIoU/accuracy are host-side
numpy + scipy. ``confusion_heatmap_png`` is a copy of the JAX package's
(PIL only).
"""

from __future__ import annotations

import numpy as np
import torch

from depthg_tpu_torch.utils import profiling


def confusion_update(preds: torch.Tensor, target: torch.Tensor, n_classes: int,
                     extra_clusters: int = 0) -> torch.Tensor:
    """Confusion increment [n_classes + extra, n_classes] (int64, on the
    inputs' device): stats[pred_cluster, actual_class]."""
    k = n_classes + extra_clusters
    actual = target.reshape(-1).long()
    pred = preds.reshape(-1).long()
    mask = (actual >= 0) & (actual < n_classes) & (pred >= 0) & (pred < n_classes)
    # masked pixels land in one overflow bin, so no data-dependent shapes
    idx = torch.where(mask, k * actual + pred, torch.full_like(actual, k * n_classes))
    with profiling.host_sync():  # on CUDA it reads idx's min and max to size its output
        counts = torch.bincount(idx, minlength=k * n_classes + 1)
    return counts[:k * n_classes].reshape(n_classes, k).T


def compute_metrics(stats: np.ndarray, n_classes: int, extra_clusters: int,
                    compute_hungarian: bool, prefix: str = ""):
    """Host-side metric computation. Returns (metrics dict, assignments)."""
    from scipy.optimize import linear_sum_assignment  # seconds to import

    stats = np.asarray(stats)
    if compute_hungarian:
        assignments = linear_sum_assignment(stats, maximize=True)
        if extra_clusters == 0:
            histogram = stats[np.argsort(assignments[1]), :]
        else:
            assignments_t = linear_sum_assignment(stats.T, maximize=True)
            histogram = stats[assignments_t[1], :]
            missing = list(set(range(n_classes + extra_clusters)) - set(assignments[0]))
            new_row = stats[missing, :].sum(0, keepdims=True)
            histogram = np.concatenate([histogram, new_row], axis=0)
            new_col = np.zeros((n_classes + 1, 1), histogram.dtype)
            histogram = np.concatenate([histogram, new_col], axis=1)
    else:
        assignments = (np.arange(n_classes), np.arange(n_classes))
        histogram = stats

    tp = np.diag(histogram).astype(np.float64)
    fp = histogram.sum(0) - tp
    fn = histogram.sum(1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = tp / (tp + fp + fn)
    acc = tp.sum() / histogram.sum() if histogram.sum() > 0 else float("nan")
    metrics = {
        prefix + "mIoU": (100.0 * float(np.nanmean(iou))
                          if not np.isnan(iou).all() else float("nan")),
        prefix + "Accuracy": 100.0 * float(acc),
    }
    return metrics, assignments


def hungarian_assignments(stats: np.ndarray, n_classes: int, extra_clusters: int):
    """(row_ind, col_ind): the cluster -> class assignment that maximizes
    the matched counts, reference semantics."""
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(stats, maximize=True)


def map_clusters(assignments, n_classes: int, extra_clusters: int,
                 clusters: np.ndarray) -> np.ndarray:
    """Map raw cluster predictions to matched class ids (-1 for unassigned)."""
    if extra_clusters == 0:
        return np.asarray(assignments[1])[clusters]
    missing = sorted(set(range(n_classes + extra_clusters)) - set(assignments[0]))
    cluster_to_class = np.asarray(assignments[1])
    for m in missing:
        if m == cluster_to_class.shape[0]:
            cluster_to_class = np.append(cluster_to_class, -1)
        else:
            cluster_to_class = np.insert(cluster_to_class, m + 1, -1)
    return cluster_to_class[clusters]


class SegMetrics:
    """Host accumulator of confusion blocks, reference lifecycle."""

    def __init__(self, prefix: str, n_classes: int, extra_clusters: int,
                 compute_hungarian: bool):
        self.prefix = prefix
        self.n_classes = n_classes
        self.extra_clusters = extra_clusters
        self.compute_hungarian = compute_hungarian
        self.reset()

    def reset(self):
        self.stats = np.zeros((self.n_classes + self.extra_clusters,
                               self.n_classes), np.int64)
        self.assignments = None

    def _block(self, preds, target) -> np.ndarray:
        """The confusion block of label maps ``preds`` against ``target``
        (tensors or arrays), on the host."""
        preds, target = (t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
                         for t in (preds, target))
        return confusion_update(preds, target, self.n_classes,
                                self.extra_clusters).cpu().numpy()

    def update(self, preds, target):
        self.stats += self._block(preds, target)

    def add_stats(self, stats: torch.Tensor):
        """Add a precomputed confusion block (fetched to the host here)."""
        self.stats += stats.cpu().numpy()

    def compute(self):
        metrics, self.assignments = compute_metrics(
            self.stats, self.n_classes, self.extra_clusters,
            self.compute_hungarian, self.prefix)
        return metrics

    def map_clusters(self, clusters):
        if self.assignments is None:
            self.compute()
        return map_clusters(self.assignments, self.n_classes, self.extra_clusters,
                            np.asarray(clusters))

    # the reference's "cherry" variants (``src/utils.py:279-323``): a second
    # confusion buffer, emptied by every ``compute_cherry``, for per-image
    # selection
    def update_cherry(self, preds, target):
        if not hasattr(self, "cherry_stats"):
            self.cherry_stats = np.zeros_like(self.stats)
        self.cherry_stats += self._block(preds, target)

    def compute_cherry(self):
        metrics, _ = compute_metrics(
            getattr(self, "cherry_stats", np.zeros_like(self.stats)),
            self.n_classes, self.extra_clusters, self.compute_hungarian, self.prefix)
        self.cherry_stats = np.zeros_like(self.stats)
        return metrics


def confusion_heatmap_png(histogram: np.ndarray, path: str, cmap=None,
                          cell: int = 12):
    """Save a column-normalized confusion-matrix heatmap as a PNG
    (reference ``plot_cm``, ``src/eval_segmentation.py:19-42``, without the
    matplotlib/seaborn dependency)."""
    from PIL import Image

    hist = np.asarray(histogram, np.float64)
    hist = hist / np.clip(hist.sum(axis=0, keepdims=True), 1, None)
    # "Blues"-like ramp: white -> blue
    v = hist.T  # rows = true labels, like the reference figure
    rgb = np.stack([1 - 0.75 * v, 1 - 0.45 * v, np.ones_like(v)], axis=-1)
    img = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    img = np.kron(img, np.ones((cell, cell, 1), np.uint8))
    Image.fromarray(img).save(path)
    return path
