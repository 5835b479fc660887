"""Metric-depth evaluation metrics (reference ``zoedepth/utils/misc.py``).

* ``compute_errors`` (``misc.py:159-200``): a1/a2/a3 delta accuracies,
  abs_rel, sq_rel, rmse, rmse_log, log_10, silog(x100) over flat valid
  pixels;
* ``compute_metrics`` (``misc.py:202-247``): bilinear align_corners=True
  interpolation of the prediction to the GT resolution, clipping to
  [min_depth_eval, max_depth_eval] with inf->max / nan->min, validity mask
  from OPEN bounds, then the garg or eigen border crop (KITTI eigen uses its
  own fractions; everything else uses the fixed NYU 45:471, 41:601 box);
* ``RunningAverageDict`` (``misc.py:46-76``): uniform running means over
  batches (each eval batch is ONE image in the reference, so the mean over
  updates equals the reference's per-image average).

Pure numpy — eval metrics are per-image host-side work in the reference
too; the device does the forward (``depthg_tpu.models.zoedepth.model``).
"""

from __future__ import annotations

import numpy as np


def compute_errors(gt: np.ndarray, pred: np.ndarray) -> dict:
    """Nine depth metrics over flat arrays of valid pixels (misc.py:159-200)."""
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean((gt - pred) ** 2 / gt)
    rmse = np.sqrt(np.mean((gt - pred) ** 2))
    rmse_log = np.sqrt(np.mean((np.log(gt) - np.log(pred)) ** 2))
    err = np.log(pred) - np.log(gt)
    silog = np.sqrt(np.mean(err ** 2) - np.mean(err) ** 2) * 100
    log_10 = np.mean(np.abs(np.log10(gt) - np.log10(pred)))
    return dict(a1=a1, a2=a2, a3=a3, abs_rel=abs_rel, rmse=rmse,
                log_10=log_10, rmse_log=rmse_log, silog=silog, sq_rel=sq_rel)


def compute_metrics(gt: np.ndarray, pred: np.ndarray, *,
                    interpolate: bool = True, garg_crop: bool = False,
                    eigen_crop: bool = True, dataset: str = "nyu",
                    min_depth_eval: float = 0.1,
                    max_depth_eval: float = 10.0) -> dict | None:
    """Crop/mask/clip then ``compute_errors`` (misc.py:202-247). ``gt`` and
    ``pred``: [H, W] (or squeezable). Returns None when no pixel survives."""
    gt = np.asarray(gt, np.float32).squeeze()
    pred = np.asarray(pred, np.float32).squeeze()
    if gt.shape != pred.shape and interpolate:
        from depthg_tpu_torch.ops.resize import resize_bilinear_array as resize_bilinear
        pred = np.asarray(resize_bilinear(
            pred[None, None], gt.shape, align_corners=True))[0, 0]

    pred = pred.copy()
    pred[pred < min_depth_eval] = min_depth_eval
    pred[pred > max_depth_eval] = max_depth_eval
    pred[np.isinf(pred)] = max_depth_eval
    pred[np.isnan(pred)] = min_depth_eval

    valid = np.logical_and(gt > min_depth_eval, gt < max_depth_eval)
    if garg_crop or eigen_crop:
        h, w = gt.shape
        eval_mask = np.zeros_like(valid)
        if garg_crop:
            eval_mask[int(0.40810811 * h):int(0.99189189 * h),
                      int(0.03594771 * w):int(0.96405229 * w)] = True
        elif dataset == "kitti":
            eval_mask[int(0.3324324 * h):int(0.91351351 * h),
                      int(0.0359477 * w):int(0.96405229 * w)] = True
        else:
            eval_mask[45:471, 41:601] = True
        valid = np.logical_and(valid, eval_mask)
    if not valid.any():
        return None
    return compute_errors(gt[valid], pred[valid])


class RunningAverageDict:
    """Uniform running mean per key (misc.py:46-76); ``update(None)`` is a
    no-op like the reference's."""

    def __init__(self):
        self._avg = None
        self._count = 0

    def update(self, new: dict | None):
        if new is None:
            return
        if self._avg is None:
            self._avg = dict(new)
            self._count = 1
            return
        self._count += 1
        for k, v in new.items():
            self._avg[k] += (v - self._avg[k]) / self._count

    def get_value(self) -> dict:
        return dict(self._avg or {})
