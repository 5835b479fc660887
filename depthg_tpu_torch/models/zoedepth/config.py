"""ZoeDepth config system: ``get_config(model, mode, **overrides)``.

Mirrors the reference's JSON config stack (``src/zoedepth/utils/config.py``:
COMMON_CONFIG + per-model/per-mode blocks + kwargs overrides) mapped onto this
framework's typed ``ZoeConfig`` / ``ZoeNKConfig`` dataclasses. The shipped
defaults reproduce ``config_zoedepth.json`` "infer" (the mode the DepthG
pipelines use).
"""

from __future__ import annotations

from typing import Any

from depthg_tpu_torch.models.zoedepth.model import ZoeConfig
from depthg_tpu_torch.models.zoedepth.nk import BinConf, ZoeNKConfig

# config_zoedepth.json "model" block (reference values)
ZOEDEPTH_MODEL_CONFIG = {
    "n_bins": 64,
    "bin_embedding_dim": 128,
    "bin_centers_type": "softplus",
    "n_attractors": (16, 8, 4, 1),
    "attractor_alpha": 1000.0,
    "attractor_gamma": 2.0,
    "attractor_kind": "mean",
    "attractor_type": "inv",
    "min_temp": 0.0212,
    "max_temp": 50.0,
    "inverse_midas": False,
    "img_size": (384, 512),
}

# config_zoedepth_nk.json "model" block
ZOEDEPTH_NK_MODEL_CONFIG = {
    "bin_conf": (
        {"name": "nyu", "n_bins": 64, "min_depth": 1e-3, "max_depth": 10.0},
        {"name": "kitti", "n_bins": 64, "min_depth": 1e-3, "max_depth": 80.0},
    ),
    "bin_embedding_dim": 128,
    "bin_centers_type": "softplus",
    "n_attractors": (16, 8, 4, 1),
    "attractor_alpha": 1000.0,
    "attractor_gamma": 2.0,
    "attractor_kind": "mean",
    "attractor_type": "inv",
    "min_temp": 0.0212,
    "max_temp": 50.0,
}

# ---------------------------------------------------------------------------
# Depth-dataset table (reference ``src/zoedepth/utils/config.py:51-232``
# DATASETS_CONFIG): per-dataset depth ranges, eval crop policy and default
# on-disk layout for the 12 train/eval depth datasets + the kitti_test alias.
# Re-designed as a typed spec (one row per dataset) instead of 180 lines of
# repeated dict literals; ``datasets_config(name)`` renders the reference-
# shaped dict for code that wants the flat keys.
# ---------------------------------------------------------------------------
import dataclasses as _dc
import os as _os

_DATA_HOME = _os.environ.get("DEPTHG_DEPTH_DATA_ROOT",
                             _os.path.join(_os.path.expanduser("~"),
                                           "shortcuts/datasets"))


@_dc.dataclass(frozen=True)
class DepthDatasetSpec:
    name: str
    min_depth: float
    max_depth: float
    min_depth_eval: float
    max_depth_eval: float
    crop: str | None          # "eigen" | "garg" | None (eval border crop)
    do_kb_crop: bool = False  # KITTI benchmark crop before eval
    root: str = ""            # relative to the datasets root
    # train-split fields (only kitti/nyu train in the reference)
    input_height: int | None = None
    input_width: int | None = None
    do_random_rotate: bool = False
    degree: float = 1.0
    use_right: bool = False
    avoid_boundary: bool = False

    def paths(self, base: str | None = None) -> dict:
        base = base or _DATA_HOME
        return {"root": _os.path.join(base, self.root)}


DEPTH_DATASETS: dict[str, DepthDatasetSpec] = {s.name: s for s in [
    DepthDatasetSpec("kitti", 0.001, 80, 1e-3, 80, "garg", do_kb_crop=True,
                     root="kitti/raw", input_height=352, input_width=1216,
                     do_random_rotate=True),
    DepthDatasetSpec("kitti_test", 0.001, 80, 1e-3, 80, "garg",
                     do_kb_crop=True, root="kitti/raw", input_height=352,
                     input_width=1216, do_random_rotate=False),
    DepthDatasetSpec("nyu", 1e-3, 10, 1e-3, 10, "eigen", root="nyu_depth_v2/sync",
                     input_height=480, input_width=640, do_random_rotate=True,
                     avoid_boundary=False),
    DepthDatasetSpec("ibims", 1e-3, 10, 0, 10, "eigen",
                     root="ibims/ibims1_core_raw"),
    DepthDatasetSpec("sunrgbd", 1e-3, 10, 0, 8, "eigen", root="SUNRGBD/test"),
    DepthDatasetSpec("diml_indoor", 1e-3, 10, 0, 10, "eigen",
                     root="diml_indoor_test"),
    DepthDatasetSpec("diml_outdoor", 1e-3, 80, 2, 80, "garg",
                     root="diml_outdoor_test"),
    DepthDatasetSpec("diode_indoor", 1e-3, 10, 1e-3, 10, "eigen",
                     root="diode_indoor"),
    DepthDatasetSpec("diode_outdoor", 1e-3, 80, 1e-3, 80, "garg",
                     root="diode_outdoor"),
    DepthDatasetSpec("hypersim_test", 1e-3, 10, 1e-3, 80, "eigen",
                     root="hypersim_test"),
    DepthDatasetSpec("vkitti", 1e-3, 80, 1e-3, 80, "garg", do_kb_crop=True,
                     root="vkitti"),
    DepthDatasetSpec("vkitti2", 1e-3, 80, 1e-3, 80, "garg", do_kb_crop=True,
                     root="vkitti2"),
    DepthDatasetSpec("ddad", 1e-3, 80, 1e-3, 80, "garg", do_kb_crop=True,
                     root="ddad/ddad_val"),
]}

ALL_INDOOR = ["nyu", "ibims", "sunrgbd", "diode_indoor", "hypersim_test"]
ALL_OUTDOOR = ["kitti", "diml_outdoor", "diode_outdoor", "vkitti2", "ddad"]
ALL_EVAL_DATASETS = ALL_INDOOR + ALL_OUTDOOR


def datasets_config(name: str, data_root: str | None = None) -> dict:
    """Reference-shaped flat dict for one dataset (DATASETS_CONFIG[name])."""
    s = DEPTH_DATASETS[name]
    d = {"dataset": s.name, "min_depth": s.min_depth, "max_depth": s.max_depth,
         "min_depth_eval": s.min_depth_eval, "max_depth_eval": s.max_depth_eval,
         "eigen_crop": s.crop == "eigen", "garg_crop": s.crop == "garg",
         "do_kb_crop": s.do_kb_crop, **s.paths(data_root)}
    if s.input_height is not None:
        d.update(input_height=s.input_height, input_width=s.input_width,
                 do_random_rotate=s.do_random_rotate, degree=s.degree,
                 use_right=s.use_right, avoid_boundary=s.avoid_boundary)
    return d


PRETRAINED_RESOURCES = {
    # "infer"/"eval" pretrained checkpoints (reference config_zoedepth*.json)
    "zoedepth": "https://github.com/isl-org/ZoeDepth/releases/download/v1.0/ZoeD_M12_N.pt",
    "zoedepth_nk": "https://github.com/isl-org/ZoeDepth/releases/download/v1.0/ZoeD_M12_NK.pt",
}


def get_config(model_name: str = "zoedepth", mode: str = "infer",
               **overwrite_kwargs: Any):
    """Returns the typed config for ``model_name`` with overrides applied."""
    if model_name not in ("zoedepth", "zoedepth_nk"):
        raise ValueError(f"Model {model_name} not in ['zoedepth', 'zoedepth_nk']")
    if mode not in ("train", "infer", "eval"):
        raise ValueError(f"Mode {mode} not in ['train', 'infer', 'eval']")

    if model_name == "zoedepth":
        cfg = dict(ZOEDEPTH_MODEL_CONFIG)
        cfg.update({k: v for k, v in overwrite_kwargs.items() if k in cfg})
        if isinstance(cfg["n_attractors"], list):
            cfg["n_attractors"] = tuple(cfg["n_attractors"])
        if isinstance(cfg["img_size"], (list, int)):
            s = cfg["img_size"]
            cfg["img_size"] = (s, s) if isinstance(s, int) else tuple(s)
        return ZoeConfig(**cfg)

    cfg = dict(ZOEDEPTH_NK_MODEL_CONFIG)
    cfg.update({k: v for k, v in overwrite_kwargs.items() if k in cfg})
    bin_confs = tuple(BinConf(c["name"], int(c["n_bins"]),
                              float(c["min_depth"]), float(c["max_depth"]))
                      for c in cfg.pop("bin_conf"))
    cfg.pop("bin_centers_type", None)
    return ZoeNKConfig(bin_confs=bin_confs,
                       bin_embedding_dim=int(cfg["bin_embedding_dim"]),
                       n_attractors=tuple(cfg["n_attractors"]),
                       attractor_alpha=float(cfg["attractor_alpha"]),
                       attractor_gamma=float(cfg["attractor_gamma"]),
                       attractor_kind=cfg["attractor_kind"],
                       attractor_type=cfg["attractor_type"],
                       min_temp=float(cfg["min_temp"]),
                       max_temp=float(cfg["max_temp"]))
