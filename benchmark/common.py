"""Helpers shared by the drivers: seeds, device synchronization, the port's
configuration objects built from a configuration file, and the timed
window."""

from __future__ import annotations

import gc
import random
import statistics
import sys
import time

import torch

# --seed may exceed 32 bits; each stream of a run gets its own 63-bit seed
_STREAMS = {"weights": 1, "data": 2, "step": 3, "sample": 4, "arrivals": 5}


def stream_seed(seed: int, stream: str, k: int = 0) -> int:
    return (int(seed) * 1_000_003 + _STREAMS[stream] * 7_919 + k * 104_729) % (2 ** 63)


def sample_indices(seed: int, n: int, k: int) -> list:
    """k of range(n) drawn from the seed (all of them when n <= k)."""
    rng = random.Random(stream_seed(seed, "sample"))
    return sorted(rng.sample(range(n), min(k, n)))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def numerics() -> None:
    """Full float32 products (TF32 off), which the port and the CRF
    reference need."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def peak_bytes(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def featurizer_config(cfg: dict):
    """The port's FeaturizerConfig at the configuration's widths."""
    from depthg_tpu_torch.models.featurizer import FeaturizerConfig
    from depthg_tpu_torch.models.vit import ViTConfig

    bb, head = cfg["backbone"], cfg["head"]
    if bb["embed_dim"] != bb["num_heads"] * bb["head_dim"]:
        raise ValueError("embed_dim must be num_heads * head_dim")
    vit = ViTConfig(patch_size=bb["patch_size"], embed_dim=bb["embed_dim"], depth=bb["depth"],
                    num_heads=bb["num_heads"], mlp_ratio=bb["mlp_ratio"], qkv_bias=bb["qkv_bias"],
                    ln_eps=bb["ln_eps"], img_size=bb["pos_embed_grid"] * bb["patch_size"])
    return FeaturizerConfig(arch=bb["arch"], patch_size=bb["patch_size"],
                            feat_type=head["feat_type"], projection_type=head["projection_type"],
                            dim=head["dim"], dropout=head["dropout"], drop_rate=head["drop_rate"],
                            vit_config=vit)


def segmenter(cfg: dict, sd: dict, decoder: bool = False):
    """The port's Segmenter holding the tensors of ``sd`` (no copy)."""
    from depthg_tpu_torch.inference import Segmenter

    k = cfg["n_classes"] + cfg["extra_clusters"]
    with torch.device("meta"):
        model = Segmenter(featurizer_config(cfg), cfg["n_classes"], k, decoder=decoder)
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def window(launch, seconds: float, dev: torch.device):
    """Call ``launch(i)`` back to back until ``seconds`` of host time have
    passed, then synchronize. Returns (calls, host seconds up to the
    synchronize); prints on stderr the median, least and most host time
    per call of each tenth of the calls (where the window's time went)."""
    sync(dev)
    t0 = time.perf_counter()
    marks = []
    while time.perf_counter() - t0 < seconds:
        launch(len(marks))
        marks.append(time.perf_counter())
    sync(dev)
    total = time.perf_counter() - t0
    n = len(marks)
    if n >= 20:
        k = n // 10
        per = sorted((marks[i + k - 1] - (marks[i - 1] if i else t0)) / k
                     for i in range(0, n - k + 1, k))
        print(f"window: {n} calls in {total:.4f} s; host s per call over tenths: median "
              f"{statistics.median(per):.6f}, min {per[0]:.6f}, max {per[-1]:.6f}",
              file=sys.stderr)
    return n, total
