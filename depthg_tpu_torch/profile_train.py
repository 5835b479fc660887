"""Where the train step's time goes on the GPU.

    python -m depthg_tpu_torch.profile_train [--steps 20] [--batch 32] [--res 224]
        [--feature_samples 11] [--fused_pair_forward] [--out FILE]
        [arch=dino|dino_depth|feature-pyramid] [guidance=...] [lhp=True]
        [propagation_strategy=depth|attn] [model_type=...] [granularity=1..4]

Full-width ViT-S/8 with random weights (``torch.Generator`` seed 0), dim 70,
synthetic smooth images and depths and random labels made on the card, bf16
backbone, FPS sampling, five negatives, the depth-feature term on (weight
0.19, shift 0.03), dropout on. The ``key=value`` overrides (those six keys
only, read as ``configs/local_config.yml`` reads them) pick a variant: the
depth-fused featurizer, LHP, or the feature pyramid over a random
ResNet-50. Prints one JSON object (also written to ``--out``):

* ``step_ms`` / ``img_per_s``: the whole ``train_step``, CUDA events around
  ``--steps`` back-to-back steps on perturbed batches after a warm-up, with
  no synchronization inside the loop; ``host_ms`` is the host's time for
  the same loop up to the last launch (a step is host-bound where the two
  are close);
* ``parts_ms``: each part on its own over the same number of calls: the two
  frozen backbone forwards (the ViT, or the pyramid's ResNet), the bf16
  casts of the backbone's parameters (done on every forward), FPS for both images, the loss forward
  (``loss_fn``, backbone included), backward, the three optimizer steps.
  Parts run one after another with a sync between them, so they need not
  add up to ``step_ms``;
* ``peak_mem_gb`` (``torch.cuda.max_memory_allocated``), the count of
  attention-kernel launches per step and of trainable parameters;
* ``profile``: one step under ``torch.profiler``: device time (and its share
  of ``step_ms``), the number of device events, and the largest host ops
  and device events by device time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

from depthg_tpu_torch import get_device
from depthg_tpu_torch.config import cli_overrides, load_config
from depthg_tpu_torch.inference import fcfg_from_run_cfg
from depthg_tpu_torch.models import featurizer
from depthg_tpu_torch.models import pyramid
from depthg_tpu_torch.models.pyramid import FeaturePyramidNet
from depthg_tpu_torch.ops import attention
from depthg_tpu_torch.ops.depth import farthest_point_sampling_depth
from depthg_tpu_torch.profile_eval import TOP, _cuda_ms, _top
from depthg_tpu_torch.train import losses as loss_lib
from depthg_tpu_torch.train import step as step_lib

DEPTH_FEAT_WEIGHT, DEPTH_FEAT_SHIFT = 0.19, 0.03
VARIANT_KEYS = ("arch", "guidance", "lhp", "propagation_strategy", "model_type", "granularity")


def variant(overrides: list, hp: step_lib.TrainHParams):
    """(featurizer config, hparams) of the ``key=value`` overrides: the
    featurizer as ``fcfg_from_run_cfg`` reads ``local_config.yml``, LHP's
    switch and strategy into ``hp``; any other key raises."""
    overrides = cli_overrides(overrides)
    unknown = sorted({o.split("=", 1)[0] for o in overrides} - set(VARIANT_KEYS))
    if unknown:
        raise ValueError(f"profile_train takes only {VARIANT_KEYS} as overrides, got {unknown}")
    cfg = load_config("local_config.yml", overrides)
    hp = dataclasses.replace(hp, lhp=bool(cfg.lhp),
                             lhp_propagation_strategy=str(cfg.propagation_strategy))
    return fcfg_from_run_cfg(cfg), hp


def frozen_forward(net, img: torch.Tensor):
    """The frozen backbone's bf16 forward alone: the ViT, or the pyramid's
    ResNet-50."""
    if isinstance(net, FeaturePyramidNet):
        return pyramid.backbone_features(net, img, "bfloat16")
    return featurizer.backbone_features(net, img, backbone_dtype="bfloat16")


def bf16_casts(net):
    if isinstance(net, FeaturePyramidNet):
        return net.model.conv_weights_bf16()
    return featurizer.bf16_parameters(net.model)


def synthetic_batch(b: int, res: int, n_classes: int, gen: torch.Generator) -> dict:
    """A train batch made on ``gen``'s device: smooth ImageNet-normalized
    images (the positive a shifted copy), smooth depths in [0, 1], random
    labels with unlabeled (-1) pixels."""
    dev = gen.device

    def smooth(ch):
        low = torch.rand(b, ch, res // 8, res // 8, device=dev, generator=gen)
        return torch.nn.functional.interpolate(low, size=(res, res), mode="bilinear")

    img = smooth(3)
    return {"img": (img - 0.45) / 0.226,
            "img_pos": (img.roll(res // 16, dims=-1) * 0.9 + 0.05 - 0.45) / 0.226,
            "label": torch.randint(-1, n_classes, (b, res, res), device=dev, generator=gen),
            "depth": smooth(1), "depth_pos": smooth(1)}


def perturbed(batch: dict, i: int) -> dict:
    """``batch`` with its images moved a little (no step sees the same input)."""
    return {**batch, "img": batch["img"] + 0.02 * i, "img_pos": batch["img_pos"] - 0.02 * i}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--feature_samples", type=int, default=11)
    ap.add_argument("--fused_pair_forward", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("overrides", nargs="*", help=f"key=value, key in {VARIANT_KEYS}")
    args = ap.parse_args(argv)
    dev = get_device("cuda")
    b, n = args.batch, args.steps

    fcfg, hp = variant(args.overrides, step_lib.TrainHParams(
        n_classes=27, backbone_dtype="bfloat16", fused_pair_forward=args.fused_pair_forward))
    lcfg = loss_lib.CorrLossConfig(feature_samples=args.feature_samples)
    state = step_lib.init_state(fcfg, hp, torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [perturbed(synthetic_batch(b, args.res, 27, gen), i) for i in range(4)]
    w, sh = DEPTH_FEAT_WEIGHT, DEPTH_FEAT_SHIFT

    def step(i):
        return step_lib.train_step(state, batches[i % 4], hp, lcfg, w, sh, generator=gen)

    step(0)
    torch.cuda.synchronize()
    attention.KERNEL.launches = 0
    step(1)
    launches = attention.KERNEL.launches
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = _cuda_ms(step, n)
    peak_mem_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step(i)
    host_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()

    net = state.model.net

    def backbones(i):
        frozen_forward(net, batches[i % 4]["img"])
        frozen_forward(net, batches[i % 4]["img_pos"])

    def casts(i):
        return [bf16_casts(net) for _ in range(2)]

    grid = torch.zeros(2 * b, 1, args.res // 8, args.res // 8, device=dev)
    depths = [torch.cat([bt["depth"], bt["depth_pos"]]) for bt in batches]

    def fps(i):
        return farthest_point_sampling_depth(grid, depths[i % 4], args.feature_samples)

    def forward(i):
        return step_lib.loss_fn(state.model, batches[i % 4], hp, lcfg, w, sh, generator=gen,
                                lhp=state.lhp)[0]

    def backward_ms():
        """The backward passes alone: events around each ``backward()``,
        recorded after its forward has been issued."""
        pairs = []
        for i in range(n + 1):
            for opt in state.opt.values():
                opt.zero_grad(set_to_none=True)
            loss = forward(i)
            pairs.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            pairs[-1][0].record()
            loss.backward()
            pairs[-1][1].record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs[1:]) / n

    def optimizers(i):
        for opt in state.opt.values():
            opt.step()

    backbone_ms = _cuda_ms(backbones, n)
    casts_ms = _cuda_ms(casts, n)
    fps_ms = _cuda_ms(fps, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fps(i)
    fps_host_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    forward_ms = _cuda_ms(forward, n)
    bwd_ms = backward_ms()
    opt_ms = _cuda_ms(optimizers, n)

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(1)
        torch.cuda.synchronize()
    events = [k for k in prof.key_averages() if k.self_device_time_total > 0]
    events.sort(key=lambda k: -k.self_device_time_total)
    on_device = [k for k in events if k.device_type != torch.autograd.DeviceType.CPU]
    host_ops = [k for k in events if k.device_type == torch.autograd.DeviceType.CPU]
    device_ms = sum(k.self_device_time_total for k in on_device) / 1e3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip()
    trainable = sum(p.numel() for opt in state.opt.values()
                    for group in opt.param_groups for p in group["params"])
    result = {
        "card": card, "torch": torch.__version__, "batch": b, "res": args.res,
        "overrides": args.overrides, "featurizer": type(fcfg).__name__, "lhp": hp.lhp,
        "steps": n, "feature_samples": args.feature_samples,
        "fused_pair_forward": args.fused_pair_forward,
        "step_ms": step_ms, "img_per_s": b / step_ms * 1e3, "host_ms": host_ms,
        "peak_mem_gb": peak_mem_gb, "attention_launches_per_step": launches,
        "trainable_parameters": trainable,
        "parts_ms": {"backbone_x2": backbone_ms, "bf16_param_casts_x2": casts_ms,
                     "fps": fps_ms, "fps_host": fps_host_ms,
                     "loss_forward": forward_ms, "backward": bwd_ms,
                     "optimizers": opt_ms},
        "profile": {
            "device_ms": device_ms, "device_busy_share": device_ms / step_ms,
            "device_events": sum(k.count for k in on_device),
            "top_ops": _top(host_ops, TOP),
            "top_device_events": _top(on_device, TOP),
        },
    }
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return result


if __name__ == "__main__":
    main()
