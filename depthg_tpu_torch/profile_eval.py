"""Where the eval step's time goes on the GPU, at the default point.

    python -m depthg_tpu_torch.profile_eval [--steps 20] [--out FILE]

Batch 16, full-width ViT-S/8 at 320 px with random weights (``torch.Generator`` seed
0), synthetic smooth images and random labels, the eval default CRF point,
bf16 backbone. Prints one JSON object (also written to ``--out``):

* ``step_ms`` / ``img_per_s``: the whole eval step, CUDA events around
  ``--steps`` back-to-back steps on perturbed inputs after a warm-up, with
  no synchronization inside the loop;
* ``parts_ms``: each part on its own over the same number of calls: the
  flip-TTA backbone (``tta_code``), probes and upsampling (``eval_logits``
  minus the backbone), the dense CRF on both probes, argmax + confusion
  (the rest of the step). Parts run one after another with a sync between
  them, so they need not add up to ``step_ms``;
* ``profile``: one step under ``torch.profiler``: device time and the
  number of device events (kernels, copies), and the largest host ops and
  device events by device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from depthg_tpu_torch import get_device, inference
from depthg_tpu_torch.models import featurizer
from depthg_tpu_torch.ops import crf

BATCH = 16
TOP = 12  # largest ops and device events listed


def _cuda_ms(fn, n: int) -> float:
    """Mean ms of ``fn(i)`` over i = 0..n-1, CUDA events, after a warm-up."""
    fn(0)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _top(events, n: int) -> list:
    return [{"name": k.key[:80], "calls": k.count,
             "device_ms": k.self_device_time_total / 1e3} for k in events[:n]]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = get_device("cuda")
    b = BATCH

    model = inference.Segmenter(featurizer.FeaturizerConfig(), 27, 27).init_weights(
        torch.Generator().manual_seed(0)).to(dev)
    ecfg = inference.EvalConfig(n_classes=27, crf=crf.crf_config_from_cfg({}),
                                backbone_dtype="bfloat16")
    step = inference.make_eval_step(ecfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    low = torch.rand(b, 3, 40, 40, device=dev, generator=gen)
    base = torch.nn.functional.interpolate(low, size=(320, 320), mode="bilinear")
    imgs = [(base + 0.02 * i - 0.45) / 0.226 for i in range(4)]
    label = torch.randint(-1, 27, (b, 320, 320), device=dev, generator=gen)

    with torch.inference_mode():
        step_ms = _cuda_ms(lambda i: step(model, imgs[i % 4], label), args.steps)
        tta_ms = _cuda_ms(lambda i: inference.tta_code(
            model.net, imgs[i % 4], backbone_dtype="bfloat16"), args.steps)
        logits_ms = _cuda_ms(lambda i: inference.eval_logits(
            model, imgs[i % 4], ecfg, normalized=False), args.steps)
        lin, clu = inference.eval_logits(model, imgs[0], ecfg, normalized=False)
        guide = inference.unnormalize_255(imgs[0])
        crf_ms = _cuda_ms(lambda i: crf.dense_crf_multi_batch(
            guide, [lin, clu], ecfg.crf), args.steps)

        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(model, imgs[1], label)
            torch.cuda.synchronize()
    # device-side events (kernels, copies) vs the host ops that launched them;
    # both carry the same device time, so totals come from the first only
    events = [k for k in prof.key_averages() if k.self_device_time_total > 0]
    events.sort(key=lambda k: -k.self_device_time_total)
    on_device = [k for k in events if k.device_type != torch.autograd.DeviceType.CPU]
    host_ops = [k for k in events if k.device_type == torch.autograd.DeviceType.CPU]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip()
    result = {
        "card": card, "torch": torch.__version__, "batch": b, "steps": args.steps,
        "step_ms": step_ms, "img_per_s": b / step_ms * 1e3,
        "parts_ms": {"tta_backbone": tta_ms, "probes_upsample": logits_ms - tta_ms,
                     "crf": crf_ms, "argmax_confusion_rest": step_ms - logits_ms - crf_ms},
        "profile": {
            "device_ms": sum(k.self_device_time_total for k in on_device) / 1e3,
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
