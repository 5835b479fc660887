"""Where the eval step's time goes on the GPU, at any CRF point.

    python -m depthg_tpu_torch.profile_eval [--steps 20] [--batch 16]
        [--out FILE] [operating_point=NAME] [crf_KEY=VALUE ...] [KEY=VALUE ...]

A full-width backbone with random weights (``torch.Generator`` seed 0),
synthetic smooth images and random labels, at the eval step the ``k=v``
overrides give, read by the eval CLI's ``eval_config`` (its defaults
without any: ``res`` 320, the bf16 backbone, stacked flip-TTA, the default
CRF point; ``fused_tta=false`` runs the two passes) and, for the backbone
and head, as a run config (``inference.fcfg_from_run_cfg``: ViT-S/8 with a
70-wide head without any; ``model_type=dinov2_vitg14_reg
dino_patch_size=14 dim=90 res=448`` is the DINOv2 eval cell's). Prints one
JSON object (also written to ``--out``):

* ``step_ms`` / ``img_per_s``: the whole eval step, CUDA events around
  ``--steps`` back-to-back steps on perturbed inputs after a warm-up, with
  no synchronization inside the loop;
* ``spans_ms``: the port's spans (``utils.profiling``) of ``--steps`` more
  steps run back to back inside one ``recording()`` stretch, no profiler:
  for each span under ``eval.step``, keyed by its path
  (``eval.step/logits/backbone``, ``eval.step/confusion/host_sync``, ...),
  its host time, its own host time (less its children) and its stream time
  per step; ``recording_step_ms`` is that stretch's CUDA-event time per
  step, and ``host_syncs_per_step`` the step's waits for the device;
* ``peak_mem_gb``: the largest device memory allocated during the timed
  steps (``torch.cuda.max_memory_allocated``);
* ``profile``: one step under ``torch.profiler``: device time and the
  number of device events (kernels, copies), and the largest host ops and
  device events by device time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess

import torch

from depthg_tpu_torch import get_device, inference
from depthg_tpu_torch.eval_segmentation import eval_config
from depthg_tpu_torch.ops import crf
from depthg_tpu_torch.utils import profiling

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


def spans_ms(spans: list) -> dict:
    """Each span under the ``eval.step`` spans, keyed by its path from the
    step: host, own host (less its children) and stream ms per step."""
    by_id = {s["id"]: s for s in spans}

    def path(s):
        return s["name"] if s["parent"] is None else f"{path(by_id[s['parent']])}/{s['name']}"

    steps = {s["id"] for s in spans if s["parent"] is None and s["name"] == "eval.step"}
    out = {}
    for s in spans:
        if s["step"] in steps:
            row = out.setdefault(path(s), {"host": 0.0, "self_host": 0.0, "device": 0.0})
            row["host"] += s["host_ms"] / len(steps)
            row["self_host"] += s["self_host_ms"] / len(steps)
            row["device"] += s["device_ms"] / len(steps)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default=None)
    ap.add_argument("overrides", nargs="*",
                    help="operating_point=NAME, crf_KEY=VALUE, res=, fused_tta=, model_type=, "
                         "dino_patch_size=, dim=")
    args = ap.parse_args(argv)
    dev = get_device("cuda")
    cfg = eval_config(args.overrides)
    b, res = args.batch, int(cfg.res)

    fcfg = inference.fcfg_from_run_cfg(cfg)
    model = inference.Segmenter(fcfg, 27, 27).init_weights(
        torch.Generator().manual_seed(0)).to(dev)
    ecfg = inference.EvalConfig(
        n_classes=27, label_res=res, crf=crf.crf_config_from_cfg(cfg),
        backbone_dtype=str(cfg.backbone_dtype), fused_tta=bool(cfg.get("fused_tta", True)))
    step = inference.make_eval_step(ecfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    low = torch.rand(b, 3, 40, 40, device=dev, generator=gen)
    base = torch.nn.functional.interpolate(low, size=(res, res), mode="bilinear")
    imgs = [(base + 0.02 * i - 0.45) / 0.226 for i in range(4)]
    label = torch.randint(-1, 27, (b, res, res), device=dev, generator=gen)

    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats(dev)
        step_ms = _cuda_ms(lambda i: step(model, imgs[i % 4], label), args.steps)
        peak_mem_gb = torch.cuda.max_memory_allocated(dev) / 2**30
        profiling.clear()
        with profiling.recording():
            recording_step_ms = _cuda_ms(lambda i: step(model, imgs[i % 4], label), args.steps)
        spans = profiling.collect()["spans"]
        profiling.clear()

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
        "arch": fcfg.arch, "patch_size": fcfg.patch_size, "res": res,
        "fused_tta": ecfg.fused_tta, "overrides": args.overrides,
        "crf": dataclasses.asdict(ecfg.crf),
        "step_ms": step_ms, "img_per_s": b / step_ms * 1e3, "peak_mem_gb": peak_mem_gb,
        "spans_ms": spans_ms(spans), "recording_step_ms": recording_step_ms,
        "host_syncs_per_step": statistics.mean(s["host_syncs"] for s in spans
                                               if s["name"] == "eval.step"),
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
