"""Headline benchmark of the port: eval images/sec on one GPU, on the
COCO-Stuff27 eval workload of the JAX package's ``bench.py``.

    python -m depthg_tpu_torch.bench [--device cuda]     # on the card
    BENCH_SMOKE=1 python -m depthg_tpu_torch.bench --device cpu

Workload: the reference's ``eval_segmentation.py`` inner loop. A DINO
ViT-S/8 at 320 px with flip-TTA and a bf16 backbone, both probes, the dense
CRF on both probe outputs, then the confusion blocks: ``inference.make_eval_step``.
Random weights (``torch.Generator().manual_seed(0)``) and synthetic inputs
from a seeded generator on the device (no dataset is shipped); the compute
is that of the real workload.

``python -m depthg_tpu_torch.bench`` is an orchestrator: each measurement
phase runs in a child process (``--phase eval|train|io``), so a CUDA fault,
which poisons its process's context, kills only that child. The eval phase
measures every named operating point of ``ops.crf.EVAL_OPERATING_POINTS``
each run:

* ``default``: the eval CLI's operating point, the headline;
* ``quality_plus``: ds=4 jbu2 sf1.41;
* ``fast``: the default with a coarse prefix of 8;
* ``safe``: eager attention (no attention-kernel launch) and the
  phase-free downsample-4 CRF, the end of the fall-back chain on the CPU.

If the default's child fails, the headline falls down this list and
``eval_fallback_reason`` says why. On the card the headline is a rate
through the attention kernel: ``safe`` is measured and reported there but
never heads, and a kernel point whose child launched no kernel counts as
failed; when every kernel point fails, ``value`` stays null. The exit
status is 0 iff a headline value was measured. Every process names its device through
``runtime.get_device(--device)``: without a card and without
``--device cpu`` the orchestrator prints the error line and exits 1 at
once; it never runs on the CPU unasked.

Numbers reported (one GPU):

* ``value`` / ``host_img_per_sec``: ``iters`` dependent eval steps (each
  step's images moved by a device scalar taken from the previous step's
  confusion sum, no host sync inside the chain), timed by CUDA events
  around the chain (``value``) and by the host clock up to the synchronize
  after it (``host_img_per_sec``); medians of 3 after a warm-up. The chain
  is checked: its confusion counts sum to 2 x iters x the labelled pixels.
  ``rtt_ms`` is the round trip of one trivial kernel and its fetch,
  recorded and not subtracted.
* ``pipelined_img_per_sec``: K independent eval steps over device-resident
  batches, the statistics summed on the device, one final fetch.
* ``batch_sweep_img_per_sec``: the chain at batches 16, 32 and 64.
* ``eval_tflops_per_sec`` / ``eval_hw_util``: ``utils.profiling.step_flops``
  of one step (the attention kernel, the CRF's bilateral message and int8
  products counted from their shapes) over the step's time, against the
  H100 SXM's dense bf16 peak (989 TFLOP/s); null on the CPU.
* ``k1_launches_per_step``: attention-kernel launches per eval step, per point.
* ``host_to_device_mb_per_sec`` / ``device_put_latency_ms``: a batch
  through ``runtime.to_device`` (pinned memory, a non-blocking copy), a
  dependent touch kernel and a synchronize; median of 3.
* ``train_step_ms_b16`` / ``train_img_per_sec``: the depth-guided train
  step (ViT-S/8 at 224 px, FPS sampling, the COCO-Stuff recipe), 20
  dependent steps (each step's float inputs moved by the previous loss on
  the device), with the bf16 frozen backbone; ``*_f32_backbone`` and
  ``*_int8_backbone`` the same with the other backbones.
* ``device``: the card's name and power limit (``nvidia-smi``), or ``cpu``.

``vs_baseline``: the reference publishes no numbers. The denominator is an
estimate of its end-to-end eval throughput on a GPU host, where the CRF
runs serially on the CPU via pydensecrf, twice per image: 1.25 img/s
(``BASELINE.md``).

Test hooks: ``BENCH_SMOKE=1`` shrinks every shape and count so the whole
orchestration runs on a CPU host in seconds; ``BENCH_FAULT_INJECT`` (a
comma list like ``eval:default,train:default``) makes the named child
phases exit with code 42 as a crashed child would;
``BENCH_PHASE_TIMEOUT_S`` bounds each child.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BASELINE_IMG_PER_SEC_EST = 1.25
# NVIDIA H100 SXM data sheet, dense bf16 tensor-core peak
H100_BF16_PEAK_TFLOPS = 989.0
# every point measured every run; the FIRST is the headline + fall-back chain head
EVAL_POINTS = ("default", "quality_plus", "fast", "safe")
SMOKE = os.environ.get("BENCH_SMOKE", "") not in ("", "0")
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def eval_sizes(smoke: bool | None = None) -> dict:
    """Batch, dependent iterations, sweep batches, pipelined steps and
    resident batches of the eval phase; ``smoke`` defaults to ``BENCH_SMOKE``."""
    smoke = SMOKE if smoke is None else smoke
    return {"batch": 2 if smoke else 16, "iters": 2 if smoke else 10,
            "sweep": () if smoke else (32, 64), "pipelined": 3 if smoke else 12,
            "resident": 2 if smoke else 4}


def train_sizes(smoke: bool | None = None) -> dict:
    smoke = SMOKE if smoke is None else smoke
    return {"res": 64 if smoke else 224, "batch": 2 if smoke else 16,
            "iters": 2 if smoke else 20}


def io_sizes(smoke: bool | None = None) -> dict:
    smoke = SMOKE if smoke is None else smoke
    return {"res": 64 if smoke else 320, "batch": 2 if smoke else 16}


# ---------------------------------------------------------------------------
# measurement children (each runs in its own process)
# ---------------------------------------------------------------------------

def _maybe_fault(phase_point: str):
    """Fault-injection hook: exit as a crashed child would."""
    inject = os.environ.get("BENCH_FAULT_INJECT", "")
    if phase_point in [p.strip() for p in inject.split(",") if p.strip()]:
        print(f"bench[{phase_point}]: injected fault", file=sys.stderr, flush=True)
        os._exit(42)


def _eval_setup(point: str, smoke: bool | None = None):
    """(fcfg, ecfg, res) of a named eval operating point, from the one
    registry the eval CLI uses (``ops.crf.EVAL_OPERATING_POINTS``);
    ``smoke`` defaults to ``BENCH_SMOKE``."""
    from depthg_tpu_torch.inference import EvalConfig
    from depthg_tpu_torch.models.featurizer import FeaturizerConfig
    from depthg_tpu_torch.ops.crf import EVAL_OPERATING_POINTS, crf_config_from_cfg

    res = 128 if (SMOKE if smoke is None else smoke) else 320
    # "safe" is also the eager-attention arm (the end of the fall-back chain)
    fcfg = FeaturizerConfig(arch="vit_small", patch_size=8, dim=70,
                            attention_impl="xla" if point == "safe" else "auto")
    crf = crf_config_from_cfg(dict(EVAL_OPERATING_POINTS[point]))
    ecfg = EvalConfig(n_classes=27, run_crf=True, label_res=res, crf=crf,
                      backbone_dtype="bfloat16")
    return fcfg, ecfg, res


def _train_setup():
    """(fcfg, hparams by backbone, loss config, depth-feature weight, shift)."""
    from depthg_tpu_torch.models.featurizer import FeaturizerConfig
    from depthg_tpu_torch.train import losses as loss_lib
    from depthg_tpu_torch.train import step as step_lib

    fcfg = FeaturizerConfig(arch="vit_small", patch_size=8, dim=70)
    hps = {dt: step_lib.TrainHParams(n_classes=27, backbone_dtype=dt)
           for dt in ("float32", "bfloat16", "int8")}
    lcfg = loss_lib.CorrLossConfig(feature_samples=11, neg_samples=5,
                                   depth_sampling="fps",
                                   depth_feat_correlation_loss=True)
    return fcfg, hps, lcfg, 0.19, 0.03


def eval_model(fcfg, dev):
    """The segmenter with random weights from ``torch.Generator`` seed 0."""
    import torch

    from depthg_tpu_torch.inference import Segmenter

    return Segmenter(fcfg, 27, 27).init_weights(torch.Generator().manual_seed(0)).to(dev)


def _timed(run, dev):
    """(device seconds, host seconds, output) of ``run()``: CUDA events
    around it and the host clock up to the synchronize after it; on the
    CPU both are the host clock."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = run()
        dt = time.perf_counter() - t0
        return dt, dt, out
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    start.record()
    out = run()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / 1e3, time.perf_counter() - t0, out


def _median3(run, dev, check=None):
    """Medians of (device seconds, host seconds) over 3 timed runs, each
    output passed to ``check``."""
    runs = []
    for _ in range(3):
        d, h, out = _timed(run, dev)
        if check is not None:
            check(out)
        runs.append((d, h))
    return sorted(r[0] for r in runs)[1], sorted(r[1] for r in runs)[1]


def heads_on(point: str, device_type: str) -> bool:
    """May ``point`` carry the headline on ``device_type``? On the card only
    a point through the attention kernel: ``safe`` (eager attention) would
    be a plain-path rate there. On the CPU every point runs the plain
    versions, so any may."""
    return device_type != "cuda" or _eval_setup(point)[0].attention_impl != "xla"


def _card(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip()


def phase_eval(point: str, dev, full: bool = False) -> dict:
    """Throughput of one operating point; ``full`` (the headline point
    only) adds the batch sweep, the pipelined number and the utilization."""
    _maybe_fault(f"eval:{point}")
    import torch

    from depthg_tpu_torch.inference import make_eval_step
    from depthg_tpu_torch.ops import attention
    from depthg_tpu_torch.utils.profiling import dispatch_rtt, step_flops

    rtt = dispatch_rtt(dev, repeats=2 if SMOKE else 5)
    fcfg, ecfg, res = _eval_setup(point)
    model = eval_model(fcfg, dev)
    step = make_eval_step(ecfg)
    sizes = eval_sizes()
    batch, iters = sizes["batch"], sizes["iters"]
    gen = torch.Generator(device=dev).manual_seed(0)

    def make_batch(bsz):
        img = torch.randn(bsz, 3, res, res, device=dev, generator=gen)
        label = torch.randint(-1, 27, (bsz, res, res), device=dev, generator=gen)
        return img, label

    @torch.inference_mode()
    def chain(img, label):
        """``iters`` dependent steps; the confusion counts' sum stays on the device."""
        carry = torch.zeros((), device=dev)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(iters):
            lin, clu = step(model, img + carry * 1e-9, label)
            s = lin.sum() + clu.sum()
            total = total + s
            carry = carry + s.float() * 1e-9
        return total

    def measure(img, label):
        """(device s, host s) per step, the chain's counts checked."""
        want = 2 * iters * int(((label >= 0) & (label < 27)).sum())

        def check(total):
            if int(total) != want:
                raise AssertionError(f"eval chain counted {int(total)} pixels, "
                                     f"the labels hold {want}")

        check(chain(img, label))  # warm-up
        d, h = _median3(lambda: chain(img, label), dev, check)
        return d / iters, h / iters

    img, label = make_batch(batch)
    chain(img, label)  # first run: kernel builds, allocator, cuDNN choices
    attention.KERNEL.launches = 0
    dt, ht = measure(img, label)
    launches = attention.KERNEL.launches / (4 * iters)
    frag: dict = {"value": round(batch / dt, 2), "host_img_per_sec": round(batch / ht, 2),
                  "rtt_ms": round(rtt * 1e3, 3), "k1_launches_per_step": launches}
    if not full:
        return frag

    sweep = {batch: frag["value"]}
    for bsz in sizes["sweep"]:
        dt_b, _ = measure(*make_batch(bsz))
        sweep[bsz] = round(bsz / dt_b, 2)

    with torch.inference_mode():
        flops = step_flops(step, model, img, label)

    # pipelined: K independent steps over resident batches, one dependent fetch
    n_res, k_steps = sizes["resident"], sizes["pipelined"]
    resident = [make_batch(batch)[0] for _ in range(n_res)]

    @torch.inference_mode()
    def pipelined_run():
        acc = None
        for k in range(k_steps):
            s = sum(b.sum() for b in step(model, resident[k % n_res], label))
            acc = s if acc is None else acc + s
        return int(acc)

    pipelined_run()
    dt_p = _median3(pipelined_run, dev)[0] / k_steps

    tflops = flops / dt / 1e12 if dev.type == "cuda" else None
    frag.update({
        "pipelined_img_per_sec": round(batch / dt_p, 2),
        "batch_sweep_img_per_sec": {str(k): v for k, v in sweep.items()},
        "eval_step_flops": flops,
        "eval_tflops_per_sec": None if tflops is None else round(tflops, 2),
        "eval_hw_util": None if tflops is None else round(tflops / H100_BF16_PEAK_TFLOPS, 4),
    })
    return frag


def phase_train(dev) -> dict:
    _maybe_fault("train:default")
    import torch

    from depthg_tpu_torch.ops import attention
    from depthg_tpu_torch.train import step as step_lib
    from depthg_tpu_torch.utils.profiling import step_flops

    sizes = train_sizes()
    res, batch, iters = sizes["res"], sizes["batch"], sizes["iters"]
    fcfg, hps, lcfg, w, shift = _train_setup()
    gen = torch.Generator(device=dev).manual_seed(0)
    tb = {
        "img": torch.randn(batch, 3, res, res, device=dev, generator=gen),
        "img_pos": torch.randn(batch, 3, res, res, device=dev, generator=gen),
        "label": torch.randint(-1, 27, (batch, res, res), device=dev, generator=gen),
        "depth": torch.rand(batch, 1, res, res, device=dev, generator=gen),
        "depth_pos": torch.rand(batch, 1, res, res, device=dev, generator=gen),
    }

    def arm(hp):
        """Device seconds per step of ``iters`` dependent steps, K1
        launches per step and the operations of one step."""
        state = step_lib.init_state(fcfg, hp, torch.Generator().manual_seed(0), device=dev)

        def loop():
            tot = torch.zeros((), device=dev)
            for _ in range(iters):
                # the carried loss moves the float inputs: no step sees an
                # input the one before it saw, and no step is independent
                b2 = {k: v + (tot * 1e-12).to(v.dtype) if v.is_floating_point() else v
                      for k, v in tb.items()}
                logs = step_lib.train_step(state, b2, hp, lcfg, w, shift, generator=gen)
                tot = tot + logs["loss/total"].float()
            return tot

        def check(tot):
            if not torch.isfinite(tot):
                raise AssertionError(f"train chain ({hp.backbone_dtype}): loss {float(tot)}")

        check(loop())  # warm-up
        attention.KERNEL.launches = 0
        d = _median3(loop, dev, check)[0]
        launches = attention.KERNEL.launches / (3 * iters)
        flops = step_flops(step_lib.train_step, state, tb, hp, lcfg, w, shift, generator=gen)
        return d / iters, launches, flops

    dt_t, l_t, _ = arm(hps["float32"])
    dt_tb, l_tb, flops = arm(hps["bfloat16"])
    dt_i8, l_i8, _ = arm(hps["int8"])
    tflops = flops / dt_tb / 1e12 if dev.type == "cuda" else None
    return {
        "train_step_ms_b16": round(dt_tb * 1e3, 3),
        "train_img_per_sec": round(batch / dt_tb, 2),
        "train_step_ms_b16_f32_backbone": round(dt_t * 1e3, 3),
        "train_img_per_sec_f32_backbone": round(batch / dt_t, 2),
        "train_step_ms_b16_int8_backbone": round(dt_i8 * 1e3, 3),
        "train_img_per_sec_int8_backbone": round(batch / dt_i8, 2),
        "train_k1_launches_per_step": {"bfloat16": l_tb, "float32": l_t, "int8": l_i8},
        "train_step_flops": flops,
        "train_tflops_per_sec": None if tflops is None else round(tflops, 2),
        "train_hw_util": None if tflops is None else round(tflops / H100_BF16_PEAK_TFLOPS, 4),
    }


def phase_io(dev) -> dict:
    _maybe_fault("io:default")
    import numpy as np
    import torch

    from depthg_tpu_torch.runtime import to_device

    sizes = io_sizes()
    rng = np.random.default_rng(0)
    host_img = rng.standard_normal((sizes["batch"], 3, sizes["res"], sizes["res"])).astype(
        np.float32)

    def put():
        y = to_device(host_img, dev)
        y.view(-1)[:1] * 1.0  # a kernel that depends on the transferred buffer
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    put()
    put_t = _median3(put, dev)[1]
    return {
        "host_to_device_mb_per_sec": round(host_img.nbytes / 1e6 / put_t, 1),
        "device_put_latency_ms": round(put_t * 1e3, 3),
    }


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

def _run_child(args: list, device: str, timeout_s: float):
    """Run one measurement phase in a subprocess. Returns (rc, frag|None,
    stderr_tail). A fault kills only the child."""
    cmd = [sys.executable, "-m", "depthg_tpu_torch.bench", *args, "--device", device]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (PKG_ROOT, env.get("PYTHONPATH")) if p)
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        return -1, None, f"timeout after {timeout_s:.0f}s"
    frag = None
    for line in reversed(r.stdout.strip().splitlines()):
        if line.startswith("{"):
            try:
                frag = json.loads(line)
            except json.JSONDecodeError:
                pass
            break
    tail = " | ".join(r.stderr.strip().splitlines()[-3:])[:500]
    return r.returncode, frag, tail


def orchestrate(device: str) -> int:
    from depthg_tpu_torch.runtime import get_device

    out = {
        "metric": "eval_images_per_sec_per_chip_cocostuff27_320px_crf",
        "value": None, "unit": "images/sec", "vs_baseline": None,
        "baseline_estimate_img_per_sec": BASELINE_IMG_PER_SEC_EST,
    }
    try:
        dev = get_device(device)
    except (RuntimeError, ValueError) as e:
        print(json.dumps({**out, "error": str(e)}))
        return 1
    out["device"] = _card(dev)

    child_timeout = float(os.environ.get(
        "BENCH_PHASE_TIMEOUT_S", "300" if SMOKE else "2700"))
    # every operating point measured every run; the first surviving point in
    # EVAL_POINTS order that may head on this device is the headline and gets
    # the full measurement set
    reasons = []
    points: dict = {}
    launches: dict = {}
    for point in EVAL_POINTS:
        may_head = heads_on(point, dev.type)
        is_headline = out["value"] is None and may_head
        print(f"bench: eval point '{point}'" + (" [headline]" if is_headline else ""),
              file=sys.stderr, flush=True)
        args = ["--phase", "eval", "--point", point]
        if is_headline:
            args.append("--full")
        rc, frag, tail = _run_child(args, device, child_timeout)
        if rc == 0 and frag and frag.get("value") is not None:
            if may_head and dev.type == "cuda" and not frag["k1_launches_per_step"]:
                # a kernel point that ran the plain attention is a fault
                reasons.append(f"{point}: no attention-kernel launch on the card")
                continue
            points[point] = frag["value"]
            launches[point] = frag["k1_launches_per_step"]
            if is_headline:
                out.update({k: v for k, v in frag.items() if k != "k1_launches_per_step"})
                out["operating_point"] = point
            continue
        reasons.append(f"{point}: rc={rc} {tail}".strip())
    if out["value"] is None and dev.type == "cuda":
        reasons.append("no point through the attention kernel was measured: no headline")
    out["points_img_per_sec"] = points
    out["k1_launches_per_step"] = launches
    if reasons:
        out["eval_fallback_reason"] = reasons

    rc, frag, tail = _run_child(["--phase", "io"], device, min(child_timeout, 600))
    if rc == 0 and frag:
        out.update(frag)
    else:
        out["io_error"] = f"rc={rc} {tail}".strip()

    rc, frag, tail = _run_child(["--phase", "train"], device, child_timeout)
    if rc == 0 and frag:
        out.update(frag)
    else:
        out["train_error"] = f"rc={rc} {tail}".strip()

    if out["value"] is not None:
        out["vs_baseline"] = round(out["value"] / BASELINE_IMG_PER_SEC_EST, 2)
    print(json.dumps(out))
    return 0 if out["value"] is not None else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=["all", "eval", "train", "io"], default="all")
    ap.add_argument("--point", choices=list(EVAL_POINTS), default="default")
    ap.add_argument("--full", action="store_true",
                    help="headline point: add sweep/pipelined/utilization")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.phase == "all":
        raise SystemExit(orchestrate(args.device))
    from depthg_tpu_torch.runtime import get_device

    dev = get_device(args.device)
    frag = {"eval": lambda: phase_eval(args.point, dev, args.full),
            "train": lambda: phase_train(dev), "io": lambda: phase_io(dev)}[args.phase]()
    print(json.dumps(frag))


if __name__ == "__main__":
    main()
