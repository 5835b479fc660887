"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero before the
final line):

1. device: CUDA required; card name and power limit; TF32 off;
2. build: nvcc builds ``depthg_tpu_torch/csrc/attention.cu``;
3. attention kernel vs ``attention_plain`` at the ViT-S/8 eval shape
   (B=16, N=1601, 6 heads x 64, packed qkv) in bf16 and f32, plus
   n_valid=1601 inside N=1664: max abs and relative error, exact-zero
   padded rows, masked keys without influence, CUDA-event times of kernel and plain;
4. CRF precision: the int8 bilateral cache of a 320 px scene built on the
   card vs float64 on the CPU, then the default-point CRF on the six
   fidelity scenes of ``scripts/crf_fidelity_study.py`` (mIoU, accuracy);
5. main path: full-width ViT-S/8 at 320 px with random weights from a
   fixed generator, ``make_eval_step`` at the default point (bf16 backbone,
   bf16 CRF state), batch 16, one warm-up and three timed batches; launch
   count, confusion sums, img/s; then one image in float32 on the card vs
   the CPU (plain path) for pixel agreement;
6. the kernels JSON line, the card line and the final JSON line.
"""

import copy
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B, N, HEADS, DIM = 16, 1601, 6, 384
SCALE = 64 ** -0.5
# kernel vs plain: dtype -> (max abs error, relative error ||out-ref||/||ref||).
# Outputs here average ~600 keys (~0.04, max ~0.3), so a max-abs limit alone
# cannot see a kernel that is off by a few percent; bf16 rounding of P and of
# the output gives a relative error near 3e-3, such a bug 2e-2 and more.
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 5e-3)}
CRF_REF = (69.67, 84.08)  # docs/CRF_FIDELITY.md:33 (mIoU, accuracy), +-0.2


def phase(name, **values):
    print(json.dumps({"phase": name, **values}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_time_ms(fn, inputs, iters=30, warmup=10):
    """Mean ms per call over ``iters`` calls cycling through perturbed
    ``inputs``, after ``warmup`` calls (the card leaves its idle clocks);
    every output is consumed into a checksum."""
    check = torch.zeros((), device="cuda")
    for i in range(warmup):
        check += fn(inputs[i % len(inputs)]).float().flatten()[0]
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        check += fn(inputs[i % len(inputs)]).float().flatten()[-1]
    stop.record()
    torch.cuda.synchronize()
    if not torch.isfinite(check):
        raise AssertionError("non-finite attention output while timing")
    return start.elapsed_time(stop) / iters


def compare(out, ref, dtype, what):
    """(max abs error, relative error) of ``out`` vs ``ref``; raises past TOL."""
    diff = out.float() - ref.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / ref.float().norm()).item()
    if not (err <= TOL[dtype][0] and rel <= TOL[dtype][1]):
        raise AssertionError(f"{what} {dtype}: max abs err {err}, relative err "
                             f"{rel}; limits {TOL[dtype]}")
    return err, rel


def attention_phase(att, gen):
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        base = torch.randn(B, N, 3 * DIM, device="cuda", generator=gen)
        inputs = [(base + 1e-2 * i).to(dtype) for i in range(3)]
        out = att.attention_qkv(inputs[0], HEADS, SCALE)
        q, k, v = att.split_qkv(inputs[0], HEADS)
        ref = att.attention_plain(q, k, v, SCALE).permute(0, 2, 1, 3).reshape(B, N, DIM)
        torch.cuda.synchronize()
        err, rel = compare(out, ref, dtype, "attention")

        # n_valid=1601 inside N=1664: padded rows exactly 0, keys past
        # n_valid without influence (set to inf there)
        pad = torch.zeros(B, 1664, 3 * DIM, device="cuda", dtype=dtype)
        pad[:, :N] = inputs[0]
        out_pad = att.attention_qkv(pad, HEADS, SCALE, N)
        pad[:, N:] = float("inf")
        out_inf = att.attention_qkv(pad, HEADS, SCALE, N)
        torch.cuda.synchronize()
        if not torch.all(out_pad[:, N:] == 0):
            raise AssertionError("padded query rows are not exactly 0")
        if not torch.equal(out_inf, out_pad):
            raise AssertionError("keys past n_valid changed the output")
        pad_err, pad_rel = compare(out_pad[:, :N], ref, dtype, "padded attention")

        def plain(x):
            q, k, v = att.split_qkv(x, HEADS)
            return att.attention_plain(q, k, v, SCALE)

        ms = cuda_time_ms(lambda x: att.attention_qkv(x, HEADS, SCALE), inputs)
        plain_ms = cuda_time_ms(plain, inputs)
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        results[name] = {"max_abs_err": err, "rel_err": rel,
                         "padded_max_abs_err": pad_err, "padded_rel_err": pad_rel,
                         "ms": ms, "plain_ms": plain_ms}
        phase("attention", dtype=name, shape=[B, N, HEADS, 64], **results[name])
        del base, inputs, ref, out, pad, out_pad, out_inf
        torch.cuda.empty_cache()
    return results


def crf_phase(fidelity, crf):
    import numpy as np

    ccfg = crf.crf_config_from_cfg({})
    image = fidelity.make_scene(320, 27, seed=0)[0]
    phases = crf._jbu_phases(ccfg, 320, 320)
    _, _, kmat = crf._jbu_operator(torch.from_numpy(image)[None].cuda(), ccfg, 8,
                                   torch.bfloat16, phases)
    feats = []
    for oy, ox in phases:
        ys, xs = np.meshgrid(np.arange(40) * 8 + oy, np.arange(40) * 8 + ox,
                             indexing="ij")
        f = np.concatenate([xs[None] / ccfg.bi_xy_std, ys[None] / ccfg.bi_xy_std,
                            image[:, oy::8, ox::8].astype(np.float64) / ccfg.bi_rgb_std])
        feats.append(f.reshape(5, -1).T)
    f = torch.from_numpy(np.concatenate(feats))  # float64 on the CPU
    sq = (f * f).sum(1)
    k64 = torch.round(torch.exp(f @ f.T - 0.5 * sq[:, None] - 0.5 * sq[None]) * 127)
    cache_diff = (kmat[0].cpu().double() - k64).abs().max().item()
    if not cache_diff <= 1:
        raise AssertionError(f"int8 cache differs from float64 by {cache_diff}")
    phase("crf_cache", points=int(f.shape[0]), max_step_diff=cache_diff)

    scenes = [fidelity.make_scene(320, 27, seed=i) for i in range(6)]
    imgs = torch.from_numpy(np.stack([s[0] for s in scenes])).cuda()
    lgs = torch.from_numpy(np.stack([s[2] for s in scenes])).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = crf.dense_crf_multi_batch(imgs, [lgs], ccfg)[0]
    preds = q.argmax(1).cpu().numpy()
    crf_s = time.perf_counter() - t0
    miou, acc = np.mean([fidelity.miou_acc(p, s[1], 27)
                         for p, s in zip(preds, scenes)], axis=0)
    ok = abs(miou - CRF_REF[0]) <= 0.2 and abs(acc - CRF_REF[1]) <= 0.2
    phase("crf_fidelity", miou=float(miou), accuracy=float(acc),
          jax_row=list(CRF_REF), seconds_6_images_first_call=crf_s)
    if not ok:
        raise AssertionError(f"CRF fidelity {miou:.2f}/{acc:.2f} not within 0.2 "
                             f"of {CRF_REF}")


def main_path_phase(att, inference, vit_lib, featurizer, crf, gen):
    fcfg = featurizer.FeaturizerConfig()  # vit_small, patch 8, dim 70
    cpu_gen = torch.Generator().manual_seed(0)
    model_cpu = inference.Segmenter(fcfg, 27, 27).init_weights(cpu_gen)
    model = copy.deepcopy(model_cpu).cuda()
    ecfg = inference.EvalConfig(n_classes=27, crf=crf.crf_config_from_cfg({}),
                                backbone_dtype="bfloat16")
    step = inference.make_eval_step(ecfg)

    low = torch.rand(B, 3, 40, 40, device="cuda", generator=gen)
    base = torch.nn.functional.interpolate(low, size=(320, 320), mode="bilinear")
    labels = torch.randint(-1, 27, (B, 320, 320), device="cuda", generator=gen)
    batches = [((base + 0.02 * i - 0.45) / 0.226, labels.roll(i, dims=-1))
               for i in range(4)]  # warm-up + 3 timed

    att.KERNEL.launches = 0
    stats = [step(model, *batches[0])]
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for img, label in batches[1:]:
        stats.append(step(model, img, label))
    stop.record()
    torch.cuda.synchronize()
    launches = att.KERNEL.launches
    img_s = 3 * B / (start.elapsed_time(stop) / 1e3)

    expected = vit_lib.VIT_PRESETS["vit_small"]["depth"] * 2 * len(batches)
    if launches != expected:
        raise AssertionError(f"attention launches {launches} != {expected}")
    for (img, label), (lin, clu) in zip(batches, stats):
        counted = int(((label >= 0) & (label < 27)).sum())
        for s in (lin, clu):
            if int(s.sum()) != counted or s.shape != (27, 27):
                raise AssertionError(f"confusion sums {int(s.sum())} != {counted}")
    phase("main_path", batch=B, res=320, batches_timed=3, img_per_s=img_s,
          attention_launches=launches, expected_launches=expected,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)

    # one image in float32: kernel on the card vs plain path on the CPU
    e32 = inference.EvalConfig(
        n_classes=27, backbone_dtype="float32",
        crf=crf.crf_config_from_cfg({"crf_dtype": "float32"}))
    predict = inference.make_predict_step(e32)
    img = batches[0][0][:1]
    before = att.KERNEL.launches
    on_card = [p.cpu() for p in predict(model, img)]
    if att.KERNEL.launches != before + 24:
        raise AssertionError("the float32 card run did not go through the kernel")
    on_cpu = predict(model_cpu, img.cpu())
    agree = [float((a == b).float().mean()) for a, b in zip(on_card, on_cpu)]
    phase("f32_card_vs_cpu", linear_agreement=agree[0], cluster_agreement=agree[1])
    if min(agree) < 0.995:
        raise AssertionError(f"card vs CPU prediction agreement {agree} < 99.5%")
    return {"img_per_s": img_s, "launches": launches, "agreement": agree}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import importlib.util

    import depthg_tpu_torch
    from depthg_tpu_torch import inference, runtime
    from depthg_tpu_torch.models import featurizer
    from depthg_tpu_torch.models import vit as vit_lib
    from depthg_tpu_torch.ops import _build, crf
    from depthg_tpu_torch.ops import attention as att

    spec = importlib.util.spec_from_file_location(
        "crf_fidelity_study", os.path.join(ROOT, "scripts", "crf_fidelity_study.py"))
    fidelity = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fidelity)

    card = card_line()
    depthg_tpu_torch.get_device("cuda")
    if not runtime.tf32_off():
        raise AssertionError("TF32 is on")
    phase("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
          gpu=torch.cuda.get_device_name(0), tf32_off=True)

    att.KERNEL.fn()
    phase("build", source="depthg_tpu_torch/csrc/attention.cu",
          seconds=_build.BUILD_SECONDS["attention"],
          ptxas=[ln.strip() for ln in _build.BUILD_LOG.get("attention", "").splitlines()
                 if "registers" in ln or "spill" in ln])

    gen = torch.Generator(device="cuda").manual_seed(0)
    attn = attention_phase(att, gen)
    crf_phase(fidelity, crf)
    main_res = main_path_phase(att, inference, vit_lib, featurizer, crf, gen)

    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "depthg_tpu.")) or m == "depthg_tpu")
    if loaded:
        raise AssertionError(f"chip_smoke imported the JAX package or JAX: {loaded}")

    kernels = {"kernels": [{
        "name": "attention", "route": "cuda",
        "source": "depthg_tpu_torch/csrc/attention.cu",
        "replaces": "depthg_tpu/ops/attention.py:144",
        "also_replaces": ["depthg_tpu/ops/attention.py:205",
                          "depthg_tpu/models/vit.py:160"],
        "launches": main_res["launches"],
        "max_abs_err": attn["bf16"]["max_abs_err"],
        "rel_err": attn["bf16"]["rel_err"],
        "ms": attn["bf16"]["ms"], "plain_ms": attn["bf16"]["plain_ms"],
        "f32_max_abs_err": attn["f32"]["max_abs_err"],
        "f32_rel_err": attn["f32"]["rel_err"],
        "f32_ms": attn["f32"]["ms"], "f32_plain_ms": attn["f32"]["plain_ms"],
    }]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
