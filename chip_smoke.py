"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero before the
final line):

1. device: CUDA required; card name and power limit; TF32 off;
2. build: nvcc builds ``depthg_tpu_torch/csrc/attention.cu`` and
   ``csrc/crf_bilateral.cu``, one process each, started together;
3. attention kernel vs ``attention_plain`` at the ViT-S/8 eval shape
   (B=16, N=1601, 6 heads x 64, packed qkv) in bf16 and f32, plus
   n_valid=1601 inside N=1664: max abs and relative error, exact-zero
   padded rows, masked keys without influence, CUDA-event times of kernel
   and plain; in bf16 also the kernel alone on preallocated views, one
   PyTorch ``scaled_dot_product_attention`` call on the same views as the
   library yardstick (the package never calls it), the host time of a
   launch and the kernel's bound from the shapes;
4. bilateral kernel (K4) vs ``bilateral_message_plain`` on the features of
   two fidelity scenes: N=25,600 (ds=2), C=54, B=2 in f32 and bf16, a
   ragged N=25,563 read through views of a NaN-padded buffer, and the
   exact CRF's N=102,400 at the shapes its paths launch: B=2, C=54 in f32
   and bf16 (the eval step), its degree (the degree entry, and the f32
   C=1 message on ones) and the fidelity row's f32 C=27, plus bf16 at
   B=2, C=27 and at B=1, C=54 and 27 (one image, one or both probes);
   relative and max abs error, CUDA-event times of kernel and plain, in
   bf16 the kernel alone on a preallocated output, and the bounds from the
   shapes;
5. CRF precision: the int8 bilateral cache of a 320 px scene built on the
   card vs float64 on the CPU, then the CRF on the six fidelity scenes of
   ``scripts/crf_fidelity_study.py`` (mIoU, accuracy) at the default point
   and at the rows exact (ds=1, through K4), ds=2 legacy, ds=4 mixed bf16
   (``safe``) and quality+, each within 0.2 of its ``docs/CRF_FIDELITY.md``
   row;
6. main path: full-width ViT-S/8 at 320 px with random weights from a
   fixed generator, ``make_eval_step`` at the default point (bf16 backbone,
   bf16 CRF state), batch 16, one warm-up and three timed batches; launch
   counts, confusion sums, img/s; then one image in float32 on the card vs
   the CPU (plain path) for pixel agreement; then the same step at
   ``crf_downsample=1`` (batch 2, 11 K4 launches per batch) and at
   ``operating_point=safe`` (batch 16);
7. the total time, the kernels JSON line, the card line and the final JSON line.
"""

import copy
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
B, N, HEADS, DIM = 16, 1601, 6, 384
SCALE = 64 ** -0.5
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): bf16 tensor
# cores, float32 outside them (an FMA counts 2, so 33.5e12 instructions/s:
# 128 lanes x 132 SMs x ~1.98 GHz), HBM3
PEAK_BF16, PEAK_F32, PEAK_HBM = 989e12, 67e12, 3.35e12
SMS = 132
# kernel vs plain: dtype -> (max abs error, relative error ||out-ref||/||ref||).
# Outputs here average ~600 keys (~0.04, max ~0.3), so a max-abs limit alone
# cannot see a kernel that is off by a few percent; bf16 rounding of P and of
# the output gives a relative error near 3e-3, such a bug 2e-2 and more.
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 5e-3)}
CRF_REF = (69.67, 84.08)  # docs/CRF_FIDELITY.md:33 (mIoU, accuracy), +-0.2
# K4 vs plain: dtype -> (relative error, max abs error / max |ref|), as in
# tests/test_torch_cuda.py; in bf16 both sides round float32 sums to bf16
# and may land one bf16 step (<= 2^-7 of the value) apart. At
# N=102,400 the f32 kernel's sequential sum over the keys and cuBLAS's
# order in the plain version part by ~sqrt(N) float32 roundings: 5e-5.
K4_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (5e-3, 1e-2)}
K4_TOL_EXACT = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (5e-3, 1e-2)}
# fidelity rows run besides the default: (name in the port's study, K4
# launches per run: the exact CRF streams, the others cache)
FIDELITY_ROWS = [("exact (ds=1)", 11), ("ds=2 legacy", 0), ("ds=4 mixed bf16", 0),
                 ("ds=4 jbu2 sf1.41 bf16 (quality+)", 0)]


def phase(name, **values):
    print(json.dumps({"phase": name, **values}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_time_ms(fn, inputs, iters=30, warmup=10):
    """Mean ms per call over ``iters`` back-to-back calls cycling through
    perturbed ``inputs``, after ``warmup`` calls (the card leaves its idle
    clocks); nothing but the calls runs between the two events, and the last
    output is checked to be finite."""
    for i in range(warmup):
        out = fn(inputs[i % len(inputs)])
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        out = fn(inputs[i % len(inputs)])
    stop.record()
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError("non-finite kernel output while timing")
    return start.elapsed_time(stop) / iters


def sm_clock_mhz() -> float:
    """The SM clock ``nvidia-smi`` reports right now (call it under load)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0])


def attention_bound(b, n, h):
    """Least ms the card could take for one attention call: q, k, v read and
    o written once over the memory rate, or 4 B H N^2 64 operations over the
    bf16 tensor-core peak, whichever is larger."""
    bytes_ms = 4 * b * h * n * 64 * 2 / PEAK_HBM * 1e3
    ops_ms = 4.0 * b * h * n * n * 64 / PEAK_BF16 * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations"


def bilateral_bound(b, n, c, itemsize):
    """Least ms for one message: feats and values read, the output written
    once, or the N^2 entries' 10 float32 instructions (5 subtractions, 5 FMAs;
    the float32 peak counts an FMA as 2) beside their 2 C N^2 tensor-core
    operations, whichever is largest."""
    entries = float(b) * n * n
    bytes_ms = b * n * (20 + 2 * c * itemsize) / PEAK_HBM * 1e3
    ops_ms = max(entries * 10 / (PEAK_F32 / 2), entries * 2 * c / PEAK_BF16) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations"


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
        plain_ms = cuda_time_ms(plain, inputs, iters=5, warmup=2)
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        results[name] = {"max_abs_err": err, "rel_err": rel,
                         "padded_max_abs_err": pad_err, "padded_rel_err": pad_rel,
                         "ms": ms, "plain_ms": plain_ms}
        if dtype == torch.bfloat16:
            results[name].update(attention_yardsticks(att, inputs))
        phase("attention", dtype=name, shape=[B, N, HEADS, 64], **results[name])
        del base, inputs, ref, out, pad, out_pad, out_inf
        torch.cuda.empty_cache()
    return results


def attention_yardsticks(att, inputs):
    """bf16 at the eval shape: the kernel alone on a preallocated output,
    the library call, the host time of a launch (its three tensor maps
    included) and the bound."""
    out = torch.empty(B, N, HEADS, 64, device="cuda", dtype=torch.bfloat16).permute(0, 2, 1, 3)

    def launch(x):
        q, k, v = att.split_qkv(x, HEADS)
        return att._launch(q, k, v, out, SCALE, N)

    def library(x):
        q, k, v = att.split_qkv(x, HEADS)
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=SCALE)

    kernel_ms = cuda_time_ms(launch, inputs, iters=50)
    library_ms = cuda_time_ms(library, inputs, iters=50)
    clock = sm_clock_mhz()
    q, k, v = att.split_qkv(inputs[0], HEADS)
    ref = library(inputs[0]).float()
    lib_rel = ((launch(inputs[0]).float() - ref).norm() / ref.norm()).item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        att._launch(q, k, v, out, SCALE, N)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    bound_ms, bound_by = attention_bound(B, N, HEADS)
    return {"kernel_only_ms": kernel_ms, "library_ms": library_ms, "rel_err_vs_library": lib_rel,
            "host_us_per_launch": host_us, "bound_ms": bound_ms, "bound_by": bound_by,
            "ex2_bound_ms": B * HEADS * N * N / (16 * SMS * clock * 1e6) * 1e3,
            "sm_clock_mhz": clock}


def bilateral_phase(bil, crf, fidelity):
    """K4 against its plain version on the CRF's own features, at every
    shape the main path and the exact fidelity row launch."""
    import numpy as np

    from depthg_tpu_torch.ops.resize import resize_bilinear

    def scene_feats(ds, seeds):
        ccfg = crf.CRFConfig(downsample=ds)
        imgs = torch.from_numpy(np.stack([fidelity.make_scene(320, 27, seed=s)[0]
                                          for s in seeds])).cuda()
        if ds > 1:
            imgs = resize_bilinear(imgs, (320 // ds, 320 // ds))
        return crf._bilateral_features(imgs, ccfg, ds)

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    # (label, ds, scenes, C, dtypes, values all ones, limits, timed calls of
    # kernel and plain)
    for label, ds, seeds, c, dtypes, ones, tol, iters in (
            ("n25600", 2, (0, 1), 54, (torch.float32, torch.bfloat16), False,
             K4_TOL, (20, 5)),
            # the eval step at ds=1: batch 2, both probes, and its degree
            ("n102400", 1, (0, 1), 54, (torch.float32, torch.bfloat16), False,
             K4_TOL_EXACT, (5, 2)),
            ("n102400_degree", 1, (0, 1), 1, (torch.float32,), True,
             K4_TOL_EXACT, (3, 2)),
            # the exact fidelity row: one probe of 27 classes in float32
            ("n102400_c27", 1, (0,), 27, (torch.float32,), False,
             K4_TOL_EXACT, (3, 1)),
            # bf16 at the other batch and probe counts an exact eval can take
            ("n102400_b2_c27", 1, (0, 1), 27, (torch.bfloat16,), False,
             K4_TOL_EXACT, (3, 1)),
            ("n102400_b1_c54", 1, (0,), 54, (torch.bfloat16,), False,
             K4_TOL_EXACT, (3, 1)),
            ("n102400_b1_c27", 1, (0,), 27, (torch.bfloat16,), False,
             K4_TOL_EXACT, (3, 1))):
        feats = scene_feats(ds, seeds)
        b, n, _ = feats.shape
        for dtype in dtypes:
            base = (torch.ones(b, n, c, device="cuda") if ones
                    else torch.rand(b, n, c, device="cuda", generator=gen))
            inputs = [(base * (1 - 0.05 * i)).to(dtype) for i in range(3)]
            out = bil.bilateral_message(feats, inputs[0])
            ref = bil.bilateral_message_plain(feats, inputs[0])
            torch.cuda.synchronize()
            rel, err = k4_errors(out, ref, tol[dtype], f"bilateral {label}")
            row = {"rel_err": rel, "max_abs_err": err,
                   "max_abs_ref": ref.float().abs().max().item()}
            if label == "n25600":
                # ragged N=25,563 through views of a buffer that is NaN past it
                nr = n - 37
                fbuf, vbuf = feats.clone(), inputs[0].clone()
                rag_ref = bil.bilateral_message_plain(fbuf[:, :nr].contiguous(),
                                                      vbuf[:, :nr].contiguous())
                fbuf[:, nr:], vbuf[:, nr:] = float("nan"), float("nan")
                obuf = torch.full_like(vbuf, 7.0)
                bil._launch(fbuf[:, :nr], vbuf[:, :nr], obuf[:, :nr])
                torch.cuda.synchronize()
                if not torch.all(obuf[:, nr:] == 7.0):
                    raise AssertionError("the bilateral kernel wrote rows past N")
                row["ragged_rel_err"], row["ragged_max_abs_err"] = k4_errors(
                    obuf[:, :nr], rag_ref, tol[dtype], f"bilateral ragged N={nr}")
                del fbuf, vbuf, obuf, rag_ref
            row["ms"] = cuda_time_ms(lambda v: bil.bilateral_message(feats, v), inputs,
                                     iters=iters[0], warmup=3)
            row["plain_ms"] = cuda_time_ms(
                lambda v: bil.bilateral_message_plain(feats, v), inputs,
                iters=iters[1], warmup=1)
            row["bound_ms"], row["bound_by"] = bilateral_bound(b, n, c, inputs[0].element_size())
            if dtype == torch.bfloat16:
                # the kernel alone: no allocation of the output
                obuf = torch.empty_like(inputs[0])
                row["kernel_only_ms"] = cuda_time_ms(
                    lambda v: bil._launch(feats, v, obuf), inputs, iters=iters[0], warmup=2)
                row["sm_clock_mhz"] = sm_clock_mhz()
                row["ex2_bound_ms"] = float(b) * n * n / (16 * SMS * row["sm_clock_mhz"] * 1e6) * 1e3
            if ones:
                # the degree entry (what the CRF calls) on the same features
                deg = bil.bilateral_degree(feats)
                torch.cuda.synchronize()
                drel, derr = k4_errors(deg, ref, tol[dtype], "bilateral degree entry")
                row.update(degree_entry_rel_err=drel, degree_entry_max_abs_err=derr,
                           degree_entry_ms=cuda_time_ms(
                               lambda v: bil.bilateral_degree(feats), inputs, iters=5, warmup=2),
                           degree_entry_bound_ms=bilateral_bound(b, n, 0, 4)[0])
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            results[f"{label}_{name}"] = row
            phase("crf_bilateral", case=label, dtype=name, shape=[b, n, c], **row)
            del base, inputs, out, ref
        torch.cuda.empty_cache()
    return results


def k4_errors(out, ref, limits, what):
    """(relative error, max abs error) of K4 vs plain; raises past ``limits``
    = (relative, max abs / max |ref|)."""
    diff = out.float() - ref.float()
    rel = (diff.norm() / ref.float().norm()).item()
    err = diff.abs().max().item()
    top = ref.float().abs().max().item()
    if not (rel <= limits[0] and err <= limits[1] * top):
        raise AssertionError(f"{what} {out.dtype}: relative err {rel}, max abs err "
                             f"{err} (max |ref| {top}); limits {limits}")
    return rel, err


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


def fidelity_rows_phase(study, bil):
    """The fidelity study's rows away from the default point: the exact CRF
    streams through K4 (11 launches per run), the others cache."""
    rows = {}
    for name, k4_per_run in FIDELITY_ROWS:
        bil.KERNEL.launches = 0
        (row,) = [r for r in study.run_rows([name], reps=1) if r["name"] == name]
        launches = bil.KERNEL.launches
        ref = row["jax"]
        phase("crf_fidelity_row", row=name, miou=row["miou"], accuracy=row["accuracy"],
              ms_per_image=row["ms_per_image"], jax_row=list(ref),
              k4_launches=launches)
        if launches != 2 * k4_per_run:  # the quality run and one timed run
            raise AssertionError(f"{name}: {launches} K4 launches, expected "
                                 f"{2 * k4_per_run}")
        if not (abs(row["miou"] - ref[0]) <= 0.2 and abs(row["accuracy"] - ref[1]) <= 0.2):
            raise AssertionError(f"{name}: {row['miou']:.2f}/{row['accuracy']:.2f} not "
                                 f"within 0.2 of {ref}")
        rows[name] = row
    return rows


def run_eval_batches(step, model, batches, att, bil):
    """Drive ``step`` over ``batches`` (the first one a warm-up), counts of
    both kernels set to 0 just before and read just after; returns
    (stats, img/s of the timed batches, attention launches, K4 launches)."""
    att.KERNEL.launches = 0
    bil.KERNEL.launches = 0
    stats = [step(model, *batches[0])]
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for img, label in batches[1:]:
        stats.append(step(model, img, label))
    stop.record()
    torch.cuda.synchronize()
    n_timed = sum(img.shape[0] for img, _ in batches[1:])
    img_s = n_timed / (start.elapsed_time(stop) / 1e3)
    for (img, label), (lin, clu) in zip(batches, stats):
        counted = int(((label >= 0) & (label < 27)).sum())
        for s in (lin, clu):
            if int(s.sum()) != counted or s.shape != (27, 27):
                raise AssertionError(f"confusion sums {int(s.sum())} != {counted}")
    return stats, img_s, att.KERNEL.launches, bil.KERNEL.launches


def make_batches(gen, b, n):
    low = torch.rand(b, 3, 40, 40, device="cuda", generator=gen)
    base = torch.nn.functional.interpolate(low, size=(320, 320), mode="bilinear")
    labels = torch.randint(-1, 27, (b, 320, 320), device="cuda", generator=gen)
    return [((base + 0.02 * i - 0.45) / 0.226, labels.roll(i, dims=-1))
            for i in range(n)]


def main_path_phase(att, bil, inference, vit_lib, featurizer, crf, gen):
    fcfg = featurizer.FeaturizerConfig()  # vit_small, patch 8, dim 70
    cpu_gen = torch.Generator().manual_seed(0)
    model_cpu = inference.Segmenter(fcfg, 27, 27).init_weights(cpu_gen)
    model = copy.deepcopy(model_cpu).cuda()
    ecfg = inference.EvalConfig(n_classes=27, crf=crf.crf_config_from_cfg({}),
                                backbone_dtype="bfloat16")
    step = inference.make_eval_step(ecfg)
    per_batch = vit_lib.VIT_PRESETS["vit_small"]["depth"] * 2

    batches = make_batches(gen, B, 4)  # warm-up + 3 timed
    torch.cuda.reset_peak_memory_stats()
    _, img_s, launches, k4 = run_eval_batches(step, model, batches, att, bil)
    expected = per_batch * len(batches)
    if launches != expected or k4 != 0:
        raise AssertionError(f"attention launches {launches} != {expected} or "
                             f"K4 launches {k4} != 0 at the default point")
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
    del batches
    torch.cuda.empty_cache()

    # the eval step away from the default point: the exact CRF (every
    # message through K4 in bf16, C = 27 + 27) and the safe point
    points = {}
    for name, cfg, b, n_batches, k4_per_batch in (
            ("exact_ds1", {"crf_downsample": 1}, 2, 3, 11),
            ("safe", crf.EVAL_OPERATING_POINTS["safe"], B, 4, 0)):
        ccfg = crf.crf_config_from_cfg(cfg)
        step = inference.make_eval_step(inference.EvalConfig(
            n_classes=27, crf=ccfg, backbone_dtype="bfloat16"))
        batches = make_batches(gen, b, n_batches)
        torch.cuda.reset_peak_memory_stats()
        _, pt_img_s, pt_att, pt_k4 = run_eval_batches(step, model, batches, att, bil)
        if pt_att != per_batch * n_batches or pt_k4 != k4_per_batch * n_batches:
            raise AssertionError(f"{name}: attention launches {pt_att}, K4 launches "
                                 f"{pt_k4}; expected {per_batch * n_batches} and "
                                 f"{k4_per_batch * n_batches}")
        points[name] = {"img_per_s": pt_img_s, "k4_launches": pt_k4}
        phase("main_path_point", point=name, cfg=cfg, batch=b,
              batches_timed=n_batches - 1, img_per_s=pt_img_s, attention_launches=pt_att,
              k4_launches=pt_k4, k4_launches_per_batch=pt_k4 / n_batches,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        del batches
        torch.cuda.empty_cache()
    return {"img_per_s": img_s, "launches": launches, "agreement": agree,
            "points": points}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import depthg_tpu_torch
    from depthg_tpu_torch import crf_fidelity_study as study
    from depthg_tpu_torch import inference, runtime
    from depthg_tpu_torch.models import featurizer
    from depthg_tpu_torch.models import vit as vit_lib
    from depthg_tpu_torch.ops import _build, crf
    from depthg_tpu_torch.ops import attention as att
    from depthg_tpu_torch.ops import crf_bilateral as bil

    fidelity = study.load_scenes_module()

    card = card_line()
    depthg_tpu_torch.get_device("cuda")
    if not runtime.tf32_off():
        raise AssertionError("TF32 is on")
    phase("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
          gpu=torch.cuda.get_device_name(0), tf32_off=True)

    t_build = time.perf_counter()
    _build.build(["attention", "crf_bilateral"])
    att.KERNEL.fn()
    bil.KERNEL.fn()
    for name in ("attention", "crf_bilateral"):
        phase("build", source=f"depthg_tpu_torch/csrc/{name}.cu",
              seconds=_build.BUILD_SECONDS[name],
              ptxas=[ln.strip() for ln in _build.BUILD_LOG.get(name, "").splitlines()
                     if "registers" in ln or "spill" in ln])
    phase("build_all", seconds=time.perf_counter() - t_build)

    gen = torch.Generator(device="cuda").manual_seed(0)
    attn = attention_phase(att, gen)
    k4 = bilateral_phase(bil, crf, fidelity)
    crf_phase(fidelity, crf)
    fidelity_rows_phase(study, bil)
    main_res = main_path_phase(att, bil, inference, vit_lib, featurizer, crf, gen)

    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "depthg_tpu.")) or m == "depthg_tpu")
    if loaded:
        raise AssertionError(f"chip_smoke imported the JAX package or JAX: {loaded}")

    k4_main = k4["n102400_bf16"]  # the exact eval step's launches: B=2, N=102,400, C=54
    kernels = {"kernels": [{
        "name": "attention", "route": "cuda",
        "source": "depthg_tpu_torch/csrc/attention.cu",
        "replaces": "depthg_tpu/ops/attention.py:144",
        "also_replaces": ["depthg_tpu/ops/attention.py:205",
                          "depthg_tpu/models/vit.py:160"],
        "shape": f"bf16, B={B}, N={N}, {HEADS} heads x 64, packed qkv",
        "launches": main_res["launches"],
        "max_abs_err": attn["bf16"]["max_abs_err"],
        "rel_err": attn["bf16"]["rel_err"],
        "ms": attn["bf16"]["ms"], "plain_ms": attn["bf16"]["plain_ms"],
        "bound_ms": attn["bf16"]["bound_ms"], "bound_by": attn["bf16"]["bound_by"],
        "library_ms": attn["bf16"]["library_ms"],
        "ex2_bound_ms": attn["bf16"]["ex2_bound_ms"],
        "kernel_only_ms": attn["bf16"]["kernel_only_ms"],
        "host_us_per_launch": attn["bf16"]["host_us_per_launch"],
        "f32_max_abs_err": attn["f32"]["max_abs_err"],
        "f32_rel_err": attn["f32"]["rel_err"],
        "f32_ms": attn["f32"]["ms"], "f32_plain_ms": attn["f32"]["plain_ms"],
    }, {
        "name": "crf_bilateral", "route": "cuda",
        "source": "depthg_tpu_torch/csrc/crf_bilateral.cu",
        "replaces": "depthg_tpu/ops/crf_pallas.py:66",
        "launches": main_res["points"]["exact_ds1"]["k4_launches"],
        "shape": "bf16, B=2, N=102400, C=54 (the exact eval step's message); "
                 "n25600: B=2, C=54; degree: B=2, N=102400",
        "max_abs_err": k4_main["max_abs_err"], "rel_err": k4_main["rel_err"],
        "ms": k4_main["ms"], "plain_ms": k4_main["plain_ms"],
        "bound_ms": k4_main["bound_ms"], "bound_by": k4_main["bound_by"],
        "library_ms": None,
        "ex2_bound_ms": k4_main["ex2_bound_ms"],
        "kernel_only_ms": k4_main["kernel_only_ms"],
        "b2_c27_ms": k4["n102400_b2_c27_bf16"]["kernel_only_ms"],
        "b1_c54_ms": k4["n102400_b1_c54_bf16"]["kernel_only_ms"],
        "b1_c27_ms": k4["n102400_b1_c27_bf16"]["kernel_only_ms"],
        "n102400_f32_ms": k4["n102400_f32"]["ms"],
        "n102400_f32_plain_ms": k4["n102400_f32"]["plain_ms"],
        "n25600_ms": k4["n25600_bf16"]["ms"],
        "n25600_plain_ms": k4["n25600_bf16"]["plain_ms"],
        "n25600_bound_ms": k4["n25600_bf16"]["bound_ms"],
        "n25600_max_abs_err": k4["n25600_bf16"]["max_abs_err"],
        "n25600_rel_err": k4["n25600_bf16"]["rel_err"],
        "n25600_f32_ms": k4["n25600_f32"]["ms"],
        "n25600_f32_plain_ms": k4["n25600_f32"]["plain_ms"],
        "n25600_f32_rel_err": k4["n25600_f32"]["rel_err"],
        "degree_ms": k4["n102400_degree_f32"]["degree_entry_ms"],
        "degree_rel_err": k4["n102400_degree_f32"]["degree_entry_rel_err"],
        "degree_bound_ms": k4["n102400_degree_f32"]["degree_entry_bound_ms"],
        "degree_plain_ms": k4["n102400_degree_f32"]["plain_ms"],
        "degree_as_f32_message_ms": k4["n102400_degree_f32"]["ms"],
    }]}
    phase("total", seconds=time.perf_counter() - T0)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
