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
   and plain; in both dtypes also the kernel alone on preallocated views, one
   PyTorch ``scaled_dot_product_attention`` call on the same views as the
   library yardstick (the package never calls it), both also queued behind
   a long product so that the events see the card's time and not the host's
   launch rate, the host time of a launch and the kernel's bound from the
   shapes (float32: the FMA pipes' bound, and beside it the split-TF32
   kernel's own, three TF32 products at the tensor peak); TF32 still off
   after the float32 runs; then the same comparison,
   times, library call and bound at the train step's shape (B=32, N=785:
   224 px, not a multiple of the kernel's 64-row sub-tile or 256-row block);
   then K1 with BEiT-L's relative-position bias at ZoeDepth's 384 x 512
   input (N=769, 16 heads x 64, the bias [16, 769, 769] built from a random
   table by the BEiT module's own builder, in the q dtype) at bf16 B=1, 8,
   16 and float32 B=2: kernel vs plain, the bias acting, +1e4 in the bias
   past n_valid=700 without influence, an odd row stride refused, times
   through ``attention_qkv``, queued and alone, without the bias, the
   library call with the bias as its ``attn_mask``, the plain version, and
   the bound with the bias bytes;
4. bilateral kernel (K4) vs ``bilateral_message_plain`` on the features of
   two fidelity scenes: N=25,600 (ds=2), C=54, B=2 in f32 and bf16, a
   ragged N=25,563 read through views of a NaN-padded buffer, and the
   exact CRF's N=102,400 at the shapes its paths launch: B=2, C=54 in f32
   and bf16 (the eval step), its degree (the degree entry, and the f32
   C=1 message on ones) and the fidelity row's f32 C=27, plus bf16 at
   B=2, C=27 and at B=1, C=54 and 27 (one image, one or both probes);
   relative and max abs error, CUDA-event times of kernel and plain, the
   kernel alone on a preallocated output, and the bounds from the shapes
   (float32: 10 + C FMA-pipe instructions per entry, and the split-TF32
   kernel's own bound beside it); TF32 still off;
5. CRF precision: the int8 bilateral cache of a 320 px scene built on the
   card vs float64 on the CPU, then the CRF on the six fidelity scenes
   (the port's copy of ``make_scene``) at the default point: mIoU, accuracy
   and label agreement with the permutohedral lattice (``native_crf`` on
   the CPU), each within 0.2 of the ``docs/CRF_FIDELITY.md`` row (69.67,
   84.08, 98.60%); then the rows exact (ds=1, through K4), ds=2 legacy,
   ds=4 mixed bf16 (``safe``) and quality+, mIoU and accuracy within 0.2 of
   their rows (their lattice agreement printed; the exact row's CRF is
   float32: 10 float32 K4 messages and the degree per run);
6. main path: full-width ViT-S/8 at 320 px with random weights from a
   fixed generator, ``make_eval_step`` at the default point (bf16 backbone,
   bf16 CRF state), batch 16, one warm-up and three timed batches; launch
   counts, confusion sums, img/s; then one image in float32 on the card vs
   the CPU (plain path) for pixel agreement (24 launches of K1's float32
   kernel); then the same step at
   ``crf_downsample=1`` (batch 2, 11 K4 launches per batch) and at
   ``operating_point=safe`` (batch 16);
7. train path: the same full-width ViT-S/8 (frozen, bf16) under
   ``train.step.train_step`` at 224 px, batch 32, dim 70, 11 x 11 FPS
   samples, five negatives, the depth-feature term on, dropout on: one
   warm-up and five timed steps on one synthetic batch (24 attention
   launches per step, no K4 launch, finite logs, falling probe losses, the
   ViT bit-identical and without gradients), FPS alone, then one
   ``make_validation_step`` batch at 320 px (12 float32 K1 launches); then
   one float32 step at batch 4 (24 float32 K1 launches through the kernel)
   with fixed coordinates and permutations on the card (eager attention, and
   through the kernel) vs the CPU from the same weights, each loss term
   within 1e-4 relative, and FPS coordinates equal;
8. attention at the shapes the serving stack and the KNN embedding launch
   it at: bf16, N=1601, B=1, 2, 4, 8 and 32 (a bucket of b images is b rows
   with ``fused_tta=False`` and 2b with the serve config's ``fused_tta=True``),
   and float32 at B=128, N=785 (224 px); kernel vs plain, times, the library
   call and the bound, as in phase 3;
9. serve path: the full-width segmenter written as a Lightning ``.ckpt`` and
   loaded through ``serve.build_service`` from ``serve_config.yml`` (320 px,
   default CRF point, bf16 backbone, max_batch 16, 10 ms window);
   ``warmup()``, the time of each bucket, then over HTTP on localhost one
   request per format, a junk body (400), ``/healthz``, ``/metrics``,
   ``serve_loadgen.run`` with 1 and with 16 clients, and 16 distinct images
   posted at once: no errors, K1 launches = 12 per batch (one stacked TTA
   forward), no K4 launch, every response equal to ``make_predict_step`` on
   the padded batch it rode in and agreeing with a batch-16 predict on
   >= 99.5% of pixels (>= 98.5% where it rode alone, in bucket 1); one
   more request alone, so bucket 1 is held every run; then one request
   through a second service at
   ``crf_downsample=1``, ``max_batch=2``, ``fused_tta=False``: 24 K1 and 11
   K4 launches for its batch;
10. demo path: ``demo_segmentation.main`` over 10 synthetic JPEGs of mixed
    sizes with ``batch_size=4`` (batches of 8 and 2) at its config's
    ``crf_downsample: 2``: 10 + 10 PNGs, each equal to the predict step's
    labels for that image;
11. KNN path: ``precompute_knns.main`` over 256 synthetic crops at 224 px
    (two float32 batches of 128, 12 float32 K1 launches each), ``pooled_features``
    alone (unit norms, img/s), then ``topk_neighbors(k=30)`` on seeded
    unit-norm features with N=147,456, C=384 (the key-blocked branch): self
    at rank 0 and, on 2,048 sampled rows, the neighbours of a one-pass
    float64 reference except where two similarities lie within 1e-6; TF32
    still off;
12. depth path: ``generate_depth.main`` with ``--model zoedepth
    --allow_random --batch_size 8`` (full-width BEiT-L + DPT + metric bins,
    random weights from seed 0, bf16) over 11 synthetic JPEGs in three size
    buckets (8 of 640 x 480 -> one 384 x 512 batch of 8, 2 of 480 x 640, 1
    of 400 x 400), the same with ``--dtype float32`` (48 launches of K1's
    float32 kernel per batch, all with the bias), then the same folder with
    ``--model midas`` (ViT-L/16
    DPT_Large), once with ``--allow_random`` (its seed-0 head ends below
    its ReLU everywhere, so its maps are constant and that is accepted)
    and once from a random file in the hub layout whose head bias is +0.1:
    48 K1 launches per ZoeDepth batch, all with a bias, 24 per
    MiDaS batch, none with one, no K4 launch; every PNG 8-bit, of its
    image's size and (but under ``--allow_random`` MiDaS) not constant; the
    first image's PNG equal to its normalized depth (inverted for MiDaS);
    the host time of ``main``, the CUDA-event time of one 384 x 512 batch of
    8, peak memory;
13. depth numerics: full-width ZoeDepth with LayerScale 0.1 (at the default
    1e-5 random blocks are nearly the identity and attention would not
    show): bf16 through K1 vs the eager softmax on the card (taps and metric
    depth, relative error), then one 384 x 512 image in float32 through K1
    on the card vs the CPU's plain path at 4 of the 24 blocks (metric depth
    within 1e-4 relative);
14. the total time, the kernels JSON line (each kernel's float32 figures
    and float32 launches per path among them), the card line and the final
    JSON line.
"""

import copy
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
B, N, HEADS, DIM = 16, 1601, 6, 384
TRAIN_B, TRAIN_RES, TRAIN_STEPS = 32, 224, 5
TRAIN_N = (TRAIN_RES // 8) ** 2 + 1  # 785 tokens
# K1 at the serving stack's shapes (bf16, N=1601: a bucket of b images is a
# batch of b, or of 2b under fused_tta) and at the KNN embedding's (float32)
SERVE_ATTENTION_B = (1, 2, 4, 8, 32)
# a served label map vs the same image in a batch-16 predict. Buckets 2-16
# give the batch-16 labels bit for bit; bucket 1 (one image: a backbone
# batch of 2) does not: its pre-CRF logits differ by up to 9.4e-3 in bf16,
# and at worst 98.90% of an image's pixels agree, on the parent tree too
# (python -m depthg_tpu_torch.serve_bucket_study; NVIDIA H100, 700 W). So
# bucket 1 has its own limit, and one request is served alone every run.
# Every response is also held exactly to the predict step on its own batch.
SERVE_CROSS_BUCKET_AGREEMENT = 0.995
SERVE_BUCKET1_AGREEMENT = 0.985
LONE_IMAGE = 3
KNN_EMBED_B, KNN_N, KNN_C, KNN_K, KNN_SAMPLED = 128, 147_456, 384, 30, 2048
SCALE = 64 ** -0.5
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): bf16 and
# TF32 tensor cores, float32 outside them (an FMA counts 2, so 33.5e12
# instructions/s: 128 lanes x 132 SMs x ~1.98 GHz), HBM3
PEAK_BF16, PEAK_TF32, PEAK_F32, PEAK_HBM = 989e12, 495e12, 67e12, 3.35e12
SMS = 132
# kernel vs plain: dtype -> (max abs error, relative error ||out-ref||/||ref||).
# Outputs here average ~600 keys (~0.04, max ~0.3), so a max-abs limit alone
# cannot see a kernel that is off by a few percent; bf16 rounding of P and of
# the output gives a relative error near 3e-3, such a bug 2e-2 and more.
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 5e-3)}
CRF_REF = (69.67, 84.08)  # docs/CRF_FIDELITY.md:33 (mIoU, accuracy), +-0.2
LATTICE_REF = 98.60  # the same row's label agreement with the lattice (%), +-0.2
# K1 with BEiT-L's relative-position bias at ZoeDepth's 384 x 512 input: a
# 24 x 32 patch grid plus cls, 16 heads of 64; (dtype, batch) cases: bf16 at
# the tails' B=1, --batch_size 8 and 16, float32 (the parity mode) at B=2
BIAS_N, BIAS_HEADS, BIAS_DIM, BIAS_GRID = 769, 16, 1024, (24, 32)
BIAS_CASES = ((torch.bfloat16, 1), (torch.bfloat16, 8), (torch.bfloat16, 16), (torch.float32, 2))
BIAS_N_VALID = 700
# depth generation: 8 images of 640 x 480 (one 384 x 512 bucket, one batch
# of 8), 2 of 480 x 640 (512 x 384) and 1 of 400 x 400 (384 x 384)
DEPTH_IMAGES = ((640, 480),) * 8 + ((480, 640),) * 2 + ((400, 400),)
DEPTH_BATCHES = 3
# full-width bf16 forward through K1 vs the eager softmax on the card, and
# float32 on the card vs the CPU (relative error of the metric depth)
DEPTH_KERNEL_VS_EAGER_TOL, DEPTH_CARD_VS_CPU_TOL = 3e-2, 1e-4
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


def device_time_ms(fn, inputs, iters=50):
    """Mean device ms per call of ``iters`` calls queued behind one long
    float32 product: the host enqueues them all while the card is busy, so
    the events bracket back-to-back kernels and not the host's launch rate
    (which decides ``cuda_time_ms`` for a kernel shorter than a launch)."""
    busy = torch.empty(8192, 8192, device="cuda").normal_()
    for i in range(3):
        fn(inputs[i % len(inputs)])
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    busy @ busy  # ~20 ms with TF32 off
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def profiled_kernel_ms(fn, inputs, names, iters=10):
    """Device ms per launch of each kernel that ``fn`` launches whose name
    holds one of ``names``, read from ``torch.profiler``'s CUDA trace of
    ``iters`` calls (None for a name the trace holds no launch of): the one
    way to time two kernels that one C entry launches in turn. The mean is
    over the launches the trace holds, which can be fewer than ``iters``."""
    from torch.profiler import ProfilerActivity, profile

    fn(inputs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    us, launches = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for evt in prof.key_averages():
        for name in names:
            if name in evt.key:
                us[name] += evt.device_time_total
                launches[name] += evt.count
    return {name: us[name] / launches[name] / 1e3 if launches[name] else None for name in names}


def sm_clock_mhz() -> float:
    """The SM clock ``nvidia-smi`` reports right now (call it under load)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0])


def attention_bound(b, n, h, dtype=torch.bfloat16, bias_bytes=0):
    """Least ms the card could take for one attention call: q, k, v (and a
    bias of ``bias_bytes``) read and o written once over the memory rate,
    or 4 B H N^2 64 operations at the peak of the kernel's arithmetic,
    whichever is larger. bf16: the tensor cores. float32: split TF32, three
    TF32 products each (``attention_fma_bound`` is the FMA pipes' figure)."""
    bf16 = dtype == torch.bfloat16
    bytes_ms = (4 * b * h * n * 64 * (2 if bf16 else 4) + bias_bytes) / PEAK_HBM * 1e3
    ops = 4.0 * b * h * n * n * 64
    ops_ms = (ops / PEAK_BF16 if bf16 else 3 * ops / PEAK_TF32) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations"


def attention_fma_bound(b, n, h):
    """A yardstick for the float32 kernel: its 4 B H N^2 64 operations on
    the FMA pipes, where a float32 kernel without the tensor cores runs."""
    return 4.0 * b * h * n * n * 64 / PEAK_F32 * 1e3


def bilateral_bound(b, n, c, itemsize):
    """Least ms for one message: feats and values read, the output written
    once, or the operations on the N^2 entries, whichever is largest: 10
    float32 instructions per entry (5 subtractions, 5 FMAs; the float32 peak
    counts an FMA as 2) beside the 2 C operations of the product, on the
    bf16 tensor cores or, for float32 values, as split TF32 (three TF32
    products; ``bilateral_fma_bound`` is the FMA pipes' figure). The degree
    is c = 0."""
    entries = float(b) * n * n
    bytes_ms = b * n * (20 + 2 * c * itemsize) / PEAK_HBM * 1e3
    product = 3 * entries * 2 * c / PEAK_TF32 if itemsize == 4 else entries * 2 * c / PEAK_BF16
    ops_ms = max(entries * 10 / (PEAK_F32 / 2), product) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations"


def bilateral_fma_bound(b, n, c):
    """A yardstick for the float32 message: 10 + C instructions per entry,
    all on the FMA pipes."""
    return float(b) * n * n * (10 + c) / (PEAK_F32 / 2) * 1e3


def compare(out, ref, dtype, what):
    """(max abs error, relative error) of ``out`` vs ``ref``; raises past TOL."""
    diff = out.float() - ref.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / ref.float().norm()).item()
    if not (err <= TOL[dtype][0] and rel <= TOL[dtype][1]):
        raise AssertionError(f"{what} {dtype}: max abs err {err}, relative err "
                             f"{rel}; limits {TOL[dtype]}")
    return err, rel


def attention_phase(att, gen, runtime):
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        # the train step's shape: B=32, N=785 (12 x 64 + 17 rows: a ragged
        # sub-tile inside a ragged 256-row block)
        results[f"train_{name}"] = attention_at_shape(att, gen, dtype, name, TRAIN_B, TRAIN_N,
                                                      "train step")
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
        results[name] = {"max_abs_err": err, "rel_err": rel,
                         "padded_max_abs_err": pad_err, "padded_rel_err": pad_rel,
                         "ms": ms, "plain_ms": plain_ms}
        results[name].update(attention_yardsticks(att, inputs, B, N))
        phase("attention", dtype=name, shape=[B, N, HEADS, 64], **results[name])
        del base, inputs, ref, out, pad, out_pad, out_inf
        torch.cuda.empty_cache()
    if not runtime.tf32_off():
        raise AssertionError("TF32 is on after the float32 attention runs")
    return results


def attention_at_shape(att, gen, dtype, name, b, n, where):
    """The kernel against its plain version at [b, n, 6 x 64], packed qkv:
    errors within TOL, CUDA-event times of both, the bound, the kernel
    alone, the library call and the host time of a launch."""
    base = torch.randn(b, n, 3 * DIM, device="cuda", generator=gen)
    inputs = [(base + 1e-2 * i).to(dtype) for i in range(3)]
    out = att.attention_qkv(inputs[0], HEADS, SCALE)

    def plain(x):
        q, k, v = att.split_qkv(x, HEADS)
        return att.attention_plain(q, k, v, SCALE)

    ref = plain(inputs[0]).permute(0, 2, 1, 3).reshape(b, n, DIM)
    torch.cuda.synchronize()
    err, rel = compare(out, ref, dtype, f"attention at B={b}, N={n} ({where})")
    row = {"max_abs_err": err, "rel_err": rel,
           "ms": cuda_time_ms(lambda x: att.attention_qkv(x, HEADS, SCALE), inputs),
           "plain_ms": cuda_time_ms(plain, inputs, iters=5, warmup=2)}
    row.update(attention_yardsticks(att, inputs, b, n))
    phase("attention", dtype=name, shape=[b, n, HEADS, 64], where=where, **row)
    return row


def attention_serving_shapes(att, gen):
    """K1 at every shape the serving stack and the KNN embedding launch it
    at (the eval shape B=16 is in ``attention_phase``)."""
    rows = []
    for dtype, name, b, n, where in (
            [(torch.bfloat16, "bf16", b, N, "serve bucket") for b in SERVE_ATTENTION_B]
            + [(torch.float32, "f32", KNN_EMBED_B, TRAIN_N, "KNN embedding")]):
        row = attention_at_shape(att, gen, dtype, name, b, n, where)
        rows.append({"shape": f"{name}, B={b}, N={n}, {HEADS} heads x 64, packed qkv",
                     "where": where, **{k: row[k] for k in (
                         "max_abs_err", "rel_err", "ms", "kernel_only_ms", "kernel_device_ms",
                         "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms",
                         "host_us_per_launch") + (("fma_bound_ms", "pack_device_ms",
                                                   "attention_kernel_device_ms")
                                                  if name == "f32" else ())}})
        torch.cuda.empty_cache()
    return rows


def attention_yardsticks(att, inputs, b, n):
    """At [b, n] in the inputs' dtype: the kernel alone on a preallocated
    output, the library call, the host time of a launch (its three tensor
    maps included) and the bound."""
    dtype = inputs[0].dtype
    out = torch.empty(b, n, HEADS, 64, device="cuda", dtype=dtype).permute(0, 2, 1, 3)

    def launch(x):
        q, k, v = att.split_qkv(x, HEADS)
        return att._launch(q, k, v, out, SCALE, n)

    def library(x):
        q, k, v = att.split_qkv(x, HEADS)
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=SCALE)

    slow = dtype == torch.float32 and b * n > 50_000  # ~10 ms per call
    iters = 10 if slow else 50
    kernel_ms = cuda_time_ms(launch, inputs, iters=iters)
    library_ms = cuda_time_ms(library, inputs, iters=iters)
    kernel_device_ms = device_time_ms(launch, inputs, iters=iters)
    library_device_ms = device_time_ms(library, inputs, iters=iters)
    clock = sm_clock_mhz()
    q, k, v = att.split_qkv(inputs[0], HEADS)
    ref = library(inputs[0]).float()
    lib_rel = ((launch(inputs[0]).float() - ref).norm() / ref.norm()).item()
    torch.cuda.synchronize()
    reps = 20 if slow else 200
    t0 = time.perf_counter()
    for _ in range(reps):
        att._launch(q, k, v, out, SCALE, n)
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    bound_ms, bound_by = attention_bound(b, n, HEADS, dtype)
    f32 = {}
    if dtype == torch.float32:
        # the pack step and the attention kernel that the float32 entry
        # launches in turn, each alone
        split = profiled_kernel_ms(launch, inputs, ("attn_pack_f32_kernel",
                                                  "attn_f32_wgmma_kernel"))
        f32 = {"fma_bound_ms": attention_fma_bound(b, n, HEADS),
               "pack_device_ms": split["attn_pack_f32_kernel"],
               "attention_kernel_device_ms": split["attn_f32_wgmma_kernel"]}
    return {**f32, "kernel_only_ms": kernel_ms, "library_ms": library_ms,
            "kernel_device_ms": kernel_device_ms, "library_device_ms": library_device_ms,
            "rel_err_vs_library": lib_rel,
            "host_us_per_launch": host_us, "bound_ms": bound_ms, "bound_by": bound_by,
            "ex2_bound_ms": b * HEADS * n * n / (16 * SMS * clock * 1e6) * 1e3,
            "sm_clock_mhz": clock}


def bilateral_phase(bil, crf, fidelity, runtime):
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
            if dtype == torch.float32:
                row["fma_bound_ms"] = bilateral_fma_bound(b, n, c)
                split = profiled_kernel_ms(lambda v: bil.bilateral_message(feats, v), inputs,
                                         ("pack_values_f32_kernel",
                                          "bilateral_f32_rows_kernel"), iters=3)
                row["pack_device_ms"] = split["pack_values_f32_kernel"]
                row["message_kernel_device_ms"] = split["bilateral_f32_rows_kernel"]
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
    if not runtime.tf32_off():
        raise AssertionError("TF32 is on after the float32 K4 runs")
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
    t0 = time.perf_counter()
    lattice = fidelity.lattice_labels(scenes, 320)  # the permutohedral lattice, CPU
    lattice_s = time.perf_counter() - t0
    agree = fidelity.agreement(preds, lattice) * 100
    ok = (abs(miou - CRF_REF[0]) <= 0.2 and abs(acc - CRF_REF[1]) <= 0.2
          and abs(agree - LATTICE_REF) <= 0.2)
    phase("crf_fidelity", miou=float(miou), accuracy=float(acc), lattice_agreement=agree,
          jax_row=[*CRF_REF, LATTICE_REF], seconds_6_images_first_call=crf_s,
          lattice_seconds_6_images=lattice_s)
    if not ok:
        raise AssertionError(f"CRF fidelity {miou:.2f}/{acc:.2f}, lattice agreement "
                             f"{agree:.2f}% not within 0.2 of {CRF_REF}, {LATTICE_REF}%")
    return {"miou": float(miou), "accuracy": float(acc), "lattice_agreement": agree}


def fidelity_rows_phase(study, bil):
    """The fidelity study's rows away from the default point: the exact CRF
    streams through K4 (11 launches per run), the others cache."""
    rows = {}
    for name, k4_per_run in FIDELITY_ROWS:
        bil.KERNEL.launches = bil.KERNEL.f32_launches = 0
        (row,) = [r for r in study.run_rows([name], reps=1) if r["name"] == name]
        launches, f32 = bil.KERNEL.launches, bil.KERNEL.f32_launches
        ref = row["jax"]
        phase("crf_fidelity_row", row=name, miou=row["miou"], accuracy=row["accuracy"],
              lattice_agreement=row["agreement"] * 100, ms_per_image=row["ms_per_image"],
              jax_row=list(ref), k4_launches=launches, k4_f32_message_launches=f32)
        # the quality run and one timed run; the exact row's CRF is float32:
        # 10 float32 messages and the degree per run
        if launches != 2 * k4_per_run or f32 != 2 * max(k4_per_run - 1, 0):
            raise AssertionError(f"{name}: {launches} K4 launches ({f32} float32 messages), "
                                 f"expected {2 * k4_per_run}")
        row["k4_f32_message_launches"] = f32
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
    att.KERNEL.f32_launches = 0
    on_card = [p.cpu() for p in predict(model, img)]
    f32_eval_launches = att.KERNEL.f32_launches
    if att.KERNEL.launches != before + 24 or f32_eval_launches != 24:
        raise AssertionError("the float32 card run did not go through the float32 kernel")
    on_cpu = predict(model_cpu, img.cpu())
    agree = [float((a == b).float().mean()) for a, b in zip(on_card, on_cpu)]
    phase("f32_card_vs_cpu", linear_agreement=agree[0], cluster_agreement=agree[1],
          k1_f32_launches=f32_eval_launches)
    if min(agree) < 0.995:
        raise AssertionError(f"card vs CPU prediction agreement {agree} < 99.5%")
    del batches
    torch.cuda.empty_cache()

    # the eval step away from the default point: the exact CRF (every
    # message through K4 in bf16, C = 27 + 27) and the safe point
    points = {}
    for name, cfg, b, n_batches, k4_per_batch in (
            ("exact_ds1", {"crf_downsample": 1}, 2, 3, 11),
            ("safe", crf.EVAL_OPERATING_POINTS["safe"], B, 3, 0)):
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
            "points": points, "f32_eval_launches": f32_eval_launches}


def train_path_phase(att, bil, inference, featurizer, gen):
    """The train step at full width: one warm-up and TRAIN_STEPS timed steps
    on one fixed batch, counts of both kernels set to 0 just before and read
    just after; then FPS alone and one validation batch at 320 px."""
    from depthg_tpu_torch import profile_train
    from depthg_tpu_torch.ops.depth import farthest_point_sampling_depth
    from depthg_tpu_torch.train import losses as loss_lib
    from depthg_tpu_torch.train import step as step_lib

    fcfg = featurizer.FeaturizerConfig()  # vit_small, patch 8, dim 70, dropout 0.1
    hp = step_lib.TrainHParams(n_classes=27, backbone_dtype="bfloat16")
    lcfg = loss_lib.CorrLossConfig(feature_samples=11, neg_samples=5, depth_sampling="fps",
                                   depth_feat_correlation_loss=True)
    w, sh = profile_train.DEPTH_FEAT_WEIGHT, profile_train.DEPTH_FEAT_SHIFT
    state = step_lib.init_state(fcfg, hp, torch.Generator().manual_seed(0), "cuda")
    n_params = {name: sum(p.numel() for g in opt.param_groups for p in g["params"])
                for name, opt in state.opt.items()}
    batch = profile_train.synthetic_batch(TRAIN_B, TRAIN_RES, 27, gen)
    vit_before = [p.detach().clone() for p in state.model.net.model.parameters()]

    def probe_losses():
        """loss/linear + loss/cluster on the fixed batch with fixed masks."""
        fixed = torch.Generator(device="cuda").manual_seed(123)
        with torch.no_grad():
            logs = step_lib.loss_fn(state.model, batch, hp, lcfg, w, sh, generator=fixed)[1]
        return float(logs["loss/linear"] + logs["loss/cluster"])

    before = probe_losses()
    torch.cuda.reset_peak_memory_stats()
    att.KERNEL.launches = 0
    bil.KERNEL.launches = 0
    all_logs = [step_lib.train_step(state, batch, hp, lcfg, w, sh, generator=gen)]
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TRAIN_STEPS):
        all_logs.append(step_lib.train_step(state, batch, hp, lcfg, w, sh, generator=gen))
    stop.record()
    torch.cuda.synchronize()
    launches, k4 = att.KERNEL.launches, bil.KERNEL.launches
    step_ms = start.elapsed_time(stop) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = probe_losses()

    per_step = 2 * len(state.model.net.model.blocks)
    if launches != per_step * (TRAIN_STEPS + 1) or k4 != 0:
        raise AssertionError(f"train path: {launches} attention launches (expected "
                             f"{per_step * (TRAIN_STEPS + 1)}) and {k4} K4 launches (expected 0)")
    for i, logs in enumerate(all_logs):
        bad = [k for k, v in logs.items() if not bool(torch.isfinite(v).all())]
        if bad:
            raise AssertionError(f"train step {i}: non-finite {bad}")
    if not after < before:
        raise AssertionError(f"loss/linear + loss/cluster did not fall: {before} -> {after}")
    if state.step != TRAIN_STEPS + 1:
        raise AssertionError(f"step counter {state.step}")
    for p, old in zip(state.model.net.model.parameters(), vit_before):
        if p.grad is not None or p.requires_grad or not torch.equal(p, old):
            raise AssertionError("the frozen ViT changed or received a gradient")
    del vit_before

    grid = torch.zeros(2 * TRAIN_B, 1, TRAIN_RES // 8, TRAIN_RES // 8, device="cuda")
    depths = [torch.cat([batch["depth"], batch["depth_pos"]]) * (1 - 0.01 * i) for i in range(3)]
    fps_ms = cuda_time_ms(lambda d: farthest_point_sampling_depth(grid, d, 11), depths,
                          iters=5, warmup=1)
    last = {k: float(v) for k, v in all_logs[-1].items()}
    phase("train_path", batch=TRAIN_B, res=TRAIN_RES, steps_timed=TRAIN_STEPS, step_ms=step_ms,
          img_per_s=TRAIN_B / step_ms * 1e3, fps_ms=fps_ms, peak_mem_gb=peak,
          attention_launches=launches, attention_launches_per_step=per_step, k4_launches=k4,
          probe_losses_before=before, probe_losses_after=after,
          optimizer_parameters=n_params, optimizer_parameters_total=sum(n_params.values()),
          last_logs=last)

    # one validation batch at 320 px (plain float32 forward through the kernel)
    img, label = make_batches(gen, B, 1)[0]
    att.KERNEL.launches = att.KERNEL.f32_launches = 0
    lin, clu = inference.make_validation_step(27, 0)(state.model, img, label, 320)
    counted = int(((label >= 0) & (label < 27)).sum())
    validation_launches = att.KERNEL.f32_launches
    if (int(lin.sum()) != counted or int(clu.sum()) != counted
            or lin.shape != (27, 27) or att.KERNEL.launches != per_step // 2
            or validation_launches != per_step // 2):
        raise AssertionError(f"validation step: confusion sums {int(lin.sum())}, "
                             f"{int(clu.sum())} != {counted} or attention launches "
                             f"{att.KERNEL.launches} != {per_step // 2}")
    phase("train_validation", batch=B, res=320, attention_launches=att.KERNEL.launches,
          attention_f32_launches=validation_launches, labelled_pixels=counted)
    return {"launches": launches, "k4_launches": k4, "step_ms": step_ms, "fps_ms": fps_ms,
            "validation_launches": validation_launches}


def train_card_vs_cpu_phase(att, inference, featurizer):
    """One float32 train step at batch 4, dropout off, with fixed coordinates
    (the CPU's FPS picks) and fixed permutations, from the same weights: on
    the card with eager attention (``precision="float32"``) and through the
    kernel, each against the CPU."""
    import dataclasses

    from depthg_tpu_torch import profile_train
    from depthg_tpu_torch.ops.depth import farthest_point_sampling_depth
    from depthg_tpu_torch.train import losses as loss_lib
    from depthg_tpu_torch.train import step as step_lib

    b = 4
    fcfg = featurizer.FeaturizerConfig(dropout=False, drop_rate=0.0)
    lcfg = loss_lib.CorrLossConfig(feature_samples=11, neg_samples=5, depth_sampling="fps")
    w, sh = profile_train.DEPTH_FEAT_WEIGHT, profile_train.DEPTH_FEAT_SHIFT
    cpu_gen = torch.Generator().manual_seed(1)
    model_cpu = inference.Segmenter(fcfg, 27, 27, decoder=True).init_weights(cpu_gen)
    batch_cpu = profile_train.synthetic_batch(b, TRAIN_RES, 27, cpu_gen)
    batch = {k: v.cuda() for k, v in batch_cpu.items()}
    perms = torch.stack([torch.randperm(b, generator=cpu_gen) for _ in range(5)])

    grid = torch.zeros(2 * b, 1, TRAIN_RES // 8, TRAIN_RES // 8)
    depth2 = torch.cat([batch_cpu["depth"], batch_cpu["depth_pos"]])
    coords_cpu = farthest_point_sampling_depth(grid, depth2, 11) * 2 - 1
    coords_card = farthest_point_sampling_depth(grid.cuda(), depth2.cuda(), 11) * 2 - 1
    if not torch.equal(coords_card.cpu(), coords_cpu):
        raise AssertionError("FPS coordinates differ between the card and the CPU")
    coords = (coords_cpu[:b], coords_cpu[b:])

    hp32 = step_lib.TrainHParams(n_classes=27, precision="float32")
    ref_state = step_lib.state_from_model(copy.deepcopy(model_cpu), hp32)
    ref = step_lib.train_step(ref_state, batch_cpu, hp32, lcfg, w, sh,
                              coords_override=coords, neg_perms=perms)
    worst, f32_launches = {}, 0
    for name, hp, k1 in (("eager", hp32, 0),
                         ("kernel", dataclasses.replace(hp32, precision=None), 24)):
        state = step_lib.state_from_model(copy.deepcopy(model_cpu).cuda(), hp)
        att.KERNEL.launches = att.KERNEL.f32_launches = 0
        logs = step_lib.train_step(state, batch, hp, lcfg, w, sh,
                                   coords_override=tuple(c.cuda() for c in coords),
                                   neg_perms=perms.cuda())
        if att.KERNEL.launches != k1 or att.KERNEL.f32_launches != k1:
            raise AssertionError(f"{name}: {att.KERNEL.launches} attention launches "
                                 f"({att.KERNEL.f32_launches} float32), expected {k1}")
        f32_launches = max(f32_launches, att.KERNEL.f32_launches)
        rel = {k: abs(float(logs[k]) - float(ref[k])) / max(abs(float(ref[k])), 1e-2)
               for k in ref}
        worst[name] = max(rel.values())
        if worst[name] > 1e-4:
            raise AssertionError(f"train step on the card ({name}) vs the CPU: {rel}")
    phase("train_f32_card_vs_cpu", batch=b, fps_coordinates_equal=True,
          loss_terms=sorted(ref), worst_rel_diff=worst, k1_f32_launches_per_step=f32_launches)
    return {"worst": worst, "f32_launches": f32_launches}


def post(base, body, query="format=npz", timeout=120):
    req = urllib.request.Request(f"{base}/v1/segment?{query}", data=body, method="POST")
    return urllib.request.urlopen(req, timeout=timeout).read()


def agreement(a, b):
    return float((a == b).mean())


def serve_path_phase(att, bil, inference, featurizer, tmp):
    """The serving stack at full width over HTTP on localhost."""
    import numpy as np
    from PIL import Image

    from depthg_tpu_torch import serve, serve_loadgen
    from depthg_tpu_torch.config import load_config
    from depthg_tpu_torch.profile_serve import load_run, synthetic_jpeg
    from depthg_tpu_torch.utils.ckpt import export_lightning_ckpt

    fcfg = featurizer.FeaturizerConfig()  # vit_small, patch 8, dim 70
    model = inference.Segmenter(fcfg, 27, 27).init_weights(torch.Generator().manual_seed(0))
    ckpt = os.path.join(tmp, "segmenter.ckpt")
    export_lightning_ckpt(ckpt, model.state_dict(), cfg={
        "model_type": "vit_small", "dino_patch_size": 8, "dim": 70, "n_classes": 27})
    del model

    cfg = load_config("serve_config.yml", [f"model_path={ckpt}"])
    t0 = time.perf_counter()
    svc = serve.build_service(cfg, "cuda")
    build_s = time.perf_counter() - t0
    per_batch = len(svc._model.net.model.blocks) * (1 if svc.ecfg.fused_tta else 2)
    t0 = time.perf_counter()
    buckets = svc.warmup()
    warmup_s = time.perf_counter() - t0
    if buckets != [1, 2, 4, 8, 16] or svc.ecfg.crf.downsample != 8:
        raise AssertionError(f"serve config: buckets {buckets}, crf {svc.ecfg.crf}")

    bodies = [synthetic_jpeg(100 + i, *((480, 360), (400, 400), (360, 500), (640, 480))[i % 4])
              for i in range(16)]
    arrs = [np.asarray(svc._transform(Image.open(io.BytesIO(b)).convert("RGB")), np.float32)
            for b in bodies]

    # each bucket after its warm-up run: host clock around stage + step + fetch
    bucket_ms = {}
    for b in buckets:
        att.KERNEL.launches = 0
        times = []
        for rep in range(4):
            t0 = time.perf_counter()
            svc._predict_padded(arrs[rep:rep + b], b)
            times.append((time.perf_counter() - t0) * 1e3)
        if att.KERNEL.launches != 4 * per_batch:
            raise AssertionError(f"bucket {b}: {att.KERNEL.launches} K1 launches in 4 runs")
        bucket_ms[b] = times
    phase("serve_buckets", build_service_s=build_s, warmup_s=warmup_s, buckets=buckets,
          k1_launches_per_batch=per_batch, fused_tta=svc.ecfg.fused_tta,
          ms_per_bucket_4_runs=bucket_ms,
          ms_per_image_best={b: min(t) / b for b, t in bucket_ms.items()})

    # record what each dispatched batch held, to hold responses to the step
    batches_seen = []
    run_batch = svc.batcher._run_batch

    def recording(items):
        batches_seen.append(list(items))
        return run_batch(items)

    svc.batcher._run_batch = recording
    server = serve.serve_http(svc, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        att.KERNEL.launches = 0
        bil.KERNEL.launches = 0
        before = svc.batcher.metrics.snapshot()

        npz = np.load(io.BytesIO(post(base, bodies[0])))
        js = json.loads(post(base, bodies[0], "format=json"))
        png = np.asarray(Image.open(io.BytesIO(post(base, bodies[0], "format=png&probe=linear"))))
        if not (npz["linear"].shape == npz["cluster"].shape == (320, 320)
                and npz["linear"].dtype == np.int32 and 0 <= npz["cluster"].min()
                and npz["cluster"].max() < 27
                and np.array_equal(np.asarray(js["linear"]), npz["linear"])
                and np.array_equal(np.asarray(js["cluster"]), npz["cluster"])
                and np.array_equal(png, npz["linear"].astype(np.uint8))):
            raise AssertionError("the three response formats disagree")
        try:
            post(base, b"this is not an image")
            raise AssertionError("a junk body was answered with 200")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise AssertionError(f"a junk body gave {e.code}, expected 400")
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=30).read())
        if health["status"] != "ok":
            raise AssertionError(f"/healthz: {health}")

        load = {}
        for clients, seconds in ((1, 3.0), (16, 6.0)):
            k1_0 = att.KERNEL.launches
            out = load_run(svc, lambda: serve_loadgen.run(base, bodies[1], clients, seconds))
            out["k1_launches"] = att.KERNEL.launches - k1_0
            load[clients] = out
            phase("serve_load", **out)
            if out["errors"] or not out["completed"]:
                raise AssertionError(f"load run with {clients} clients: {out}")

        # 16 distinct images posted at once: each response is its own image's
        n_before = len(batches_seen)
        outs = [None] * 16

        def one(i):
            outs[i] = np.load(io.BytesIO(post(base, bodies[i])))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        if any(o is None for o in outs):
            raise AssertionError("a concurrent request got no response")
        # then one image alone: a batch of 1 (bucket 1) on every run, however
        # the batcher split the 16
        n_lone = len(batches_seen)
        lone = np.load(io.BytesIO(post(base, bodies[LONE_IMAGE])))
        if [len(b) for b in batches_seen[n_lone:]] != [1]:
            raise AssertionError(f"a lone request was dispatched as "
                                 f"{[len(b) for b in batches_seen[n_lone:]]}")
        launches, k4 = att.KERNEL.launches, bil.KERNEL.launches
        after = json.loads(urllib.request.urlopen(f"{base}/metrics", timeout=30).read())
    finally:
        server.shutdown()
        server.server_close()
        svc.batcher._run_batch = run_batch
    n_batches = after["batches"] - before["batches"]
    if after["errors"] != 0:  # the junk body failed in its decode, before the batcher
        raise AssertionError(f"server errors: {after}")
    if launches != per_batch * n_batches or k4 != 0 or n_batches != len(batches_seen):
        raise AssertionError(f"serve path: {launches} K1 launches over {n_batches} batches "
                             f"(expected {per_batch} each), {k4} K4 launches (expected 0)")

    # each response against make_predict_step on the padded batch it rode in
    predict = inference.make_predict_step(svc.ecfg)
    checked, bucket_of = 0, {}
    for items in batches_seen[n_before:n_lone]:
        b = serve._bucket(len(items), svc.batcher.max_batch)
        padded = np.stack(items + [items[0]] * (b - len(items)))
        lin, clu = (p.cpu().numpy() for p in predict(svc._model, torch.from_numpy(padded).cuda()))
        for row, item in enumerate(items):
            (i,) = [j for j, a in enumerate(arrs) if np.array_equal(a, item)]
            bucket_of[i] = b
            if not (np.array_equal(outs[i]["linear"], lin[row])
                    and np.array_equal(outs[i]["cluster"], clu[row])):
                raise AssertionError(f"image {i}: the response differs from the predict "
                                     f"step on its padded batch of {b}")
            checked += 1
    if checked != 16:
        raise AssertionError(f"{checked} of 16 concurrent responses were matched to a batch")
    lin1, clu1 = (p.cpu().numpy() for p in predict(
        svc._model, torch.from_numpy(arrs[LONE_IMAGE][None]).cuda()))
    if not (np.array_equal(lone["linear"], lin1[0]) and np.array_equal(lone["cluster"], clu1[0])):
        raise AssertionError("the lone response differs from the predict step on a batch of 1")
    lin16, clu16 = (p.cpu().numpy() for p in predict(svc._model,
                                                     torch.from_numpy(np.stack(arrs)).cuda()))
    agree = [min(agreement(outs[i]["linear"], lin16[i]), agreement(outs[i]["cluster"], clu16[i]))
             for i in range(16)]
    lone_agree = min(agreement(lone["linear"], lin16[LONE_IMAGE]),
                     agreement(lone["cluster"], clu16[LONE_IMAGE]))
    distinct = len({outs[i]["cluster"].tobytes() for i in range(16)})
    svc.close()
    if svc.batcher._thread.is_alive():
        raise AssertionError("the batcher's dispatcher thread is still alive")
    phase("serve_path", requests=after["requests"] - before["requests"], batches=n_batches,
          k1_launches=launches, k1_launches_per_batch=per_batch, k4_launches=k4,
          errors=after["errors"],
          concurrent_batch_sizes=[len(b) for b in batches_seen[n_before:n_lone]],
          responses_equal_to_padded_batch_predict=checked,
          min_agreement_with_batch16_predict=min(agree), distinct_label_maps=distinct,
          lone_request_agreement_with_batch16_predict=lone_agree,
          limits=[SERVE_CROSS_BUCKET_AGREEMENT, SERVE_BUCKET1_AGREEMENT],
          server_latency_ms_p50=after["latency_ms_p50"], server_latency_ms_p99=after["latency_ms_p99"])
    low = [i for i in range(16) if agree[i] < (SERVE_CROSS_BUCKET_AGREEMENT if bucket_of[i] > 1
                                               else SERVE_BUCKET1_AGREEMENT)]
    if low or lone_agree < SERVE_BUCKET1_AGREEMENT or distinct != 16:
        raise AssertionError(f"agreement with a batch-16 predict {agree}, alone {lone_agree}; "
                             f"{distinct} distinct maps")

    # the exact CRF through a second service: every message through K4
    cfg2 = load_config("serve_config.yml", [f"model_path={ckpt}", "crf_downsample=1",
                                            "max_batch=2", "fused_tta=False"])
    svc2 = serve.build_service(cfg2, "cuda")
    server2 = serve.serve_http(svc2, port=0)
    try:
        svc2.warmup()
        att.KERNEL.launches = 0
        bil.KERNEL.launches = 0
        t0 = time.perf_counter()
        exact = np.load(io.BytesIO(post(f"http://127.0.0.1:{server2.server_address[1]}", bodies[2])))
        exact_ms = (time.perf_counter() - t0) * 1e3
        k1_exact, k4_exact = att.KERNEL.launches, bil.KERNEL.launches
    finally:
        server2.shutdown()
        server2.server_close()
        svc2.close()
    phase("serve_path_exact", cfg={"crf_downsample": 1, "max_batch": 2, "fused_tta": False},
          k1_launches=k1_exact, k4_launches=k4_exact, request_ms=exact_ms,
          agreement_with_default_point=agreement(exact["cluster"], outs[2]["cluster"]))
    if k1_exact != 24 or k4_exact != 11 or exact["cluster"].shape != (320, 320):
        raise AssertionError(f"exact serve request: {k1_exact} K1 and {k4_exact} K4 launches "
                             "(expected 24 and 11)")
    return {"launches": launches, "k4_launches": k4, "batches": n_batches, "per_batch": per_batch,
            "exact_k4_launches": k4_exact, "bucket_ms": bucket_ms, "load": load, "ckpt": ckpt}


def demo_path_phase(att, bil, inference, ckpt, tmp):
    """``demo_segmentation.main`` over a folder of JPEGs of mixed sizes."""
    import numpy as np
    from PIL import Image

    from depthg_tpu_torch import demo_segmentation
    from depthg_tpu_torch.config import load_config
    from depthg_tpu_torch.data import get_transform
    from depthg_tpu_torch.profile_serve import synthetic_jpeg
    from depthg_tpu_torch.utils.checkpoint_io import load_segmenter

    image_dir = os.path.join(tmp, "demo_images")
    os.makedirs(image_dir)
    sizes = ((480, 360), (333, 500), (640, 427), (320, 320), (500, 375))
    for i in range(10):
        with open(os.path.join(image_dir, f"img{i:02d}.jpg"), "wb") as f:
            f.write(synthetic_jpeg(200 + i, *sizes[i % 5]))
    argv = [f"model_path={ckpt}", f"image_dir={image_dir}", f"output_root={tmp}", "batch_size=4"]
    torch.cuda.reset_peak_memory_stats()
    att.KERNEL.launches = 0
    bil.KERNEL.launches = 0
    t0 = time.perf_counter()
    result_dir = demo_segmentation.main(argv)
    seconds = time.perf_counter() - t0
    launches, k4 = att.KERNEL.launches, bil.KERNEL.launches
    peak = torch.cuda.max_memory_allocated() / 2**30

    cfg = load_config("demo_config.yml", argv)
    sd, run_cfg = load_segmenter(ckpt)
    ecfg = inference.ecfg_from_checkpoint(cfg, sd, run_cfg)
    if ecfg.crf.downsample != 2:
        raise AssertionError(f"the demo config's CRF point: {ecfg.crf}")
    model = inference.Segmenter.from_state_dict(sd, inference.fcfg_from_run_cfg(run_cfg)).cuda()
    per_batch = len(model.net.model.blocks) * (1 if ecfg.fused_tta else 2)
    if launches != 2 * per_batch or k4 != 0:
        raise AssertionError(f"demo path: {launches} K1 launches (expected {2 * per_batch} for "
                             f"two batches) and {k4} K4 launches (expected 0)")
    names = sorted(os.listdir(image_dir))
    transform = get_transform(cfg.res, False, "center")
    imgs = np.stack([np.asarray(transform(Image.open(os.path.join(image_dir, n)).convert("RGB")),
                                np.float32) for n in names])
    predict = inference.make_predict_step(ecfg)
    for lo, hi in ((0, 8), (8, 10)):
        lin, clu = (p.cpu().numpy() for p in predict(model, torch.from_numpy(imgs[lo:hi]).cuda()))
        for j, name in enumerate(names[lo:hi]):
            for probe, ref in (("linear", lin[j]), ("cluster", clu[j])):
                png = np.asarray(Image.open(os.path.join(result_dir, probe, name[:-4] + ".png")))
                if png.dtype != np.uint8 or not np.array_equal(png, ref.astype(np.uint8)):
                    raise AssertionError(f"demo {probe}/{name}: the PNG differs from the "
                                         "predict step's labels")
    for probe in ("linear", "cluster"):
        if len(os.listdir(os.path.join(result_dir, probe))) != 10:
            raise AssertionError(f"demo: {probe} does not hold 10 PNGs")
    phase("demo_path", images=10, batches=[8, 2], crf_downsample=2, seconds=seconds,
          peak_mem_gb=peak, k1_launches=launches, k4_launches=k4, pngs_equal_predict_step=20)
    return {"launches": launches, "k4_launches": k4, "seconds": seconds}


def knn_path_phase(att, bil, featurizer, runtime, gen, tmp):
    """The KNN CLI on synthetic crops, the embedding alone, and the
    key-blocked top-k at a dataset's size."""
    import numpy as np

    from depthg_tpu_torch import precompute_knns
    from depthg_tpu_torch.parallel import knn
    from depthg_tpu_torch.profile_serve import synthetic_jpeg

    crop_dir = os.path.join(tmp, "knn_data", "cropped", "cocostuff27_five_crop_0.5")
    os.makedirs(os.path.join(crop_dir, "img", "train"))  # images alone: no labels needed
    n_img = 2 * KNN_EMBED_B
    for i in range(n_img):
        with open(os.path.join(crop_dir, "img", "train", f"{i}.jpg"), "wb") as f:
            f.write(synthetic_jpeg(300 + i, 240, 240))
    att.KERNEL.launches = att.KERNEL.f32_launches = 0
    bil.KERNEL.launches = 0
    t0 = time.perf_counter()
    written = precompute_knns.main([
        f"data_dir={os.path.join(tmp, 'knn_data')}", "knn_datasets=[cocostuff27]",
        "knn_crop_types=[five]", "knn_image_sets=[train]", "num_workers=4"])
    cli_s = time.perf_counter() - t0
    launches, k4 = att.KERNEL.launches, bil.KERNEL.launches
    f32_launches = att.KERNEL.f32_launches
    nns = np.load(written[0])["nns"]
    name = os.path.basename(written[0])
    if (name != "nns_vit_small_cocostuff27_train_five_224.npz" or nns.shape != (n_img, KNN_K)
            or nns.dtype != np.int32 or nns.min() < 0 or nns.max() >= n_img
            or any(len(set(row)) != KNN_K for row in nns.tolist())):
        raise AssertionError(f"precompute_knns wrote {name}: {nns.shape} {nns.dtype}")
    if launches != 12 * 2 or f32_launches != launches or k4 != 0:
        raise AssertionError(f"KNN embedding: {launches} K1 launches (expected 24 for two "
                             f"batches of {KNN_EMBED_B}) and {k4} K4 launches")

    net = featurizer.DinoFeaturizer(featurizer.FeaturizerConfig())
    net.model.init_weights(torch.Generator().manual_seed(0))
    net = net.cuda().eval()
    imgs = [torch.randn(KNN_EMBED_B, 3, TRAIN_RES, TRAIN_RES, device="cuda", generator=gen)
            for _ in range(2)]
    before = att.KERNEL.launches
    pooled = knn.pooled_features(net, imgs[0])
    if att.KERNEL.launches != before + 12 or pooled.shape != (KNN_EMBED_B, 384) \
            or pooled.dtype != torch.float32:
        raise AssertionError("pooled_features: launches, shape or dtype")
    norm_err = float((pooled.norm(dim=1) - 1).abs().max())
    if not norm_err <= 1e-5:
        raise AssertionError(f"pooled features are not unit vectors: {norm_err}")
    embed_ms = cuda_time_ms(lambda x: knn.pooled_features(net, x), imgs, iters=4, warmup=1)
    del net, imgs, pooled
    torch.cuda.empty_cache()

    if not KNN_N > 2 * knn._KEY_BLOCK:
        raise AssertionError("N does not reach the key-blocked branch")
    feats = torch.nn.functional.normalize(
        torch.randn(KNN_N, KNN_C, device="cuda", generator=gen), dim=1)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = knn.topk_neighbors(feats, k=KNN_K, precision="highest")
    exact_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    idx_bf16 = knn.topk_neighbors(feats, k=KNN_K)
    bf16_s = time.perf_counter() - t0
    if idx.shape != (KNN_N, KNN_K) or idx.dtype != np.int32:
        raise AssertionError(f"topk_neighbors returned {idx.shape} {idx.dtype}")
    if not ((idx[:, 0] == np.arange(KNN_N)).all() and (idx_bf16[:, 0] == np.arange(KNN_N)).all()):
        raise AssertionError("rank 0 is not self for every row")

    # a one-pass float64 reference on sampled query rows
    rows = torch.randperm(KNN_N, device="cuda", generator=gen)[:KNN_SAMPLED]
    f64 = feats.double()
    sims = f64[rows] @ f64.t()
    ref = sims.topk(KNN_K, dim=1).indices
    got = torch.from_numpy(idx).cuda()[rows].long()
    differ = got != ref
    gap = (sims.gather(1, got) - sims.gather(1, ref)).abs()
    worst_gap = float(gap[differ].max()) if bool(differ.any()) else 0.0
    if worst_gap > 1e-6:
        raise AssertionError(f"top-k differs from the float64 reference by {worst_gap} in similarity")
    bf16_same = float((torch.from_numpy(idx_bf16).cuda()[rows].long() == ref).float().mean())
    if not runtime.tf32_off():
        raise AssertionError("TF32 is on after the KNN")
    phase("knn_path", cli_seconds=cli_s, cli_images=n_img, file=name, k1_launches=launches,
          k1_launches_per_batch=12, embed_batch=KNN_EMBED_B, embed_ms=embed_ms,
          embed_img_per_s=KNN_EMBED_B / embed_ms * 1e3, unit_norm_err=norm_err,
          n=KNN_N, c=KNN_C, k=KNN_K, key_blocks=-(-KNN_N // knn._KEY_BLOCK),
          topk_highest_s=exact_s, topk_default_bf16_s=bf16_s, peak_mem_gb=peak,
          sampled_rows=KNN_SAMPLED, entries_differing_from_float64=int(differ.sum()),
          worst_similarity_gap=worst_gap, bf16_entries_equal_to_float64=bf16_same,
          tf32_off=True)
    return {"launches": launches, "f32_launches": f32_launches, "embed_ms": embed_ms}


def attention_bias_phase(att, beit, gen):
    """K1 with BEiT-L's bias at N=769, 16 heads: kernel vs plain, the bias
    acting, +1e4 past n_valid ignored, an odd row stride refused; times
    through ``attention_qkv``, queued, alone, the library call with the bias
    as its ``attn_mask``, the plain version, and the bound."""
    import torch.nn.functional as F

    n, h = BIAS_N, BIAS_HEADS
    # a random table through the BEiT module's own builder: the 47 x 47
    # pretraining table resized to the 47 x 63 window, as [16, 769, 776]
    table = torch.randn((2 * 24 - 1) ** 2 + 3, h, device="cuda", generator=gen)
    rows = {}
    for dtype, b in BIAS_CASES:
        name = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_b{b}"
        bias = beit.relative_position_bias(table.to(dtype), 24, *BIAS_GRID)
        if bias.shape != (h, n, n) or bias.stride(1) % 8:
            raise AssertionError(f"the BEiT bias builder gave {bias.shape}, {bias.stride()}")
        base = torch.randn(b, n, 3 * BIAS_DIM, device="cuda", generator=gen)
        inputs = [(base + 1e-2 * i).to(dtype) for i in range(3)]

        def plain(x, nv=None, bias=bias):
            q, k, v = att.split_qkv(x, h)
            return att.attention_plain(q, k, v, SCALE, nv, bias).permute(0, 2, 1, 3).reshape(
                x.shape[0], n, BIAS_DIM)

        before = att.KERNEL.bias_launches
        out = att.attention_qkv(inputs[0], h, SCALE, bias=bias)
        ref = plain(inputs[0])
        torch.cuda.synchronize()
        if att.KERNEL.bias_launches != before + 1:
            raise AssertionError("a launch with a bias was not counted")
        err, rel = compare(out, ref, dtype, f"attention with bias {name}")
        without = att.attention_qkv(inputs[0], h, SCALE)
        moved = ((without.float() - out.float()).norm() / out.float().norm()).item()
        if not moved > 0.05:
            raise AssertionError(f"the bias did not act: {moved}")
        # keys and rows past n_valid: +1e4 in the bias there changes nothing
        masked = att.attention_qkv(inputs[0], h, SCALE, BIAS_N_VALID, bias=bias)
        poisoned = beit.relative_position_bias(table.to(dtype), 24, *BIAS_GRID)
        poisoned[:, :, BIAS_N_VALID:] = 1e4
        poisoned[:, BIAS_N_VALID:] = 1e4
        torch.cuda.synchronize()
        if not torch.equal(att.attention_qkv(inputs[0], h, SCALE, BIAS_N_VALID, bias=poisoned),
                           masked) or not torch.all(masked[:, BIAS_N_VALID:] == 0):
            raise AssertionError(f"{name}: the bias past n_valid changed the output")
        nv_err, nv_rel = compare(masked[:, :BIAS_N_VALID],
                                 plain(inputs[0], BIAS_N_VALID)[:, :BIAS_N_VALID], dtype,
                                 f"attention with bias {name}, n_valid={BIAS_N_VALID}")
        try:
            att.attention_qkv(inputs[0], h, SCALE, bias=bias.contiguous())  # row stride 769
            raise AssertionError("a bias with an odd row stride was launched")
        except ValueError:
            pass

        o = torch.empty(b, n, h, 64, device="cuda", dtype=dtype).permute(0, 2, 1, 3)

        def launch(x):
            q, k, v = att.split_qkv(x, h)
            return att._launch(q, k, v, o, SCALE, n, bias)

        def library(x):
            q, k, v = att.split_qkv(x, h)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=SCALE)

        lib_ref = library(inputs[0]).float()
        lib_rel = ((launch(inputs[0]).float() - lib_ref).norm() / lib_ref.norm()).item()
        iters = 10 if dtype == torch.float32 else 50
        bound_ms, bound_by = attention_bound(b, n, h, dtype, h * n * n * bias.element_size())
        clock = sm_clock_mhz()
        rows[name] = {
            "max_abs_err": err, "rel_err": rel, "n_valid_max_abs_err": nv_err,
            "n_valid_rel_err": nv_rel, "rel_change_from_bias": moved,
            "rel_err_vs_library": lib_rel,
            "ms": cuda_time_ms(lambda x: att.attention_qkv(x, h, SCALE, bias=bias), inputs,
                               iters=iters),
            "device_ms": device_time_ms(lambda x: att.attention_qkv(x, h, SCALE, bias=bias),
                                        inputs, iters=iters),
            "kernel_only_ms": cuda_time_ms(launch, inputs, iters=iters),
            "kernel_device_ms": device_time_ms(launch, inputs, iters=iters),
            "no_bias_device_ms": device_time_ms(lambda x: att.attention_qkv(x, h, SCALE),
                                                inputs, iters=iters),
            "library_ms": cuda_time_ms(library, inputs, iters=iters),
            "library_device_ms": device_time_ms(library, inputs, iters=iters),
            "plain_ms": cuda_time_ms(plain, inputs, iters=3, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            **({"fma_bound_ms": attention_fma_bound(b, n, h)} if dtype == torch.float32 else {}),
            "ex2_bound_ms": b * h * n * n / (16 * SMS * clock * 1e6) * 1e3,
            "sm_clock_mhz": clock}
        phase("attention_bias", case=name, shape=[b, n, h, 64],
              bias=[h, n, n, str(bias.dtype), bias.stride(1)], **rows[name])
        del base, inputs, out, ref, without, masked, poisoned, o, lib_ref
        torch.cuda.empty_cache()
    return rows


def depth_path_phase(att, bil, tmp):
    """``generate_depth.main`` (ZoeDepth, then MiDaS twice: --allow_random
    and a random file; full width, batch 8) over 11 synthetic JPEGs in
    three size buckets: launch counts, every PNG, the inversion, host time,
    one batch's device time, peak memory."""
    import numpy as np
    from PIL import Image

    from depthg_tpu_torch import generate_depth
    from depthg_tpu_torch.profile_serve import synthetic_jpeg

    image_dir = os.path.join(tmp, "depth_images", "val")
    os.makedirs(image_dir)
    for i, (w, h) in enumerate(DEPTH_IMAGES):
        with open(os.path.join(image_dir, f"img{i:02d}.jpg"), "wb") as f:
            f.write(synthetic_jpeg(400 + i, w, h))
    built, first_depth = {}, {}
    build, write_one = generate_depth.build, generate_depth.write_one

    def keep_build(args, device, *configs):
        built[args.model] = build(args, device, *configs)
        return built[args.model]

    def keep_first(args, depth, ow, oh, src, feats=None):
        first_depth.setdefault((args.model, src), np.array(depth))
        return write_one(args, depth, ow, oh, src, feats)

    # MiDaS twice: through --allow_random, whose seed-0 draw ends in a last
    # convolution that is negative everywhere behind its ReLU, so its
    # relative depth is all zero and every PNG constant (accepted there);
    # then from a file in the hub layout (through the strict loader) with
    # the same random weights but a head bias of +0.1, which gives maps
    # with a range to check
    midas_file = os.path.join(tmp, "dpt_large_random.pt")
    midas_random_file(midas_file)
    generate_depth.build, generate_depth.write_one = keep_build, keep_first
    results = {}
    try:
        for label, model, per_batch, with_bias, weights in (
                ("zoedepth", "zoedepth", 48, True, ["--allow_random"]),
                # the float32 entry: 48 launches of K1's float32 kernel per batch
                ("zoedepth_f32", "zoedepth", 48, True, ["--allow_random", "--dtype", "float32"]),
                ("midas_random", "midas", 24, False, ["--allow_random"]),
                ("midas", "midas", 24, False, ["--weights", midas_file])):
            out_dir = os.path.join(tmp, f"depth_{label}")
            argv = ["--data_dir", os.path.dirname(image_dir), "--output_dir", out_dir,
                    "--model", model, "--batch_size", "8", *weights]
            first_depth.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            att.KERNEL.launches = att.KERNEL.bias_launches = bil.KERNEL.launches = 0
            att.KERNEL.f32_launches = 0
            t0 = time.perf_counter()
            written = generate_depth.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches, bias_launches, k4 = (att.KERNEL.launches, att.KERNEL.bias_launches,
                                           bil.KERNEL.launches)
            f32_launches = att.KERNEL.f32_launches
            peak = torch.cuda.max_memory_allocated() / 2**30
            expected = per_batch * DEPTH_BATCHES
            if (written != len(DEPTH_IMAGES) or launches != expected or k4 != 0
                    or bias_launches != (expected if with_bias else 0)
                    or f32_launches != (expected if label == "zoedepth_f32" else 0)):
                raise AssertionError(f"{model}: {written} maps, {launches} K1 launches "
                                     f"({bias_launches} with a bias), {k4} K4 launches; "
                                     f"expected {expected} K1 launches per "
                                     f"{DEPTH_BATCHES} batches, all with a bias: {with_bias}")
            names = sorted(os.listdir(image_dir))
            constant = []
            for name, (w, h) in zip(names, DEPTH_IMAGES):
                png = np.asarray(Image.open(os.path.join(out_dir, "val",
                                                         f"{name[:-4]}_{model}.png")))
                constant.append(bool(png.min() == png.max()))
                if png.dtype != np.uint8 or png.shape != (h, w) or (
                        constant[-1] and label != "midas_random"):
                    raise AssertionError(f"{label} {name}: PNG {png.dtype} {png.shape} "
                                         f"range {png.min()}-{png.max()}")
            # the PNG of the first image from the map the model gave it
            (src, depth), = [(s, d) for (m, s), d in first_depth.items()
                             if m == model and s.endswith(names[0])]
            if depth.shape != (DEPTH_IMAGES[0][1], DEPTH_IMAGES[0][0]):
                depth = np.asarray(Image.fromarray(depth, mode="F").resize(
                    DEPTH_IMAGES[0], Image.BILINEAR))
            norm = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-12)
            expect = ((1.0 - norm if model == "midas" else norm) * 255).astype(np.uint8)
            png = np.asarray(Image.open(os.path.join(out_dir, "val",
                                                     f"{names[0][:-4]}_{model}.png")))
            if not np.array_equal(png, expect):
                raise AssertionError(f"{label}: the PNG is not the (inverted for MiDaS) "
                                     "normalized depth")
            if label in ("midas_random", "zoedepth_f32"):
                results[label] = {"images": written, "batches": DEPTH_BATCHES,
                                  "k1_launches": launches, "k1_bias_launches": bias_launches,
                                  "k1_f32_launches": f32_launches, "k4_launches": k4,
                                  "main_seconds": seconds, "constant_maps": sum(constant),
                                  "peak_mem_gb": peak}
                phase("depth_path", model=label, **results[label])
                del built[model]
                continue

            # one 384 x 512 batch of 8 through the same model: CUDA events
            infer, _ = built[model]
            x = torch.rand(8, 3, 384, 512, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(5))
            xs = [x, x.flip(-1), 1 - x]
            att.KERNEL.launches = 0
            batch_ms = cuda_time_ms(lambda v: infer(v)[0], xs, iters=3, warmup=1)
            if att.KERNEL.launches != 4 * per_batch:
                raise AssertionError(f"{model}: {att.KERNEL.launches} K1 launches in 4 batches")
            results[model] = {
                "images": written, "batches": DEPTH_BATCHES, "k1_launches": launches,
                "k1_bias_launches": bias_launches, "k4_launches": k4,
                "k1_launches_per_batch": launches / DEPTH_BATCHES, "main_seconds": seconds,
                "main_img_per_s": written / seconds, "batch8_384x512_ms": batch_ms,
                "batch8_img_per_s": 8 / batch_ms * 1e3, "peak_mem_gb": peak}
            phase("depth_path", model=model, **results[model])
            del built[model], infer, x, xs
            torch.cuda.empty_cache()
    finally:
        generate_depth.build, generate_depth.write_one = build, write_one
    return results


def midas_random_file(path):
    """A DPT_Large state dict in the torch-hub layout: random full-width
    weights (CUDA generator seed 0), the head's last bias set to +0.1."""
    from depthg_tpu_torch.models.midas_dpt import MidasDPT, MidasDPTConfig

    with torch.device("cuda"):
        model = MidasDPT(MidasDPTConfig()).init_weights(
            torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        model.scratch.output_conv[4].bias.fill_(0.1)
    torch.save({k: v.bfloat16().cpu() for k, v in model.state_dict().items()}, path)
    del model
    torch.cuda.empty_cache()


def depth_numerics_phase(att):
    """Full-width ZoeDepth (LayerScale 0.1: at the default 1e-5 every random
    block is nearly the identity and attention would not show): bf16
    through K1 vs the eager softmax on the card, then float32 on the card
    (through K1) vs the CPU's plain path at 4 of the 24 blocks."""
    import dataclasses

    from depthg_tpu_torch.models.zoedepth import ZoeConfig, ZoeDepth
    from depthg_tpu_torch.models.zoedepth.beit import BEiTConfig
    from depthg_tpu_torch.models.zoedepth.model import prep

    cfg = ZoeConfig(beit=BEiTConfig(layer_scale_init=0.1))
    gen = torch.Generator(device="cuda").manual_seed(7)
    with torch.device("cuda"):
        model = ZoeDepth(cfg).init_weights(gen).bfloat16().eval()
    x = prep(torch.rand(2, 3, 384, 512, device="cuda", generator=gen), cfg).bfloat16()
    outs = {}
    for impl in ("fused", "xla"):
        att.KERNEL.launches = 0
        with torch.inference_mode():
            taps, _ = model.core.core.pretrained.model(x, impl)
            outs[impl] = (taps, model(x, attn_impl=impl)["metric_depth"].float())
        if att.KERNEL.launches != (48 if impl == "fused" else 0):
            raise AssertionError(f"{impl}: {att.KERNEL.launches} K1 launches")

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    tap_err = [rel(a, b) for a, b in zip(outs["fused"][0], outs["xla"][0])]
    depth_err = rel(outs["fused"][1], outs["xla"][1])
    del model, outs
    torch.cuda.empty_cache()

    cfg4 = dataclasses.replace(cfg, beit=dataclasses.replace(cfg.beit, depth=4,
                                                             hooks=(0, 1, 2, 3)))
    cpu_model = ZoeDepth(cfg4).init_weights(torch.Generator().manual_seed(8)).eval()
    card_model = copy.deepcopy(cpu_model).cuda()  # attn_impl "auto": the kernel
    x32 = prep(torch.rand(1, 3, 384, 512, generator=torch.Generator().manual_seed(9)), cfg4)
    att.KERNEL.launches = 0
    with torch.inference_mode():
        on_card = card_model(x32.cuda())["metric_depth"].cpu()
        if att.KERNEL.launches != 4:
            raise AssertionError(f"float32 card run: {att.KERNEL.launches} K1 launches")
        t0 = time.perf_counter()
        on_cpu = cpu_model(x32)["metric_depth"]
        cpu_s = time.perf_counter() - t0
    card_err = rel(on_card, on_cpu)
    phase("depth_numerics", layer_scale_init=0.1, bf16_batch=2, res=[384, 512],
          kernel_vs_eager_tap_rel_err=tap_err, kernel_vs_eager_depth_rel_err=depth_err,
          f32_blocks=4, f32_card_vs_cpu_depth_rel_err=card_err, cpu_seconds=cpu_s,
          limits=[DEPTH_KERNEL_VS_EAGER_TOL, DEPTH_CARD_VS_CPU_TOL])
    if max(tap_err + [depth_err]) > DEPTH_KERNEL_VS_EAGER_TOL or card_err > DEPTH_CARD_VS_CPU_TOL:
        raise AssertionError(f"depth numerics: kernel vs eager {tap_err}, {depth_err}; "
                             f"card vs CPU {card_err}")
    return {"tap_rel_err": tap_err, "depth_rel_err": depth_err, "card_vs_cpu": card_err}


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
    from depthg_tpu_torch.models.zoedepth import beit

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
    attn = attention_phase(att, gen, runtime)
    attn_bias = attention_bias_phase(att, beit, gen)
    k4 = bilateral_phase(bil, crf, study, runtime)
    crf_phase(study, crf)
    fidelity = fidelity_rows_phase(study, bil)
    main_res = main_path_phase(att, bil, inference, vit_lib, featurizer, crf, gen)
    train_res = train_path_phase(att, bil, inference, featurizer, gen)
    train_f32 = train_card_vs_cpu_phase(att, inference, featurizer)
    serve_shapes = attention_serving_shapes(att, gen)
    with tempfile.TemporaryDirectory() as tmp:
        serve_res = serve_path_phase(att, bil, inference, featurizer, tmp)
        demo_res = demo_path_phase(att, bil, inference, serve_res["ckpt"], tmp)
        knn_res = knn_path_phase(att, bil, featurizer, runtime, gen, tmp)
        depth_res = depth_path_phase(att, bil, tmp)
    depth_numerics_phase(att)

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
        "train_path_launches": train_res["launches"],
        "serve_path_launches": serve_res["launches"],
        "serve_path_batches": serve_res["batches"],
        "demo_path_launches": demo_res["launches"],
        "knn_path_launches": knn_res["launches"],
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
        "train_shape": f"B={TRAIN_B}, N={TRAIN_N}, {HEADS} heads x 64, packed qkv",
        "train_ms": attn["train_bf16"]["ms"],
        "train_kernel_only_ms": attn["train_bf16"]["kernel_only_ms"],
        "train_plain_ms": attn["train_bf16"]["plain_ms"],
        "train_bound_ms": attn["train_bf16"]["bound_ms"],
        "train_bound_by": attn["train_bf16"]["bound_by"],
        "train_library_ms": attn["train_bf16"]["library_ms"],
        "train_max_abs_err": attn["train_bf16"]["max_abs_err"],
        "train_rel_err": attn["train_bf16"]["rel_err"],
        "train_f32_ms": attn["train_f32"]["ms"],
        "train_f32_plain_ms": attn["train_f32"]["plain_ms"],
        "train_f32_max_abs_err": attn["train_f32"]["max_abs_err"],
        "serve_and_knn_shapes": serve_shapes,
        "depth_path_launches": depth_res["zoedepth"]["k1_launches"],
        "depth_path_bias_launches": depth_res["zoedepth"]["k1_bias_launches"],
        "depth_path_midas_launches": depth_res["midas"]["k1_launches"],
        "depth_path_midas_random_launches": depth_res["midas_random"]["k1_launches"],
        "bias_shape": f"bf16, B=8, N={BIAS_N}, {BIAS_HEADS} heads x 64, packed qkv, "
                      f"bias [{BIAS_HEADS}, {BIAS_N}, {BIAS_N}] bf16",
        "bias_ms": attn_bias["bf16_b8"]["ms"],
        "bias_device_ms": attn_bias["bf16_b8"]["device_ms"],
        "bias_kernel_only_ms": attn_bias["bf16_b8"]["kernel_only_ms"],
        "bias_library_ms": attn_bias["bf16_b8"]["library_ms"],
        "bias_library_device_ms": attn_bias["bf16_b8"]["library_device_ms"],
        "bias_plain_ms": attn_bias["bf16_b8"]["plain_ms"],
        "bias_bound_ms": attn_bias["bf16_b8"]["bound_ms"],
        "bias_bound_by": attn_bias["bf16_b8"]["bound_by"],
        "bias_max_abs_err": attn_bias["bf16_b8"]["max_abs_err"],
        "bias_rel_err": attn_bias["bf16_b8"]["rel_err"],
        "bias_cases": attn_bias,
        # the float32 kernel (split TF32) at the eval shape, then per path
        "f32_kernel_only_ms": attn["f32"]["kernel_only_ms"],
        "f32_kernel_device_ms": attn["f32"]["kernel_device_ms"],
        "f32_library_ms": attn["f32"]["library_ms"],
        "f32_library_device_ms": attn["f32"]["library_device_ms"],
        "f32_bound_ms": attn["f32"]["bound_ms"], "f32_bound_by": attn["f32"]["bound_by"],
        "f32_fma_bound_ms": attn["f32"]["fma_bound_ms"],
        "f32_pack_device_ms": attn["f32"]["pack_device_ms"],
        "f32_attention_kernel_device_ms": attn["f32"]["attention_kernel_device_ms"],
        "train_f32_kernel_device_ms": attn["train_f32"]["kernel_device_ms"],
        "train_f32_library_ms": attn["train_f32"]["library_ms"],
        "train_f32_library_device_ms": attn["train_f32"]["library_device_ms"],
        "train_f32_bound_ms": attn["train_f32"]["bound_ms"],
        "train_f32_fma_bound_ms": attn["train_f32"]["fma_bound_ms"],
        "train_f32_pack_device_ms": attn["train_f32"]["pack_device_ms"],
        "train_f32_attention_kernel_device_ms": attn["train_f32"]["attention_kernel_device_ms"],
        "train_f32_rel_err": attn["train_f32"]["rel_err"],
        "f32_launches": {
            "knn_embedding_per_batch": knn_res["f32_launches"] / 2,
            "train_validation_batch": train_res["validation_launches"],
            "f32_eval_predict": main_res["f32_eval_launches"],
            "f32_train_step": train_f32["f32_launches"],
            "zoedepth_f32_per_batch": depth_res["zoedepth_f32"]["k1_f32_launches"] / DEPTH_BATCHES,
            "zoedepth_f32_bias_per_batch":
                depth_res["zoedepth_f32"]["k1_bias_launches"] / DEPTH_BATCHES},
    }, {
        "name": "crf_bilateral", "route": "cuda",
        "source": "depthg_tpu_torch/csrc/crf_bilateral.cu",
        "replaces": "depthg_tpu/ops/crf_pallas.py:66",
        "launches": main_res["points"]["exact_ds1"]["k4_launches"],
        "train_path_launches": train_res["k4_launches"],
        "serve_path_launches": serve_res["k4_launches"],
        "serve_path_exact_request_launches": serve_res["exact_k4_launches"],
        "demo_path_launches": demo_res["k4_launches"],
        "knn_path_launches": 0,
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
        # the float32 message (split TF32) at the exact eval step's shape
        "f32_kernel_only_ms": k4["n102400_f32"]["kernel_only_ms"],
        "f32_bound_ms": k4["n102400_f32"]["bound_ms"],
        "f32_fma_bound_ms": k4["n102400_f32"]["fma_bound_ms"],
        "f32_pack_device_ms": k4["n102400_f32"]["pack_device_ms"],
        "f32_message_kernel_device_ms": k4["n102400_f32"]["message_kernel_device_ms"],
        "f32_rel_err": k4["n102400_f32"]["rel_err"],
        "f32_max_abs_err": k4["n102400_f32"]["max_abs_err"],
        "c27_f32_ms": k4["n102400_c27_f32"]["ms"],
        "c27_f32_fma_bound_ms": k4["n102400_c27_f32"]["fma_bound_ms"],
        "n25600_f32_kernel_only_ms": k4["n25600_f32"]["kernel_only_ms"],
        "n25600_f32_fma_bound_ms": k4["n25600_f32"]["fma_bound_ms"],
        "f32_library_ms": None,
        "exact_f32_crf_message_launches_per_run":
            fidelity["exact (ds=1)"]["k4_f32_message_launches"] / 2,
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
