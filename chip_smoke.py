"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero before the
final line):

1. device: CUDA required; card name and power limit; TF32 off;
2. build: nvcc builds ``depthg_tpu_torch/csrc/attention.cu``,
   ``csrc/crf_bilateral.cu``, ``csrc/zoe_bins.cu``, ``csrc/swiglu.cu`` and
   ``csrc/residual_norm.cu``, one process each, started together;
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
   table by the BEiT module's own builder, in the q dtype) at bf16 B=1, 2,
   8, 16 and float32 B=2 and 8 (``--dtype float32``): kernel vs plain, the
   bias acting, +1e4 in the bias past n_valid=700 without influence, an odd
   row stride refused, B=8 equal to its images one by one, times through
   ``attention_qkv``, queued
   and alone, without the bias (the difference: the bias's own cost), the
   kernel alone by ``torch.profiler``, the library call with the bias as
   its ``attn_mask``, the plain version, and the bound with the bias
   bytes; also float32 B=1 at 480 x 640 (N=1201, the bias [16, 1201,
   1208]: the fine-tune's validation); then kernel vs plain at the bias
   kernel's edges (N=577, 1345, B=3 and 5, n_valid 768, 640 and 129, bf16
   at N=1201); then K1 without a bias at MiDaS's shape (bf16 B=8, N=769,
   16 heads: the same figures, the kernel by ``torch.profiler`` too); then
   K1 at the cases of fault F6 (N=769 with n_valid 640 and 129, N=1664
   with 1400 and 1; bf16 and float32, without and with a bias) into output
   memory that held NaN, proved by the output's address: rows past n_valid
   exactly 0, the others within TOL of the plain version, no NaN;
4. bilateral kernel (K4) vs ``bilateral_message_plain`` on the features of
   two fidelity scenes: N=25,600 (ds=2), C=54, B=2 in f32 and bf16, a
   ragged N=25,563 read through views of a NaN-padded buffer, and the
   exact CRF's N=102,400 at the shapes its paths launch: B=2, C=54 in f32
   and bf16 (the eval step), its degree (the degree entry, and the f32
   C=1 message on ones) and the fidelity row's f32 C=27, plus bf16 at
   B=2, C=27 and at B=1, C=54 and 27 (one image, one or both probes);
   relative and max abs error, CUDA-event times of kernel and plain, the
   kernel alone on a preallocated output, and the bounds from the shapes
   (the slowest of the memory rate, one ex2 per entry at the SM clock
   read, and the tensor cores' products, the exponent over augmented
   features among them; the degree entry's with its row sums' adds, its
   pack step and loop by ``torch.profiler``), and beside them yardsticks
   of this kernel's algorithm (10 FP32 instructions per entry, 11 for the
   degree; float32: 10 + C on the FMA pipes); TF32 still off;
5. CRF precision: the int8 bilateral cache of a 320 px scene built on the
   card (one launch of the cache kernel) vs float64 on the CPU; the cache
   kernel and the eager build at the eval step's B=16, N=6,400 (16 scenes):
   CUDA-event times (also queued behind a long product), the bound (bytes
   written once, or one ex2 per entry) and the entries where the two
   builds differ; the int8 message through that cache (a quantize and a
   product launch) at B=16, N=6,400 with C=54 and C=1 and at N=8,100, bit
   for bit against its plain version and (N=6,400) the ``torch._int_mm``
   route it replaced, CUDA-event times (also queued), each kernel by
   ``torch.profiler``, the host time a call, the route's and the plain
   version's times and the bound (the cache read once); then the CRF on the
   six fidelity scenes
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
   counts (one int8 cache launch and 13 int8 messages per batch), confusion
   sums, img/s; then
   one image in float32 on the card vs the CPU (plain path) for pixel
   agreement (24 launches of K1's float32 kernel); then the same step at
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
    MiDaS batch, none with one, no K4 launch; two launches of the bins
    tail kernel per bf16 ZoeDepth batch (one a pass), none in float32 or
    for MiDaS; every PNG 8-bit, of its
    image's size and (but under ``--allow_random`` MiDaS) not constant; the
    first image's PNG equal to its normalized depth (inverted for MiDaS);
    the host time of ``main``, the CUDA-event time of one 384 x 512 batch of
    8, peak memory;
13. depth numerics: full-width ZoeDepth with LayerScale 0.1 (at the default
    1e-5 random blocks are nearly the identity and attention would not
    show): bf16 through K1 vs the eager softmax on the card (taps and metric
    depth, relative error), then one 384 x 512 image in float32 through K1
    on the card vs the CPU's plain path at 4 of the 24 blocks (metric depth
    within 1e-4 relative); then ZoeDepth's bins tail at the depth cell's
    shape (B=8, 384 x 512, a pass; ``tests/bins_tail_cases.py``'s inputs and
    limits): the kernel against its plain version, its time back to back,
    queued and by ``torch.profiler``, its host time a call, the plain
    version's time, the bound (bytes); then DINOv2's SwiGLU gate at the
    DINOv2 cell's shape (``w12``'s bf16 output [32 x 1,029, 8,192]): the
    kernel bit for bit against eager ``F.silu(a) * b`` (and in float32 at
    1,029 rows), one launch a call, its time back to back, queued and by
    ``torch.profiler``, its host time a call, the eager pair's time (the
    plain version, and the library yardstick), the bound (bytes); then the
    ViT blocks' residual junction kernel at the DINOv2 cell's shape
    ([32 x 1,029, 1,536]) and Depth Anything V2's ([8 x 1,814, 1,024]), bf16
    with LayerScale: each entry (the residual with the next norm, the
    residual, the norm) back to back, queued and by ``torch.profiler``,
    against its bound (bytes) and beside the eager passes it replaced; the
    sum bit for bit against eager, the norm within one bf16 step, one launch
    a call; then the
    DINOv2 path: the DINOv2 cell's eval step (``inference.make_eval_step``
    with the CRF, resolution, flip-TTA and bf16 backbone of
    ``benchmark/configs/depthg-dinov2-vitg14reg-cocostuff27.json``) on a
    full-width ViT-g/14-reg segmenter with random weights from seed 0, at
    batch 16 and 448 px: one warm-up and 3 timed steps, the gate's and K1's
    counts set to 0 just before and read just after (40 of each a step, one
    a block of the stacked [32] forward; 121 residual junction launches, three
    a block and the final norm), the confusion sums, and in the
    warm-up step one block's ``w3`` input bit for bit against eager
    ``F.silu(a) * b`` of its ``w12`` output;
14. fine-tune path: ``finetune_zoedepth.main`` at full width (random
    float32 ZoeDepth from seed 0, TF32 off) on a synthetic NYU layout of 8
    training and 4 evaluation pairs at 640 x 480: 4 steps at batch 4 (the
    reference's 16 would hold ~106 GB of eager float32 attention alone),
    validation after steps 2 and 4 and at the end; no K1 launch in a
    training step (the kernel has no backward: eager attention), 24 float32
    K1 launches with the bias per validation image (N=1201), finite
    losses, the nine metrics, ``latest.pt`` / ``best.pt`` through
    ``load_zoedepth_pt`` giving the depth of the weights they were written
    from; ms per step on CUDA events and the host clock, ms per validation
    image, peak memory; then one float32 loss and backward at 4 of the 24
    blocks on 2 x 192 x 256 on the card vs the CPU: the loss and all
    gradients together within 1e-4 relative, every gradient tensor within
    1e-4 of the CPU's float64
    gradient beyond the CPU's own float32 error (SILog's gradient nearly
    cancels in the decoder's output convolutions: any float32 run is
    ~2.5e-3 off float64 there). Phase 3 holds K1 float32 with the bias
    at that validation's shape (B=1, N=1201, the bias [16, 1201, 1208]);
15. NK path: full-width ZoeDepth-NK (``get_config("zoedepth_nk")``,
    LayerScale 0.1, random weights), one 384 x 512 batch of 2 through K1
    (24 launches with the bias) vs the eager softmax on the card: bf16
    within 3e-2, float32 within 1e-4 relative, the same domain both ways;
16. variants path (ROADMAP item 6): ``configs/local_config.yml`` at full
    width (ViT-S/8, batch 32, 224 px, dim 70, bf16 backbone, random
    weights from seed 0) through ``train.step.train_step`` with
    ``arch=dino_depth guidance=cross_attn``, ``guidance=sum``, ``lhp=True``
    with ``propagation_strategy=depth`` and ``attn``, and
    ``arch=feature-pyramid model_type=resnet50 granularity=4`` (a random
    ResNet-50): one warm-up and nine timed steps each, ms per step on CUDA
    events and the host clock, peak memory, K1 launches per step held to
    24 / 24 / 24 / 12 / 0, no K4 launch, finite logs, falling probe losses,
    the frozen ViT / ResNet (running statistics included) / LHP head bit
    for bit, the pyramid head's BatchNorm statistics moved; one
    ``dino_depth`` eval step at 320 px, batch 16, default CRF point (24 K1
    launches); LHP's depth affinity at B=4, 224 px on the card vs the CPU
    in float32 (zero-pattern flips only within 2e-3 of the threshold, each
    printed with its distance; the mixed code within 1e-5 relative); the
    float32 pyramid (granularity 4) on the card vs the CPU within 1e-4
    relative; ``precompute_knns`` with ``model_type=resnet50`` over 40
    synthetic crops (a random ResNet-50: no file under ``output_root``),
    self at rank 0;
17. the total time, the kernels JSON line (each kernel's float32 figures
    and float32 launches per path among them, K1's launches per rank and
    per replica of phase 18 and per int8 path of phase 19), the card line
    and the final JSON line;
18. parallel paths (ROADMAP item 7; run before phase 17's lines): two gloo
    ranks (``chip_smoke.py --parallel-worker``) and two NCCL probes
    (``--nccl-probe``) share the card with this process after its timed
    parts. First, here, the train cell of phase 7 (bf16, 224 px, batch 32)
    runs twice without a process group and once through the torchrun code
    path in an NCCL group of one (``parallel.dist.init_from_env``): the first step's
    logs bit-equal (its forward is deterministic), its gradients no
    further from the ungrouped run than 4x the two ungrouped runs' own
    difference (the backward adds with atomics: ``grid_sample``, bilinear
    resize; parameters are not bit-equal even between two ungrouped runs),
    the parameters within 1e-6 of their scale plus the Adam gap, 24 K1
    launches per step, ms per step with and without the group (the
    collectives' overhead); then the service with two replicas on
    ``cuda:0`` serves 13 images in bucket 16 (8 rows a replica): every
    response equal to ``make_predict_step`` on its replica's rows, 12 K1
    launches per replica, no K4, host ms beside one device's and the two
    halves in turn. The two ranks (16 rows each of the same batches): three
    float32 train steps (TF32 off) against one process on the card (logs
    and step-1 gradients 1e-5 relative, parameters 1e-5 of their scale
    plus the Adam gap), 24 float32 K1 launches per rank per step; one
    default-point eval step at global batch 16 (confusion blocks equal,
    else >= 99.9% of labels, flips printed); ``topk_neighbors`` at
    N=147,456 with its query rows split (indices equal). The probes print
    the error NCCL gives for two ranks on one card;
19. the int8 (w8a8) backbone (its linears right after phase 2, its paths
    before phase 17's lines): ``linear_w8a8`` at every linear shape of the ViT-S/8 eval step
    (M = 16 x 1,601) and of BEiT-L's 384 x 512 batch of 8 (M = 8 x 769) on
    the card against the CPU: the weight and activation codes and scales
    (mismatch counts printed), the int32 sums of 2,048 rows exactly, the
    bf16 outputs within one bf16 step; CUDA-event times of the linear, its
    quantize pass, ``torch._int_mm`` and bf16 ``F.linear``, the bounds, and
    a ``torch.profiler`` split of the int8 product from the other passes,
    traced first in a process of its own (``--int8-profile``).
    Then every entry point with ``backbone_dtype=int8``: the default-point
    eval step at batch 16, 320 px, bf16 and int8 in turns (24 K1 launches
    per batch, no K4, img/s; every int8 batch forwards through the cached
    int8 copy's w8a8 linears; the int8 features' cosine to float32 > 0.99);
    one batch of 16 served through ``serve.build_service`` (12 K1
    launches); the train cell (224 px, batch 32) one warm-up and 5 + 5
    steps, bf16 and int8 in turns (24 K1 launches per step, no K4, finite
    logs, falling probe losses, the frozen ViT bit for bit);
    ``generate_depth.main --dtype int8 --allow_random`` for ZoeDepth and
    MiDaS over phase 12's images (48 K1 launches per batch, all with the
    bias, and 24; 8-bit PNGs of each image's size) and one 384 x 512 batch
    of 8 beside bf16, in turns; two steps of ``train_crf.main`` on a
    two-image Coco layout;
20. bench (before phase 17's lines): ``python -m depthg_tpu_torch.bench`` at
    full size in a process of its own, its JSON line printed: exit 0, the
    ``default`` headline, all four points measured, no ``*_error`` and no
    fall-back, K1 launches per eval step 24 / 24 / 24 / 0 (``safe`` runs the
    eager attention) and 24 per train step with each backbone, the card's
    name and power limit as its ``device``; then ``step_flops`` of one
    smoke-size eval step (the bench's smoke setup, 128 px, batch 2) from
    one set of weights, equal on the card (24 K1 launches) and on the CPU.
"""

import copy
import io
import json
import math
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
N_PADDED = 1664  # the eval batch padded to a multiple of 64 rows, n_valid = N
TRAIN_B, TRAIN_RES, TRAIN_STEPS = 32, 224, 5
TRAIN_N = (TRAIN_RES // 8) ** 2 + 1  # 785 tokens
# K1 at the serving stack's shapes (bf16, N=1601: a bucket of b images is a
# batch of b, or of 2b under fused_tta) and at the KNN embedding's (float32)
SERVE_ATTENTION_B = (1, 2, 4, 8, 32)
# a served label map vs the same image in a batch-16 predict. Buckets 2-16
# give the batch-16 labels bit for bit; bucket 1 (one image: a backbone
# batch of 2) does not: its pre-CRF logits differ by up to 9.4e-3 in bf16,
# and at worst 98.90% of an image's pixels agree, on the parent tree too
# (a one-off bucket study whose figures CHANGES.md keeps; NVIDIA H100, 700 W). So
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
# int8 messages of one default-point CRF call: the coarse degree, 5 coarse
# iterations, the mid and full degrees, 4 mid iterations and 1 full one
CRF_MESSAGES = 13
# DINOv2's SwiGLU gate at the DINOv2 cell's shape: w12's output over stacked
# flip-TTA at batch 16 (32 x 1,029 tokens: the class token, 4 registers,
# 32 x 32 patches at 448 px) and ViT-g's hidden width
SWIGLU_M, SWIGLU_H = 32 * 1029, 4096
# the residual junction's rows: the DINOv2 cell's stacked [32] forward at
# N = 1,029, Depth Anything V2's batch 8 at N = 1,814
RESIDUAL_DINOV2_ROWS, RESIDUAL_DAV2_ROWS = 32 * 1029, 8 * 1814
# and ViT-S/8's or ViT-B/8's stacked eval batch of 16 at 320 px (N = 1,601)
RESIDUAL_VIT8_ROWS = 32 * N
# the DINOv2 cell's configuration (its step's CRF, resolution, flip-TTA and
# backbone dtype), its batch, and the block whose gate the path phase checks
DINOV2_CONFIG = os.path.join(ROOT, "benchmark", "configs",
                             "depthg-dinov2-vitg14reg-cocostuff27.json")
DINOV2_B = 16
DINOV2_CHECKED_BLOCK = 20
SMS = 132
# kernel vs plain: dtype -> (max abs error, relative error ||out-ref||/||ref||).
# Outputs here average ~600 keys (~0.04, max ~0.3), so a max-abs limit alone
# cannot see a kernel that is off by a few percent; bf16 rounding of P and of
# the output gives a relative error near 3e-3, such a bug 2e-2 and more.
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 5e-3)}
CRF_REF = (69.67, 84.08)  # docs/CRF_FIDELITY.md:33 (mIoU, accuracy), +-0.2
LATTICE_REF = 98.60  # the same row's label agreement with the lattice (%), +-0.2
# K1 with BEiT-L's relative-position bias at ZoeDepth's 384 x 512 input: a
# 24 x 32 patch grid plus cls, 16 heads of 64; (dtype, batch, grid) cases:
# bf16 at the tails' B=1, ZoeDepth-NK's B=2, --batch_size 8 and 16, float32 (the parity mode)
# at B=2 and at ``generate_depth --dtype float32``'s B=8, and float32 B=1 at NYU's
# 480 x 640 (30 x 40 + 1 = 1201 tokens: the fine-tune's validation, one image at a
# time; the bias [16, 1201, 1208])
BIAS_N, BIAS_HEADS, BIAS_DIM, BIAS_GRID = 769, 16, 1024, (24, 32)
FT_GRID = (30, 40)
BIAS_CASES = ((torch.bfloat16, 1, BIAS_GRID), (torch.bfloat16, 2, BIAS_GRID),
              (torch.bfloat16, 8, BIAS_GRID),
              (torch.bfloat16, 16, BIAS_GRID), (torch.float32, 2, BIAS_GRID),
              (torch.float32, 8, BIAS_GRID), (torch.float32, 1, FT_GRID))
BIAS_N_VALID = 700
MIDAS_B = 8  # MiDaS's DPT_Large at 384 x 512: ViT-L/16, N=769, 16 heads, no bias
# the bias kernel's edges, held against the plain version only: (dtype, batch,
# grid, n_valid or None): 384 x 384 (N=577), the portrait bucket (N=1345),
# batches of 3 and 5, n_valid 768 (no row past three 256-row blocks), 640 and
# 129 (ragged key tiles and query blocks), bf16 at N=1201
BIAS_EDGE_CASES = ((torch.bfloat16, 2, (24, 24), None), (torch.float32, 2, (24, 24), None),
                   (torch.bfloat16, 1, (42, 32), None), (torch.bfloat16, 3, BIAS_GRID, None),
                   (torch.bfloat16, 5, BIAS_GRID, None), (torch.bfloat16, 2, BIAS_GRID, 768),
                   (torch.bfloat16, 2, BIAS_GRID, 640), (torch.bfloat16, 2, BIAS_GRID, 129),
                   (torch.float32, 2, BIAS_GRID, 768), (torch.float32, 2, BIAS_GRID, 129),
                   (torch.bfloat16, 1, FT_GRID, None))
# depth generation: 8 images of 640 x 480 (one 384 x 512 bucket, one batch
# of 8), 2 of 480 x 640 (512 x 384) and 1 of 400 x 400 (384 x 384)
DEPTH_IMAGES = ((640, 480),) * 8 + ((480, 640),) * 2 + ((400, 400),)
DEPTH_BATCHES = 3
# full-width bf16 forward through K1 vs the eager softmax on the card, and
# float32 on the card vs the CPU (relative error of the metric depth)
DEPTH_KERNEL_VS_EAGER_TOL, DEPTH_CARD_VS_CPU_TOL = 3e-2, 1e-4
# ZoeDepth-NK through K1 vs the eager softmax on the card: relative errors of
# BEiT's four taps and of the metric depth. Set from the readings of a run
# beside a control that drops the bias (NVIDIA H100 80GB HBM3, 700.00 W):
# bf16 taps 3.1e-3, 5.2e-3, 6.9e-3, 8.4e-3, the control 1.41e-2, 1.99e-2,
# 2.42e-2, 2.75e-2 (each limit near the geometric mean of the two); float32
# taps <= 6.4e-7, the control >= 1.19e-2. The metric depth cannot see the
# bias in bf16 (7.1e-5 with it, 7.0e-5 without; the limit is the depth
# phase's 3e-2); in float32 2.3e-8 with it, 5.5e-6 without
NK_TOL = {"bf16": {"taps": (6.5e-3, 1e-2, 1.3e-2, 1.5e-2),
                   "metric_depth": DEPTH_KERNEL_VS_EAGER_TOL},
          "f32": {"taps": (1e-4,) * 4, "metric_depth": 1e-6}}
# K4 vs plain: dtype -> (relative error, max abs error / max |ref|), as in
# tests/test_torch_cuda.py; in bf16 both sides round float32 sums to bf16
# and may land one bf16 step (<= 2^-7 of the value) apart. At
# N=102,400 the f32 kernel's sequential sum over the keys and cuBLAS's
# order in the plain version part by ~sqrt(N) float32 roundings: 5e-5.
K4_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (5e-3, 1e-2)}
K4_TOL_EXACT = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (5e-3, 1e-2)}
# fidelity rows run besides the default: (name in the port's study, K4
# launches per run: the exact CRF streams, the others cache)
# the fine-tune path: 8 training and 4 evaluation pairs at 640 x 480, batch
# 4 (the reference's 16 would hold ~106 GB of eager float32 attention), 4
# steps, validation after steps 2 and 4 (validate_every=1.0 of an epoch of
# 2 steps) and at the end
FT_TRAIN_IMAGES, FT_EVAL_IMAGES, FT_BATCH, FT_STEPS, FT_VALIDATIONS = 8, 4, 4, 4, 3
FT_METRICS = ("a1", "a2", "a3", "abs_rel", "rmse", "log_10", "rmse_log", "silog", "sq_rel")
FT_CARD_VS_CPU_TOL = 1e-4
# the variants of ROADMAP item 6 through the train step at the train
# path's full width (ViT-S/8 or the pyramid's ResNet-50, 224 px, batch 32,
# dim 70, bf16 backbone): (name, overrides of configs/local_config.yml, K1
# launches per step: 12 blocks x 2 frozen forwards; LHP "attn" runs the
# first forward eagerly for its attention maps; the ResNet has no attention)
VARIANTS = (("dino_depth_cross_attn", ["arch=dino_depth", "guidance=cross_attn"], 24),
            ("dino_depth_sum", ["arch=dino_depth", "guidance=sum"], 24),
            ("lhp_depth", ["lhp=True", "propagation_strategy=depth"], 24),
            ("lhp_attn", ["lhp=True", "propagation_strategy=attn"], 12),
            ("feature_pyramid", ["arch=feature-pyramid", "model_type=resnet50",
                                 "granularity=4"], 0))
# timed, after one warm-up step: ten in all. The pyramid's probe losses first
# rise (the cluster probe's first Adam step) and, on an H100, fell 2e-2 below
# their start after ten steps (3.074 -> 3.055), while the head's drift under
# other negatives moved them by ~7e-3 (3.0755 after four steps in another run)
VARIANT_STEPS = 9
DINO_DEPTH_EVAL_LAUNCHES = 24  # per eval step: flip TTA, two [B] forwards
# LHP's depth affinity on the card vs the CPU (float32, TF32 off): a flip of
# its zero pattern may only sit next to the threshold, within the
# expansion's rounding of a normalized distance; the mixed code in relative
# error. The pyramid's float32 code, card vs CPU, in relative error.
LHP_FLIP_GAP, LHP_CODE_TOL, PYRAMID_CARD_VS_CPU_TOL = 2e-3, 1e-5, 1e-4
KNN_CNN_IMAGES = 40
FIDELITY_ROWS = [("exact (ds=1)", 11), ("ds=2 legacy", 0), ("ds=4 mixed bf16", 0),
                 ("ds=4 jbu2 sf1.41 bf16 (quality+)", 0)]


# the least operations of each function bounded below, from its shapes alone
def attention_flops(b: int, h: int, n: int, n_valid: int, d: int = 64) -> float:
    """Masked attention on [B, H, N, D]: q k^T and P v over the keys that
    weigh, 2 N n_valid D operations each per (image, head)."""
    return 4.0 * b * h * n * n_valid * d


def bilateral_exponent_flops(b: int, n: int) -> float:
    """The CRF kernel's exponent -|f_i - f_j|^2 / 2 for every pair, as one
    product over the 5 features augmented to 8 (f_i . f_j - |f_i|^2 / 2 -
    |f_j|^2 / 2, the TPU kernel's form)."""
    return 2.0 * b * n * n * 8


def bilateral_product_flops(b: int, n: int, c: int) -> float:
    """K Z for [B, N, N] K and [B, N, C] Z."""
    return 2.0 * b * n * n * c


def bilateral_degree_adds(b: int, n: int) -> float:
    """K 1: one add per entry of K."""
    return float(b) * n * n


def int8_matmul_flops(m: int, k: int, n: int) -> float:
    """An [M, K] x [K, N] product."""
    return 2.0 * m * k * n


def bins_tail_flops(b: int, h: int, w: int, c_in: int, bottleneck: int) -> float:
    """ZoeDepth's bins tail: the c_in -> bottleneck -> 4 products per pixel
    of [B, H, W], as the flop counter counts the two 1x1 convolutions."""
    return 2.0 * b * h * w * (c_in * bottleneck + bottleneck * 4)


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


def profiled_device_ms(fn, inputs, tries=6):
    """(device ms, kernels) per call of ``fn``, summed over every kernel of
    a ``torch.profiler`` CUDA trace of one call per input. CUPTI can drop
    some or all of a trace's records after earlier traces, so a trace
    counts only when the one before it held as many kernels per call (a
    whole number); after ``tries`` traces without two such, it raises."""
    from torch.profiler import ProfilerActivity, profile

    last = None
    for _ in range(tries):
        fn(inputs[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for v in inputs:
                fn(v)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_time_total > 0]
        kernels = sum(e.count for e in events)
        if kernels and kernels % len(inputs) == 0 and kernels == last:
            return (sum(e.device_time_total for e in events) / len(inputs) / 1e3,
                    kernels // len(inputs))
        last = kernels
    raise AssertionError(f"{tries} profiler traces gave no two equal kernel counts")


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
    ops = attention_flops(b, h, n, n)
    ops_ms = (ops / PEAK_BF16 if bf16 else 3 * ops / PEAK_TF32) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations"


def attention_fma_bound(b, n, h):
    """A yardstick for the float32 kernel: its 4 B H N^2 64 operations on
    the FMA pipes, where a float32 kernel without the tensor cores runs."""
    return attention_flops(b, h, n, n) / PEAK_F32 * 1e3


def bilateral_bound(b, n, c, itemsize, clock_mhz, degree=False):
    """Least ms for one message, the largest of: feats and values read and
    the output written once over the memory rate; one ex2 per entry of the
    N^2 on the MUFU (16 a clock per SM at ``clock_mhz``); and on the tensor
    cores, the exponent -|f_i - f_j|^2 / 2 as one product over the
    features augmented to 8 (f_i . f_j - |f_i|^2 / 2 - |f_j|^2 / 2, as
    the TPU kernel computes it) in split TF32 (three products), plus the 2 C
    operations of K Z on the bf16 tensor cores or, for float32 values, in
    split TF32. The degree entry (``degree``: K @ 1) reads the features,
    writes one float32 a point and sums each row on the FP32 pipes, one add
    per entry, in place of the product. The pipes run side by side, so the
    slowest sets the bound; ``bilateral_algorithm_bound`` and
    ``bilateral_fma_bound`` are yardsticks of this kernel's own algorithm."""
    entries = float(b) * n * n
    ex2_ms = entries / (16 * SMS * clock_mhz * 1e6) * 1e3
    exponent = 3 * bilateral_exponent_flops(b, n) / PEAK_TF32
    if degree:
        bytes_ms = b * n * 24 / PEAK_HBM * 1e3
        ops_ms = max(ex2_ms, exponent * 1e3,
                     bilateral_degree_adds(b, n) / (PEAK_F32 / 2) * 1e3)
    else:
        bytes_ms = b * n * (20 + 2 * c * itemsize) / PEAK_HBM * 1e3
        product = (3 * bilateral_product_flops(b, n, c) / PEAK_TF32 if itemsize == 4
                   else bilateral_product_flops(b, n, c) / PEAK_BF16)
        ops_ms = max(ex2_ms, (exponent + product) * 1e3)
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations"


def bilateral_algorithm_bound(b, n, degree=False):
    """A yardstick of this kernel's algorithm, not a bound of the function:
    the exponent from the differences of the features, 10 FP32
    instructions per entry (5 subtractions, 5 FMAs; the FP32 peak counts an
    FMA as 2), 11 with the degree entry's row-sum add, on the FP32 pipes."""
    return float(b) * n * n * (11 if degree else 10) / (PEAK_F32 / 2) * 1e3


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
        pad = torch.zeros(B, N_PADDED, 3 * DIM, device="cuda", dtype=dtype)
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


def attention_at_shape(att, gen, dtype, name, b, n, where, heads=HEADS, profile=False):
    """The kernel against its plain version at [b, n, heads x 64], packed
    qkv: errors within TOL, CUDA-event times of both, the bound, the kernel
    alone, the library call and the host time of a launch (``profile``: the
    bf16 kernel by ``torch.profiler`` too)."""
    base = torch.randn(b, n, 3 * 64 * heads, device="cuda", generator=gen)
    inputs = [(base + 1e-2 * i).to(dtype) for i in range(3)]
    out = att.attention_qkv(inputs[0], heads, SCALE)

    def plain(x):
        q, k, v = att.split_qkv(x, heads)
        return att.attention_plain(q, k, v, SCALE)

    ref = plain(inputs[0]).permute(0, 2, 1, 3).reshape(b, n, 64 * heads)
    torch.cuda.synchronize()
    err, rel = compare(out, ref, dtype, f"attention at B={b}, N={n} ({where})")
    row = {"max_abs_err": err, "rel_err": rel,
           "ms": cuda_time_ms(lambda x: att.attention_qkv(x, heads, SCALE), inputs),
           "plain_ms": cuda_time_ms(plain, inputs, iters=5, warmup=2)}
    row.update(attention_yardsticks(att, inputs, b, n, heads, profile))
    phase("attention", dtype=name, shape=[b, n, heads, 64], where=where, **row)
    return row


def k1_shapes():
    """Every (case, dtype, B, N, n_valid, heads, bias dtype or None) at which
    phase 3 holds K1 to its plain version: the eval shape and its pad, the train,
    serving, KNN and MiDaS shapes, and with BEiT-L's bias ``BIAS_CASES``
    (with and without ``BIAS_N_VALID``) and ``BIAS_EDGE_CASES``.
    ``depthg_tpu_torch/attention_contract_study.py`` compares two trees'
    kernels at these."""
    bf16, f32 = torch.bfloat16, torch.float32
    tag = {bf16: "bf16", f32: "f32"}
    shapes = [(f"{case}_{tag[d]}", d, b, n, nv, HEADS, None)
              for d in (bf16, f32)
              for case, b, n, nv in (("eval", B, N, N), ("eval_padded", B, N_PADDED, N),
                                     ("train", TRAIN_B, TRAIN_N, TRAIN_N))]
    shapes += [(f"serve_b{b}_bf16", bf16, b, N, N, HEADS, None) for b in SERVE_ATTENTION_B]
    shapes += [("knn_f32", f32, KNN_EMBED_B, TRAIN_N, TRAIN_N, HEADS, None),
               ("midas_bf16", bf16, MIDAS_B, BIAS_N, BIAS_N, BIAS_HEADS, None)]
    for d, b, grid in BIAS_CASES:
        n = grid[0] * grid[1] + 1
        shapes += [(f"bias_{tag[d]}_b{b}_n{n}_valid{nv}", d, b, n, nv, BIAS_HEADS, d)
                   for nv in (n, BIAS_N_VALID)]
    for d, b, grid, nv in BIAS_EDGE_CASES:
        n = grid[0] * grid[1] + 1
        nv = n if nv is None else nv
        shapes.append((f"bias_edge_{tag[d]}_b{b}_n{n}_valid{nv}", d, b, n, nv, BIAS_HEADS, d))
    return shapes


def attention_contract_phase(att, poison, gen):
    """K1 at the cases of fault F6 (``poison.F6_CASES``: rows < N of a
    256-row block's second round of sub-tiles that holds no row < n_valid),
    B=2, into output memory that held NaN (the address of the output proves
    it: ``poison.poisoned``), bf16 and float32, without and with a bias in
    the q dtype: rows >= n_valid exactly 0, the others within the tests'
    TOL of the plain version, no NaN; raises at the first case that fails."""
    rows = {}
    for n, nv, heads in poison.F6_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            for with_bias in (False, True):
                x = torch.randn(2, n, 3 * 64 * heads, device="cuda", generator=gen).to(dtype)
                bias = poison.padded_bias(heads, n, dtype, gen) if with_bias else None
                res = poison.k1_contract(att, x, heads, nv, bias)
                name = (f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_n{n}_valid{nv}"
                        + ("_bias" if with_bias else ""))
                phase("attention_contract", case=name, shape=[2, n, heads, 64], n_valid=nv,
                      **res)
                if not res["passes"]:
                    raise AssertionError(f"attention {name} on poisoned output: {res}")
                rows[name] = res
    return rows


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
                         "host_us_per_launch", "host_us_per_call", "library_host_us_per_call",
                         "grid") + (("fma_bound_ms", "pack_device_ms",
                                                   "attention_kernel_device_ms")
                                                  if name == "f32" else ())}})
        torch.cuda.empty_cache()
    return rows


def attention_grid(att, b, n, heads, dtype, bias=False):
    """The bf16 grid the wrapper chooses (``block_plan`` without a bias,
    every block 256 rows with one): 256-row blocks per (image, head),
    blocks in all, the SMs it was planned for; None for float32."""
    if dtype != torch.bfloat16:
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big = -(-n // 256) if bias else att.block_plan(b, heads, n, n, sms)
    return {"big_blocks_per_head": big, "blocks": len(att.plan_blocks(b, heads, n, big)),
            "blocks_if_all_256_rows": len(att.plan_blocks(b, heads, n, -(-n // 256))),
            "sms": sms}


def attention_small_grids(serve_shapes, midas, train):
    """K1 bf16 where its grid is small or ragged, side by side (queued device
    ms of the kernel and of the library call, the bound, host us of a launch,
    of a wrapper call and of a library call, the grid): the serving buckets'
    B=1, 2, 4, 8 at N=1601, MiDaS's batch and the train step's shape."""
    keys = ("kernel_device_ms", "library_device_ms", "bound_ms", "host_us_per_launch",
            "host_us_per_call", "library_host_us_per_call", "grid")
    rows = [{"shape": row["shape"], **{k: row[k] for k in keys}}
            for row in serve_shapes if row["where"] == "serve bucket"
            and int(row["shape"].split("B=")[1].split(",")[0]) <= 8]
    rows.append({"shape": f"bf16, B={MIDAS_B}, N={BIAS_N}, {BIAS_HEADS} heads x 64",
                 **{k: midas[k] for k in keys}})
    rows.append({"shape": f"bf16, B={TRAIN_B}, N={TRAIN_N}, {HEADS} heads x 64",
                 **{k: train[k] for k in keys}})
    for row in rows:
        row["kernel_over_library"] = row["kernel_device_ms"] / row["library_device_ms"]
    phase("attention_small_grids", rows=rows)
    return rows


def attention_yardsticks(att, inputs, b, n, heads=HEADS, profile=False):
    """At [b, n, heads] in the inputs' dtype: the kernel alone on a
    preallocated output, the library call, the host time of a launch
    (``_launch`` on a preallocated output), of a call of ``attention_qkv``
    and of the library call on the same q, k, v views, the grid and the
    bound; float32 (or ``profile``): the kernel by ``torch.profiler``."""
    dtype = inputs[0].dtype
    out = torch.empty(b, n, heads, 64, device="cuda", dtype=dtype).permute(0, 2, 1, 3)

    def launch(x):
        q, k, v = att.split_qkv(x, heads)
        return att._launch(q, k, v, out, SCALE, n)

    def library(x):
        q, k, v = att.split_qkv(x, heads)
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=SCALE)

    slow = dtype == torch.float32 and b * n > 50_000  # ~10 ms per call
    iters = 10 if slow else 50
    kernel_ms = cuda_time_ms(launch, inputs, iters=iters)
    library_ms = cuda_time_ms(library, inputs, iters=iters)
    kernel_device_ms = device_time_ms(launch, inputs, iters=iters)
    library_device_ms = device_time_ms(library, inputs, iters=iters)
    clock = sm_clock_mhz()
    q, k, v = att.split_qkv(inputs[0], heads)
    ref = library(inputs[0]).float()
    lib_rel = ((launch(inputs[0]).float() - ref).norm() / ref.norm()).item()
    torch.cuda.synchronize()
    reps = 20 if slow else 200

    def host_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return us

    launch_us = host_us(lambda: att._launch(q, k, v, out, SCALE, n))
    call_us = host_us(lambda: att.attention_qkv(inputs[0], heads, SCALE))
    library_us = host_us(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, scale=SCALE))
    bound_ms, bound_by = attention_bound(b, n, heads, dtype)
    traced = {}
    if dtype == torch.float32:
        # the pack step and the attention kernel that the float32 entry
        # launches in turn, each alone
        split = profiled_kernel_ms(launch, inputs, ("attn_pack_f32_kernel",
                                                  "attn_f32_wgmma_kernel"))
        traced = {"fma_bound_ms": attention_fma_bound(b, n, heads),
                  "pack_device_ms": split["attn_pack_f32_kernel"],
                  "attention_kernel_device_ms": split["attn_f32_wgmma_kernel"]}
    elif profile:
        traced = {"kernel_profiler_ms": profiled_kernel_ms(
            launch, inputs, ("attn_bf16_wgmma_kernel",))["attn_bf16_wgmma_kernel"]}
    return {**traced, "kernel_only_ms": kernel_ms, "library_ms": library_ms,
            "kernel_device_ms": kernel_device_ms, "library_device_ms": library_device_ms,
            "rel_err_vs_library": lib_rel, "host_us_per_launch": launch_us,
            "host_us_per_call": call_us, "library_host_us_per_call": library_us,
            "grid": attention_grid(att, b, n, heads, dtype),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ex2_bound_ms": b * heads * n * n / (16 * SMS * clock * 1e6) * 1e3,
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
            row["sm_clock_mhz"] = sm_clock_mhz()
            row["bound_ms"], row["bound_by"] = bilateral_bound(
                b, n, c, inputs[0].element_size(), row["sm_clock_mhz"])
            row["algorithm_bound_ms"] = bilateral_algorithm_bound(b, n)
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
            row["ex2_bound_ms"] = float(b) * n * n / (16 * SMS * row["sm_clock_mhz"] * 1e6) * 1e3
            if ones:
                # the degree entry (what the CRF calls) on the same features
                deg = bil.bilateral_degree(feats)
                torch.cuda.synchronize()
                drel, derr = k4_errors(deg, ref, tol[dtype], "bilateral degree entry")
                dbound, dbound_by = bilateral_bound(b, n, 1, 4, row["sm_clock_mhz"],
                                                    degree=True)
                # its pack step and its loop (the rows kernel's degree form) apart
                traced = profiled_kernel_ms(lambda v: bil.bilateral_degree(feats), inputs,
                                            ("pack_feats_kernel", "bilateral_rows_kernel"),
                                            iters=3)
                row.update(degree_entry_rel_err=drel, degree_entry_max_abs_err=derr,
                           degree_entry_ms=cuda_time_ms(
                               lambda v: bil.bilateral_degree(feats), inputs, iters=5, warmup=2),
                           degree_entry_pack_profiler_ms=traced["pack_feats_kernel"],
                           degree_entry_kernel_profiler_ms=traced["bilateral_rows_kernel"],
                           degree_entry_bound_ms=dbound, degree_entry_bound_by=dbound_by,
                           degree_entry_algorithm_bound_ms=bilateral_algorithm_bound(
                               b, n, degree=True))
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


def phase_point_features(image, ccfg, phases):
    """[4 x 40 x 40, 5] float64 point features of a 320 px image at the
    default point, phase-major as ``crf._jbu_operator`` builds them."""
    import numpy as np

    feats = []
    for oy, ox in phases:
        ys, xs = np.meshgrid(np.arange(40) * 8 + oy, np.arange(40) * 8 + ox,
                             indexing="ij")
        f = np.concatenate([xs[None] / ccfg.bi_xy_std, ys[None] / ccfg.bi_xy_std,
                            image[:, oy::8, ox::8].astype(np.float64) / ccfg.bi_rgb_std])
        feats.append(f.reshape(5, -1).T)
    return np.concatenate(feats)


def cache_bound_ms(b, n, clock_mhz):
    """Least ms of the int8 cache build: B N^2 bytes written once over the
    memory rate, against one ex2 per entry on the MUFU (16 a clock per SM)."""
    entries = float(b) * n * n
    bytes_ms = entries / PEAK_HBM * 1e3
    ex2_ms = entries / (16 * SMS * clock_mhz * 1e6) * 1e3
    return max(bytes_ms, ex2_ms), "bytes" if bytes_ms > ex2_ms else "ex2"


def cache_float64(feats):
    """round_half_even(127 exp(-|f_i - f_j|^2 / 2)) of [B, N, 5] features in
    float64 on the card (the direct distance), a block of rows at a time."""
    b, n, _ = feats.shape
    f = feats.double()
    out = torch.empty((b, n, n), dtype=torch.int8, device=feats.device)
    for i in range(b):
        for r0 in range(0, n, 2048):
            d2 = ((f[i, r0:r0 + 2048, None] - f[i, None]) ** 2).sum(-1)
            out[i, r0:r0 + 2048] = torch.round(torch.exp(-0.5 * d2) * 127.0).to(torch.int8)
    return out


def crf_phase(fidelity, crf, bil):
    import numpy as np

    ccfg = crf.crf_config_from_cfg({})
    image = fidelity.make_scene(320, 27, seed=0)[0]
    phases = crf._jbu_phases(ccfg, 320, 320)
    before = bil.KERNEL.cache_launches
    _, _, kmat = crf._jbu_operator(torch.from_numpy(image)[None].cuda(), ccfg, 8,
                                   torch.bfloat16, phases)
    if bil.KERNEL.cache_launches != before + 1:
        raise AssertionError("the default point's cache was not built by the kernel")
    f = torch.from_numpy(phase_point_features(image, ccfg, phases))  # float64 on the CPU
    sq = (f * f).sum(1)
    k64 = torch.round(torch.exp(f @ f.T - 0.5 * sq[:, None] - 0.5 * sq[None]) * 127)
    cache_diff = (kmat[0].cpu().double() - k64).abs().max().item()
    if not cache_diff <= 1:
        raise AssertionError(f"int8 cache differs from float64 by {cache_diff}")

    # the eval step's build: 16 scenes at 320 px, kernel and eager build
    f16 = torch.from_numpy(np.stack([
        phase_point_features(fidelity.make_scene(320, 27, seed=i)[0], ccfg, phases)
        for i in range(16)])).float().cuda()
    b, n = f16.shape[:2]
    inputs = [f16 + 1e-3 * i for i in range(4)]
    kernel_ms = cuda_time_ms(crf.cache_kernel_int8, inputs, iters=50)
    queued_ms = device_time_ms(crf.cache_kernel_int8, inputs, iters=50)
    clock = sm_clock_mhz()
    bound, bound_by = cache_bound_ms(b, n, clock)
    eager_ms = cuda_time_ms(crf.cache_kernel_int8_plain, inputs, iters=10, warmup=2)
    kern, eager = crf.cache_kernel_int8(f16), crf.cache_kernel_int8_plain(f16)
    steps_apart = (kern.int() - eager.int()).abs()
    # the rounding contract at the eval step's shape, as the card tests hold
    # it: against float64, at most one step off, at most 1e-3 of the entries
    # off, and no more of them than the eager build's
    ref = cache_float64(f16)
    kern_off = (kern.int() - ref.int()).abs()
    cache = dict(points=n, batch=b, kernel_ms=kernel_ms, kernel_queued_ms=queued_ms,
                 eager_ms=eager_ms, bound_ms=bound, bound_by=bound_by, sm_clock_mhz=clock,
                 share_of_bound=bound / min(kernel_ms, queued_ms),
                 max_step_from_float64=int(kern_off.max()),
                 entries_off_float64=int((kern_off != 0).sum()),
                 eager_entries_off_float64=int((eager != ref).sum()),
                 entries_apart_from_eager=int((steps_apart != 0).sum()),
                 max_step_apart_from_eager=int(steps_apart.max()))
    phase("crf_cache", scene0_max_step_from_float64=cache_diff, **cache)
    del f16, inputs, kern, eager, steps_apart, ref, kern_off
    torch.cuda.empty_cache()
    if not (cache["max_step_from_float64"] <= 1
            and cache["entries_off_float64"] <= 1e-3 * b * n * n
            and cache["entries_off_float64"] <= cache["eager_entries_off_float64"]):
        raise AssertionError(f"int8 cache kernel at B={b}, N={n}: at most "
                             f"{cache['max_step_from_float64']} steps and "
                             f"{cache['entries_off_float64']} entries off float64 (the eager "
                             f"build: {cache['eager_entries_off_float64']}); limits 1 step, "
                             f"{1e-3 * b * n * n:.0f} entries and the eager build's")

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
    return {"miou": float(miou), "accuracy": float(acc), "lattice_agreement": agree,
            "cache": cache}


def int8_message_bound_ms(b, n, c):
    """(least ms, what bounds it) of the CRF's int8 message: the [B, N, N]
    cache read once over the memory rate, against its products at the int8
    peak (the operand, N C bytes an image, is read from L2)."""
    bytes_ms = float(b) * n * n / PEAK_HBM * 1e3
    ops_ms = int8_matmul_flops(b * n, n, c) / PEAK_INT8 * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations"


def int8_message_phase(bil):
    """The CRF's int8 message (``crf_bilateral.int8_message``, a quantize and
    a product launch) at the eval cells' shape (B=16, N=6,400: both probes,
    C=54, and the degree, C=1) and at 360 px's N=8,100 (rows off 16 bytes),
    bf16, on ``tests/int8_message_cases.py``'s inputs: bit for bit against
    its plain version and against the ``torch._int_mm`` route it replaced
    (the library yardstick; N = 6,400 only), CUDA-event times back to back
    and queued, each kernel by ``torch.profiler``, the host time a call,
    the route's and the plain version's times, and the bound."""
    import int8_message_cases as cases

    rows = {}
    for name, (b, n, c) in {"b16_n6400_c54": (16, 6400, 54), "b16_n6400_c1": (16, 6400, 1),
                            "b16_n8100_c54": (16, 8100, 54)}.items():
        inputs = [cases.inputs("cuda", b, n, c, torch.bfloat16, seed=i) for i in range(2)]

        def kernel(a):
            return bil.int8_message(a[0], a[1], torch.bfloat16)

        def plain(a):
            return bil.int8_message_plain(a[0], a[1], torch.bfloat16)

        out = kernel(inputs[0])
        row = dict(shape=[b, n, c], equal_plain=bool(torch.equal(out, plain(inputs[0]))))
        row["ms"] = cuda_time_ms(kernel, inputs)
        row["queued_ms"] = device_time_ms(kernel, inputs)
        split = profiled_kernel_ms(kernel, inputs, ["int8_quantize_kernel", "int8_message_kernel"])
        row["quantize_profiler_ms"] = split["int8_quantize_kernel"]
        row["product_profiler_ms"] = split["int8_message_kernel"]
        busy = torch.empty(8192, 8192, device="cuda").normal_()
        torch.cuda.synchronize()
        busy @ busy
        t0 = time.perf_counter()
        for i in range(20):
            kernel(inputs[i % 2])
        row["host_us_per_call"] = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        del busy
        if n % 8 == 0:
            def library(a):
                return cases.int_mm_message(a[0], a[1], torch.bfloat16)

            row["equal_library"] = bool(torch.equal(out, library(inputs[0])))
            row["library_ms"] = cuda_time_ms(library, inputs, iters=20)
            row["library_queued_ms"] = device_time_ms(library, inputs, iters=20)
        row["plain_ms"] = cuda_time_ms(plain, inputs, iters=3, warmup=1)
        row["bound_ms"], row["bound_by"] = int8_message_bound_ms(b, n, c)
        row["share_of_bound"] = row["bound_ms"] / min(row["ms"], row["queued_ms"])
        phase("int8_message", case=name, **row)
        rows[name] = row
        del inputs, out
        torch.cuda.empty_cache()
        if not (row["equal_plain"] and row.get("equal_library", True)):
            raise AssertionError(f"int8 message {name} differs from its plain version or the "
                                 f"_int_mm route: {row}")
    return rows


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


def junction_launches(depth, forwards):
    """Residual junction launches of ``forwards`` ViT forwards of ``depth``
    blocks, each with one final norm: three a block and one."""
    return forwards * (3 * depth + 1)


def make_batches(gen, b, n):
    low = torch.rand(b, 3, 40, 40, device="cuda", generator=gen)
    base = torch.nn.functional.interpolate(low, size=(320, 320), mode="bilinear")
    labels = torch.randint(-1, 27, (b, 320, 320), device="cuda", generator=gen)
    return [((base + 0.02 * i - 0.45) / 0.226, labels.roll(i, dims=-1))
            for i in range(n)]


def main_path_phase(att, bil, inference, vit_lib, featurizer, crf, gen):
    from depthg_tpu_torch.ops import residual_norm as rn

    fcfg = featurizer.FeaturizerConfig()  # vit_small, patch 8, dim 70
    cpu_gen = torch.Generator().manual_seed(0)
    model_cpu = inference.Segmenter(fcfg, 27, 27).init_weights(cpu_gen)
    model = copy.deepcopy(model_cpu).cuda()
    ecfg = inference.EvalConfig(n_classes=27, crf=crf.crf_config_from_cfg({}),
                                backbone_dtype="bfloat16")
    step = inference.make_eval_step(ecfg)
    depth = vit_lib.VIT_PRESETS["vit_small"]["depth"]
    per_batch = depth * 2  # flip-TTA in two forwards

    batches = make_batches(gen, B, 4)  # warm-up + 3 timed
    torch.cuda.reset_peak_memory_stats()
    caches, messages = bil.KERNEL.cache_launches, bil.KERNEL.message_launches
    rn.KERNEL.launches = 0
    _, img_s, launches, k4 = run_eval_batches(step, model, batches, att, bil)
    junctions = rn.KERNEL.launches
    caches = bil.KERNEL.cache_launches - caches
    messages = bil.KERNEL.message_launches - messages
    caches_per_batch, messages_per_batch = caches / len(batches), messages / len(batches)
    junctions_per_batch = junctions / len(batches)
    expected = per_batch * len(batches)
    expected_junctions = junction_launches(depth, 2 * len(batches))
    if (launches != expected or k4 != 0 or caches != len(batches)
            or messages != CRF_MESSAGES * len(batches) or junctions != expected_junctions):
        raise AssertionError(f"attention launches {launches} != {expected}, K4 launches "
                             f"{k4} != 0, int8 cache launches {caches} != {len(batches)}, "
                             f"int8 messages {messages} != {CRF_MESSAGES * len(batches)} or "
                             f"junction launches {junctions} != {expected_junctions} at the "
                             f"default point")
    phase("main_path", batch=B, res=320, batches_timed=3, img_per_s=img_s,
          attention_launches=launches, expected_launches=expected,
          junction_launches_per_batch=junctions_per_batch,
          crf_cache_launches=caches, crf_message_launches=messages,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)

    # one image in float32: kernel on the card vs plain path on the CPU
    e32 = inference.EvalConfig(
        n_classes=27, backbone_dtype="float32",
        crf=crf.crf_config_from_cfg({"crf_dtype": "float32"}))
    predict = inference.make_predict_step(e32)
    img = batches[0][0][:1]
    before = att.KERNEL.launches
    att.KERNEL.f32_launches = rn.KERNEL.launches = 0
    on_card = [p.cpu() for p in predict(model, img)]
    f32_eval_launches, f32_junctions = att.KERNEL.f32_launches, rn.KERNEL.launches
    if (att.KERNEL.launches != before + 24 or f32_eval_launches != 24
            or f32_junctions != junction_launches(depth, 2)):
        raise AssertionError(f"the float32 card run did not go through the float32 kernels: "
                             f"{f32_eval_launches} K1 and {f32_junctions} junction launches")
    on_cpu = predict(model_cpu, img.cpu())
    agree = [float((a == b).float().mean()) for a, b in zip(on_card, on_cpu)]
    phase("f32_card_vs_cpu", linear_agreement=agree[0], cluster_agreement=agree[1],
          k1_f32_launches=f32_eval_launches, junction_f32_launches=f32_junctions)
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
        caches = bil.KERNEL.cache_launches
        _, pt_img_s, pt_att, pt_k4 = run_eval_batches(step, model, batches, att, bil)
        if (pt_att != per_batch * n_batches or pt_k4 != k4_per_batch * n_batches
                or bil.KERNEL.cache_launches != caches):  # no int8 cache at these points
            raise AssertionError(f"{name}: attention launches {pt_att}, K4 launches "
                                 f"{pt_k4}, int8 cache launches "
                                 f"{bil.KERNEL.cache_launches - caches}; expected "
                                 f"{per_batch * n_batches}, {k4_per_batch * n_batches} "
                                 f"and 0")
        points[name] = {"img_per_s": pt_img_s, "k4_launches": pt_k4}
        phase("main_path_point", point=name, cfg=cfg, batch=b,
              batches_timed=n_batches - 1, img_per_s=pt_img_s, attention_launches=pt_att,
              k4_launches=pt_k4, k4_launches_per_batch=pt_k4 / n_batches,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        del batches
        torch.cuda.empty_cache()
    return {"img_per_s": img_s, "launches": launches, "agreement": agree,
            "points": points, "f32_eval_launches": f32_eval_launches,
            "junction_launches_per_batch": junctions_per_batch,
            "f32_junction_launches": f32_junctions,
            "crf_cache_launches_per_batch": caches_per_batch,
            "crf_message_launches_per_batch": messages_per_batch}


def train_path_phase(att, bil, inference, featurizer, gen):
    """The train step at full width: one warm-up and TRAIN_STEPS timed steps
    on one fixed batch, counts of both kernels set to 0 just before and read
    just after; then FPS alone and one validation batch at 320 px."""
    from depthg_tpu_torch import profile_train
    from depthg_tpu_torch.ops import residual_norm as rn
    from depthg_tpu_torch.ops.depth import farthest_point_sampling_depth
    from depthg_tpu_torch.train import losses as loss_lib
    from depthg_tpu_torch.train import step as step_lib

    fcfg = featurizer.FeaturizerConfig()  # vit_small, patch 8, dim 70, dropout 0.1
    hp = step_lib.TrainHParams(n_classes=27, backbone_dtype="bfloat16")
    lcfg = loss_lib.CorrLossConfig(feature_samples=11, neg_samples=5, depth_sampling="fps",
                                   depth_feat_correlation_loss=True)
    w, sh = profile_train.DEPTH_FEAT_WEIGHT, profile_train.DEPTH_FEAT_SHIFT
    state = step_lib.init_state(fcfg, hp, torch.Generator().manual_seed(0), device="cuda")
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
    rn.KERNEL.launches = 0
    all_logs = [step_lib.train_step(state, batch, hp, lcfg, w, sh, generator=gen)]
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TRAIN_STEPS):
        all_logs.append(step_lib.train_step(state, batch, hp, lcfg, w, sh, generator=gen))
    stop.record()
    torch.cuda.synchronize()
    launches, k4, junctions = att.KERNEL.launches, bil.KERNEL.launches, rn.KERNEL.launches
    step_ms = start.elapsed_time(stop) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = probe_losses()

    depth = len(state.model.net.model.blocks)
    per_step = 2 * depth  # two frozen forwards a step
    junctions_per_step = junction_launches(depth, 2)
    if (launches != per_step * (TRAIN_STEPS + 1) or k4 != 0
            or junctions != junctions_per_step * (TRAIN_STEPS + 1)):
        raise AssertionError(f"train path: {launches} attention launches (expected "
                             f"{per_step * (TRAIN_STEPS + 1)}), {k4} K4 launches (expected 0) "
                             f"and {junctions} junction launches (expected "
                             f"{junctions_per_step * (TRAIN_STEPS + 1)})")
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
          junction_launches_per_step=junctions / (TRAIN_STEPS + 1),
          probe_losses_before=before, probe_losses_after=after,
          optimizer_parameters=n_params, optimizer_parameters_total=sum(n_params.values()),
          last_logs=last)

    # one validation batch at 320 px (plain float32 forward through the kernel)
    img, label = make_batches(gen, B, 1)[0]
    att.KERNEL.launches = att.KERNEL.f32_launches = rn.KERNEL.launches = 0
    lin, clu = inference.make_validation_step(27, 0)(state.model, img, label, 320)
    counted = int(((label >= 0) & (label < 27)).sum())
    validation_launches = att.KERNEL.f32_launches
    if (int(lin.sum()) != counted or int(clu.sum()) != counted
            or lin.shape != (27, 27) or att.KERNEL.launches != per_step // 2
            or validation_launches != per_step // 2
            or rn.KERNEL.launches != junction_launches(depth, 1)):
        raise AssertionError(f"validation step: confusion sums {int(lin.sum())}, "
                             f"{int(clu.sum())} != {counted}, attention launches "
                             f"{att.KERNEL.launches} != {per_step // 2} or junction launches "
                             f"{rn.KERNEL.launches} != {junction_launches(depth, 1)}")
    phase("train_validation", batch=B, res=320, attention_launches=att.KERNEL.launches,
          attention_f32_launches=validation_launches, junction_launches=rn.KERNEL.launches,
          labelled_pixels=counted)
    return {"launches": launches, "k4_launches": k4, "step_ms": step_ms, "fps_ms": fps_ms,
            "validation_launches": validation_launches,
            "junction_launches_per_step": junctions / (TRAIN_STEPS + 1)}


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
    from depthg_tpu_torch.ops import residual_norm as rn
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
    depth = len(svc._model.net.model.blocks)
    forwards = 1 if svc.ecfg.fused_tta else 2  # backbone forwards a batch
    per_batch = depth * forwards
    junctions_per_batch = junction_launches(depth, forwards)
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
        att.KERNEL.launches = rn.KERNEL.launches = 0
        times = []
        for rep in range(4):
            t0 = time.perf_counter()
            svc._predict_padded(arrs[rep:rep + b], b)
            times.append((time.perf_counter() - t0) * 1e3)
        if att.KERNEL.launches != 4 * per_batch or rn.KERNEL.launches != 4 * junctions_per_batch:
            raise AssertionError(f"bucket {b}: {att.KERNEL.launches} K1 and "
                                 f"{rn.KERNEL.launches} junction launches in 4 runs")
        bucket_ms[b] = times
    phase("serve_buckets", build_service_s=build_s, warmup_s=warmup_s, buckets=buckets,
          k1_launches_per_batch=per_batch, junction_launches_per_batch=junctions_per_batch,
          fused_tta=svc.ecfg.fused_tta, ms_per_bucket_4_runs=bucket_ms,
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
        rn.KERNEL.launches = 0
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
        launches, k4, junctions = att.KERNEL.launches, bil.KERNEL.launches, rn.KERNEL.launches
        after = json.loads(urllib.request.urlopen(f"{base}/metrics", timeout=30).read())
    finally:
        server.shutdown()
        server.server_close()
        svc.batcher._run_batch = run_batch
    n_batches = after["batches"] - before["batches"]
    if after["errors"] != 0:  # the junk body failed in its decode, before the batcher
        raise AssertionError(f"server errors: {after}")
    if (launches != per_batch * n_batches or k4 != 0 or n_batches != len(batches_seen)
            or junctions != junctions_per_batch * n_batches):
        raise AssertionError(f"serve path: {launches} K1 and {junctions} junction launches "
                             f"over {n_batches} batches (expected {per_batch} and "
                             f"{junctions_per_batch} each), {k4} K4 launches (expected 0)")

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
          junction_launches=junctions, errors=after["errors"],
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
            "junction_launches_per_batch": junctions / n_batches,
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
    from depthg_tpu_torch.ops import residual_norm as rn
    from depthg_tpu_torch.parallel import knn
    from depthg_tpu_torch.profile_serve import synthetic_jpeg

    crop_dir = os.path.join(tmp, "knn_data", "cropped", "cocostuff27_five_crop_0.5")
    os.makedirs(os.path.join(crop_dir, "img", "train"))  # images alone: no labels needed
    n_img = 2 * KNN_EMBED_B
    for i in range(n_img):
        with open(os.path.join(crop_dir, "img", "train", f"{i}.jpg"), "wb") as f:
            f.write(synthetic_jpeg(300 + i, 240, 240))
    att.KERNEL.launches = att.KERNEL.f32_launches = 0
    bil.KERNEL.launches = rn.KERNEL.launches = 0
    t0 = time.perf_counter()
    written = precompute_knns.main([
        f"data_dir={os.path.join(tmp, 'knn_data')}", "knn_datasets=[cocostuff27]",
        "knn_crop_types=[five]", "knn_image_sets=[train]", "num_workers=4"])
    cli_s = time.perf_counter() - t0
    launches, k4, junctions = att.KERNEL.launches, bil.KERNEL.launches, rn.KERNEL.launches
    f32_launches = att.KERNEL.f32_launches
    nns = np.load(written[0])["nns"]
    name = os.path.basename(written[0])
    if (name != "nns_vit_small_cocostuff27_train_five_224.npz" or nns.shape != (n_img, KNN_K)
            or nns.dtype != np.int32 or nns.min() < 0 or nns.max() >= n_img
            or any(len(set(row)) != KNN_K for row in nns.tolist())):
        raise AssertionError(f"precompute_knns wrote {name}: {nns.shape} {nns.dtype}")
    if (launches != 12 * 2 or f32_launches != launches or k4 != 0
            or junctions != junction_launches(12, 2)):
        raise AssertionError(f"KNN embedding: {launches} K1 launches (expected 24 for two "
                             f"batches of {KNN_EMBED_B}), {junctions} junction launches "
                             f"(expected {junction_launches(12, 2)}) and {k4} K4 launches")

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
          k1_launches_per_batch=12, junction_launches=junctions, embed_batch=KNN_EMBED_B, embed_ms=embed_ms,
          embed_img_per_s=KNN_EMBED_B / embed_ms * 1e3, unit_norm_err=norm_err,
          n=KNN_N, c=KNN_C, k=KNN_K, key_blocks=-(-KNN_N // knn._KEY_BLOCK),
          topk_highest_s=exact_s, topk_default_bf16_s=bf16_s, peak_mem_gb=peak,
          sampled_rows=KNN_SAMPLED, entries_differing_from_float64=int(differ.sum()),
          worst_similarity_gap=worst_gap, bf16_entries_equal_to_float64=bf16_same,
          tf32_off=True)
    return {"launches": launches, "f32_launches": f32_launches, "k4_launches": k4,
            "junction_launches": junctions, "embed_ms": embed_ms}


def attention_bias_phase(att, beit, gen):
    """K1 with BEiT-L's bias at N=769, 16 heads: kernel vs plain, the bias
    acting, +1e4 past n_valid ignored, an odd row stride refused, a batch of
    8 equal to its images one by one; times through ``attention_qkv``,
    queued, alone, without the bias (the bias's own cost: the difference),
    the kernel alone by ``torch.profiler``, the library call with the bias
    as its ``attn_mask``, the plain version, and the bound; then the
    kernel against the plain version at ``BIAS_EDGE_CASES``."""
    import torch.nn.functional as F

    h = BIAS_HEADS
    # a random table through the BEiT module's own builder: the 47 x 47
    # pretraining table resized to the 47 x 63 window, as [16, 769, 776]
    # (59 x 79 at 480 x 640: [16, 1201, 1208])
    table = torch.randn((2 * 24 - 1) ** 2 + 3, h, device="cuda", generator=gen)
    rows = {}
    for dtype, b, grid in BIAS_CASES:
        n = grid[0] * grid[1] + 1
        name = (f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_b{b}"
                + ("" if n == BIAS_N else f"_n{n}"))
        bias = beit.relative_position_bias(table.to(dtype), 24, *grid)
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
        poisoned = beit.relative_position_bias(table.to(dtype), 24, *grid)
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
        if b == 8:  # images that share the bias's tiles mix nothing
            alone = torch.cat([att.attention_qkv(inputs[0][i:i + 1], h, SCALE, bias=bias)
                               for i in range(b)])
            if not torch.equal(alone, out):
                raise AssertionError(f"{name}: the batch differs from its images one by one")

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
        kernels = (("attn_pack_f32_kernel", "attn_f32_wgmma_kernel") if dtype == torch.float32
                   else ("attn_bf16_wgmma_kernel",))
        traced = profiled_kernel_ms(launch, inputs, kernels)
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
            "kernel_profiler_ms": traced[kernels[-1]],
            **({"pack_profiler_ms": traced[kernels[0]]} if dtype == torch.float32 else {}),
            "library_ms": cuda_time_ms(library, inputs, iters=iters),
            "library_device_ms": device_time_ms(library, inputs, iters=iters),
            "plain_ms": cuda_time_ms(plain, inputs, iters=3, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            **({"fma_bound_ms": attention_fma_bound(b, n, h)} if dtype == torch.float32 else {}),
            "ex2_bound_ms": b * h * n * n / (16 * SMS * clock * 1e6) * 1e3,
            "sm_clock_mhz": clock, "grid": attention_grid(att, b, n, h, dtype, bias=True)}
        rows[name]["bias_cost_ms"] = rows[name]["device_ms"] - rows[name]["no_bias_device_ms"]
        phase("attention_bias", case=name, shape=[b, n, h, 64],
              bias=[h, n, n, str(bias.dtype), bias.stride(1)], **rows[name])
        del base, inputs, out, ref, without, masked, poisoned, o, lib_ref
        torch.cuda.empty_cache()
    for dtype, b, grid, nv in BIAS_EDGE_CASES:
        n = grid[0] * grid[1] + 1
        nv = n if nv is None else nv
        name = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_b{b}_n{n}_valid{nv}"
        bias = beit.relative_position_bias(table.to(dtype), 24, *grid)
        x = torch.randn(b, n, 3 * BIAS_DIM, device="cuda", generator=gen).to(dtype)
        q, k, v = att.split_qkv(x, h)
        ref = att.attention_plain(q, k, v, SCALE, nv, bias).permute(0, 2, 1, 3).reshape(
            b, n, BIAS_DIM)
        out = att.attention_qkv(x, h, SCALE, nv, bias=bias)
        without = att.attention_qkv(x, h, SCALE, nv)
        torch.cuda.synchronize()
        err, rel = compare(out, ref, dtype, f"attention with bias {name}")
        moved = ((without.float() - out.float()).norm() / out.float().norm()).item()
        if not moved > 0.05 or not torch.all(out[:, nv:] == 0):
            raise AssertionError(f"{name}: the bias did not act ({moved}) or a row past "
                                 f"n_valid is not 0")
        rows[name] = {"max_abs_err": err, "rel_err": rel, "rel_change_from_bias": moved,
                      "grid": attention_grid(att, b, n, h, dtype, bias=True)}
        phase("attention_bias_edge", case=name, shape=[b, n, h, 64], n_valid=nv, **rows[name])
        del bias, x, q, k, v, ref, out, without
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
    from depthg_tpu_torch.ops import zoe_bins
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
            att.KERNEL.f32_launches = zoe_bins.KERNEL.bins_launches = 0
            t0 = time.perf_counter()
            written = generate_depth.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches, bias_launches, k4 = (att.KERNEL.launches, att.KERNEL.bias_launches,
                                           bil.KERNEL.launches)
            f32_launches, bins = att.KERNEL.f32_launches, zoe_bins.KERNEL.bins_launches
            peak = torch.cuda.max_memory_allocated() / 2**30
            expected = per_batch * DEPTH_BATCHES
            # the bins tail kernel: one a pass (two a batch) of the bf16 ZoeDepth
            expected_bins = 2 * DEPTH_BATCHES if label == "zoedepth" else 0
            if (written != len(DEPTH_IMAGES) or launches != expected or k4 != 0
                    or bias_launches != (expected if with_bias else 0)
                    or f32_launches != (expected if label == "zoedepth_f32" else 0)
                    or bins != expected_bins):
                raise AssertionError(f"{model}: {written} maps, {launches} K1 launches "
                                     f"({bias_launches} with a bias), {k4} K4 launches, "
                                     f"{bins} bins tail launches; expected {expected} K1 "
                                     f"launches per {DEPTH_BATCHES} batches, all with a bias: "
                                     f"{with_bias}, and {expected_bins} bins tail launches")
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
                "k1_launches_per_batch": launches / DEPTH_BATCHES,
                "bins_tail_launches_per_batch": bins / DEPTH_BATCHES, "main_seconds": seconds,
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


def bins_tail_bound_ms(b, h, w):
    """(least ms, what bounds it) of ZoeDepth's bins tail at [B, H, W]: its
    bytes (out_conv, rel and the half-size embedding and centers read once,
    feats and the float32 depth written once) over the memory rate, against
    its two products at the bf16 peak."""
    px, src = b * h * w, b * (h // 2) * (w // 2)
    nbytes = px * (32 * 2 + 2 + 128 * 2 + 4) + src * (128 + 64) * 2
    bytes_ms = nbytes / PEAK_HBM * 1e3
    flops_ms = bins_tail_flops(b, h, w, 161, 80) / PEAK_BF16 * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms > flops_ms else "operations"


def bins_tail_phase(zb):
    """ZoeDepth's bins tail at the depth cell's shape (B=8, 384 x 512, one
    pass): the kernel against its plain version (``tests/bins_tail_cases.py``'s
    inputs and limits), the kernel on CUDA events back to back, queued
    behind a long product and by ``torch.profiler``, its host time a call,
    the plain version, the bound."""
    import bins_tail_cases as cases

    b, h, w = 8, 384, 512
    clb = cases.head("cuda")
    inputs = [cases.inputs("cuda", b, h, w, seed=i) for i in range(2)]
    with torch.inference_mode():
        before = zb.KERNEL.bins_launches
        depth, feats = zb.bins_tail(*inputs[0], clb)
        ref_depth, ref_feats, _, _ = zb.bins_tail_plain(*inputs[0], clb)
        held = cases.holds(depth, feats, ref_depth, ref_feats, inputs[0][2])
        if zb.KERNEL.bins_launches != before + 1:
            raise AssertionError("the bins tail kernel did not count its launch")
        del depth, feats, ref_depth, ref_feats

        def kernel(a):
            return zb.bins_tail(*a, clb)[0]

        kernel_ms = cuda_time_ms(kernel, inputs, iters=30)
        queued_ms = device_time_ms(kernel, inputs, iters=30)
        profiled_ms = profiled_kernel_ms(kernel, inputs, ["zoe_bins_tail_kernel"])[
            "zoe_bins_tail_kernel"]
        # the host's time a call, while the card works through a long product
        busy = torch.empty(8192, 8192, device="cuda").normal_()
        torch.cuda.synchronize()
        busy @ busy
        t0 = time.perf_counter()
        for i in range(20):
            kernel(inputs[i % 2])
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        del busy
        plain_ms = cuda_time_ms(lambda a: zb.bins_tail_plain(*a, clb)[0], inputs, iters=5,
                                warmup=2)
    bound, bound_by = bins_tail_bound_ms(b, h, w)
    out = dict(shape=[b, h, w], kernel_ms=kernel_ms, kernel_queued_ms=queued_ms,
               kernel_profiler_ms=profiled_ms, host_us_per_call=host_us, plain_ms=plain_ms,
               bound_ms=bound, bound_by=bound_by,
               share_of_bound=bound / min(queued_ms, profiled_ms or queued_ms),
               limits={"depth_p99_over_range": cases.P99_TOL,
                       "depth_max_over_range": cases.MAX_TOL,
                       "feats_share_differing": cases.FEATS_SHARE}, **held)
    phase("bins_tail", **out)
    del inputs
    torch.cuda.empty_cache()
    if not held["passes"]:
        raise AssertionError(f"bins tail kernel vs plain: {held}")
    return out


def swiglu_gate_bound_ms(m, hidden, itemsize):
    """(least ms, bytes) of the SwiGLU gate over [m, 2H]: the input read
    once and the [m, H] output written once, over the memory rate."""
    nbytes = 3 * m * hidden * itemsize
    return nbytes / PEAK_HBM * 1e3, nbytes


def swiglu_gate_phase(sw):
    """DINOv2's SwiGLU gate at the DINOv2 cell's shape (``w12``'s bf16
    output [32 x 1,029, 2 x 4,096]: stacked flip-TTA at batch 16): the
    kernel bit for bit against eager ``F.silu(a) * b`` (and in float32 at
    1,029 rows), one launch a call, the kernel on CUDA events back to back,
    queued behind a long product and by ``torch.profiler``, its host time a
    call, the eager pair (the plain version, and the two PyTorch calls the
    module made before the kernel: the library yardstick), the bound."""
    m, hidden = SWIGLU_M, SWIGLU_H
    gen = torch.Generator(device="cuda").manual_seed(0)

    def w12_output(rows, dtype):
        return (torch.randn(rows, 2 * hidden, device="cuda", generator=gen) * 3.0).to(dtype)

    inputs = [w12_output(m, torch.bfloat16) for _ in range(2)]
    with torch.inference_mode():
        before = sw.KERNEL.gate_launches
        got = sw.swiglu_gate(inputs[0])
        launched = sw.KERNEL.gate_launches - before
        eager = sw.swiglu_gate_plain(inputs[0])
        mismatched = int((got.view(torch.int16) != eager.view(torch.int16)).sum())
        h32 = w12_output(1029, torch.float32)
        f32_mismatched = int((sw.swiglu_gate(h32).view(torch.int32)
                              != sw.swiglu_gate_plain(h32).view(torch.int32)).sum())
        del got, eager, h32
        kernel_ms = cuda_time_ms(sw.swiglu_gate, inputs, iters=50)
        queued_ms = device_time_ms(sw.swiglu_gate, inputs, iters=50)
        profiled_ms = profiled_kernel_ms(sw.swiglu_gate, inputs, ["swiglu_gate_kernel"])[
            "swiglu_gate_kernel"]
        host_us = host_us_per_call(sw.swiglu_gate, inputs)
        library_ms = cuda_time_ms(sw.swiglu_gate_plain, inputs, iters=20)
        library_queued_ms = device_time_ms(sw.swiglu_gate_plain, inputs, iters=20)
    bound, nbytes = swiglu_gate_bound_ms(m, hidden, 2)
    out = dict(shape=[m, 2 * hidden], dtype="bf16", bytes=nbytes, launches_per_call=launched,
               elements_differing=mismatched, f32_rows=1029, f32_elements_differing=f32_mismatched,
               kernel_ms=kernel_ms, kernel_queued_ms=queued_ms, kernel_profiler_ms=profiled_ms,
               host_us_per_call=host_us, library_ms=library_ms,
               library_queued_ms=library_queued_ms, bound_ms=bound, bound_by="bytes",
               share_of_bound=bound / min(queued_ms, profiled_ms or queued_ms))
    phase("swiglu_gate", **out)
    del inputs
    torch.cuda.empty_cache()
    if mismatched or f32_mismatched or launched != 1:
        raise AssertionError(f"SwiGLU gate kernel vs eager: {out}")
    return out


def residual_norm_bound_ms(rows, d, itemsize, entry):
    """(least ms, bytes) of one junction launch over [rows, d]: the fused
    entry reads x and y and writes the sum and its norm, the residual
    reads two and writes one, the norm reads one and writes one."""
    nbytes = {"fused": 4, "residual": 3, "norm": 2}[entry] * rows * d * itemsize
    return nbytes / PEAK_HBM * 1e3, nbytes


def step_at(scale):
    """One bf16 step at each magnitude of ``scale`` (float32)."""
    return torch.exp2(torch.floor(torch.log2(scale.clamp_min(2.0 ** -126))) - 7)


def host_us_per_call(fn, inputs, calls=20):
    """The host's microseconds a call of ``fn``, while the card works
    through a long product (so no call waits for the card)."""
    busy = torch.empty(8192, 8192, device="cuda").normal_()
    fn(inputs[0])
    torch.cuda.synchronize()
    busy @ busy
    t0 = time.perf_counter()
    for i in range(calls):
        fn(inputs[i % len(inputs)])
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host_us


# the residual junction phase's shapes: (label, rows, D, dtype, LayerScale).
# DINOv2's stacked flip-TTA at batch 16 (N = 1,029), Depth Anything V2's
# batch 8 (N = 1,814), and ViT-S/8's and ViT-B/8's stacked eval batch of 16
# at 320 px (N = 1,601; no LayerScale), ViT-S/8 also in float32
RESIDUAL_CASES = (
    ("dinov2", RESIDUAL_DINOV2_ROWS, 1536, torch.bfloat16, True),
    ("dav2", RESIDUAL_DAV2_ROWS, 1024, torch.bfloat16, True),
    ("vits8", RESIDUAL_VIT8_ROWS, 384, torch.bfloat16, False),
    ("vits8_f32", RESIDUAL_VIT8_ROWS, 384, torch.float32, False),
    ("vitb8", RESIDUAL_VIT8_ROWS, 768, torch.bfloat16, False),
)


def residual_norm_phase(rn):
    """The ViT blocks' residual junction kernel at each shape of
    ``RESIDUAL_CASES``: for each of its three entries (the residual with
    the next norm, the residual, the norm) the kernel back to back, queued
    behind a long product and by ``torch.profiler``, against its bound
    (bytes), beside the eager passes it replaced (the plain versions), and
    the host's microseconds a call of each; the sum's elements whose bits
    differ from eager, the norm's elements more than one bf16 step off and
    those differing at all (of the fused entry and the norm entry), and one
    launch a call. A bf16 step of the norm is taken at the larger of the
    output and the terms it sums (normalized value times weight, bias):
    where they cancel, float32's own rounding of the terms exceeds a step of
    the small result; the elements past a step at their own magnitude (in
    bf16 at most 4 and one in 100,000, as the card tests hold), and the
    three farthest, are reported beside."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, rows, d, dtype, layer_scale in RESIDUAL_CASES:
        def inputs():
            x = torch.randn(rows, d, device="cuda", generator=gen) * 2.0 + 0.5
            y = torch.randn(rows, d, device="cuda", generator=gen)
            gamma = torch.rand(d, device="cuda", generator=gen) * 0.2
            w = 1.0 + 0.1 * torch.randn(d, device="cuda", generator=gen)
            b = 0.1 * torch.randn(d, device="cuda", generator=gen)
            x, y, gamma, w, b = [t.to(dtype) for t in (x, y, gamma, w, b)]
            return [x, y, gamma if layer_scale else None, w, b]

        def bits(t):
            return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

        sets = [inputs(), inputs()]
        entries = {
            "fused": (lambda a: rn.residual_norm(*a, 1e-6)[1],
                      lambda a: rn.residual_norm_plain(*a, 1e-6)[1]),
            "residual": (lambda a: rn.residual_add(*a[:3]),
                         lambda a: rn.residual_add_plain(*a[:3])),
            "norm": (lambda a: rn.layer_norm(a[0], *a[3:], 1e-6),
                     lambda a: rn.layer_norm_plain(a[0], *a[3:], 1e-6)),
        }
        with torch.inference_mode():
            x, y, gamma, w, b = sets[0]
            before = rn.KERNEL.launches
            got_x, got_n = rn.residual_norm(x, y, gamma, w, b, 1e-6)
            launched = rn.KERNEL.launches - before
            want_x, want_n = rn.residual_norm_plain(x, y, gamma, w, b, 1e-6)
            got_norm, want_norm = rn.layer_norm(x, w, b, 1e-6), rn.layer_norm_plain(x, w, b, 1e-6)
            checks = dict(launches_per_call=launched,
                          sum_elements_differing=int((bits(got_x) != bits(want_x)).sum()))
            for name, got, want, s in (("fused", got_n, want_n, want_x),
                                       ("norm", got_norm, want_norm, x)):
                got, want = got.float(), want.float()
                # the terms the norm sums in float32, in float64: the
                # normalized value times the weight, and the bias
                s64 = s.double()
                t = ((s64 - s64.mean(-1, keepdim=True)) * w.double()
                     * (s64.var(-1, unbiased=False, keepdim=True) + 1e-6).rsqrt())
                terms = torch.maximum(t.abs(), b.double().abs()).float()
                del s64, t
                own = step_at(want.abs())
                at_terms = step_at(torch.maximum(want.abs(), terms))
                off = (got - want).abs()
                checks[f"{name}_norm_elements_differing"] = int((got != want).sum())
                checks[f"{name}_norm_max_abs_diff"] = off.max().item()
                checks[f"{name}_norm_elements_past_a_step"] = int((off > at_terms).sum())
                past = off > own
                checks[f"{name}_norm_elements_past_their_own_step"] = int(past.sum())
                worst = (off / own).flatten().topk(3).indices
                checks[f"{name}_norm_worst_own_steps"] = [
                    dict(got=got.flatten()[i].item(), want=want.flatten()[i].item(),
                         terms=terms.flatten()[i].item()) for i in worst.tolist()]
                del own, at_terms, off, past, terms
            del got_x, got_n, want_x, want_n, got_norm, want_norm
            for entry, (kernel, eager) in entries.items():
                bound, nbytes = residual_norm_bound_ms(rows, d, sets[0][0].element_size(), entry)
                queued = device_time_ms(kernel, sets, iters=50)
                profiled = profiled_kernel_ms(kernel, sets, ["residual_norm_kernel"])[
                    "residual_norm_kernel"]
                checks[entry] = dict(
                    bytes=nbytes, bound_ms=bound, kernel_ms=cuda_time_ms(kernel, sets, iters=50),
                    kernel_queued_ms=queued, kernel_profiler_ms=profiled,
                    host_us_per_call=host_us_per_call(kernel, sets),
                    eager_ms=cuda_time_ms(eager, sets, iters=20),
                    eager_queued_ms=device_time_ms(eager, sets, iters=20),
                    eager_host_us_per_call=host_us_per_call(eager, sets),
                    share_of_bound=bound / min(queued, profiled or queued))
        out[label] = dict(shape=[rows, d], dtype=str(dtype).replace("torch.", ""),
                          layer_scale=layer_scale, **checks)
        del sets
        torch.cuda.empty_cache()
    phase("residual_norm", **out)
    def rare(v):  # bf16 norms past a step at their own magnitude: 4 and 1 in 100,000
        return v["dtype"] != "bfloat16" or max(
            v["fused_norm_elements_past_their_own_step"],
            v["norm_norm_elements_past_their_own_step"]) <= 4 + math.prod(v["shape"]) // 100_000

    bad = {k: v for k, v in out.items()
           if v["launches_per_call"] != 1 or v["sum_elements_differing"]
           or v["fused_norm_elements_past_a_step"] or v["norm_norm_elements_past_a_step"]
           or not rare(v)}
    if bad:
        raise AssertionError(f"residual junction kernel vs eager: {bad}")
    return out


def dinov2_path_phase(att, bil, sw, inference, crf_lib):
    """The DINOv2 cell's eval step on a full-width ViT-g/14-reg (random
    weights from seed 0): 40 gate and 40 K1 launches a step, 121 residual
    junction launches, the gate's bits in one block of the path, the step's
    rate (docstring, phase 13)."""
    from depthg_tpu_torch.ops import residual_norm as rn

    cfg = json.loads(open(DINOV2_CONFIG).read())
    bb, head, ev = cfg["backbone"], cfg["head"], cfg["eval"]
    fcfg = inference.fcfg_from_run_cfg({
        "model_type": bb["arch"], "dino_patch_size": bb["patch_size"],
        "dino_feat_type": head["feat_type"], "projection_type": head["projection_type"],
        "dim": head["dim"], "dropout": head["dropout"]})
    n_classes, res = cfg["n_classes"], ev["res"]
    with torch.device("cuda"):
        model = inference.Segmenter(fcfg, n_classes, n_classes + cfg["extra_clusters"])
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    ecfg = inference.EvalConfig(
        n_classes=n_classes, extra_clusters=cfg["extra_clusters"], label_res=res,
        cluster_alpha=ev["cluster_alpha"], crf=crf_lib.CRFConfig(**ev["crf"]),
        backbone_dtype=ev["backbone_dtype"], fused_tta=ev["fused_tta"])
    step = inference.make_eval_step(ecfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    low = torch.rand(DINOV2_B, 3, 40, 40, device="cuda", generator=gen)
    base = torch.nn.functional.interpolate(low, size=(res, res), mode="bilinear")
    labels = torch.randint(-1, n_classes, (DINOV2_B, res, res), device="cuda", generator=gen)
    batches = [((base + 0.02 * i - 0.45) / 0.226, labels.roll(i, dims=-1)) for i in range(4)]

    # the warm-up step's gate in one block: w3's input against the eager
    # pair over w12's output
    ffn = model.net.model.blocks[DINOV2_CHECKED_BLOCK].mlp
    seen = {}
    hooks = [ffn.w12.register_forward_hook(
                 lambda m, i, o: seen.setdefault("w12", o.detach().clone())),
             ffn.w3.register_forward_pre_hook(
                 lambda m, i: seen.setdefault("w3_in", i[0].detach().clone()))]
    gates, junctions = sw.KERNEL.gate_launches, rn.KERNEL.launches
    try:
        _, img_s, launches, k4 = run_eval_batches(step, model, batches, att, bil)
    finally:
        for h in hooks:
            h.remove()
    gates = sw.KERNEL.gate_launches - gates
    junctions = rn.KERNEL.launches - junctions
    got, ref = seen["w3_in"], sw.swiglu_gate_plain(seen["w12"])
    differing = int((got.view(torch.int16) != ref.view(torch.int16)).sum())
    depth = bb["depth"]
    out = dict(batch=DINOV2_B, res=res, steps=len(batches), batches_timed=len(batches) - 1,
               img_per_s=img_s, gate_launches=gates,
               gate_launches_per_step=gates / len(batches),
               junction_launches_per_step=junctions / len(batches),
               attention_launches_per_step=launches / len(batches), k4_launches=k4,
               w12_output_shape=list(seen["w12"].shape), w12_output_dtype=str(ref.dtype),
               checked_block=DINOV2_CHECKED_BLOCK, gate_elements_differing=differing,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    phase("dinov2_path", **out)
    del model, step, batches, seen, got, ref
    torch.cuda.empty_cache()
    if (gates != depth * 4 or launches != depth * 4 or junctions != (3 * depth + 1) * 4
            or differing or out["w12_output_dtype"] != str(torch.bfloat16)):
        raise AssertionError(f"DINOv2 path: {gates} gate launches and {launches} K1 launches "
                             f"in 4 steps (expected {depth * 4} each), {junctions} junction "
                             f"launches (expected {(3 * depth + 1) * 4}), {differing} gate "
                             f"elements off the eager pair: {out}")
    return out


def write_nyu_layout(root, n_train, n_eval, hw=(480, 640), seed=0):
    """A synthetic NYU-layout folder as ``tests/test_zoedepth_data.py``
    writes one: random RGB PNGs and 16-bit depth PNGs in millimetres
    (0.5-9 m), ``rgb/i.png gt/i.png 518.8579`` lines; the first ``n_train``
    pairs listed in ``train.txt``, the next ``n_eval`` in ``eval.txt``."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in ("rgb", "gt"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    lines = []
    for i in range(n_train + n_eval):
        Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(root, "rgb", f"{i}.png"))
        depth = rng.uniform(0.5, 9.0, hw) * 1000.0
        Image.fromarray(depth.astype(np.uint16)).save(os.path.join(root, "gt", f"{i}.png"))
        lines.append(f"rgb/{i}.png gt/{i}.png 518.8579")
    files = []
    for name, part in (("train.txt", lines[:n_train]), ("eval.txt", lines[n_train:])):
        files.append(os.path.join(root, name))
        with open(files[-1], "w") as f:
            f.write("\n".join(part))
    return files


def finetune_path_phase(att, bil, tmp):
    """``finetune_zoedepth.main`` at full width (random float32 ZoeDepth from
    seed 0, TF32 off) on a synthetic NYU layout: 4 steps at batch 4 (the
    reference's 16 would hold ~106 GB of eager float32 attention alone),
    validation after steps 2 and 4 and at the end on 4 images each. Checks:
    no K1 launch in a training step (eager attention: the kernel has no
    backward), 24 float32 K1 launches with the bias per validation image,
    finite losses, the nine metrics, ``latest.pt`` and ``best.pt`` through
    ``load_zoedepth_pt`` giving the depth of the model they were saved from.
    Times: ms per step on CUDA events and the host clock, ms per validation
    image, peak memory. Then one float32 loss and backward at 4 of the 24
    blocks on 2 x 192 x 256 from the same weights on the card and the CPU
    (``finetune_card_vs_cpu``)."""
    from depthg_tpu_torch import finetune_zoedepth as cli
    from depthg_tpu_torch.models.zoedepth import finetune
    from depthg_tpu_torch.models.zoedepth.convert import load_zoedepth_pt

    root = os.path.join(tmp, "nyu")
    train_file, eval_file = write_nyu_layout(root, FT_TRAIN_IMAGES, FT_EVAL_IMAGES)
    out_dir = os.path.join(tmp, "finetune_out")
    seen = {"steps": [], "val_images": 0, "val_launches": [0, 0, 0], "val_ms": 0.0, "depth": {}}
    init_state, step, validate = finetune.init_state, finetune.finetune_step, cli.validate

    def keep_state(model, ftcfg):
        seen["state"] = init_state(model, ftcfg)
        return seen["state"]

    def timed_step(state, batch):
        before = att.KERNEL.launches
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        logs = step(state, batch)
        stop.record()
        torch.cuda.synchronize()
        seen["steps"].append({"ms": start.elapsed_time(stop),
                              "host_ms": (time.perf_counter() - t0) * 1e3,
                              "k1_launches": att.KERNEL.launches - before,
                              "loss": float(logs["loss/total"])})
        return logs

    def timed_validate(model, dcfg, test_set, spec, limit=0):
        counts = (att.KERNEL.launches, att.KERNEL.bias_launches, att.KERNEL.f32_launches)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = validate(model, dcfg, test_set, spec, limit)
        stop.record()
        torch.cuda.synchronize()
        seen["val_ms"] += start.elapsed_time(stop)
        seen["val_images"] += min(limit, len(test_set)) if limit else len(test_set)
        for i, c in enumerate((att.KERNEL.launches, att.KERNEL.bias_launches,
                               att.KERNEL.f32_launches)):
            seen["val_launches"][i] += c - counts[i]
        # the depth of the first evaluation image from the weights of this
        # validation (a checkpoint written now holds them), eager: no launch
        seen.setdefault("x", torch.from_numpy(test_set[0]["image"][None]).cuda())
        with torch.no_grad():
            seen["depth"][seen["state"].step] = model(seen["x"], attn_impl="xla")[
                "metric_depth"].cpu()
        return out

    argv = [f"data_path={root}", f"gt_path={root}", f"data_path_eval={root}",
            f"gt_path_eval={root}", f"filenames_file={train_file}",
            f"filenames_file_eval={eval_file}", f"batch_size={FT_BATCH}",
            f"max_steps={FT_STEPS}", f"eval_limit={FT_EVAL_IMAGES}", "validate_every=1.0",
            "log_every=1", f"output_dir={out_dir}", "device=cuda", "seed=0"]
    finetune.init_state, finetune.finetune_step, cli.validate = keep_state, timed_step, timed_validate
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        att.KERNEL.launches = att.KERNEL.bias_launches = att.KERNEL.f32_launches = 0
        bil.KERNEL.launches = 0
        t0 = time.perf_counter()
        result = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (att.KERNEL.launches, att.KERNEL.bias_launches, att.KERNEL.f32_launches,
                    bil.KERNEL.launches)
    finally:
        finetune.init_state, finetune.finetune_step, cli.validate = init_state, step, validate
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = seen["state"]
    expected = FT_VALIDATIONS * FT_EVAL_IMAGES * 24
    if (len(seen["steps"]) != FT_STEPS or any(s["k1_launches"] for s in seen["steps"])
            or seen["val_images"] != FT_VALIDATIONS * FT_EVAL_IMAGES
            or seen["val_launches"] != [expected] * 3 or launches != (expected,) * 3 + (0,)):
        raise AssertionError(f"fine-tune: {seen['steps']} steps; validation over "
                             f"{seen['val_images']} images, K1 launches (all, bias, f32) "
                             f"{seen['val_launches']}; run {launches}")
    losses = [s["loss"] for s in seen["steps"]]
    final = result["final"]
    if not all(math.isfinite(v) for v in losses) or sorted(final) != sorted(FT_METRICS) or not all(
            math.isfinite(v) for v in final.values()):
        raise AssertionError(f"fine-tune: losses {losses}, metrics {final}")
    # both checkpoints back through the released-layout loader
    loaded = {}
    for name in ("latest.pt", "best.pt"):
        blob = torch.load(os.path.join(out_dir, name), map_location="cpu", weights_only=False,
                          mmap=True)
        model = load_zoedepth_pt(os.path.join(out_dir, name)).cuda()
        with torch.no_grad():
            depth = model(seen["x"], attn_impl="xla")["metric_depth"].cpu()
        ref = seen["depth"][blob["step"]]
        err = ((depth - ref).norm() / ref.norm()).item()
        loaded[name] = {"step": blob["step"], "rel_err": err}
        if err > 1e-6:
            raise AssertionError(f"{name} (step {blob['step']}): depth {err} from the model's")
        del model
    if loaded["latest.pt"]["step"] != FT_STEPS:
        raise AssertionError(f"latest.pt holds step {loaded['latest.pt']['step']}")
    del state, seen["state"]
    torch.cuda.empty_cache()
    steps = seen["steps"][1:]  # the first carries the allocator's growth
    results = {
        "batch": FT_BATCH, "res": [480, 640], "tokens": FT_GRID[0] * FT_GRID[1] + 1,
        "reference_batch": 16, "steps": FT_STEPS, "losses": losses,
        "step_ms": [s["ms"] for s in steps], "step_host_ms": [s["host_ms"] for s in steps],
        "first_step_ms": seen["steps"][0]["ms"],
        "k1_launches_per_step": [s["k1_launches"] for s in seen["steps"]],
        "validation_images": seen["val_images"],
        "k1_f32_bias_launches_per_validation_image": seen["val_launches"][1] / seen["val_images"],
        "validation_ms_per_image": seen["val_ms"] / seen["val_images"],
        "main_seconds": seconds, "peak_mem_gb": peak, "metrics": final,
        "checkpoints": loaded}
    phase("finetune_path", **results)
    results["card_vs_cpu"] = finetune_card_vs_cpu()
    return results


def finetune_card_vs_cpu():
    """One float32 fine-tune loss and backward at 4 of the 24 blocks
    (LayerScale 0.1, so attention shows) on 2 x 192 x 256, from the same
    weights on the card and on the CPU (eager attention on both), each held
    to the CPU's float64 gradient: the loss and all gradients as one
    vector within 1e-4 relative of the CPU's, and each gradient tensor (by
    norm) within 1e-4 of float64 beyond the CPU's own float32 error. The decoder's output convolutions sum
    SILog's gradient over every pixel, where it nearly cancels (the loss is
    scale invariant in log depth): there every float32 run, the CPU's too,
    is ~2.5e-3 off float64 and two of them ~3e-4 apart."""
    import dataclasses

    from depthg_tpu_torch.models.zoedepth import ZoeConfig, ZoeDepth
    from depthg_tpu_torch.models.zoedepth import finetune

    base = ZoeConfig()
    cfg = dataclasses.replace(base, beit=dataclasses.replace(
        base.beit, depth=4, hooks=(0, 1, 2, 3), layer_scale_init=0.1))
    gen = torch.Generator().manual_seed(11)
    cpu = ZoeDepth(cfg).init_weights(gen)
    batch = {"image": torch.rand(2, 3, 192, 256, generator=gen),
             "depth": torch.rand(2, 1, 192, 256, generator=gen) * 8.5 + 0.5,
             "mask": torch.rand(2, 1, 192, 256, generator=gen) > 0.2}
    ftcfg = finetune.FinetuneConfig(total_steps=4)
    losses, grads = {}, {}
    t0 = time.perf_counter()
    for name, dev, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                             ("cpu_f64", "cpu", torch.float64)):
        model = copy.deepcopy(cpu).to(dev, dtype)
        loss, _ = finetune.finetune_loss(model, {k: v.to(dev, dtype) if v.is_floating_point()
                                                 else v.to(dev) for k, v in batch.items()}, ftcfg)
        loss.backward()
        losses[name] = float(loss.detach())
        grads[name] = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()
                       if p.grad is not None}
        del model
    cpu_s = time.perf_counter() - t0
    loss_err = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    exact = grads["cpu_f64"]
    if not set(grads["card"]) == set(grads["cpu"]) == set(exact):
        raise AssertionError("the card and the CPU give gradients for different parameters")

    def err(side, k):
        return ((grads[side][k] - exact[k]).norm() / max(exact[k].norm().item(), 1e-30)).item()

    excess = sorted(((err("card", k) - err("cpu", k), k) for k in exact), reverse=True)
    worst_card = max((err("card", k), k) for k in exact)
    worst_cpu = max((err("cpu", k), k) for k in exact)
    card_vs_cpu = max((((grads["card"][k] - grads["cpu"][k]).norm()
                        / max(grads["cpu"][k].norm().item(), 1e-30)).item(), k) for k in exact)
    global_err = math.sqrt(sum(((grads["card"][k] - grads["cpu"][k]) ** 2).sum().item()
                               for k in exact) / sum((grads["cpu"][k] ** 2).sum().item()
                                                     for k in exact))
    phase("finetune_f32_card_vs_cpu", blocks=4, batch=2, res=[192, 256], layer_scale_init=0.1,
          loss=losses, loss_rel_err=loss_err, worst_card_grad_vs_f64=worst_card,
          worst_cpu_grad_vs_f64=worst_cpu, worst_card_excess_over_cpu=excess[0],
          worst_card_vs_cpu=card_vs_cpu, all_grads_card_vs_cpu=global_err, seconds=cpu_s,
          limit=FT_CARD_VS_CPU_TOL)
    if (loss_err > FT_CARD_VS_CPU_TOL or excess[0][0] > FT_CARD_VS_CPU_TOL
            or global_err > FT_CARD_VS_CPU_TOL):
        raise AssertionError(f"fine-tune step on the card vs the CPU: loss {loss_err}, "
                             f"gradient {excess[0]} beyond the CPU's float32 error")
    del cpu, grads
    torch.cuda.empty_cache()
    return {"loss_rel_err": loss_err, "worst_card_excess_over_cpu": excess[0][0],
            "worst_card_vs_cpu": card_vs_cpu[0], "all_grads_card_vs_cpu": global_err}


def nk_path_phase(att):
    """Full-width ZoeDepth-NK (``get_config("zoedepth_nk")``, LayerScale 0.1,
    random weights, the BEiT bias tables drawn at unit scale as in
    ``attention_bias`` so that the bias moves each block's attention well
    past bf16's rounding) on one 384 x 512 batch of 2: through K1 (with the
    bias, 24 launches per forward) against the eager softmax on the card,
    bf16 and float32: BEiT's four taps and the metric depth within
    ``NK_TOL``, the same domain both ways, the relative depth finite (the
    random MiDaS head ends below its ReLU: zero). A control runs K1 with the
    bias dropped against the same eager result: it must fail every tap's
    limit and float32's metric-depth limit, so they can see a kernel that is
    wrong."""
    import dataclasses

    from depthg_tpu_torch.models.zoedepth import beit, nk
    from depthg_tpu_torch.models.zoedepth.config import get_config

    base = get_config("zoedepth_nk")
    cfg = dataclasses.replace(base, beit=dataclasses.replace(base.beit, layer_scale_init=0.1))
    gen = torch.Generator(device="cuda").manual_seed(13)
    with torch.device("cuda"):
        model = nk.ZoeDepthNK(cfg).init_weights(gen).eval()
    encoder = model.core.core.pretrained.model
    with torch.no_grad():
        for blk in encoder.blocks:
            blk.attn.relative_position_bias_table.normal_(generator=gen)
    x = torch.rand(2, 3, 384, 512, device="cuda", generator=gen) * 2 - 1
    kernel = beit.attention_qkv

    def without_bias(qkv, num_heads, scale, n_valid=None, bias=None):
        return kernel(qkv, num_heads, scale, n_valid)

    def run(m, xd, impl):
        taps = []
        hook = encoder.register_forward_hook(lambda mod, args, out: taps.extend(out[0]))
        try:
            with torch.inference_mode():
                out = m(xd, attn_impl=impl)
        finally:
            hook.remove()
        return {"taps": [t.float() for t in taps], "rel_depth": out["rel_depth"].float(),
                "metric_depth": out["metric_depth"].float(),
                "domain": nk.domain_index(out["domain_logits"])}

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def errors(got, ref):
        return {"taps": [rel(a, b) for a, b in zip(got["taps"], ref["taps"])],
                "metric_depth": rel(got["metric_depth"], ref["metric_depth"])}

    results, failures = {}, []
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        m = model.to(dtype)
        xd = x.to(dtype)
        eager = run(m, xd, "xla")
        att.KERNEL.launches = att.KERNEL.bias_launches = 0
        fused = run(m, xd, "fused")
        launches, bias_launches = att.KERNEL.launches, att.KERNEL.bias_launches
        beit.attention_qkv = without_bias
        try:
            control = run(m, xd, "fused")
        finally:
            beit.attention_qkv = kernel
        tol = NK_TOL[label]
        err, ctl = errors(fused, eager), errors(control, eager)
        results[label] = {"errors": err, "control_errors": ctl, "domain": fused["domain"],
                          "k1_launches": launches, "k1_bias_launches": bias_launches,
                          "limits": tol}
        phase("nk_path", case=label, layer_scale_init=0.1, batch=2, res=[384, 512],
              **results[label])
        if (launches, bias_launches) != (24, 24):
            failures.append(f"nk {label}: {launches} K1 launches ({bias_launches} with the "
                            f"bias) per forward")
        if (fused["domain"] != eager["domain"] or len(err["taps"]) != len(tol["taps"])
                or not all(torch.isfinite(fused[k]).all() for k in ("rel_depth", "metric_depth"))
                or not all(e <= t for e, t in zip(err["taps"], tol["taps"]))
                or not err["metric_depth"] <= tol["metric_depth"]):
            failures.append(f"nk {label}: domain {fused['domain']} vs {eager['domain']}, "
                            f"kernel vs eager {err} (limits {tol})")
        if (not all(e > t for e, t in zip(ctl["taps"], tol["taps"]))
                or label == "f32" and not ctl["metric_depth"] > tol["metric_depth"]):
            failures.append(f"nk {label}: the control without the bias {ctl} passes the "
                            f"limits {tol}")
        del eager, fused, control
    if failures:
        raise AssertionError("; ".join(failures))
    del model, m
    torch.cuda.empty_cache()
    return results


def variants_path_phase(att, bil, inference, crf, gen, tmp):
    """ROADMAP item 6 on the card: each variant of ``VARIANTS`` through
    ``train.step.train_step`` (one warm-up and ``VARIANT_STEPS`` timed steps
    on one synthetic batch, both kernels' counts set to 0 just before and
    read just after), one ``dino_depth`` eval step, LHP's depth affinity and
    the pyramid's float32 code on the card vs the CPU, and the KNN CLI over
    a ResNet-50."""
    import numpy as np

    from depthg_tpu_torch import precompute_knns, profile_train
    from depthg_tpu_torch.models import featurizer, lhp, pyramid
    from depthg_tpu_torch.models.featurizer_depth import DepthFeaturizerConfig
    from depthg_tpu_torch.profile_serve import synthetic_jpeg
    from depthg_tpu_torch.train import losses as loss_lib
    from depthg_tpu_torch.train import step as step_lib

    lcfg = loss_lib.CorrLossConfig(feature_samples=11, neg_samples=5, depth_sampling="fps",
                                   depth_feat_correlation_loss=True)
    w, sh = profile_train.DEPTH_FEAT_WEIGHT, profile_train.DEPTH_FEAT_SHIFT
    batch = profile_train.synthetic_batch(TRAIN_B, TRAIN_RES, 27, gen)
    results = {}
    for name, overrides, per_step in VARIANTS:
        fcfg, hp = profile_train.variant(
            overrides, step_lib.TrainHParams(n_classes=27, backbone_dtype="bfloat16"))
        state = step_lib.init_state(fcfg, hp, torch.Generator().manual_seed(0), device="cuda")
        net = state.model.net
        frozen = {"model." + k: v.clone() for k, v in net.model.state_dict().items()}
        if state.lhp is not None:
            frozen.update({"lhp." + k: v.clone() for k, v in state.lhp.state_dict().items()})
        head_stats = {k: v.clone() for k, v in net.state_dict().items()
                      if ".running_" in k and not k.startswith("model.")}

        def probe_losses():
            """loss/linear + loss/cluster on the fixed batch with fixed
            masks; the pyramid head's running statistics are put back."""
            stats = {k: v.clone() for k, v in net.named_buffers()}
            fixed = torch.Generator(device="cuda").manual_seed(123)
            with torch.no_grad():
                logs = step_lib.loss_fn(state.model, batch, hp, lcfg, w, sh, generator=fixed,
                                        lhp=state.lhp)[1]
                for k, v in net.named_buffers():
                    v.copy_(stats[k])
            return float(logs["loss/linear"] + logs["loss/cluster"])

        before = probe_losses()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        att.KERNEL.launches = 0
        bil.KERNEL.launches = 0
        all_logs = [step_lib.train_step(state, batch, hp, lcfg, w, sh, generator=gen)]
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(VARIANT_STEPS):
            all_logs.append(step_lib.train_step(state, batch, hp, lcfg, w, sh, generator=gen))
        stop.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / VARIANT_STEPS * 1e3
        launches, k4 = att.KERNEL.launches, bil.KERNEL.launches
        step_ms = start.elapsed_time(stop) / VARIANT_STEPS
        peak = torch.cuda.max_memory_allocated() / 2**30
        after = probe_losses()

        if launches != per_step * (VARIANT_STEPS + 1) or k4 != 0:
            raise AssertionError(f"{name}: {launches} K1 launches in {VARIANT_STEPS + 1} steps "
                                 f"(expected {per_step} per step) and {k4} K4 launches")
        for i, logs in enumerate(all_logs):
            bad = [k for k, v in logs.items() if not bool(torch.isfinite(v).all())]
            if bad:
                raise AssertionError(f"{name} step {i}: non-finite {bad}")
        if not after < before:
            raise AssertionError(f"{name}: loss/linear + loss/cluster did not fall: "
                                 f"{before} -> {after}")
        now = {"model." + k: v for k, v in net.model.state_dict().items()}
        if state.lhp is not None:
            now.update({"lhp." + k: v for k, v in state.lhp.state_dict().items()})
        changed = [k for k in frozen if not torch.equal(now[k], frozen[k])]
        if changed or any(p.grad is not None or p.requires_grad for p in net.model.parameters()):
            raise AssertionError(f"{name}: frozen parameters changed or took a gradient: "
                                 f"{changed[:5]}")
        head_moved = [k for k, v in head_stats.items() if not torch.equal(net.state_dict()[k], v)]
        if len(head_moved) != len(head_stats) or (name == "feature_pyramid") != bool(head_stats):
            raise AssertionError(f"{name}: head BatchNorm statistics moved: {len(head_moved)} "
                                 f"of {len(head_stats)}")
        results[name] = {"step_ms": step_ms, "host_ms": host_ms, "peak_mem_gb": peak,
                         "k1_launches_per_step": launches / (VARIANT_STEPS + 1),
                         "k4_launches": k4}
        phase("variants_path", variant=name, overrides=overrides,
              featurizer=type(fcfg).__name__, lhp=hp.lhp, batch=TRAIN_B, res=TRAIN_RES,
              steps_timed=VARIANT_STEPS, step_ms=step_ms, host_ms=host_ms,
              img_per_s=TRAIN_B / step_ms * 1e3, peak_mem_gb=peak, k1_launches=launches,
              k1_launches_per_step=per_step, k4_launches=k4, probe_losses_before=before,
              probe_losses_after=after, frozen_tensors_unchanged=len(frozen),
              head_running_stats_moved=len(head_moved),
              last_logs={k: float(v) for k, v in all_logs[-1].items()})
        del state, net, frozen, now, all_logs
        torch.cuda.empty_cache()

    # one dino_depth eval step at the default point (eval: the no-depth embed)
    model = inference.Segmenter(DepthFeaturizerConfig(guidance="cross_attn"), 27, 27)
    model = model.init_weights(torch.Generator().manual_seed(0)).cuda()
    step = inference.make_eval_step(inference.EvalConfig(
        n_classes=27, crf=crf.crf_config_from_cfg({}), backbone_dtype="bfloat16"))
    batches = make_batches(gen, B, 2)  # warm-up + one timed
    _, eval_img_s, eval_launches, eval_k4 = run_eval_batches(step, model, batches, att, bil)
    if eval_launches != DINO_DEPTH_EVAL_LAUNCHES * 2 or eval_k4 != 0:
        raise AssertionError(f"dino_depth eval: {eval_launches} K1 launches in 2 steps "
                             f"(expected {DINO_DEPTH_EVAL_LAUNCHES} each), {eval_k4} K4")
    phase("variants_eval", arch="dino_depth", guidance="cross_attn", batch=B, res=320,
          crf_point="default", img_per_s=eval_img_s,
          k1_launches_per_step=eval_launches / 2, k4_launches=eval_k4)
    del model, batches
    torch.cuda.empty_cache()

    # LHP's depth affinity and mixed code, card vs CPU (float32, TF32 off)
    cpu_gen = torch.Generator().manual_seed(1)
    depth = torch.nn.functional.interpolate(torch.rand(4, 1, 28, 28, generator=cpu_gen),
                                            size=(TRAIN_RES, TRAIN_RES), mode="bilinear")
    grid = (TRAIN_RES // 8,) * 2
    ref = lhp._depth_affinity(depth, grid, False)
    out = lhp._depth_affinity(depth.cuda(), grid, False).cpu()
    normed, thresh = lhp._depth_normed(depth, grid, False)
    flips = (out == 0) != (ref == 0)
    gaps = sorted(float(g) for g in (normed - thresh).abs()[flips])
    head = lhp.LHP(lhp.LHPConfig()).init_weights(cpu_gen)
    code = torch.randn(4, 70, *grid, generator=cpu_gen)
    mixed_ref = lhp.lhp_apply(head, code, depth)
    mixed = lhp.lhp_apply(head.cuda(), code.cuda(), depth.cuda()).cpu()
    code_err = float((mixed - mixed_ref).norm() / mixed_ref.norm())
    value_err = float((out - ref)[~flips].abs().max())
    phase("variants_lhp_card_vs_cpu", batch=4, res=TRAIN_RES, points=grid[0] * grid[1],
          zero_pattern_flips=int(flips.sum()), flip_threshold_gaps=gaps[:20],
          max_abs_diff_elsewhere=value_err, mixed_code_rel_err=code_err)
    if (gaps and gaps[-1] > LHP_FLIP_GAP) or value_err > LHP_FLIP_GAP or code_err > LHP_CODE_TOL:
        raise AssertionError(f"LHP card vs CPU: flips at gaps {gaps[-5:]}, values "
                             f"{value_err}, mixed code {code_err}")

    # the pyramid in float32, card vs CPU (eval: running-stat BatchNorm)
    fcfg, _ = profile_train.variant(VARIANTS[-1][1], step_lib.TrainHParams(n_classes=27))
    pyr = pyramid.FeaturePyramidNet(fcfg).init_weights(torch.Generator().manual_seed(2))
    img = torch.randn(2, 3, TRAIN_RES, TRAIN_RES, generator=cpu_gen)
    with torch.no_grad():
        code_cpu = featurizer.dispatch_apply(pyr, img)["code"]
        code_card = featurizer.dispatch_apply(pyr.cuda(), img.cuda())["code"].cpu()
    pyr_err = float((code_card - code_cpu).norm() / code_cpu.norm())
    phase("variants_pyramid_card_vs_cpu", granularity=fcfg.granularity, batch=2,
          res=TRAIN_RES, code_rel_err=pyr_err)
    if not pyr_err <= PYRAMID_CARD_VS_CPU_TOL:
        raise AssertionError(f"pyramid float32 card vs CPU: {pyr_err}")
    del pyr
    torch.cuda.empty_cache()

    # the KNN CLI over a random ResNet-50 (no weights file under output_root/data)
    data = os.path.join(tmp, "knn_cnn")
    img_dir = os.path.join(data, "cropped", "cocostuff27_five_crop_0.5", "img", "train")
    os.makedirs(img_dir)
    for i in range(KNN_CNN_IMAGES):
        with open(os.path.join(img_dir, f"{i}.jpg"), "wb") as f:
            f.write(synthetic_jpeg(500 + i, 240, 240))
    att.KERNEL.launches = 0
    t0 = time.perf_counter()
    written = precompute_knns.main([
        f"data_dir={data}", f"output_root={tmp}", "model_type=resnet50",
        "knn_datasets=[cocostuff27]", "knn_crop_types=[five]", "knn_image_sets=[train]",
        "num_workers=4"])
    knn_s = time.perf_counter() - t0
    nns = np.load(written[0])["nns"]
    if (os.path.basename(written[0]) != "nns_resnet50_cocostuff27_train_five_224.npz"
            or nns.shape != (KNN_CNN_IMAGES, KNN_K)
            or not (nns[:, 0] == np.arange(KNN_CNN_IMAGES)).all() or att.KERNEL.launches):
        raise AssertionError(f"precompute_knns over resnet50: {written} {nns.shape}, "
                             f"{att.KERNEL.launches} K1 launches")
    phase("variants_knn", model_type="resnet50", images=KNN_CNN_IMAGES, seconds=knn_s,
          file=os.path.basename(written[0]), self_at_rank_0=True)
    return {"steps": results, "eval_launches_per_step": eval_launches / 2,
            "k4_launches": sum(r["k4_launches"] for r in results.values()) + eval_k4,
            "lhp_flips": int(flips.sum()), "lhp_code_rel_err": code_err,
            "pyramid_card_vs_cpu": pyr_err}


# -- phase 18: the parallel paths -----------------------------------------------

PAR_STEPS = 3  # float32 train steps of the two gloo ranks
PAR_EVAL_B = 16
PAR_TIMEOUT = 240  # seconds for the two ranks' processes
# two gloo ranks on one card vs one process there: each step's logs and the
# first step's gradients within 1e-5 relative (of the log, of the largest
# entry of the gradient's tensor); the parameters after three steps within
# 1e-5 of their tensor's largest entry plus what float64 Adam makes of the
# two runs' gradient differences (Adam divides by |g| + 1e-8: an entry that
# cancels to rounding noise moves by up to lr whatever its size)
PAR_TOL = 1e-5
PAR_LABEL_AGREEMENT = 0.999


def _par_train_setup(featurizer, dtype):
    from depthg_tpu_torch import profile_train
    from depthg_tpu_torch.train import losses as loss_lib
    from depthg_tpu_torch.train import step as step_lib

    hp = step_lib.TrainHParams(n_classes=27, backbone_dtype=dtype)
    lcfg = loss_lib.CorrLossConfig(feature_samples=11, neg_samples=5, depth_sampling="fps",
                                   depth_feat_correlation_loss=True)
    state = step_lib.init_state(featurizer.FeaturizerConfig(), hp,
                                torch.Generator().manual_seed(0), device="cuda")
    batch = profile_train.synthetic_batch(TRAIN_B, TRAIN_RES, 27,
                                          torch.Generator(device="cuda").manual_seed(11))
    return state, batch, hp, lcfg


def _par_train_run(featurizer, dtype, steps):
    """``steps`` steps of the train cell on this rank's rows of one batch,
    step k's draws seeded from k: logs, every step's gradients and the
    trainable parameters, on the host."""
    from depthg_tpu_torch import profile_train
    from depthg_tpu_torch.parallel import dist
    from depthg_tpu_torch.train import step as step_lib

    state, batch, hp, lcfg = _par_train_setup(featurizer, dtype)
    local = {k: dist.shard_rows(v) for k, v in batch.items()}
    w, sh = profile_train.DEPTH_FEAT_WEIGHT, profile_train.DEPTH_FEAT_SHIFT
    logs, grads = [], {}
    for k in range(steps):
        gen = torch.Generator(device="cuda").manual_seed(100 + k)
        out = step_lib.train_step(state, local, hp, lcfg, w, sh, generator=gen)
        logs.append({name: float(v) for name, v in out.items()})
        for name, p in state.model.named_parameters():
            if p.grad is not None:
                grads.setdefault(name, []).append(p.grad.detach().cpu())
    params = {k: v.detach().cpu() for k, v in state.model.state_dict().items()
              if not k.startswith("net.model.")}
    return {"logs": logs, "grads": grads, "params": params}


def _par_eval_setup(inference, featurizer, crf):
    model = inference.Segmenter(featurizer.FeaturizerConfig(), 27, 27).init_weights(
        torch.Generator().manual_seed(0)).cuda()
    ecfg = inference.EvalConfig(n_classes=27, crf=crf.crf_config_from_cfg({}),
                                backbone_dtype="bfloat16")
    img, label = make_batches(torch.Generator(device="cuda").manual_seed(21), PAR_EVAL_B, 1)[0]
    return model, ecfg, img, label


def _par_knn_feats():
    gen = torch.Generator(device="cuda").manual_seed(31)
    return torch.nn.functional.normalize(
        torch.randn(KNN_N, KNN_C, device="cuda", generator=gen), dim=1)


def parallel_worker(rank, world, port, out_dir):
    """One of two gloo ranks sharing the card (``chip_smoke.py
    --parallel-worker RANK WORLD PORT DIR``): the float32 train steps, the
    default-point eval and predict steps and the top-k, each on its rows,
    counts of K1 and K4 set to 0 before each and read after."""
    sys.path.insert(0, ROOT)
    import depthg_tpu_torch
    from depthg_tpu_torch import inference
    from depthg_tpu_torch.models import featurizer
    from depthg_tpu_torch.ops import _build, crf
    from depthg_tpu_torch.ops import attention as att
    from depthg_tpu_torch.ops import crf_bilateral as bil
    from depthg_tpu_torch.parallel import dist, knn

    depthg_tpu_torch.get_device("cuda")
    _build.build(["attention", "crf_bilateral"])
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    group = torch.distributed.group.WORLD
    out = {}
    att.KERNEL.launches = att.KERNEL.f32_launches = bil.KERNEL.launches = 0
    out["train"] = _par_train_run(featurizer, "float32", PAR_STEPS)
    out["train_launches"], out["train_f32_launches"] = att.KERNEL.launches, att.KERNEL.f32_launches
    out["train_k4"] = bil.KERNEL.launches
    model, ecfg, img, label = _par_eval_setup(inference, featurizer, crf)
    att.KERNEL.launches = bil.KERNEL.launches = 0
    x, y = dist.shard_rows(img), dist.shard_rows(label)
    out["eval"] = [t.cpu() for t in inference.make_eval_step(ecfg, group)(model, x, y)]
    out["eval_launches"] = att.KERNEL.launches
    out["predict"] = [t.cpu() for t in inference.make_predict_step(ecfg, group)(model, x)]
    out["eval_k4"] = bil.KERNEL.launches  # the eval and the predict step
    t0 = time.perf_counter()
    idx = knn.topk_neighbors(_par_knn_feats(), k=KNN_K, precision="highest", group=group)
    out["knn_s"] = time.perf_counter() - t0
    if rank == 0:
        out["knn"] = idx
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def nccl_probe(rank, world, port, out_dir):
    """``--nccl-probe``: NCCL with two ranks on the one card; writes what
    happened (the error NCCL gives, or that the all-reduce ran)."""
    import datetime

    torch.cuda.set_device(0)
    try:
        torch.distributed.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=30))
        t = torch.ones(1, device="cuda")
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        result = f"all_reduce ran: {float(t)}"
    except Exception as e:  # the outcome is what this probe reports
        result = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:300]}"
    with open(os.path.join(out_dir, f"nccl{rank}.txt"), "w") as f:
        f.write(result)
    return 0


def _spawn(args, tmp, name, n):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = []
    for r in range(n):
        log = open(os.path.join(tmp, f"{name}{r}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), *args(r)],
                                       cwd=ROOT, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, timeout):
    """Wait for every process; kill what outlives ``timeout``. Returns the
    exit codes (None for a killed one)."""
    deadline = time.time() + timeout
    codes = []
    for p, log in procs:
        try:
            codes.append(p.wait(max(deadline - time.time(), 1)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.append(None)
        log.close()
    return codes


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _adam_total(grads, lr, b1=0.9, b2=0.999, eps=1e-8):
    m = v = total = 0
    for t, g in enumerate(grads, start=1):
        g = g.double()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        total = total - lr * (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
    return total


def _hold_train(got, ref, lr, what, tol=PAR_TOL):
    """``got`` (a rank's run) against ``ref`` (the single process): worst
    relative log error, step-1 gradient error, parameter excess over the
    Adam gap (the parameters held to ``tol`` only)."""
    log_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-2)
                  for a, b in zip(got["logs"], ref["logs"]) for k in b)
    grad_err = max(float((got["grads"][k][0] - g[0]).abs().max())
                   / max(float(g[0].abs().max()), 1e-12) for k, g in ref["grads"].items())
    param_err = 0.0
    for k, r in ref["params"].items():
        if k.endswith("num_batches_tracked"):
            continue
        gap = (_adam_total(got["grads"][k], lr) - _adam_total(ref["grads"][k], lr)).abs() \
            if k in ref["grads"] else 0.0
        excess = ((got["params"][k].double() - r.double()).abs() - gap).max()
        param_err = max(param_err, float(excess) / max(float(r.abs().max()), 1e-12))
    if not param_err <= tol or (tol == PAR_TOL and not (log_err <= tol and grad_err <= tol)):
        raise AssertionError(f"{what}: logs {log_err}, step-1 gradients {grad_err}, "
                             f"parameters {param_err} (limit {tol})")
    return {"log_rel_err": log_err, "grad_rel_err": grad_err, "param_excess_rel": param_err}


def parallel_path_phase(att, bil, inference, featurizer, crf, tmp):
    """Phase 18: the train cell through the torchrun code path at world size
    1 (NCCL), two gloo ranks sharing the card (float32 train steps, an eval
    and a predict step, the top-k), NCCL asked for two ranks on one card,
    and the service with two replicas on ``cuda:0``."""
    import numpy as np

    from depthg_tpu_torch import profile_train
    from depthg_tpu_torch.parallel import dist
    from depthg_tpu_torch.parallel import knn
    from depthg_tpu_torch.serve import SegmentationService, _bucket
    from depthg_tpu_torch.train import step as step_lib

    t_phase = time.perf_counter()
    # world size 1 through the torchrun code path: the phase-7 train cell
    # (bf16 backbone), twice without a group and once in an NCCL group of
    # one; then the same loop timed without a group and in the group
    w, sh = profile_train.DEPTH_FEAT_WEIGHT, profile_train.DEPTH_FEAT_SHIFT

    def timed(steps):
        state, batch, hp, lcfg = _par_train_setup(featurizer, "bfloat16")
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        att.KERNEL.launches = bil.KERNEL.launches = 0
        for k in range(steps + 1):
            if k == 1:
                torch.cuda.synchronize()
                start.record()
            gen = torch.Generator(device="cuda").manual_seed(100 + k)
            step_lib.train_step(state, batch, hp, lcfg, w, sh, generator=gen)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / steps, att.KERNEL.launches, bil.KERNEL.launches

    ref = _par_train_run(featurizer, "bfloat16", TRAIN_STEPS + 1)
    again = _par_train_run(featurizer, "bfloat16", TRAIN_STEPS + 1)
    ref_ms, _, _ = timed(TRAIN_STEPS)
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(_free_port()))
    try:
        if dist.init_from_env() != 1 or torch.distributed.get_backend() != "nccl":
            raise AssertionError("the torchrun path did not make an NCCL group of one")
        grouped = _par_train_run(featurizer, "bfloat16", TRAIN_STEPS + 1)
        group_ms, launches, world1_k4 = timed(TRAIN_STEPS)
    finally:
        dist.destroy()
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)
    again_ms, _, _ = timed(TRAIN_STEPS)
    per_step = 2 * 12
    if launches != per_step * (TRAIN_STEPS + 1) or world1_k4 != 0:
        raise AssertionError(f"world size 1: {launches} K1 launches, expected "
                             f"{per_step * (TRAIN_STEPS + 1)}; {world1_k4} K4 launches")
    # the forward of the first step (the same weights) is deterministic:
    # its logs are bit-equal; the backward adds with atomics (grid_sample,
    # bilinear resize), so two runs without a group part at the rounding
    # level, and the group's run may part from them no further
    logs_equal = ref["logs"][0] == grouped["logs"][0] == again["logs"][0]
    repeat_equal = all(torch.equal(again["params"][k], v) for k, v in ref["params"].items())
    grouped_equal = all(torch.equal(grouped["params"][k], v) for k, v in ref["params"].items())
    grad_excess = 0.0
    for k, g in ref["grads"].items():
        pair = float((again["grads"][k][0] - g[0]).abs().max())
        diff = float((grouped["grads"][k][0] - g[0]).abs().max())
        grad_excess = max(grad_excess, (diff - 4 * pair) / max(float(g[0].abs().max()), 1e-12))
    lr = step_lib.TrainHParams(n_classes=27).lr
    param_err = _hold_train(grouped, ref, lr, "world size 1 (NCCL)", tol=1e-6)
    if not logs_equal or grad_excess > 1e-6:
        raise AssertionError(f"world size 1 (NCCL): step-1 logs bit-equal {logs_equal}; "
                             f"step-1 gradients beyond 4x the two ungrouped runs' difference "
                             f"by {grad_excess} of their scale")
    if repeat_equal and not grouped_equal:
        raise AssertionError("world size 1 (NCCL): two runs without a group are bit-equal, "
                             "the group's is not")
    phase("parallel_world1", backend="nccl", batch=TRAIN_B, res=TRAIN_RES,
          steps=TRAIN_STEPS + 1, step1_logs_bit_equal=logs_equal,
          params_bit_equal=grouped_equal, repeat_without_group_bit_equal=repeat_equal,
          step1_grad_excess_over_4x_repeat=grad_excess, vs_without_group=param_err,
          ms_per_step_without_group=ref_ms, ms_per_step_without_group_again=again_ms,
          ms_per_step_world1=group_ms, collective_overhead_ms=group_ms - min(ref_ms, again_ms),
          k1_launches=launches, k1_launches_per_step=per_step, k4_launches=world1_k4)

    # the service with two replicas on one card: a batch of 16 splits 8 + 8
    model, ecfg, img, _ = _par_eval_setup(inference, featurizer, crf)
    ecfg = inference.EvalConfig(n_classes=27, crf=crf.crf_config_from_cfg({}),
                                backbone_dtype="bfloat16", fused_tta=True)
    one = SegmentationService(copy.deepcopy(model), ecfg, res=320, max_batch=16,
                              max_wait_ms=10.0, device="cuda")
    svc = SegmentationService(model, ecfg, res=320, max_batch=16, max_wait_ms=10.0,
                              devices=["cuda:0", "cuda:0"])
    imgs = [x.cpu().numpy() for x in img]
    rows = imgs[:13] + [imgs[0]] * 3

    def host_ms(fn, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    try:
        svc.warmup([16])
        one.warmup([16])
        att.KERNEL.launches = bil.KERNEL.launches = 0
        served = svc._run_batch(imgs[:13])  # bucket 16: 13 images and 3 pad rows
        replica_launches, k4 = att.KERNEL.launches, bil.KERNEL.launches
        # host ms of the batch: two replicas at once, one device, the two
        # halves in turn on one replica (what overlap the threads get)
        serve_ms = host_ms(lambda: svc._run_batch(imgs[:13]))
        one_ms = host_ms(lambda: one._run_batch(imgs[:13]))
        halves_ms = host_ms(lambda: (svc._predict_part(rows[:8], 0),
                                     svc._predict_part(rows[8:], 0)))
        predict = inference.make_predict_step(ecfg)
        mismatched = 0
        for i in range(2):
            part = torch.from_numpy(np.stack(rows[8 * i:8 * i + 8])).cuda()
            lin, clu = (t.cpu().numpy() for t in predict(svc._models[i], part))
            for j in range(8):
                if 8 * i + j < 13:
                    mismatched += int(not (np.array_equal(served[8 * i + j][0], lin[j])
                                           and np.array_equal(served[8 * i + j][1], clu[j])))
        # the replicas' weights against the model's: the single-device service
        # on the same bucket (batch 16 against two of 8: cuBLAS and cuDNN may
        # pick other algorithms per batch size, hence the agreement floor)
        one_lin, one_clu = one._predict_padded(imgs[:13], 16)
        vs_one = [float(np.mean([np.mean(served[j][k] == ref[j]) for j in range(13)]))
                  for k, ref in enumerate((one_lin, one_clu))]
        vs_one_flips = [int(sum(np.sum(served[j][k] != ref[j]) for j in range(13)))
                        for k, ref in enumerate((one_lin, one_clu))]
    finally:
        svc.close()
        one.close()
    if (_bucket(13, 16, 2) != 16 or mismatched or replica_launches != 2 * 12 or k4 != 0
            or min(vs_one) < PAR_LABEL_AGREEMENT):
        raise AssertionError(f"two replicas: {mismatched} responses differ from the predict "
                             f"step on their replica's rows; labels agree with the single-device "
                             f"service on {vs_one} of the pixels (limit {PAR_LABEL_AGREEMENT}); "
                             f"K1 {replica_launches} (expected 24: 12 per replica), K4 {k4}")
    phase("parallel_serve_replicas", devices=["cuda:0", "cuda:0"], images=13, bucket=16,
          rows_per_replica=8, ms=serve_ms, one_device_ms=one_ms, halves_in_turn_ms=halves_ms,
          responses_equal_to_predict=True, label_agreement_with_one_device=vs_one,
          label_flips_against_one_device=vs_one_flips,
          k1_launches=replica_launches, k1_launches_per_replica=replica_launches // 2,
          k4_launches=k4)

    # the two ranks and the NCCL probes start after the timed parts (they
    # share the card and the host); this process takes the single-process
    # references while they run
    port = _free_port()
    ranks = _spawn(lambda r: ["--parallel-worker", str(r), "2", str(port), tmp], tmp, "rank", 2)
    nccl_port = _free_port()
    probes = _spawn(lambda r: ["--nccl-probe", str(r), "2", str(nccl_port), tmp], tmp, "nccl", 2)
    single = _par_train_run(featurizer, "float32", PAR_STEPS)
    model, ecfg, img, label = _par_eval_setup(inference, featurizer, crf)
    eval_ref = [t.cpu() for t in inference.make_eval_step(ecfg)(model, img, label)]
    pred_ref = [t.cpu() for t in inference.make_predict_step(ecfg)(model, img)]
    del model
    knn_ref = knn.topk_neighbors(_par_knn_feats(), k=KNN_K, precision="highest")

    codes = _wait(ranks, PAR_TIMEOUT)
    if codes != [0, 0]:
        tails = "".join(open(os.path.join(tmp, f"rank{r}.log")).read()[-3000:] for r in range(2))
        raise AssertionError(f"the two gloo ranks exited with {codes}:\n{tails}")
    probe_codes = _wait(probes, 5)
    nccl = [open(os.path.join(tmp, f"nccl{r}.txt")).read()
            if os.path.exists(os.path.join(tmp, f"nccl{r}.txt")) else
            f"no answer (exit code {c}: killed after the ranks were done)"
            for r, c in enumerate(probe_codes)]
    outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    lr = step_lib.TrainHParams(n_classes=27).lr
    train_err = [_hold_train(o["train"], single, lr, f"rank {r}") for r, o in enumerate(outs)]
    if any(o["train_launches"] != per_step * PAR_STEPS
           or o["train_f32_launches"] != o["train_launches"] or o["train_k4"] or o["eval_k4"]
           for o in outs):
        raise AssertionError(f"K1 per rank: {[o['train_launches'] for o in outs]}, expected "
                             f"{per_step * PAR_STEPS} float32 launches; K4 per rank (train, "
                             f"eval): {[(o['train_k4'], o['eval_k4']) for o in outs]}, expected 0")
    blocks_equal = all(torch.equal(a, b) for o in outs for a, b in zip(o["eval"], eval_ref))
    agree = [float((a == b).float().mean()) for a, b in zip(outs[0]["predict"], pred_ref)]
    flips = [int((a != b).sum()) for a, b in zip(outs[0]["predict"], pred_ref)]
    if not blocks_equal and min(agree) < PAR_LABEL_AGREEMENT:
        raise AssertionError(f"two-rank eval: confusion blocks differ and the labels agree on "
                             f"{agree} of the pixels (limit {PAR_LABEL_AGREEMENT})")
    if not np.array_equal(outs[0]["knn"], knn_ref):
        raise AssertionError("two-rank top-k indices differ from the single process's")
    phase("parallel_two_ranks", backend="gloo", devices=["cuda:0", "cuda:0"],
          train={"global_batch": TRAIN_B, "per_rank": TRAIN_B // 2, "steps": PAR_STEPS,
                 "backbone": "float32", "tf32_off": True, "per_rank_err": train_err,
                 "tolerance": PAR_TOL},
          k1_launches_per_rank_per_step=outs[0]["train_launches"] // PAR_STEPS,
          k4_launches_per_rank={"train": [o["train_k4"] for o in outs],
                                "eval_and_predict": [o["eval_k4"] for o in outs]},
          eval={"global_batch": PAR_EVAL_B, "confusion_blocks_equal": blocks_equal,
                "label_agreement": agree, "label_flips": flips,
                "k1_launches_per_rank": outs[0]["eval_launches"]},
          knn={"n": KNN_N, "k": KNN_K, "indices_equal": True,
               "seconds_per_rank": [o["knn_s"] for o in outs]},
          nccl_two_ranks_one_card=nccl, seconds=time.perf_counter() - t_phase)
    return {"world1_launches_per_step": launches // (TRAIN_STEPS + 1),
            "rank_launches_per_step": outs[0]["train_launches"] // PAR_STEPS,
            "replica_launches_per_batch": replica_launches // 2,
            "eval_launches_per_rank": outs[0]["eval_launches"],
            "k4_launches": {"world1_train": world1_k4, "serve_replicas": k4,
                            **{f"rank{r}_train": o["train_k4"] for r, o in enumerate(outs)},
                            **{f"rank{r}_eval": o["eval_k4"] for r, o in enumerate(outs)}}}


# phase 19: the int8 (w8a8) backbone. Each linear's rows M on its path and
# its (in, out) widths: ViT-S/8 at the eval step's backbone batch (16 images
# of 1,601 tokens per forward) and BEiT-L at ZoeDepth's 384 x 512 batch of 8
# (769 tokens)
INT8_LINEARS = (("vit_s8", B * N, ((384, 1152), (384, 384), (384, 1536), (1536, 384))),
                ("beit_l", 8 * 769, ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))))
INT8_CPU_ROWS = 2048  # rows of each product also summed on the CPU
INT8_FEATURE_COSINE = 0.99  # tests/test_int8_backbone.py's bound, int8 vs float32
PEAK_INT8 = 1979e12  # int8 tensor-core operations/s (H100 SXM data sheet, dense)


def int8_linear_bound_ms(m, k, n):
    """Least ms for one w8a8 linear: the bf16 input, the int8 weight, its
    scales and bias read and the bf16 output written once over the memory
    rate, or 2 MNK int8 operations over the int8 peak."""
    nbytes = 2 * m * k + k * n + 8 * n + 2 * m * n
    return max(nbytes / PEAK_HBM, int8_matmul_flops(m, k, n) / PEAK_INT8) * 1e3


def bf16_linear_bound_ms(m, k, n):
    nbytes = 2 * m * k + 2 * k * n + 2 * n + 2 * m * n
    return max(nbytes / PEAK_HBM, 2 * m * n * k / PEAK_BF16) * 1e3


def _int8_linear_case(m, k, n):
    """One w8a8 shape's ``nn.Linear`` (torch's default init, on the CPU,
    seeded by its widths) and bf16 input rows on the card."""
    torch.manual_seed(k * 7 + n)
    lin = torch.nn.Linear(k, n)
    x = torch.randn(m, k, generator=torch.Generator(device="cuda").manual_seed(n),
                    device="cuda").bfloat16()
    return lin, x


def int8_profile_worker(out_dir):
    """``chip_smoke.py --int8-profile DIR``: at every shape of
    ``INT8_LINEARS``, the device time of the whole w8a8 linear and of its
    int8 product alone, each summed over every kernel of ``torch.profiler``
    traces, and the linear's kernels per call; written to
    ``DIR/int8_profile.json``. It runs in a process of its own, whose
    profiler has traced nothing before, because CUPTI drops records from
    later traces of a process that has traced much already."""
    sys.path.insert(0, ROOT)
    from depthg_tpu_torch.models import layers

    res = {}
    for model, m, widths in INT8_LINEARS:
        for k, n in widths:
            lin, x = _int8_linear_case(m, k, n)
            q = layers.quantize_linear(lin.cuda())
            xs = [x, -x, x * 1.5]
            codes_in = [layers.quantize_rows(v)[0] for v in xs]
            whole_ms, n_kernels = profiled_device_ms(
                lambda v: layers.linear_w8a8(v, q.w_q, q.s_w, q.b), xs)
            mm_ms, _ = profiled_device_ms(lambda c: layers.int8_matmul(c, q.w_q), codes_in)
            res[f"{model}_{k}x{n}"] = {
                "profiled_ms": whole_ms, "profiled_int_mm_ms": mm_ms,
                "profiled_other_ms": whole_ms - mm_ms, "device_kernels_per_linear": n_kernels}
    with open(os.path.join(out_dir, "int8_profile.json"), "w") as f:
        json.dump(res, f)
    return 0


def int8_linear_phase():
    """``linear_w8a8`` at every linear shape of the ViT-S/8 eval step and of
    BEiT-L's depth batch, on the card against the CPU: the weight codes and
    scales, the activation codes and scales (mismatch counts), the int32
    sums exactly (on the first ``INT8_CPU_ROWS`` rows), the bf16 output;
    CUDA-event times of the whole linear, of its quantize pass, of
    ``torch._int_mm`` and of bf16 ``F.linear``, and the profiler's device
    times of the linear and of its int8 product (``int8_profile_worker``,
    run first and alone on the card)."""
    import torch.nn.functional as F

    from depthg_tpu_torch.models import layers

    with tempfile.TemporaryDirectory() as tmp:
        code, = _wait(_spawn(lambda r: ["--int8-profile", tmp], tmp, "int8_profile", 1), 300)
        if code != 0:
            raise AssertionError(f"the int8 profiler process exited with {code}:\n"
                                 + open(os.path.join(tmp, "int8_profile0.log")).read()[-3000:])
        with open(os.path.join(tmp, "int8_profile.json")) as f:
            profiled = json.load(f)
    results = {}
    for model, m, widths in INT8_LINEARS:
        for k, n in widths:
            name = f"{model}_{k}x{n}"
            lin, x = _int8_linear_case(m, k, n)
            q_cpu, q = layers.quantize_linear(lin), layers.quantize_linear(lin.cuda())
            codes, s_x = layers.quantize_rows(x)
            codes_cpu, s_x_cpu = layers.quantize_rows(x.cpu())
            mism = {"weight_codes": int((q.w_q.cpu() != q_cpu.w_q).sum()),
                    "weight_scales": int((q.s_w.cpu() != q_cpu.s_w).sum()),
                    "activation_codes": int((codes.cpu() != codes_cpu).sum()),
                    "activation_scales": int((s_x.cpu() != s_x_cpu).sum())}
            rows = slice(0, INT8_CPU_ROWS)
            sums = layers.int8_matmul(codes, q.w_q)
            if not torch.equal(sums[rows].cpu(),
                               layers.int8_matmul(codes[rows].cpu(), q.w_q.cpu())):
                raise AssertionError(f"{name}: int32 sums differ from the CPU's")
            out = layers.linear_w8a8(x, q.w_q, q.s_w, q.b)
            ref = layers.linear_w8a8(x[rows].cpu(), q_cpu.w_q, q_cpu.s_w, q_cpu.b).float()
            got = out[rows].float().cpu()
            # one bf16 step (the rescale may round its float32 product apart)
            bad = int(((got - ref).abs() > 2.0 ** -7 * ref.abs() + 1e-6).sum())
            if bad or out.dtype != torch.bfloat16 or out.shape != (m, n):
                raise AssertionError(f"{name}: {bad} outputs off the CPU's by more than "
                                     "a bf16 step")
            xs = [x, -x, x * 1.5]
            w_bf16, b_bf16 = lin.weight.bfloat16(), lin.bias.bfloat16()
            codes_in = [layers.quantize_rows(v)[0] for v in xs]
            row = {"m": m, "k": k, "n": n, "mismatches": mism,
                   "max_rel_err": float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max()),
                   "ms": cuda_time_ms(lambda v: layers.linear_w8a8(v, q.w_q, q.s_w, q.b), xs),
                   "quantize_ms": cuda_time_ms(lambda v: layers.quantize_rows(v)[0], xs),
                   "int_mm_ms": cuda_time_ms(lambda c: layers.int8_matmul(c, q.w_q), codes_in),
                   "bf16_linear_ms": cuda_time_ms(lambda v: F.linear(v, w_bf16, b_bf16), xs),
                   "bound_ms": int8_linear_bound_ms(m, k, n),
                   "bf16_bound_ms": bf16_linear_bound_ms(m, k, n)}
            row.update(profiled[name])
            results[name] = row
            phase("int8_linear", linear=name, **row)
            del x, xs, codes_in, sums, out
    return results


def int8_path_phase(att, bil, inference, featurizer, crf, gen, tmp, card):
    """The int8 backbone through every entry point at full width:
    eval (batch 16, 320 px, default point; bf16 and int8 in turns, features'
    cosine to float32), one served batch in bucket 16 (``build_service``),
    five train steps at the train cell (bf16 and int8 in turns), depth
    generation for ZoeDepth and MiDaS (``generate_depth.main --dtype int8``,
    one 384 x 512 batch of 8 timed beside bf16), two steps of the CRF
    playground."""
    import numpy as np
    from PIL import Image

    from depthg_tpu_torch import generate_depth, profile_train, serve, train_crf
    from depthg_tpu_torch.config import load_config
    from depthg_tpu_torch.models import layers
    from depthg_tpu_torch.models import vit as vit_lib
    from depthg_tpu_torch.profile_serve import synthetic_jpeg
    from depthg_tpu_torch.train import losses as loss_lib
    from depthg_tpu_torch.train import step as step_lib
    from depthg_tpu_torch.utils.ckpt import export_lightning_ckpt

    out = {"card": card}
    fcfg = featurizer.FeaturizerConfig()  # vit_small, patch 8, dim 70
    model = inference.Segmenter(fcfg, 27, 27).init_weights(
        torch.Generator().manual_seed(0)).cuda()
    per_batch = 2 * len(model.net.model.blocks)

    # the eval step, bf16 and int8 in turns (bf16, int8, int8, bf16)
    steps = {d: inference.make_eval_step(inference.EvalConfig(
        n_classes=27, crf=crf.crf_config_from_cfg({}), backbone_dtype=d))
        for d in ("bfloat16", "int8")}
    img_s = {"bfloat16": [], "int8": []}
    int8_launches = int8_k4 = 0
    # the int8 step must run the ViT's cached int8 copy: count the forwards
    # of its first w8a8 linear (one per backbone forward)
    copy8 = vit_lib.int8_copy(model.net.model)
    if not all(isinstance(lin, layers.W8A8Linear) for blk in copy8.blocks
               for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2)):
        raise AssertionError("the int8 copy's block linears are not all W8A8Linear")
    w8a8_forwards = []
    hook = copy8.blocks[0].attn.qkv.register_forward_hook(
        lambda *_: w8a8_forwards.append(1))
    for d in ("bfloat16", "int8", "int8", "bfloat16"):
        batches = make_batches(gen, B, 4)
        _, rate, launches, k4 = run_eval_batches(steps[d], model, batches, att, bil)
        if launches != per_batch * 4 or k4:
            raise AssertionError(f"{d} eval: {launches} K1 launches in 4 batches, {k4} K4")
        img_s[d].append(rate)
        if d == "int8":
            int8_launches, int8_k4 = int8_launches + launches, int8_k4 + k4
    hook.remove()
    forwards = per_batch // len(copy8.blocks) * 8  # K1 launches once a block a forward
    if len(w8a8_forwards) != forwards or vit_lib.int8_copy(model.net.model) is not copy8:
        raise AssertionError(f"int8 eval: {len(w8a8_forwards)} forwards through the int8 "
                             f"copy's w8a8 linears in 8 batches, expected {forwards}")
    img = make_batches(gen, B, 1)[0][0]
    with torch.no_grad():
        f8, _ = featurizer.backbone_features(model.net, img, backbone_dtype="int8")
        f32, _ = featurizer.backbone_features(model.net, img)
    cos = float((f8 * f32).sum() / (f8.norm() * f32.norm()))
    if not cos > INT8_FEATURE_COSINE:
        raise AssertionError(f"int8 features' cosine to float32 {cos}")
    out["eval"] = {"batch": B, "res": 320, "img_per_s": img_s,
                   "k1_launches_per_batch": int8_launches / 8, "k4_launches": int8_k4,
                   "w8a8_forwards_per_batch": len(w8a8_forwards) / 8,
                   "feature_cosine_to_f32": cos}
    phase("int8_eval", **out["eval"])

    # one served batch in bucket 16
    ckpt = os.path.join(tmp, "int8_segmenter.ckpt")
    export_lightning_ckpt(ckpt, model.cpu().state_dict(), cfg={
        "model_type": "vit_small", "dino_patch_size": 8, "dim": 70, "n_classes": 27})
    svc = serve.build_service(load_config("serve_config.yml", [
        f"model_path={ckpt}", "backbone_dtype=int8"]), "cuda")
    try:
        arrs = [np.asarray(svc._transform(Image.open(io.BytesIO(synthetic_jpeg(
            700 + i, 480, 360))).convert("RGB")), np.float32) for i in range(16)]
        svc._predict_padded(arrs, 16)  # warm-up
        att.KERNEL.launches = bil.KERNEL.launches = 0
        t0 = time.perf_counter()
        lin, clu = svc._predict_padded(arrs, 16)
        serve_ms = (time.perf_counter() - t0) * 1e3
        launches, k4 = att.KERNEL.launches, bil.KERNEL.launches
        if (svc.ecfg.backbone_dtype != "int8" or launches != len(model.net.model.blocks)
                or k4 or len(lin) != 16 or lin[0].shape != (320, 320)):
            raise AssertionError(f"int8 service: {svc.ecfg.backbone_dtype}, {launches} K1 "
                                 f"launches, {k4} K4 launches")
    finally:
        svc.close()
    out["serve"] = {"bucket": 16, "k1_launches_per_batch": launches, "k4_launches": k4,
                    "host_ms": serve_ms}
    phase("int8_serve", **out["serve"])
    del svc, model
    torch.cuda.empty_cache()

    # five train steps at the train cell, bf16 and int8 in turns
    lcfg = loss_lib.CorrLossConfig(feature_samples=11, neg_samples=5, depth_sampling="fps",
                                   depth_feat_correlation_loss=True)
    w, sh = profile_train.DEPTH_FEAT_WEIGHT, profile_train.DEPTH_FEAT_SHIFT
    batch = profile_train.synthetic_batch(TRAIN_B, TRAIN_RES, 27, gen)
    runs = {}
    for d in ("bfloat16", "int8"):
        hp = step_lib.TrainHParams(n_classes=27, backbone_dtype=d)
        state = step_lib.init_state(fcfg, hp, torch.Generator().manual_seed(0), device="cuda")
        vit = [p.detach().clone() for p in state.model.net.model.parameters()]
        runs[d] = {"hp": hp, "state": state, "vit": vit, "ms": [], "logs": []}

    def probe_losses(run):
        fixed = torch.Generator(device="cuda").manual_seed(123)
        with torch.no_grad():
            logs = step_lib.loss_fn(run["state"].model, batch, run["hp"], lcfg, w, sh,
                                    generator=fixed)[1]
        return float(logs["loss/linear"] + logs["loss/cluster"])

    before = probe_losses(runs["int8"])
    att.KERNEL.launches = bil.KERNEL.launches = 0
    for d in ("bfloat16", "int8"):  # warm-up
        runs[d]["logs"].append(step_lib.train_step(runs[d]["state"], batch, runs[d]["hp"],
                                                   lcfg, w, sh, generator=gen))
    int8_launches = 0
    for d in ("bfloat16", "int8", "int8", "bfloat16"):
        run = runs[d]
        first = att.KERNEL.launches
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(TRAIN_STEPS):
            run["logs"].append(step_lib.train_step(run["state"], batch, run["hp"], lcfg, w, sh,
                                                   generator=gen))
        stop.record()
        torch.cuda.synchronize()
        run["ms"].append(start.elapsed_time(stop) / TRAIN_STEPS)
        if att.KERNEL.launches - first != per_batch * TRAIN_STEPS:
            raise AssertionError(f"{d} train: {att.KERNEL.launches - first} K1 launches "
                                 f"in {TRAIN_STEPS} steps")
        int8_launches += (att.KERNEL.launches - first) if d == "int8" else 0
    after = probe_losses(runs["int8"])
    train_k4 = bil.KERNEL.launches
    if train_k4 or not after < before:
        raise AssertionError(f"int8 train: {bil.KERNEL.launches} K4 launches, probe losses "
                             f"{before} -> {after}")
    for d, run in runs.items():
        for i, logs in enumerate(run["logs"]):
            if not all(bool(torch.isfinite(v).all()) for v in logs.values()):
                raise AssertionError(f"{d} train step {i}: non-finite logs")
        for p, old in zip(run["state"].model.net.model.parameters(), run["vit"]):
            if p.grad is not None or p.requires_grad or not torch.equal(p, old):
                raise AssertionError(f"{d} train: the frozen ViT changed")
    out["train"] = {"batch": TRAIN_B, "res": TRAIN_RES, "steps": 1 + 2 * TRAIN_STEPS,
                    "step_ms": {d: r["ms"] for d, r in runs.items()},
                    "k1_launches_per_step": int8_launches / (2 * TRAIN_STEPS),
                    "k4_launches": train_k4, "probe_losses_before": before,
                    "probe_losses_after": after,
                    "last_logs": {k: float(v) for k, v in runs["int8"]["logs"][-1].items()}}
    phase("int8_train", **out["train"])
    del runs, batch
    torch.cuda.empty_cache()

    # depth generation, int8, over phase 12's images; one batch of 8 at
    # 384 x 512 timed beside the bf16 model, in turns
    image_dir = os.path.join(tmp, "int8_depth_images", "val")
    os.makedirs(image_dir)
    for i, (w_, h_) in enumerate(DEPTH_IMAGES):
        with open(os.path.join(image_dir, f"img{i:02d}.jpg"), "wb") as f:
            f.write(synthetic_jpeg(400 + i, w_, h_))
    out["depth"] = {}
    for model_name, expect, with_bias in (("zoedepth", 48, True), ("midas", 24, False)):
        argv = ["--data_dir", os.path.dirname(image_dir), "--model", model_name,
                "--batch_size", "8", "--allow_random"]
        out_dir = os.path.join(tmp, f"int8_depth_{model_name}")
        att.KERNEL.launches = att.KERNEL.bias_launches = bil.KERNEL.launches = 0
        t0 = time.perf_counter()
        written = generate_depth.main(argv + ["--output_dir", out_dir, "--dtype", "int8"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, bias_launches = att.KERNEL.launches, att.KERNEL.bias_launches
        depth_k4 = bil.KERNEL.launches
        if (written != len(DEPTH_IMAGES) or launches != expect * DEPTH_BATCHES
                or bias_launches != (launches if with_bias else 0) or depth_k4):
            raise AssertionError(f"int8 {model_name}: {written} maps, {launches} K1 launches "
                                 f"({bias_launches} with a bias)")
        for name, (w_, h_) in zip(sorted(os.listdir(image_dir)), DEPTH_IMAGES):
            png = np.asarray(Image.open(os.path.join(out_dir, "val",
                                                     f"{name[:-4]}_{model_name}.png")))
            # MiDaS's seed-0 head ends below its ReLU: constant maps (phase 12)
            if png.dtype != np.uint8 or png.shape != (h_, w_) or (
                    model_name == "zoedepth" and png.min() == png.max()):
                raise AssertionError(f"int8 {model_name} {name}: PNG {png.dtype} {png.shape}")
        infers = {d: generate_depth.build(generate_depth.get_args_parser().parse_args(
            argv + ["--dtype", d]), torch.device("cuda"))[0] for d in ("bfloat16", "int8")}
        x = torch.rand(8, 3, 384, 512, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(5))
        xs = [x, x.flip(-1), 1 - x]
        ms = {"bfloat16": [], "int8": []}
        for d in ("bfloat16", "int8", "int8", "bfloat16"):
            ms[d].append(cuda_time_ms(lambda v: infers[d](v)[0], xs, iters=3, warmup=1))
        out["depth"][model_name] = {
            "images": written, "batches": DEPTH_BATCHES,
            "k1_launches_per_batch": launches / DEPTH_BATCHES,
            "k1_bias_launches_per_batch": bias_launches / DEPTH_BATCHES,
            "k4_launches": depth_k4,
            "main_seconds": seconds, "batch8_384x512_ms": ms}
        phase("int8_depth", model=model_name, **out["depth"][model_name])
        del infers, x, xs
        torch.cuda.empty_cache()

    # two steps of the CRF playground on a two-image Coco layout at 224 px
    base = os.path.join(tmp, "crf_data", "cocostuff")
    for sub in ("curated/val2017", "images/val2017", "annotations/val2017"):
        os.makedirs(os.path.join(base, sub))
    with open(os.path.join(base, "curated/val2017/Coco164kFull_Stuff_Coarse_7.txt"), "w") as f:
        f.write("v0\nv1")
    rng = np.random.default_rng(0)
    for name in ("v0", "v1"):
        with open(os.path.join(base, "images/val2017", name + ".jpg"), "wb") as f:
            f.write(synthetic_jpeg(800 + len(name), 320, 240))
        Image.fromarray(rng.integers(0, 182, (240, 320)).astype(np.uint8)).save(
            os.path.join(base, "annotations/val2017", name + ".png"))
    t0 = time.perf_counter()
    res = train_crf.main([f"data_dir={os.path.dirname(base)}", f"output_root={tmp}",
                          "image_set=val", "n_images=2", "epochs=2", "res=224",
                          "device=cuda"])
    if not (np.isfinite(res["loss"]) and len(os.listdir(res["out_dir"])) == 4):
        raise AssertionError(f"train_crf: {res}")
    out["train_crf"] = {"steps": res["steps"], "loss": res["loss"], "crf": res["crf"],
                        "seconds": time.perf_counter() - t0}
    phase("train_crf", **out["train_crf"])
    return out


# the bench (``python -m depthg_tpu_torch.bench``) at full size: seconds for
# the whole run and for each of its child phases; K1 launches per eval step
# by point (``safe`` runs the eager attention) and per train step by backbone
BENCH_TIMEOUT_S, BENCH_PHASE_TIMEOUT_S = 600, 300
BENCH_K1_PER_STEP = {"default": 24, "quality_plus": 24, "fast": 24, "safe": 0}
BENCH_TRAIN_K1_PER_STEP = {"bfloat16": 24, "float32": 24, "int8": 24}


def bench_phase(card):
    """Phase 20: the bench at full size in a process of its own (its phases
    in children of that process), its JSON line printed on its own line."""
    from depthg_tpu_torch import bench

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update({"PYTHONPATH": ROOT, "BENCH_PHASE_TIMEOUT_S": str(BENCH_PHASE_TIMEOUT_S)})
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "depthg_tpu_torch.bench"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"bench: rc {proc.returncode}, stdout {proc.stdout[-2000:]!r}, "
                             f"stderr {proc.stderr[-4000:]!r}")
    out = json.loads(lines[-1])
    print(json.dumps(out), flush=True)
    errors = sorted(k for k in out if k.endswith("_error") or k == "eval_fallback_reason")
    if out["value"] is None or out["operating_point"] != "default" or errors:
        raise AssertionError(f"bench: value {out['value']}, point {out.get('operating_point')}, "
                             f"errors {[(k, out[k]) for k in errors]}")
    if sorted(out["points_img_per_sec"]) != sorted(bench.EVAL_POINTS):
        raise AssertionError(f"bench measured {sorted(out['points_img_per_sec'])}")
    if out["k1_launches_per_step"] != BENCH_K1_PER_STEP:
        raise AssertionError(f"bench K1 launches per eval step {out['k1_launches_per_step']}, "
                             f"want {BENCH_K1_PER_STEP}")
    if out["train_k1_launches_per_step"] != BENCH_TRAIN_K1_PER_STEP:
        raise AssertionError(f"bench K1 launches per train step "
                             f"{out['train_k1_launches_per_step']}")
    if out["device"] != card:
        raise AssertionError(f"bench device {out['device']!r} (card {card!r})")
    phase("bench", seconds=seconds, value=out["value"], host_img_per_sec=out["host_img_per_sec"],
          points_img_per_sec=out["points_img_per_sec"],
          train_step_ms_b16=out["train_step_ms_b16"])
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.append(os.path.join(ROOT, "tests"))
    import depthg_tpu_torch
    import test_torch_poison as poison
    from depthg_tpu_torch import crf_fidelity_study as study
    from depthg_tpu_torch import inference, runtime
    from depthg_tpu_torch.models import featurizer
    from depthg_tpu_torch.models import vit as vit_lib
    from depthg_tpu_torch.ops import _build, crf
    from depthg_tpu_torch.ops import attention as att
    from depthg_tpu_torch.ops import crf_bilateral as bil
    from depthg_tpu_torch.ops import residual_norm as rn
    from depthg_tpu_torch.ops import swiglu as sw
    from depthg_tpu_torch.ops import zoe_bins as zb
    from depthg_tpu_torch.models.zoedepth import beit

    card = card_line()
    depthg_tpu_torch.get_device("cuda")
    if not runtime.tf32_off():
        raise AssertionError("TF32 is on")
    phase("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
          gpu=torch.cuda.get_device_name(0), tf32_off=True)

    t_build = time.perf_counter()
    _build.build(["attention", "crf_bilateral", "zoe_bins", "swiglu", "residual_norm"])
    att.KERNEL.fn()
    bil.KERNEL.fn()
    zb.KERNEL.fn()
    sw.KERNEL.fn()
    rn.KERNEL.fn()
    for name in ("attention", "crf_bilateral", "zoe_bins", "swiglu", "residual_norm"):
        phase("build", source=f"depthg_tpu_torch/csrc/{name}.cu",
              seconds=_build.BUILD_SECONDS[name],
              ptxas=[ln.strip() for ln in _build.BUILD_LOG.get(name, "").splitlines()
                     if "registers" in ln or "spill" in ln])
    phase("build_all", seconds=time.perf_counter() - t_build)

    int8_linear_phase()
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn = attention_phase(att, gen, runtime)
    attn_bias = attention_bias_phase(att, beit, gen)
    # MiDaS's DPT_Large at 384 x 512: ViT-L/16, 24 x 32 + 1 tokens, no bias
    midas = attention_at_shape(att, gen, torch.bfloat16, "bf16", MIDAS_B, BIAS_N,
                               "MiDaS batch", heads=BIAS_HEADS, profile=True)
    contract_rows = attention_contract_phase(att, poison, gen)
    k4 = bilateral_phase(bil, crf, study, runtime)
    crf_res = crf_phase(study, crf, bil)
    messages = int8_message_phase(bil)
    fidelity = fidelity_rows_phase(study, bil)
    main_res = main_path_phase(att, bil, inference, vit_lib, featurizer, crf, gen)
    train_res = train_path_phase(att, bil, inference, featurizer, gen)
    train_f32 = train_card_vs_cpu_phase(att, inference, featurizer)
    serve_shapes = attention_serving_shapes(att, gen)
    small_grids = attention_small_grids(serve_shapes, midas, attn["train_bf16"])
    with tempfile.TemporaryDirectory() as tmp:
        serve_res = serve_path_phase(att, bil, inference, featurizer, tmp)
        demo_res = demo_path_phase(att, bil, inference, serve_res["ckpt"], tmp)
        knn_res = knn_path_phase(att, bil, featurizer, runtime, gen, tmp)
        depth_res = depth_path_phase(att, bil, tmp)
    depth_numerics_phase(att)
    bins = bins_tail_phase(zb)
    gate = swiglu_gate_phase(sw)
    junction = residual_norm_phase(rn)
    dinov2_res = dinov2_path_phase(att, bil, sw, inference, crf)
    with tempfile.TemporaryDirectory() as tmp:
        ft_res = finetune_path_phase(att, bil, tmp)
    nk_res = nk_path_phase(att)
    with tempfile.TemporaryDirectory() as tmp:
        var_res = variants_path_phase(att, bil, inference, crf, gen, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        par_res = parallel_path_phase(att, bil, inference, featurizer, crf, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        int8_res = int8_path_phase(att, bil, inference, featurizer, crf, gen, tmp, card)
    bench_phase(card)

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
        # the bias's own cost (queued, minus the same call without it) and the
        # kernel alone by torch.profiler
        "bias_cost_ms": attn_bias["bf16_b8"]["bias_cost_ms"],
        "bias_kernel_profiler_ms": attn_bias["bf16_b8"]["kernel_profiler_ms"],
        "bias_max_abs_err": attn_bias["bf16_b8"]["max_abs_err"],
        "bias_rel_err": attn_bias["bf16_b8"]["rel_err"],
        "bias_cases": attn_bias,
        "midas_shape": {"shape": f"bf16, B=8, N={BIAS_N}, {BIAS_HEADS} heads x 64, packed qkv",
                        **{k: midas[k] for k in (
                            "max_abs_err", "rel_err", "ms", "kernel_only_ms",
                            "kernel_device_ms", "kernel_profiler_ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "library_device_ms",
                            "host_us_per_launch", "host_us_per_call",
                            "library_host_us_per_call", "grid")}},
        "small_grid_rows": small_grids,
        "poisoned_output_cases_passed": len(contract_rows),
        # float32 with the bias at NYU's 480 x 640 (the fine-tune's validation)
        "f32_bias_n1201_shape": "f32, B=1, N=1201, 16 heads x 64, packed qkv, bias "
                                "[16, 1201, 1201] f32 (a view of [16, 1201, 1208])",
        **{f"f32_bias_n1201_{k}": attn_bias["f32_b1_n1201"][k]
           for k in ("ms", "device_ms", "kernel_device_ms", "library_ms", "library_device_ms",
                     "plain_ms", "bound_ms", "bound_by", "max_abs_err", "rel_err",
                     "no_bias_device_ms", "bias_cost_ms", "kernel_profiler_ms",
                     "pack_profiler_ms")},
        "finetune_path_train_step_launches": max(ft_res["k1_launches_per_step"]),
        "finetune_path_validation_launches_per_image":
            ft_res["k1_f32_bias_launches_per_validation_image"],
        "nk_path_bias_launches_per_forward": nk_res["f32"]["k1_bias_launches"],
        "variants_path_launches_per_step": {
            name: r["k1_launches_per_step"] for name, r in var_res["steps"].items()},
        "variants_path_step_ms": {name: r["step_ms"] for name, r in var_res["steps"].items()},
        "dino_depth_eval_launches_per_step": var_res["eval_launches_per_step"],
        # the parallel paths: per step at world size 1 (NCCL), per rank of two
        # gloo ranks (float32 train step, eval step), per service replica
        "parallel_world1_launches_per_step": par_res["world1_launches_per_step"],
        "parallel_launches_per_rank_per_step": par_res["rank_launches_per_step"],
        "parallel_eval_launches_per_rank": par_res["eval_launches_per_rank"],
        "serve_launches_per_replica_per_batch": par_res["replica_launches_per_batch"],
        # the int8 (w8a8) backbone's paths (phase 19): K1 in bf16 behind the
        # int8 linears, per eval batch, served batch, train step, depth batch
        "int8_eval_launches_per_batch": int8_res["eval"]["k1_launches_per_batch"],
        "int8_serve_launches_per_batch": int8_res["serve"]["k1_launches_per_batch"],
        "int8_train_launches_per_step": int8_res["train"]["k1_launches_per_step"],
        "int8_zoedepth_bias_launches_per_batch":
            int8_res["depth"]["zoedepth"]["k1_bias_launches_per_batch"],
        "int8_midas_launches_per_batch": int8_res["depth"]["midas"]["k1_launches_per_batch"],
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
        "knn_path_launches": knn_res["k4_launches"],
        "variants_path_launches": var_res["k4_launches"],
        # the parallel paths at the default point (K4 runs at crf_downsample=1)
        "parallel_path_launches": sum(par_res["k4_launches"].values()),
        "parallel_path_launches_by_part": par_res["k4_launches"],
        "int8_path_launches": sum([int8_res["eval"]["k4_launches"],
                                   int8_res["serve"]["k4_launches"],
                                   int8_res["train"]["k4_launches"],
                                   *(r["k4_launches"] for r in int8_res["depth"].values())]),
        "shape": "bf16, B=2, N=102400, C=54 (the exact eval step's message); "
                 "n25600: B=2, C=54; degree: B=2, N=102400",
        "max_abs_err": k4_main["max_abs_err"], "rel_err": k4_main["rel_err"],
        "ms": k4_main["ms"], "plain_ms": k4_main["plain_ms"],
        "bound_ms": k4_main["bound_ms"], "bound_by": k4_main["bound_by"],
        "library_ms": None,
        "ex2_bound_ms": k4_main["ex2_bound_ms"],
        "algorithm_bound_ms": k4_main["algorithm_bound_ms"],
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
        "degree_bound_by": k4["n102400_degree_f32"]["degree_entry_bound_by"],
        "degree_algorithm_bound_ms":
            k4["n102400_degree_f32"]["degree_entry_algorithm_bound_ms"],
        "degree_kernel_profiler_ms": k4["n102400_degree_f32"]["degree_entry_kernel_profiler_ms"],
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
    }, {
        "name": "crf_cache_int8", "route": "cuda",
        "source": "depthg_tpu_torch/csrc/crf_bilateral.cu",
        "replaces": "none (XLA ops, depthg_tpu/ops/crf.py:820)",
        "launches": main_res["crf_cache_launches_per_batch"],
        "shape": f"B={crf_res['cache']['batch']}, N={crf_res['cache']['points']}, 5 features "
                 "(the default eval step's cache, 16 fidelity scenes)",
        "ms": crf_res["cache"]["kernel_ms"],
        "queued_ms": crf_res["cache"]["kernel_queued_ms"],
        "plain_ms": crf_res["cache"]["eager_ms"],
        "bound_ms": crf_res["cache"]["bound_ms"], "bound_by": crf_res["cache"]["bound_by"],
        "library_ms": None,
        "max_step_from_float64": crf_res["cache"]["max_step_from_float64"],
        "entries_off_float64": crf_res["cache"]["entries_off_float64"],
        "eager_entries_off_float64": crf_res["cache"]["eager_entries_off_float64"],
    }, {
        "name": "crf_int8_message", "route": "cuda",
        "source": "depthg_tpu_torch/csrc/crf_bilateral.cu",
        "replaces": "none (an XLA int8 product, depthg_tpu/ops/crf.py _cached_matmul)",
        "launches": main_res["crf_message_launches_per_batch"],
        "shape": "bf16, B=16, N=6400, C=54 (a message of the default eval step); c1: the "
                 "degree (C=1); n8100: 360 px",
        "ms": messages["b16_n6400_c54"]["ms"],
        "queued_ms": messages["b16_n6400_c54"]["queued_ms"],
        "quantize_profiler_ms": messages["b16_n6400_c54"]["quantize_profiler_ms"],
        "product_profiler_ms": messages["b16_n6400_c54"]["product_profiler_ms"],
        "plain_ms": messages["b16_n6400_c54"]["plain_ms"],
        "bound_ms": messages["b16_n6400_c54"]["bound_ms"],
        "bound_by": messages["b16_n6400_c54"]["bound_by"],
        "library_ms": messages["b16_n6400_c54"]["library_ms"],
        "library_queued_ms": messages["b16_n6400_c54"]["library_queued_ms"],
        "c1_queued_ms": messages["b16_n6400_c1"]["queued_ms"],
        "c1_library_queued_ms": messages["b16_n6400_c1"]["library_queued_ms"],
        "n8100_queued_ms": messages["b16_n8100_c54"]["queued_ms"],
        "n8100_bound_ms": messages["b16_n8100_c54"]["bound_ms"],
    }, {
        "name": "zoe_bins_tail", "route": "cuda",
        "source": "depthg_tpu_torch/csrc/zoe_bins.cu",
        "replaces": "none (XLA ops, depthg_tpu/models/zoedepth/heads.py and model.py)",
        "launches": depth_res["zoedepth"]["bins_tail_launches_per_batch"],
        "shape": "bf16, B=8, 384 x 512 (a pass of the depth cell's step)",
        "ms": bins["kernel_ms"], "queued_ms": bins["kernel_queued_ms"],
        "profiler_ms": bins["kernel_profiler_ms"], "plain_ms": bins["plain_ms"],
        "bound_ms": bins["bound_ms"], "bound_by": bins["bound_by"],
        "library_ms": None,
        "depth_p99_over_range": bins["depth_p99_over_range"],
        "depth_max_over_range": bins["depth_max_over_range"],
    }, {
        "name": "swiglu_gate", "route": "cuda",
        "source": "depthg_tpu_torch/csrc/swiglu.cu",
        "replaces": "none (the JAX package has no DINOv2)",
        # per step of the DINOv2 cell's eval step (one a block)
        "launches": dinov2_res["gate_launches_per_step"],
        "shape": f"bf16, [{SWIGLU_M}, {2 * SWIGLU_H}] (w12's output in the DINOv2 cell's step)",
        "ms": gate["kernel_ms"], "queued_ms": gate["kernel_queued_ms"],
        "profiler_ms": gate["kernel_profiler_ms"], "plain_ms": gate["library_ms"],
        "bound_ms": gate["bound_ms"], "bound_by": gate["bound_by"],
        "library_ms": gate["library_ms"],
        "elements_differing": gate["elements_differing"],
        "host_us_per_call": gate["host_us_per_call"],
        "dinov2_path_elements_differing": dinov2_res["gate_elements_differing"],
        "dinov2_path_img_per_s": dinov2_res["img_per_s"],
    }, {
        "name": "residual_norm", "route": "cuda",
        "source": "depthg_tpu_torch/csrc/residual_norm.cu",
        "replaces": "none (the JAX package leaves its blocks' element-wise work to XLA)",
        # per step of the DINOv2 cell's eval step (three a block, one final norm)
        "launches": dinov2_res["junction_launches_per_step"],
        "shape": f"bf16, [{RESIDUAL_DINOV2_ROWS}, 1536] (the DINOv2 cell's step), fused entry",
        "ms": junction["dinov2"]["fused"]["kernel_ms"],
        "queued_ms": junction["dinov2"]["fused"]["kernel_queued_ms"],
        "profiler_ms": junction["dinov2"]["fused"]["kernel_profiler_ms"],
        "plain_ms": junction["dinov2"]["fused"]["eager_ms"],
        "bound_ms": junction["dinov2"]["fused"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "elements_differing": junction["dinov2"]["sum_elements_differing"],
        "norm_elements_past_a_step": junction["dinov2"]["fused_norm_elements_past_a_step"],
        "host_us_per_call": {label: {entry: case[entry]["host_us_per_call"]
                                     for entry in ("fused", "residual", "norm")}
                             for label, case in junction.items()},
        "eager_host_us_per_call": {label: {entry: case[entry]["eager_host_us_per_call"]
                                           for entry in ("fused", "residual", "norm")}
                                   for label, case in junction.items()},
        # per batch or step of the paths that count them
        "main_path_launches_per_batch": main_res["junction_launches_per_batch"],
        "f32_eval_predict_launches": main_res["f32_junction_launches"],
        "train_path_launches_per_step": train_res["junction_launches_per_step"],
        "serve_path_launches_per_batch": serve_res["junction_launches_per_batch"],
        "knn_path_launches": knn_res["junction_launches"],
    }]}
    phase("total", seconds=time.perf_counter() - T0)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--int8-profile":
        sys.exit(int8_profile_worker(sys.argv[2]))
    if len(sys.argv) == 6 and sys.argv[1] in ("--parallel-worker", "--nccl-probe"):
        worker = parallel_worker if sys.argv[1] == "--parallel-worker" else nccl_probe
        sys.exit(worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
