"""The attention kernel's grid order, timed both ways on the card.

    python -m depthg_tpu_torch.attention_grid_study [--out FILE]

``csrc/attention.cu`` launches its grid as (query blocks, batch, heads)
(the bf16 kernel's one-dimensional grid decodes its blocks in that order):
the images of one head run together, so with BEiT's [H, N, N] logit bias a
wave of blocks shares a few heads' bias in L2. This script builds a second
library from the same source with the grid swapped to (query blocks, heads,
batch), the images' heads together, checks that both give the same bits,
and times both through ``attention_qkv`` at the shapes the port runs: BEiT-L
at ZoeDepth's 384 x 512 input (N=769, 16 heads) with and without the bias,
and the DINO ViT-S/8 of the eval and serve paths (N=1601, 6 heads). Each
time is the device ms per call of calls queued behind a long product, the
two orders alternating over 15 rounds; the median is reported.
Prints one JSON line per case and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

# (name, dtype, batch, tokens, heads, with a bias)
CASES = (
    ("beit_l_bf16_b8_bias", torch.bfloat16, 8, 769, 16, True),
    ("beit_l_bf16_b8", torch.bfloat16, 8, 769, 16, False),
    ("beit_l_bf16_b16_bias", torch.bfloat16, 16, 769, 16, True),
    ("beit_l_f32_b2_bias", torch.float32, 2, 769, 16, True),
    ("beit_l_f32_b2", torch.float32, 2, 769, 16, False),
    ("vit_s8_bf16_b2", torch.bfloat16, 2, 1601, 6, False),
    ("vit_s8_bf16_b16", torch.bfloat16, 16, 1601, 6, False),
    ("vit_s8_bf16_b32", torch.bfloat16, 32, 1601, 6, False),
)
ROUNDS = 15
# the source's grid order and the swapped one, as text
# (the float32 kernels' three-dimensional grid, the bf16 kernel's decode)
HEAD_MAJOR = ("h = blockIdx.z; b = blockIdx.y;", "dim3(q_blocks, batch, heads)",
              "b = bh % p.batch; h = bh / p.batch;")
IMAGE_MAJOR = ("h = blockIdx.y; b = blockIdx.z;", "dim3(q_blocks, heads, batch)",
               "h = bh % p.heads; b = bh / p.heads;")


def image_major_library():
    """Build ``csrc/attention.cu`` with the grid swapped; its entry point."""
    import ctypes

    from depthg_tpu_torch.ops import _build

    src = (_build.CSRC / "attention.cu").read_text()
    for old, new in zip(HEAD_MAJOR, IMAGE_MAJOR):
        if src.count(old) != 1:
            raise RuntimeError(f"attention.cu holds {old!r} {src.count(old)} times, not once")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "attention_image_major.cu"
    so = _build.BUILD_DIR / "libattention_image_major.so"
    cu.write_text(src)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _build.build(["attention"])  # the source's own library, meanwhile
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the image-major variant:\n{err}")
    return ctypes.CDLL(str(so)).depthg_attention_launch


def queued_ms(fn, iters: int) -> float:
    """Device ms per call of ``iters`` calls queued behind a long product."""
    busy = torch.empty(8192, 8192, device="cuda").normal_()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    busy @ busy
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="", help="also write the JSON lines here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_grid_study needs a CUDA card", file=sys.stderr)
        return 1
    from depthg_tpu_torch.models.zoedepth.beit import relative_position_bias
    from depthg_tpu_torch.ops import attention as att

    fns = att.KERNEL.fn()
    head_major = fns.fwd
    image_major = image_major_library()
    image_major.argtypes, image_major.restype = head_major.argtypes, head_major.restype
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn((2 * 24 - 1) ** 2 + 3, 16, device="cuda", generator=gen)
    lines = []
    for name, dtype, b, n, h, with_bias in CASES:
        qkv = torch.randn(b, n, 3 * 64 * h, device="cuda", generator=gen).to(dtype)
        bias = relative_position_bias(table.to(dtype), 24, 24, 32) if with_bias else None
        scale = 64 ** -0.5

        def call(fn):
            fns.fwd = fn
            return att.attention_qkv(qkv, h, scale, bias=bias)

        outs = [call(fn) for fn in (head_major, image_major)]
        torch.cuda.synchronize()
        if not torch.equal(*outs):
            raise AssertionError(f"{name}: the two grid orders give different outputs")
        iters = 10 if dtype == torch.float32 else 50
        times = {"head_major": [], "image_major": []}
        for r in range(ROUNDS):
            order = (("head_major", head_major), ("image_major", image_major))
            for key, fn in (order if r % 2 == 0 else order[::-1]):
                times[key].append(queued_ms(lambda fn=fn: call(fn), iters))
        fns.fwd = head_major
        med = {k: statistics.median(v) for k, v in times.items()}
        line = {"case": name, "dtype": str(dtype), "shape": [b, n, h, 64],
                "bias": list(bias.shape) if with_bias else None,
                "head_major_ms": med["head_major"], "image_major_ms": med["image_major"],
                "image_major_over_head_major": med["image_major"] / med["head_major"],
                "rounds_ms": times, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del qkv, bias, outs
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
