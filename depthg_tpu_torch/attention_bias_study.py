"""Where the attention kernel's bias path spends its time, on the card.

    python -m depthg_tpu_torch.attention_bias_study [--source FILE] [--out FILE]

Builds variants of ``csrc/attention.cu`` (or ``--source``, e.g. an older
tree's copy) with parts of the loop compiled out, and times each at the
two shapes the depth paths run K1 with BEiT-L's relative-position bias:
bf16 B=8, N=769 (a ZoeDepth batch at 384 x 512) and float32 B=1, N=1201
(one fine-tune validation image at 480 x 640), 16 heads of 64. Variants:

* ``as_is``: the source unchanged (also timed without the bias);
* ``no_bias_reads``: the bias fragment is 0 (its reads compiled out), the
  products still accumulate onto it;
* ``no_softmax``: P is S rounded, no mask, max, exponentials or sums;
* ``no_products``: the ``wgmma`` instructions compiled out;
* ``loads_only``: neither products nor softmax: the loads, barriers and
  stores alone;
* ``bias_one_tile`` (a source whose bias comes through its ring of
  tiles): every step's bias tile is the head's first, so the bias's own
  L2 and memory traffic is gone;
* ``tail_only``: only the last query block of every (image, head), the
  one that holds the rows past the last full block.

The variants' outputs are wrong by design: only their times are read.
Each time is the device ms per call of calls queued behind a long product,
the variants in turns over ``--rounds`` rounds, the median reported.

``--depth OTHER.cu`` instead times what the kernel moves end to end: the
package's library and one built from ``OTHER.cu`` (an older tree's
``attention.cu``) in turns, under one full-width ZoeDepth with random
weights from seed 0 and the same inputs: ``zoedepth_infer`` on a bf16
batch of 8 at 384 x 512 (48 launches with the bias) and the float32
forward of one 480 x 640 image as the fine-tune's validation runs it (24
launches at N=1201); CUDA events around 5 calls, after a warm-up, over
``--rounds`` rounds.
Prints one JSON line per case and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

# (name, dtype, batch, patch grid): N = h w + 1 tokens
CASES = (("bf16_b8_n769", torch.bfloat16, 8, (24, 32)),
         ("f32_b1_n1201", torch.float32, 1, (30, 40)))
HEADS = 16

# Each variant is a list of edits; an edit is (old, new) text, or
# (start, end, new) to replace a span from start up to and including end.
# An edit whose anchor is missing from the source is skipped; a variant none
# of whose edits applies is not built.
_NO_PRODUCT = [(f'"wgmma.mma_async.sync.aligned.{shape} "', '"// "')
               for shape in ("m64n128k16.f32.bf16.bf16", "m64n64k16.f32.bf16.bf16",
                             "m64n16k16.f32.bf16.bf16", "m64n64k8.f32.tf32.tf32")]
_NO_SOFTMAX = [
    ("      float mx[2] = {m_i[u][0], m_i[u][1]};",
     "        pa[c >> 1][(c & 1) * 2 + 1] = pack_bf16(p2, p3);\n      }\n",
     "      float alpha[2] = {1.f, 1.f}, rs[2] = {0.f, 0.f};\n"
     "#pragma unroll\n"
     "      for (int c = 0; c < 16; ++c) {\n"
     "        pa[c >> 1][(c & 1) * 2] = pack_bf16(s[4 * c], s[4 * c + 1]);\n"
     "        pa[c >> 1][(c & 1) * 2 + 1] = pack_bf16(s[4 * c + 2], s[4 * c + 3]);\n"
     "      }\n"),
    # the bf16 softmax as a function of the live chunks NC
    ("  float mx[2] = {m[0], m[1]};",
     "    pa[c >> 1][(c & 1) * 2 + 1] = pack_bf16(p2, p3);\n  }\n",
     "  float rs[2] = {0.f, 0.f};\n"
     "  alpha[0] = alpha[1] = 1.f;\n"
     "#pragma unroll\n"
     "  for (int c = 0; c < NC; ++c) {\n"
     "    pa[c >> 1][(c & 1) * 2] = pack_bf16(s[4 * c], s[4 * c + 1]);\n"
     "    pa[c >> 1][(c & 1) * 2 + 1] = pack_bf16(s[4 * c + 2], s[4 * c + 3]);\n"
     "  }\n"),
    ("    float mx[2] = {m_i[0], m_i[1]};",
     "      split_tf32(p3, ph_[c][3], pl_[c][3]);\n    }\n",
     "    float alpha[2] = {1.f, 1.f}, rs[2] = {0.f, 0.f};\n"
     "    uint32_t ph_[8][4], pl_[8][4];\n"
     "#pragma unroll\n"
     "    for (int c = 0; c < 8; ++c) {\n"
     "      split_tf32(s[4 * c], ph_[c][0], pl_[c][0]);\n"
     "      split_tf32(s[4 * c + 2], ph_[c][1], pl_[c][1]);\n"
     "      split_tf32(s[4 * c + 1], ph_[c][2], pl_[c][2]);\n"
     "      split_tf32(s[4 * c + 3], ph_[c][3], pl_[c][3]);\n"
     "    }\n"),
]
VARIANTS = {
    "as_is": [],
    "no_bias_reads": [
        # the per-thread global loads of the first design
        ("      s[4 * c + 2 * r] = x.x;\n      s[4 * c + 2 * r + 1] = x.y;",
         "      s[4 * c + 2 * r] = 0.f;\n      s[4 * c + 2 * r + 1] = 0.f;"),
        # the shared-memory reads of the staged design
        ("      s[4 * c + 2 * r] = x.x, s[4 * c + 2 * r + 1] = x.y;",
         "      s[4 * c + 2 * r] = 0.f, s[4 * c + 2 * r + 1] = 0.f;"),
        ('"ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\\n"', '"// \\n"'),
    ],
    "no_softmax": _NO_SOFTMAX,
    "no_products": _NO_PRODUCT,
    "loads_only": _NO_SOFTMAX + _NO_PRODUCT,
    "bias_one_tile": [
        # every step's bias from one tile of its head, which stays in L2: what
        # the bias's own traffic costs, the most that sharing tiles between
        # images could save
        ("ring.load(&map_b, seq, q0 + (NCW * u + cw) * 64, kt * WK, h);",
         "ring.load(&map_b, seq, 0, 0, h);"),
        ("ring.load(&map_b, seq, q0 + cw * 64, kt * F_BK, h);",
         "ring.load(&map_b, seq, 0, 0, h);"),
    ],
    "tail_only": [
        # bf16: one block per (image, head), the last of the one-dimensional grid's
        ("  int i = blockIdx.x, per = p.big, base = 0;",
         "  int i = p.small ? p.big * p.batch * p.heads + (blockIdx.x + 1) * p.small - 1\n"
         "                  : (blockIdx.x + 1) * p.big - 1;\n"
         "  int per = p.big, base = 0;"),
        ("<<<(plan.big + plan.small) * plan.batch * plan.heads,", "<<<plan.batch * plan.heads,"),
        ("  const int q0 = blockIdx.x * F_BQ;",
         "  const int q0 = (blockIdx.x + (n - 1) / F_BQ) * F_BQ;"),
        ("grid_of((n + F_BQ - 1) / F_BQ, batch, heads)", "grid_of(1, batch, heads)"),
    ],
}


def variant_source(src: str, edits) -> str:
    applied = 0
    for edit in edits:
        if len(edit) == 2:
            old, new = edit
            if old in src:
                src, applied = src.replace(old, new), applied + src.count(old)
        else:
            start, end, new = edit
            while start in src:
                i = src.index(start)
                j = src.index(end, i) + len(end)
                src, applied = src[:i] + new + src[j:], applied + 1
    if edits and not applied:
        return None
    return src


def build_variants(source: Path) -> dict:
    """Compile every variant, one nvcc each, all at once; their entry points."""
    from depthg_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "bias_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = source.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = variant_source(src, edits)
        if text is None:  # no anchor of this variant in the source
            continue
        cu, so = out_dir / f"attention_{name}.cu", out_dir / f"libattention_{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                         str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err}")
        fns[name] = ctypes.CDLL(str(so)).depthg_attention_launch
    return fns


def build_other(source: Path, subdir: str):
    """(entry, ptxas report): ``source`` (another tree's ``attention.cu``)
    compiled with the package's flags into ``build/.../<subdir>/``; the
    entry takes the package's arguments."""
    from depthg_tpu_torch.ops import _build
    from depthg_tpu_torch.ops import attention as att

    so = _build.BUILD_DIR / subdir / "libattention_other.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    fwd = att.KERNEL.fn().fwd
    entry = ctypes.CDLL(str(so)).depthg_attention_launch
    entry.argtypes, entry.restype = fwd.argtypes, fwd.restype
    return entry, proc.stderr


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


def depth_ab(other: Path, rounds: int, card: str) -> list:
    """ms per ZoeDepth call with the package's kernel and with ``other``'s,
    in turns (see the module's docstring)."""
    from depthg_tpu_torch.generate_depth import to_dtype
    from depthg_tpu_torch.models.zoedepth import ZoeConfig, ZoeDepth, zoedepth_infer
    from depthg_tpu_torch.ops import attention as att

    fns = att.KERNEL.fn()
    libs = {"package": fns.fwd, "other": build_other(other, "bias_study")[0]}
    with torch.device("cuda"):
        model = ZoeDepth(ZoeConfig()).init_weights(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(5)
    x8 = torch.rand(8, 3, 384, 512, device="cuda", generator=gen)
    x1 = torch.rand(1, 3, 480, 640, device="cuda", generator=gen)
    lines = []
    for name, dtype in (("zoedepth_bf16_b8_384x512", "bfloat16"),
                        ("validation_f32_b1_480x640", "float32")):
        net = to_dtype(copy.deepcopy(model), dtype).eval()
        if dtype == "bfloat16":
            def fn(net=net):
                return zoedepth_infer(net, x8.bfloat16(), attn_impl="auto")
        else:
            def fn(net=net):
                return net(x1, attn_impl="auto")["metric_depth"]
        times = {lib: [] for lib in libs}
        outs = {}
        with torch.inference_mode():
            for r in range(rounds):
                order = list(libs.items())
                for lib, entry in (order if r % 2 == 0 else order[::-1]):
                    fns.fwd = entry
                    outs[lib] = fn()
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(5):
                        fn()
                    stop.record()
                    torch.cuda.synchronize()
                    times[lib].append(start.elapsed_time(stop) / 5)
        fns.fwd = libs["package"]
        del net
        torch.cuda.empty_cache()
        line = {"case": name, "other": str(other), "rounds_ms": times,
                "median_ms": {lib: statistics.median(t) for lib, t in times.items()},
                "same_output": bool(torch.equal(outs["package"], outs["other"])), "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--source", default="", help="the .cu file to vary (default: the package's)")
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--out", default="", help="also write the JSON lines here")
    p.add_argument("--depth", default="",
                   help="an older attention.cu: time ZoeDepth with its kernel and the package's")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_bias_study needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    if args.depth:
        lines = depth_ab(Path(args.depth), args.rounds, card)
        if args.out:
            with open(args.out, "w") as f:
                f.writelines(json.dumps(line) + "\n" for line in lines)
        print(card)
        return 0
    from depthg_tpu_torch.models.zoedepth.beit import relative_position_bias
    from depthg_tpu_torch.ops import _build
    from depthg_tpu_torch.ops import attention as att

    source = Path(args.source) if args.source else _build.CSRC / "attention.cu"
    fns = att.KERNEL.fn()
    own = fns.fwd
    variants = build_variants(source)
    for fn in variants.values():
        fn.argtypes, fn.restype = own.argtypes, own.restype
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn((2 * 24 - 1) ** 2 + 3, HEADS, device="cuda", generator=gen)
    lines = []
    for case, dtype, b, grid in CASES:
        n = grid[0] * grid[1] + 1
        qkv = torch.randn(b, n, 3 * 64 * HEADS, device="cuda", generator=gen).to(dtype)
        bias = relative_position_bias(table.to(dtype), 24, *grid)
        q, k, v = att.split_qkv(qkv, HEADS)
        out = torch.empty(b, n, HEADS, 64, device="cuda", dtype=dtype).permute(0, 2, 1, 3)
        scale = 64 ** -0.5

        def call(fn, with_bias=True):
            fns.fwd = fn
            att._launch(q, k, v, out, scale, n, bias if with_bias else None)

        # the source as it is against the plain version (its variants are wrong by design)
        call(variants["as_is"])
        ref = att.attention_plain(q, k, v, scale, n, bias)
        diff = out.float() - ref.float()
        errors = {"max_abs_err": diff.abs().max().item(),
                  "rel_err": (diff.norm() / ref.float().norm()).item()}
        runs = {name: (fn, True) for name, fn in variants.items()}
        runs["as_is_without_bias"] = (variants["as_is"], False)
        for fn, with_bias in runs.values():
            call(fn, with_bias)
        torch.cuda.synchronize()
        iters = 20 if dtype == torch.float32 else 50
        times = {name: [] for name in runs}
        for r in range(args.rounds):
            order = list(runs.items())
            for name, (fn, with_bias) in (order if r % 2 == 0 else order[::-1]):
                times[name].append(queued_ms(lambda: call(fn, with_bias), iters))
        fns.fwd = own
        line = {"case": case, "shape": [b, n, HEADS, 64], "bias": [HEADS, n, n, str(bias.dtype)],
                "source": str(source),
                "source_sha256": hashlib.sha256(source.read_bytes()).hexdigest()[:16],
                "as_is_vs_plain": errors,
                "median_ms": {name: statistics.median(t) for name, t in times.items()},
                "rounds_ms": times, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del qkv, bias, q, k, v, out, ref, diff
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
