"""The attention kernel against another tree's, and against its contract, on the card.

    python -m depthg_tpu_torch.attention_contract_study --other-tree DIR [--rounds 5]
        [--sections shapes,plans,host,contract,variants] [--out FILE]

Run from the repository's root. ``DIR`` is another checkout (e.g. the parent
commit unpacked with ``git archive`` under ``build/``): its
``ops/attention.py`` is loaded as a module of its own and bound to a library
built from its ``csrc/attention.cu`` with the package's flags, so each tree
runs its own wrapper and C entry, whatever their arguments. On the same
inputs:

* ``shapes``: at every shape at which ``chip_smoke.py`` holds K1 to its
  plain version (``chip_smoke.k1_shapes``: the eval, padded eval, train,
  serving, KNN, MiDaS and BEiT-L bias shapes, the bias kernel's edges),
  whether the two outputs are equal bit for bit, the device ms per call of
  each, queued behind a long product, the two in turns (package, other,
  other, package, ...) over ``--rounds`` rounds after ~2 s of warm-up (the
  median of each, and the mean over rounds of the ratio within a round),
  and the host us per call of each tree's ``_launch`` (a preallocated
  output) and ``attention_qkv``, in turns too; the package's grid
  (``block_plan``) beside;
* ``plans``: at the small-grid table's shapes (``PLAN_SHAPES``, bf16
  without a bias), the package's kernel at every choice of its grid (256-row
  blocks per (image, head) from ceil(N / 256) down to 0): queued ms in
  turns, the same bits as the plan's choice, and ``block_plan``'s model of
  each (the finish time in units of a 256-row block);
* ``host``: where a launch's host time goes at ``HOST_SHAPES``: each part
  of the wrapper timed alone (the torch calls the other tree's wrapper
  makes, its ctypes entry with a prebuilt argument list where it takes the
  28 separate arguments of the parent; the package's packing, plan, stream
  and entry), and a tensor-map encode through ctypes;
* ``variants`` (only when named): the package's kernel against text edits
  of its own source that each change one tail measure of the bias-free
  kernel (``VARIANTS``), at ``VARIANT_SHAPES``;
* ``contract``: each kernel at the cases of fault F6 (``F6_CASES``: rows <
  N in a 256-row block's second round of sub-tiles that holds no row <
  n_valid), both dtypes, with and without a bias, its output written into
  memory that held NaN: rows >= n_valid exactly 0, the others within
  ``TOL`` of ``attention_plain``, no NaN (``tests/test_torch_poison.py``'s
  ``k1_contract``, the card tests' own check);
* always: the registers and spills of every kernel of both builds.

Prints one JSON line per case and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (B, N, heads): the serving buckets' N=1601 at B=1-8, MiDaS, the eval
# step, B=32 and the train step; B=1 at N=1536 has only whole blocks
PLAN_SHAPES = ((1, 1601, 6), (2, 1601, 6), (4, 1601, 6), (8, 1601, 6), (8, 769, 16),
               (16, 1601, 6), (32, 1601, 6), (32, 785, 6), (1, 1536, 6))
HOST_SHAPES = ((8, 769, 16), (32, 785, 6), (1, 1601, 6))
HOST_REPS = 200
# Text edits of the package's csrc/attention.cu, each still a correct kernel,
# that change a tail measure of the bias-free bf16 kernel: without the one
# warpgroup on a block whose rows past its first 64 are all >= n_valid;
# with the narrow last key tile (and the one warpgroup decided per block) as
# the bias kernels have them; the same with S zeroed before a narrow
# product that then accumulates, as a bias fragment starts it
_NARROW = [("  if constexpr (BIAS != 0) {", "  if constexpr (true) {")]
_LOOP = "  for (int ks = 0; ks < 4; ++ks) {\n    const uint64_t desc = smem_desc(s_tile) + 2 * ks;"
_ZEROED = [("    const int accumulate = BIAS || ks > 0;", "    const int accumulate = 1;"),
           (_LOOP, "#pragma unroll\n  for (int i = 0; i < 64; ++i)\n"
                   "    if (!BIAS && i < 4 * nc) s[i] = 0.f;\n" + _LOOP)]
VARIANTS = {"no_alone": [("    if (has_alone_block(plan, n_valid))", "    if (false)")],
            "narrow": _NARROW, "narrow_zeroed": _NARROW + _ZEROED}
VARIANT_SHAPES = ((1, 1536, 6), (1, 1601, 6), (16, 1601, 6), (8, 769, 16), (32, 785, 6))


def ptxas_report(log: str) -> dict:
    """{kernel: its "Used ... registers" line and its spill line} of a ptxas -v log."""
    report, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("spill" in line or "Used" in line):
            report.setdefault(name, []).append(line.strip())
    return report


def build_sources(sources: dict, subdir: str) -> dict:
    """{name: (library, ptxas log)}: each source text compiled with the
    package's flags into ``build/.../<subdir>/``, one nvcc each, all at once."""
    from depthg_tpu_torch.ops import _build

    out = _build.BUILD_DIR / subdir
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = out / f"attention_{name}.cu", out / f"libattention_{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                         str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        libs[name] = (ctypes.CDLL(str(so)), err)
    return libs


def tree_attention(tree: Path, lib):
    """``tree``'s ``ops/attention.py`` as a module of its own, its ``KERNEL``
    bound to ``lib`` (built from ``tree``'s ``csrc/attention.cu``)."""
    path = tree / "depthg_tpu_torch" / "ops" / "attention.py"  # the port's wrapper there
    mod = types.ModuleType(f"attention_of_{tree.name}")
    mod.__file__ = str(path)
    exec(compile(path.read_text(), str(path), "exec"), mod.__dict__)
    mod._build = types.SimpleNamespace(load=lambda name: lib)  # read by its KERNEL.fn()
    return mod


def host_us(fn, reps: int = HOST_REPS) -> float:
    """Host us per call of ``fn`` over ``reps`` calls (what they enqueue is
    waited for afterwards, outside the time)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def inputs(b, n, heads, dtype, gen, bias_dtype=None):
    from test_torch_poison import padded_bias

    qkv = torch.randn(b, n, 3 * 64 * heads, device="cuda", generator=gen).to(dtype)
    bias = None if bias_dtype is None else padded_bias(heads, n, bias_dtype, gen)
    out = torch.empty(b, n, heads, 64, device="cuda", dtype=dtype).permute(0, 2, 1, 3)
    return qkv, bias, out


def shapes_section(mods, gen, rounds, card):
    from chip_smoke import k1_shapes

    from depthg_tpu_torch.attention_bias_study import queued_ms
    from depthg_tpu_torch.ops import attention as att

    lines = []
    for name, dtype, b, n, nv, heads, bias_dtype in k1_shapes():
        qkv, bias, out = inputs(b, n, heads, dtype, gen, bias_dtype)
        q, k, v = att.split_qkv(qkv, heads)
        outs = {}
        for lib, mod in mods.items():
            out.fill_(float("nan"))  # a row left unwritten is never equal
            mod._launch(q, k, v, out, 64 ** -0.5, nv, bias)
            outs[lib] = out.clone()
        iters = 10 if dtype == torch.float32 and b * n > 50_000 else 40
        times = {lib: [] for lib in mods}
        launch_us = {lib: [] for lib in mods}
        call_us = {lib: [] for lib in mods}
        reps = 20 if iters == 10 else HOST_REPS
        for r in range(rounds):
            for lib in (("package", "other") if r % 2 == 0 else ("other", "package")):
                mod = mods[lib]
                times[lib].append(queued_ms(
                    lambda mod=mod: mod._launch(q, k, v, out, 64 ** -0.5, nv, bias), iters))
                launch_us[lib].append(host_us(
                    lambda mod=mod: mod._launch(q, k, v, out, 64 ** -0.5, nv, bias), reps))
                call_us[lib].append(host_us(
                    lambda mod=mod: mod.attention_qkv(qkv, heads, 64 ** -0.5, nv, bias), reps))
        med = {lib: statistics.median(t) for lib, t in times.items()}
        big = (att.block_plan(b, heads, n, nv) if dtype == torch.bfloat16 and bias is None
               else -(-n // att.BLOCK_ROWS))
        line = {"case": name, "dtype": str(dtype), "shape": [b, n, heads, 64], "n_valid": nv,
                "bias": None if bias is None else str(bias_dtype),
                "grid": None if dtype == torch.float32 else
                {"big_blocks": big, "blocks": len(att.plan_blocks(b, heads, n, big))},
                "same_bits": bool(torch.equal(outs["package"], outs["other"])),
                "median_ms": med, "package_over_other": med["package"] / med["other"],
                "paired_ratio_mean": statistics.mean(
                    p / o for p, o in zip(times["package"], times["other"])),
                "host_us_per_launch": {lib: statistics.median(t) for lib, t in launch_us.items()},
                "host_us_per_call": {lib: statistics.median(t) for lib, t in call_us.items()},
                "rounds_ms": times, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del qkv, bias, out, q, k, v, outs
        torch.cuda.empty_cache()
    return lines


@contextlib.contextmanager
def forced_grid(att, big):
    """``att``'s bias-free bf16 launches take ``big`` 256-row blocks per
    (image, head), whatever ``block_plan`` would choose."""
    plan = att.block_plan
    att.block_plan = lambda *args, **kwargs: big
    try:
        yield
    finally:
        att.block_plan = plan


def plans_section(gen, rounds, card):
    from depthg_tpu_torch.attention_bias_study import queued_ms
    from depthg_tpu_torch.ops import attention as att

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lines = []
    for b, n, heads in PLAN_SHAPES:
        qkv, _, out = inputs(b, n, heads, torch.bfloat16, gen)
        q, k, v = att.split_qkv(qkv, heads)
        choices = list(range(-(-n // att.BLOCK_ROWS), -1, -1))
        chosen = att.block_plan(b, heads, n, n, sms)
        att._launch(q, k, v, out, 64 ** -0.5, n)
        ref = out.clone()
        same = {}
        for big in choices:
            out.fill_(float("nan"))
            with forced_grid(att, big):
                att._launch(q, k, v, out, 64 ** -0.5, n)
            same[big] = bool(torch.equal(out, ref))
        times = {big: [] for big in choices}
        for r in range(rounds):
            for big in (choices if r % 2 == 0 else choices[::-1]):
                with forced_grid(att, big):
                    times[big].append(queued_ms(
                        lambda: att._launch(q, k, v, out, 64 ** -0.5, n), 40))
        med = {big: statistics.median(t) for big, t in times.items()}
        line = {"plans": [b, n, heads, 64], "chosen_big_blocks": chosen,
                "fastest_big_blocks": min(med, key=med.get),
                "candidates": [{"big_blocks": big,
                                "blocks": len(att.plan_blocks(b, heads, n, big)),
                                "median_ms": med[big], "same_bits_as_chosen": same[big],
                                "model_units": att.plan_finish(b, heads, n, n, big, sms)}
                               for big in choices],
                "rounds_ms": {str(k): v for k, v in times.items()}, "sms": sms, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del qkv, out, q, k, v, ref
        torch.cuda.empty_cache()
    return lines


def variants_section(variants, gen, rounds, card):
    """The package's kernel and its ``VARIANTS`` at ``VARIANT_SHAPES`` (bf16,
    no bias, the grid ``block_plan`` chooses), queued ms in turns, and whether
    each variant gives the package's bits."""
    from depthg_tpu_torch.attention_bias_study import queued_ms
    from depthg_tpu_torch.ops import attention as att

    fns = att.KERNEL.fn()
    entries = {"package": fns.fwd}
    for name, lib in variants.items():
        entries[name] = lib.depthg_attention_launch
        entries[name].argtypes, entries[name].restype = fns.fwd.argtypes, fns.fwd.restype
    lines = []
    for b, n, heads in VARIANT_SHAPES:
        qkv, _, out = inputs(b, n, heads, torch.bfloat16, gen)
        q, k, v = att.split_qkv(qkv, heads)
        outs = {}
        for name, entry in entries.items():
            fns.fwd = entry
            out.fill_(float("nan"))
            att._launch(q, k, v, out, 64 ** -0.5, n)
            outs[name] = out.clone()
        times = {name: [] for name in entries}
        order = list(entries.items())
        for r in range(rounds):
            for name, entry in (order if r % 2 == 0 else order[::-1]):
                fns.fwd = entry
                times[name].append(queued_ms(
                    lambda: att._launch(q, k, v, out, 64 ** -0.5, n), 40))
        fns.fwd = entries["package"]
        line = {"variants": [b, n, heads, 64],
                "median_ms": {name: statistics.median(t) for name, t in times.items()},
                "same_bits": {name: bool(torch.equal(o, outs["package"]))
                              for name, o in outs.items()},
                "rounds_ms": times, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del qkv, out, q, k, v, outs
        torch.cuda.empty_cache()
    return lines


def encode_us(q, b, heads, nv) -> float | None:
    """Host us of one ``cuTensorMapEncodeTiled`` of q's map, called through
    ctypes from Python (the call's own ctypes cost included)."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    fn = lib.cuTensorMapEncodeTiled
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, u32, ctypes.c_void_p, ctypes.POINTER(u64),
                    ctypes.POINTER(u64), ctypes.POINTER(u32), ctypes.POINTER(u32)]
                   + [ctypes.c_int] * 4)
    st = q.stride()
    dims = (u64 * 4)(64, nv, heads, b)
    strides = (u64 * 3)(st[2] * 2, st[1] * 2, st[0] * 2)
    box, elem = (u32 * 4)(64, 64, 1, 1), (u32 * 4)(1, 1, 1, 1)
    tmap = ctypes.create_string_buffer(192)
    addr = (ctypes.addressof(tmap) + 63) // 64 * 64  # CUtensorMap is 64-byte aligned
    args = (addr, 9, 4, q.data_ptr(), dims, strides, box, elem,
            0, 3, 2, 0)  # bf16, rank 4, no interleave, 128-byte swizzle, L2 128 B, no fill
    if fn(*args) != 0:
        return None
    return host_us(lambda: fn(*args), 2000)


def host_section(mods, gen, card):
    from depthg_tpu_torch.ops import attention as att

    lines = []
    dev = torch.cuda.current_device()
    for b, n, heads in HOST_SHAPES:
        qkv, _, out = inputs(b, n, heads, torch.bfloat16, gen)
        q, k, v = att.split_qkv(qkv, heads)
        scale = 64 ** -0.5
        parts = {}
        for lib, mod in mods.items():
            parts[f"{lib}.attention_qkv"] = host_us(lambda mod=mod: mod.attention_qkv(
                qkv, heads, scale))
            parts[f"{lib}._launch"] = host_us(lambda mod=mod: mod._launch(q, k, v, out, scale, n))
        other = mods["other"]
        ofns = other.KERNEL.fn()
        if len(getattr(ofns.fwd, "argtypes", None) or ()) == 28:
            # the parent's entry: 28 arguments, three maps encoded and the
            # shared-memory attribute set on every launch
            stream = torch.cuda.current_stream().cuda_stream
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *q.stride()[:3],
                    *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], None, 0, 0, 0, b, heads,
                    n, n, scale, 1, None, stream)
            parts["other.entry_28_arguments"] = host_us(lambda: ofns.fwd(*args))
        parts["split_qkv_and_check"] = host_us(
            lambda: att._check(*att.split_qkv(qkv, heads), None))
        parts["empty_workspace_0_bytes"] = host_us(
            lambda: torch.empty(0, dtype=torch.uint8, device=qkv.device))
        parts["empty_output"] = host_us(
            lambda: torch.empty(b, n, heads * 64, dtype=qkv.dtype, device=qkv.device))

        def device_context():
            with torch.cuda.device(qkv.device):
                return torch.cuda.current_stream(qkv.device).cuda_stream

        parts["device_context_and_current_stream"] = host_us(device_context)
        parts["current_stream"] = host_us(lambda: torch.cuda.current_stream(dev).cuda_stream)
        parts["raw_stream"] = host_us(lambda: torch._C._cuda_getCurrentRawStream(dev))
        parts["operand_checks_4"] = host_us(lambda: [att._check_operand(
            "q", t.data_ptr(), t.stride(), 2) for t in (q, k, v, out)])
        parts["block_plan_cached"] = host_us(lambda: att.block_plan(b, heads, n, n, 132))
        fns = att.KERNEL.fn()
        packed = att.ARGS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0, 0,
                               torch._C._cuda_getCurrentRawStream(dev), *q.stride()[:3],
                               *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], 0, 0, 0, b,
                               heads, n, n, 1, dev, att.block_plan(b, heads, n, n), scale)
        parts["package.pack_arguments"] = host_us(lambda: att.ARGS.pack(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0, 0, 0, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], 0, 0, 0, b, heads, n, n, 1, dev,
            1, scale))
        parts["package.entry_packed"] = host_us(lambda: fns.fwd(packed))
        parts["ctypes_call_4_ints"] = host_us(lambda: fns.workspace_bytes(1, 1, 1, 1), 2000)
        parts["encode_one_map_via_ctypes"] = encode_us(q, b, heads, n)
        line = {"host": [b, n, heads, 64], "us": parts, "reps": HOST_REPS, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del qkv, out, q, k, v
        torch.cuda.empty_cache()
    return lines


def contract_section(mods, gen, card):
    from test_torch_poison import F6_CASES, k1_contract, padded_bias

    lines = []
    for n, nv, heads in F6_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            for bias_dtype in (None, dtype):
                qkv = torch.randn(2, n, 3 * 64 * heads, device="cuda", generator=gen).to(dtype)
                bias = None if bias_dtype is None else padded_bias(heads, n, bias_dtype, gen)
                res = {lib: k1_contract(mod, qkv, heads, nv, bias) for lib, mod in mods.items()}
                line = {"contract": f"n{n}_valid{nv}", "dtype": str(dtype),
                        "shape": [2, n, heads, 64], "bias": bias is not None, **res,
                        "card": card}
                print(json.dumps(line), flush=True)
                lines.append(line)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other-tree", required=True, help="another checkout's root")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--sections", default="shapes,plans,host,contract")
    p.add_argument("--out", default="", help="also write the JSON lines here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_contract_study needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from depthg_tpu_torch.ops import _build
    from depthg_tpu_torch.ops import attention as att

    sections = args.sections.split(",")
    tree = Path(args.other_tree)
    sources = {"other": (tree / "depthg_tpu_torch" / "csrc" / "attention.cu").read_text()}
    if "variants" in sections:
        from depthg_tpu_torch.attention_bias_study import variant_source

        own = (_build.CSRC / "attention.cu").read_text()
        for name, edits in VARIANTS.items():
            sources[name] = variant_source(own, edits)
            if sources[name] is None or any(old not in own for old, _ in edits):
                raise RuntimeError(f"variant {name}: an edit's anchor is not in attention.cu")
    package = threading.Thread(target=_build.build, args=(["attention"],))  # meanwhile
    package.start()
    libs = build_sources(sources, "contract_study")
    package.join()
    other_log = libs["other"][1]
    mods = {"package": att, "other": tree_attention(tree, libs["other"][0])}
    lines = [{"ptxas": {"package": ptxas_report(_build.BUILD_LOG.get("attention", "")),
                        "other": ptxas_report(other_log)}, "other_tree": args.other_tree}]
    print(json.dumps(lines[0]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    busy = torch.empty(8192, 8192, device="cuda").normal_()
    for _ in range(100):  # ~2 s of work: the card leaves its idle clocks first
        busy @ busy
    del busy
    if "variants" in sections:
        lines += variants_section({name: libs[name][0] for name in VARIANTS}, gen, args.rounds,
                                  card)
    if "shapes" in sections:
        lines += shapes_section(mods, gen, args.rounds, card)
    if "plans" in sections:
        lines += plans_section(gen, args.rounds, card)
    if "host" in sections:
        lines += host_section(mods, gen, card)
    if "contract" in sections:
        lines += contract_section(mods, gen, card)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
