"""Per-image depth PNGs for a dataset with ZoeDepth, MiDaS or Depth Anything V2, on one GPU or more.

    python -m depthg_tpu_torch.generate_depth --data_dir DIR --output_dir OUT \\
        [--model zoedepth|midas|depth_anything_v2] (--weights FILE | --allow_random) \\
        [--dataset imagefolder|cocostuff|...] [--split val] [--batch_size 8] \\
        [--dtype bfloat16|float32|int8] [--attn_impl auto|xla|fused|flash] \\
        [--save_features] [--device cuda|cpu]

The port of ``scripts/generate_depth.py``. It iterates a dataset, buckets
the images by size (aspect kept, long side <= 512, multiples of 32; Depth
Anything V2: its own rule, below), runs ``--batch_size`` images of one
bucket per forward, resizes each depth map back to its image, min-max
normalizes it per image (the relative disparities of MiDaS and Depth
Anything V2 inverted) and writes
``{output_dir}/{parent folder}/{stem}_{model}.png`` (8-bit), and
``{stem}_feats.npy`` under ``--save_features``.

* ``--model zoedepth``: ``models/zoedepth`` with the reflect-pad + flip TTA
  of ``zoedepth_infer``; BEiT-L attention goes through the Hopper kernel
  with its relative-position bias (48 launches per batch: 24 blocks, two
  passes), each batch one ``depth.step`` span of ``utils.profiling``.
  ``--model midas``: ``models/midas_dpt`` on raw images (24 kernel
  launches per batch, no bias).
* ``--model depth_anything_v2``: ``models/depth_anything_v2`` (the
  released ViT-L, ``depth_anything_v2_vitl.pth``), one pass without a flip
  as its ``infer_image`` runs it, 24 kernel launches per batch, each batch
  one ``depth.step`` span. Its input rule (``image2tensor``): the short
  side to 518 as a lower bound, aspect kept, each side rounded to a
  multiple of 14 (``model.prep_size``): a 640x480 image runs at 518x686.
  Departures: the image is resized on the host with PIL's bicubic filter
  in place of OpenCV's ``INTER_CUBIC``, and the map goes back to the image
  size with PIL's bilinear filter as every model's here, in place of
  ``infer_image``'s ``align_corners=True`` resize; the ImageNet
  normalization runs on the device.
* Weights: ``--weights`` (``ZoeD_M12_N.pt``, ``dpt_large-midas-2f21e586.pt``
  or ``depth_anything_v2_vitl.pth``, nothing is downloaded) or
  ``--allow_random`` (full width, random weights from seed 0); without
  either it refuses, naming the file.
* ``--device`` defaults to ``cuda`` and raises without a card; the CPU runs
  only when asked for.
* Data-parallel over N GPUs, one process each: ``torchrun --nproc_per_node
  N -m depthg_tpu_torch.generate_depth --n_devices N ...``. Every rank
  walks the same images and buckets; of each dispatch, rank r runs and
  writes its contiguous share of the images (the JAX script shards each
  dispatch over its mesh), so every PNG is the single-process run's.
* ``--dtype int8``: the weights are loaded (or drawn) in float32, then the
  backbone (BEiT-L or a ViT-L) is quantized to w8a8 (``beit.quantize_beit``,
  ``vit.quantize_vit``: int8 block linears, bf16 elsewhere) and the rest of
  the model is cast to bf16, as the JAX script does; the images enter in
  bf16 and K1 runs in bf16.
* Tails of a bucket run at their own size: the JAX script padded them to a
  power of two to bound its compilations, which changes no output.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from depthg_tpu_torch.data.transforms import image_to_array as _image_to_array
from depthg_tpu_torch.parallel import dist
from depthg_tpu_torch.runtime import get_device
from depthg_tpu_torch.utils import profiling

def get_args_parser():
    p = argparse.ArgumentParser("Depth", add_help=False)
    p.add_argument("--model", default="zoedepth",
                   choices=["zoedepth", "midas", "depth_anything_v2"])
    p.add_argument("--data_dir", default="")
    p.add_argument("--dataset", default="imagefolder",
                   choices=["cocostuff", "potsdam", "cityscapes", "imagefolder",
                            "nyuv2", "pascalvoc"])
    p.add_argument("--split", default="val")
    p.add_argument("--output_dir", default="")
    p.add_argument("--save_features", action="store_true")
    p.add_argument("--weights", default=None,
                   help="ZoeD_M12_N.pt, dpt_large-midas-2f21e586.pt or "
                        "depth_anything_v2_vitl.pth")
    p.add_argument("--allow_random", action="store_true",
                   help="run with random weights (smoke testing only)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "int8"],
                   help="int8: the w8a8 backbone, bf16 elsewhere")
    p.add_argument("--batch_size", type=int, default=8,
                   help="images per forward (same-size buckets are batched)")
    p.add_argument("--attn_impl", default="auto",
                   choices=["auto", "xla", "flash", "fused"],
                   help="backbone attention path (auto = the kernel on CUDA); "
                        "zoedepth supports auto|xla|fused")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--n_devices", type=int, default=None,
                   help="the torchrun world size (default: the group's, 1 without torchrun)")
    return p


def iter_images(args):
    """Yield (pil_image, naming_path) pairs for the chosen dataset.

    Non-imagefolder datasets are read through their own ``__getitem__`` (the
    reference wraps them in a DataLoader too) — Potsdam images live in .mat
    files and NYUv2 filepaths are bare names, so opening ``filepaths``
    directly would yield nothing; ``filepaths`` is used only for naming.
    """
    from depthg_tpu_torch.data import datasets as D
    from depthg_tpu_torch.data.transforms import RawTransform

    raw = RawTransform(is_label=False)
    rawl = RawTransform(is_label=True)
    if args.dataset == "imagefolder":
        root = args.data_dir
        for sub in sorted(os.listdir(root)):
            subp = os.path.join(root, sub)
            if not os.path.isdir(subp):
                continue
            for fn in sorted(os.listdir(subp)):
                yield Image.open(os.path.join(subp, fn)).convert("RGB"), os.path.join(subp, fn)
        return
    if args.dataset == "potsdam":
        ds = D.Potsdam(args.data_dir, args.split, raw, rawl, coarse_labels=False)
    elif args.dataset == "cityscapes":
        ds = D.CityscapesSeg(args.data_dir, args.split, raw, rawl)
    elif args.dataset == "cocostuff":
        ds = D.Coco(args.data_dir, args.split, raw, rawl,
                    coarse_labels=False, exclude_things=False)
    elif args.dataset == "nyuv2":
        ds = D.NYUv2(args.data_dir, args.split, raw, rawl)
    elif args.dataset == "pascalvoc":
        ds = D.PascalVOC(args.data_dir, args.split, raw, rawl)
    else:
        raise NotImplementedError(args.dataset)
    rng = np.random.default_rng(0)
    for i in range(len(ds)):
        item = ds.__getitem__(i, rng)
        arr = item["img"]  # [3, H, W] float in [0, 1] (RawTransform: no normalize)
        pil = Image.fromarray(
            np.clip(arr.transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8))
        yield pil, str(ds.filepaths[i])


def bucket_size(ow: int, oh: int) -> tuple:
    """(bh, bw) of an ow x oh image: aspect kept, long side <= 512, multiples of 32."""
    scale = min(1.0, 512 / max(ow, oh))
    bw = max(32, int(round(ow * scale / 32)) * 32)
    bh = max(32, int(round(oh * scale / 32)) * 32)
    return bh, bw


def dav2_bucket_size(ow: int, oh: int) -> tuple:
    """(bh, bw) of an ow x oh image under Depth Anything V2's input rule:
    518 x 518 as a lower bound, aspect kept, multiples of 14."""
    from depthg_tpu_torch.models.depth_anything_v2 import DepthAnythingV2Config
    from depthg_tpu_torch.models.zoedepth.model import prep_size

    return prep_size(oh, ow, DepthAnythingV2Config(), resize_method="lower_bound", multiple=14)


# models whose output is a relative disparity: their PNGs are inverted
DISPARITY_MODELS = ("midas", "depth_anything_v2")


def write_one(args, depth, ow, oh, src, feats=None):
    """Resize one depth map to its image, min-max normalize it (a disparity
    inverted) and write its 8-bit PNG (and its features)."""
    if depth.shape != (oh, ow):
        depth = np.asarray(Image.fromarray(depth, mode="F")
                           .resize((ow, oh), Image.BILINEAR))
    # per-image min-max normalization (batching does not change it);
    # MiDaS relative depth is inverted — reference generate_depth.py:192-197
    depth = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-12)
    if args.model in DISPARITY_MODELS:
        depth = 1.0 - depth
    src_path = Path(src)
    folder = Path(args.output_dir) / src_path.parent.name
    folder.mkdir(parents=True, exist_ok=True)
    out_png = folder / f"{src_path.stem}_{args.model}.png"
    Image.fromarray((depth * 255).astype(np.uint8)).save(out_png)
    if feats is not None:
        np.save(folder / f"{src_path.stem}_feats.npy", feats)


def run_pipeline(args, infer, *, device: torch.device) -> int:
    """Drive ``infer(x [B, 3, H, W] float32 on device) -> (depth [B, 1, h, w],
    feats)`` over the input images with size-bucketed batches; returns the
    number of maps written (by every rank together). Split from ``main``
    so the batching and the normalization are testable with a stub model.
    Under a process group each rank runs and writes its contiguous share of
    every dispatch."""
    n = 0
    bs = max(1, args.batch_size)
    buckets = {}  # (bh, bw) -> list of (x [1, 3, bh, bw], (ow, oh, src))

    def flush(items):
        nonlocal n
        per = -(-len(items) // dist.world())
        items = items[dist.rank() * per:(dist.rank() + 1) * per]
        if not items:
            return
        xs = torch.from_numpy(np.concatenate([it[0] for it in items], axis=0)).to(device)
        depth_b, feats_b = infer(xs)
        depth_b = depth_b[:, 0].float().cpu().numpy()
        feats_b = feats_b.float().cpu().numpy() if args.save_features else [None] * len(items)
        for (_, (ow, oh, src)), depth, feats in zip(items, depth_b, feats_b):
            write_one(args, depth, ow, oh, src, feats)
            n += 1
            if n % 50 == 0:
                print(f"{n} depth maps written", flush=True)

    dav2 = args.model == "depth_anything_v2"
    bucket, resample = ((dav2_bucket_size, Image.BICUBIC) if dav2
                        else (bucket_size, Image.BILINEAR))
    for pil, src in iter_images(args):
        if pil is None:
            continue
        ow, oh = pil.size
        bh, bw = bucket(ow, oh)
        x = _image_to_array(pil.resize((bw, bh), resample))[None]
        buckets.setdefault((bh, bw), []).append((x, (ow, oh, src)))
        if len(buckets[(bh, bw)]) >= bs:
            flush(buckets.pop((bh, bw)))
    for items in buckets.values():
        flush(items)
    n = int(dist.all_reduce_sum(torch.tensor(n, device=device)))
    if dist.is_main():
        print(f"done: {n} depth maps -> {args.output_dir}")
    return n


def to_dtype(model: torch.nn.Module, dtype: str) -> torch.nn.Module:
    """A float32 ZoeDepth, MiDaS or Depth Anything V2 model in ``--dtype``:
    cast whole to float32 or bf16, or for int8 its backbone
    (``core.core.pretrained.model`` of ZoeDepth, ``pretrained.model`` of the
    other two, each a ``DPT``) replaced by its w8a8 copy and the rest cast
    to bf16."""
    if dtype != "int8":
        return model.to(torch.float32 if dtype == "float32" else torch.bfloat16)
    from depthg_tpu_torch.models.layers import cast_bf16
    from depthg_tpu_torch.models.vit import VisionTransformer, quantize_vit
    from depthg_tpu_torch.models.zoedepth.beit import quantize_beit

    dpt = model.core.core if hasattr(model, "core") else model
    backbone = dpt.pretrained.model
    quantize = quantize_vit if isinstance(backbone, VisionTransformer) else quantize_beit
    dpt.pretrained.model = quantize(backbone)
    return cast_bf16(model)


WEIGHT_FILES = {"zoedepth": "ZoeD_M12_N.pt", "midas": "dpt_large-midas-2f21e586.pt",
                "depth_anything_v2": "depth_anything_v2_vitl.pth"}


def build(args, device: torch.device, zoe_config=None, midas_config=None, dav2_config=None):
    """(infer, model) for ``args``: the weights loaded or drawn at random on
    ``device`` (``--allow_random`` draws ``zoe_config`` / ``midas_config`` /
    ``dav2_config``, the released models' by default), cast to ``--dtype``
    (``to_dtype``), in eval mode."""
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    weights = args.weights if args.weights and os.path.exists(args.weights) else None
    if weights is None and not args.allow_random:
        raise SystemExit(f"No --weights given (nothing is downloaded: "
                         f"{WEIGHT_FILES[args.model]} must be on disk). Pass --weights or "
                         "--allow_random.")
    gen = torch.Generator(device=device).manual_seed(0)
    if args.model == "depth_anything_v2":
        from depthg_tpu_torch.models.depth_anything_v2 import (DepthAnythingV2,
                                                               DepthAnythingV2Config)
        from depthg_tpu_torch.models.zoedepth.convert import load_depth_anything_v2

        if weights:
            model = load_depth_anything_v2(weights).to(device)
        else:
            print("WARNING: running with RANDOM Depth Anything V2 weights (smoke test only).")
            with device:
                model = DepthAnythingV2(dav2_config or DepthAnythingV2Config()).init_weights(gen)
        model = to_dtype(model, args.dtype).eval()
        impl = args.attn_impl

        def infer(x):
            # one pass without a flip, as the published infer_image
            with torch.inference_mode(), profiling.span("depth.step"):
                depth, hooks = model(x, attn_impl=impl)
                return depth[:, None].float(), hooks["out_conv"]
        return infer, model
    if args.model == "midas":
        from depthg_tpu_torch.models.midas_dpt import MidasDPT, MidasDPTConfig
        from depthg_tpu_torch.models.zoedepth.convert import load_midas_dpt

        if weights:
            model = load_midas_dpt(weights).to(device)
        else:
            print("WARNING: running with RANDOM DPT_Large weights (smoke test only).")
            with device:
                model = MidasDPT(midas_config or MidasDPTConfig()).init_weights(gen)
        model = to_dtype(model, args.dtype).eval()
        impl = args.attn_impl

        def infer(x):
            # raw 0..1 input, single forward — reference generate_depth.py:166
            with torch.inference_mode():
                depth, hooks = model(x.to(dtype), attn_impl=impl)
            return depth[:, None].float(), hooks["out_conv"].float()
        return infer, model

    from depthg_tpu_torch.models.zoedepth import ZoeConfig, ZoeDepth, zoedepth_infer
    from depthg_tpu_torch.models.zoedepth.convert import load_zoedepth_pt

    if weights:
        model = load_zoedepth_pt(weights).to(device)
    else:
        print("WARNING: running with RANDOM ZoeDepth weights (smoke test only).")
        with device:
            model = ZoeDepth(zoe_config or ZoeConfig()).init_weights(gen)
    impl = args.attn_impl
    if impl == "flash":  # BEiT has no flash path (its bias goes inside the kernel)
        print("zoedepth has no 'flash' attention; using 'auto' (the kernel on CUDA)",
              flush=True)
        impl = "auto"
    model = to_dtype(model, args.dtype).eval()

    def infer(x):
        with torch.inference_mode(), profiling.span("depth.step"):
            depth, feats = zoedepth_infer(model, x.to(dtype), return_feats=True,
                                          attn_impl=impl)
            return depth.float(), feats.float()
    return infer, model


def main(argv=None, zoe_config=None, midas_config=None, dav2_config=None) -> int:
    """The CLI; returns the number of depth maps written. The configurations
    are those ``--allow_random`` draws (the released models' by default)."""
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                   parents=[get_args_parser()]).parse_args(argv)
    device = get_device(args.device)
    dist.init_from_env(device=device.type)
    dist.check_world(args.n_devices)
    device = dist.rank_device(device)
    if args.output_dir:
        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    infer, _ = build(args, device, zoe_config, midas_config, dav2_config)
    return run_pipeline(args, infer, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
