"""How far a served label map depends on the batch it rides in, on the card.

    python -m depthg_tpu_torch.serve_bucket_study [--out FILE] [--device cuda]

The serving stack pads a batch to a power-of-two bucket (1 to 16 images)
and runs the predict step on it, so one image's labels come from a forward
of 1, 2, 4, 8 or 16 images. This script builds the server's model as
``chip_smoke.py`` does (the ViT-S/8 segmenter, random weights from seed 0,
``serve_config.yml``), decodes 16 synthetic JPEGs, and predicts every image
in each bucket through the service's own staging and step, under three
operating points: the served one (bf16 backbone, bf16 CRF state), bf16
backbone with a float32 CRF, and float32 throughout. Per bucket it reports
the least pixel agreement of an image's labels with those of the batch of
16, whether the pre-CRF logits are the same bits, and the first of the
model's modules whose output for an image alone is not the same bits as in
the batch of 16. To locate further where the
batch size enters, it also checks bit-identity across batch sizes for the
attention kernel alone and for one of the backbone's ``nn.Linear`` layers
(cuBLAS) at the served shapes, and prints a digest of every label map so
that two trees can be compared run against run. One JSON line per reading,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

IMAGES = 16
BUCKETS = (1, 2, 4, 8, 16)
# (name, config overrides)
POINTS = (("bf16_backbone_bf16_crf", []),
          ("bf16_backbone_f32_crf", ["crf_dtype=float32"]),
          ("f32_backbone_f32_crf", ["backbone_dtype=float32", "crf_dtype=float32"]))


def agreement(a: np.ndarray, b: np.ndarray) -> float:
    return float((a == b).mean())


def batch_invariance(fn, x: torch.Tensor, rows: int) -> dict:
    """``fn`` on the first ``rows`` rows of ``x`` vs those rows of ``fn(x)``."""
    alone, together = fn(x[:rows]), fn(x)[:rows]
    diff = (alone.float() - together.float()).abs().max().item()
    return {"rows": rows, "of": x.shape[0], "bit_identical": bool(torch.equal(alone, together)),
            "max_abs_diff": diff}


def batch_dependent_modules(model, forward, x_alone, x_batch) -> tuple:
    """Run ``forward(x)`` on an image alone and in a batch (row 0 in both)
    with a hook on every submodule of ``model``; the modules, in call
    order, whose output row 0 differs between the two, with the max abs
    difference, and the number of module calls."""
    names = {m: n for n, m in model.named_modules()}
    calls = []

    def hook(mod, inp, out):
        if isinstance(out, torch.Tensor):
            calls[-1].append((names[mod], out[0].detach().float().cpu()))

    handles = [m.register_forward_hook(hook) for m in names]
    try:
        for x in (x_alone, x_batch):
            calls.append([])
            with torch.inference_mode():
                forward(x)
    finally:
        for h in handles:
            h.remove()
    differ = [(n, (a - b).abs().max().item()) for (n, a), (_, b) in zip(*calls)
              if not torch.equal(a, b)]
    return differ, len(calls[0])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="", help="also write the JSON lines here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    from PIL import Image

    from depthg_tpu_torch import inference, serve
    from depthg_tpu_torch.config import load_config
    from depthg_tpu_torch.models import featurizer
    from depthg_tpu_torch.ops import attention as att
    from depthg_tpu_torch.profile_serve import synthetic_jpeg
    from depthg_tpu_torch.runtime import get_device
    from depthg_tpu_torch.utils.ckpt import export_lightning_ckpt

    device = get_device(args.device)

    lines = []

    def emit(**kw):
        print(json.dumps(kw), flush=True)
        lines.append(kw)

    tmp = tempfile.mkdtemp(prefix="serve_bucket_study_")
    model = inference.Segmenter(featurizer.FeaturizerConfig(), 27, 27).init_weights(
        torch.Generator().manual_seed(0))
    ckpt = os.path.join(tmp, "segmenter.ckpt")
    export_lightning_ckpt(ckpt, model.state_dict(), cfg={
        "model_type": "vit_small", "dino_patch_size": 8, "dim": 70, "n_classes": 27})
    del model
    bodies = [synthetic_jpeg(100 + i, *((480, 360), (400, 400), (360, 500), (640, 480))[i % 4])
              for i in range(IMAGES)]

    for point, overrides in POINTS:
        svc = serve.build_service(load_config("serve_config.yml",
                                              [f"model_path={ckpt}", *overrides]), device)
        arrs = [np.asarray(svc._transform(Image.open(io.BytesIO(b)).convert("RGB")), np.float32)
                for b in bodies]
        preds, logits = {}, {}
        for b in BUCKETS:
            lin, clu, log = [], [], []
            for i in range(0, IMAGES, b):
                lo, cl = svc._predict_padded(arrs[i:i + b], b)
                lin.append(lo)
                clu.append(cl)
                with torch.inference_mode():
                    log.append(inference.eval_logits(svc._model, svc._stage(arrs[i:i + b], 0),
                                                     svc.ecfg, normalized=False)[1].cpu())
            preds[b] = (np.concatenate(lin), np.concatenate(clu))
            logits[b] = torch.cat(log)
        differ, n_calls = batch_dependent_modules(
            svc._model, lambda x: inference.eval_logits(svc._model, x, svc.ecfg, normalized=False),
            svc._stage(arrs[:1], 0), svc._stage(arrs, 0))
        emit(point=point, stage="modules_whose_output_depends_on_the_batch",
             module_calls=n_calls, differ=len(differ), first=differ[:6])
        for b in BUCKETS:
            agree = [min(agreement(preds[b][0][i], preds[IMAGES][0][i]),
                         agreement(preds[b][1][i], preds[IMAGES][1][i])) for i in range(IMAGES)]
            emit(point=point, backbone_dtype=svc.ecfg.backbone_dtype, crf_dtype=svc.ecfg.crf.dtype,
                 fused_tta=svc.ecfg.fused_tta, bucket=b,
                 min_agreement_with_batch16=min(agree),
                 images_below_100pct=sum(a < 1.0 for a in agree),
                 cluster_logits_bit_identical_to_batch16=bool(torch.equal(logits[b], logits[IMAGES])),
                 cluster_logits_max_abs_diff=(logits[b] - logits[IMAGES]).abs().max().item(),
                 labels_sha256=hashlib.sha256(preds[b][0].tobytes() + preds[b][1].tobytes()
                                              ).hexdigest()[:16])
        svc.close()
        del svc

    # the served shapes (fused flip TTA: bucket b is a backbone batch of 2b)
    gen = torch.Generator(device=device).manual_seed(1)
    qkv = torch.randn(2 * IMAGES, 1601, 3 * 384, device=device, generator=gen).bfloat16()
    x = torch.randn(2 * IMAGES, 1601, 384, device=device, generator=gen).bfloat16()
    w = (torch.randn(3 * 384, 384, device=device, generator=gen) * 384 ** -0.5).bfloat16()
    for rows in (2, 4, 8, 16):
        emit(stage="attention_kernel", **batch_invariance(
            lambda t: att.attention_qkv(t, 6, 64 ** -0.5), qkv, rows))
        emit(stage="linear_384_to_1152_bf16", **batch_invariance(
            lambda t: F.linear(t, w), x, rows))
    card = "cpu" if device.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(dict(line, card=card)) + "\n" for line in lines)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
