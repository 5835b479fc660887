"""What the dataset-wide KNN costs on the GPU at a dataset's size.

    python -m depthg_tpu_torch.profile_knn [--n 590000] [--c 384] [--k 30]
        [--batch 128] [--res 224] [--out FILE]

Prints one JSON object (also written to ``--out``): the seconds and the peak
device memory of ``parallel.knn.topk_neighbors`` on ``--n`` seeded unit-norm
features of width ``--c`` at ``precision="highest"`` (float32 products) and
at the default (bf16 operands, float32 sums), whether rank 0 is self, the
share of entries the two precisions agree on; and the ms of
``pooled_features`` on one float32 batch of the full-width ViT-S/8 with
random weights (CUDA events over five calls after a warm-up).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from depthg_tpu_torch import get_device
from depthg_tpu_torch.models import featurizer
from depthg_tpu_torch.parallel import knn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=590_000)
    ap.add_argument("--c", type=int, default=384)
    ap.add_argument("--k", type=int, default=30)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = get_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    feats = torch.nn.functional.normalize(
        torch.randn(args.n, args.c, device=dev, generator=gen), dim=1)
    topk = {}
    for name, precision in (("highest", "highest"), ("default_bf16", None)):
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = knn.topk_neighbors(feats, k=args.k, precision=precision)
        topk[name] = {"seconds": time.perf_counter() - t0,
                      "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
                      "rank0_is_self": bool((idx[:, 0] == np.arange(args.n)).all()),
                      "idx": idx}
    same = float((topk["highest"].pop("idx") == topk["default_bf16"].pop("idx")).mean())
    del feats

    net = featurizer.DinoFeaturizer(featurizer.FeaturizerConfig())
    net.model.init_weights(torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    imgs = [torch.randn(args.batch, 3, args.res, args.res, device=dev, generator=gen)
            for _ in range(2)]
    knn.pooled_features(net, imgs[0])
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(5):
        knn.pooled_features(net, imgs[i % 2])
    stop.record()
    torch.cuda.synchronize()
    embed_ms = start.elapsed_time(stop) / 5

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip()
    result = {"card": card, "torch": torch.__version__, "n": args.n, "c": args.c, "k": args.k,
              "key_blocks": -(-args.n // knn._KEY_BLOCK) if args.n > 2 * knn._KEY_BLOCK else 1,
              "topk": topk, "entries_equal_between_precisions": same,
              "embed_batch": args.batch, "embed_res": args.res, "embed_ms": embed_ms,
              "embed_img_per_s": args.batch / embed_ms * 1e3}
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return result


if __name__ == "__main__":
    main()
