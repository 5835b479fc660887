"""Print the run config embedded in a checkpoint (the port of
``scripts/load_pretrained_model_cfg.py``; reference
``src/load_pretrained_model_cfg.py``).

    python -m depthg_tpu_torch.load_pretrained_model_cfg --path CHECKPOINT

Reads every format ``utils.checkpoint_io.load_segmenter`` reads: a Lightning
``.ckpt``, the trainer's ``<tag>.pt`` and the JAX package's orbax directory.
"""

import argparse

from depthg_tpu_torch.utils.checkpoint_io import load_segmenter


def main(argv=None):
    parser = argparse.ArgumentParser(description="Load pretrained model cfg")
    parser.add_argument("--path", required=True, type=str)
    args = parser.parse_args(argv)
    print(args.path)
    _, cfg = load_segmenter(args.path)
    print(cfg.to_yaml())
    return cfg


if __name__ == "__main__":
    main()
