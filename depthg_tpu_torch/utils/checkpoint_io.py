"""The one checkpoint loader of the eval, demo and serve entry points
(``depthg_tpu/utils/checkpoint_io.py:load_segmenter``), and a reader of the
JAX package's orbax checkpoint directories that needs no JAX.

``load_segmenter`` takes three formats, each into the eval state dict that
``inference.Segmenter.from_state_dict`` loads, with its run config:

* a reference Lightning ``.ckpt`` (hparams embedded);
* the port trainer's ``<tag>.pt`` (``utils.ckpt.save_segmenter``);
* an orbax directory written by the JAX package's ``save_native``: its
  ``params`` tree goes through ``utils.ckpt.state_dict_from_jax``.

``read_orbax`` reads such a directory with ``tensorstore`` alone (imported
inside it; ``orbax.checkpoint`` imports JAX). The directory's ``_METADATA``
names every leaf by its key path with a value type: arrays and scalars
are zarr arrays in the OCDBT key-value store at ``base/``, named by the
key path joined with dots (the ``zarr3`` driver when ``use_zarr3`` is
set); strings are in ``_strings.json`` under the same names; ``None``
leaves are stored as nothing. Sequence levels (key type 1) come back as
lists. ``read_npz`` reads a ``.npz`` whose entry names are the same
dotted key paths. ``fcfg_from_run_cfg`` and ``ecfg_from_checkpoint``, the
other two functions of the JAX module, live in
``depthg_tpu_torch/inference.py``.
"""

from __future__ import annotations

import ast
import json
import os

import numpy as np

from depthg_tpu_torch.config import Config
from depthg_tpu_torch.utils.ckpt import load_lightning_ckpt, load_segmenter_file, \
    state_dict_from_jax

_SEQUENCE_KEY = 1  # orbax's key_type of a list or tuple level


def _nest(leaves) -> dict:
    """[(key path, whether each key indexes a sequence, value)] -> the
    nested tree: dicts, and lists for the sequence levels."""
    root: dict = {}
    seq_ids = set()
    for keys, seqs, value in leaves:
        node = root
        for i, k in enumerate(keys):
            if seqs[i]:
                seq_ids.add(id(node))
            if i == len(keys) - 1:
                node[k] = value
            else:
                node = node.setdefault(k, {})

    def fix(tree):
        if not isinstance(tree, dict):
            return tree
        out = {k: fix(v) for k, v in tree.items()}
        return [out[k] for k in sorted(out, key=int)] if id(tree) in seq_ids else out

    return fix(root)


def read_orbax(path: str) -> dict:
    """The tree of an orbax ``PyTreeCheckpointer`` directory, without JAX:
    numpy arrays, Python scalars (0-d leaves), strings and ``None``."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise NotImplementedError(
            f"{path}: reading an orbax checkpoint directory needs the tensorstore "
            "package, which is not installed") from e
    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    strings = {}
    if os.path.exists(os.path.join(path, "_strings.json")):
        with open(os.path.join(path, "_strings.json")) as f:
            strings = json.load(f)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    leaves = []
    for key, entry in meta["tree_metadata"].items():
        keys = [str(k) for k in ast.literal_eval(key)]
        seqs = [m.get("key_type") == _SEQUENCE_KEY for m in entry["key_metadata"]]
        vtype = entry["value_metadata"]["value_type"]
        name = ".".join(keys)
        if vtype == "None" or entry["value_metadata"].get("skip_deserialize"):
            value = None
        elif vtype == "string":
            value = strings[name]
        else:
            spec = {"driver": driver,
                    "kvstore": {"driver": "ocdbt", "base": f"file://{path}/", "path": name}}
            value = ts.open(spec, open=True, read=True).result().read().result()
            if vtype == "scalar":
                value = value.item()
        leaves.append((keys, seqs, value))
    return _nest(leaves)


def read_npz(path: str) -> dict:
    """A ``.npz`` of a JAX param tree (entries named by dotted key paths):
    the nested tree, levels whose keys are all integers as lists."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    root: dict = {}
    for name, value in flat.items():
        node = root
        keys = name.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def fix(tree):
        if not isinstance(tree, dict):
            return tree
        out = {k: fix(v) for k, v in tree.items()}
        if out and all(k.isdigit() for k in out):
            return [out[k] for k in sorted(out, key=int)]
        return out

    return fix(root)


def read_param_tree(path: str) -> dict:
    """The ``params`` tree of an orbax directory or a ``.npz`` (the whole
    tree when it has no ``params`` entry)."""
    tree = read_orbax(path) if os.path.isdir(path) else read_npz(path)
    return tree.get("params", tree)


def load_segmenter(path: str):
    """Returns (eval state dict, run_cfg: Config) of a Lightning ``.ckpt``,
    a ``<tag>.pt`` of the port's trainer or an orbax directory of the JAX
    package."""
    if os.path.isdir(path):
        tree = read_orbax(path)
        sd = state_dict_from_jax(tree["params"])
        sd = {k: v for k, v in sd.items() if not k.startswith("lhp.")}
        return sd, Config(tree.get("cfg") or {})
    if path.endswith(".pt"):
        sd, cfg, _ = load_segmenter_file(path)
        return sd, Config(cfg)
    sd, hparams = load_lightning_ckpt(path)
    return sd, Config(hparams or {})

