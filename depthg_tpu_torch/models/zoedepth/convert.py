"""Weights of the depth models carried across, in the released files' own layout.

The port's modules hold the released torch state dicts natively, so loading
a file is ``load_state_dict(strict=True)``. This module has the inverse of
the JAX package's converters (``depthg_tpu/models/zoedepth/convert.py
zoe_params_from_torch``, ``depthg_tpu/models/midas_dpt.py
midas_dpt_from_torch``): the JAX parameter tree (numpy arrays) -> the
released layout (ZoeDepth, ZoeDepth-NK, DPT_Large), so the same random
weights reach both packages; the loaders of ``ZoeD_M12_N.pt`` and
``dpt_large-midas-2f21e586.pt``; and the configurations derived from a
state dict's shapes. Depth Anything V2's released files
(``depth_anything_v2_vitl.pth``) name their parts ``pretrained.*`` and
``depth_head.*``; ``depth_anything_v2_state_dict`` maps them onto the port's
DPT layout.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from depthg_tpu_torch.models.depth_anything_v2 import DepthAnythingV2, DepthAnythingV2Config
from depthg_tpu_torch.models.midas_dpt import MidasDPT, MidasDPTConfig
from depthg_tpu_torch.models.zoedepth.beit import BEiTConfig
from depthg_tpu_torch.models.zoedepth.dpt import DPTConfig
from depthg_tpu_torch.models.zoedepth.model import ZoeConfig, ZoeDepth
from depthg_tpu_torch.utils.ckpt import _layer_norm_sd, _linear_sd, _torch, vit_state_dict


def _conv_sd(out: dict, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _torch(p["w"])
    if "b" in p:
        out[prefix + ".bias"] = _torch(p["b"])


def beit_state_dict(bp: dict, prefix: str) -> dict:
    """The JAX BEiT tree -> timm BEiT keys under ``prefix``."""
    out = {}
    pw = np.asarray(bp["patch_embed"]["w"])  # [3 ps ps, D], (c, kh, kw) order
    d = pw.shape[1]
    ps = int(round((pw.shape[0] // 3) ** 0.5))
    out[prefix + "patch_embed.proj.weight"] = _torch(pw.T.reshape(d, 3, ps, ps))
    out[prefix + "patch_embed.proj.bias"] = _torch(bp["patch_embed"]["b"])
    out[prefix + "cls_token"] = _torch(bp["cls_token"])
    for i, blk in enumerate(bp["blocks"]):
        p = f"{prefix}blocks.{i}."
        _layer_norm_sd(out, p + "norm1", blk["norm1"])
        out[p + "attn.qkv.weight"] = _torch(np.asarray(blk["qkv_w"]).T)
        out[p + "attn.q_bias"] = _torch(blk["q_bias"])
        out[p + "attn.v_bias"] = _torch(blk["v_bias"])
        _linear_sd(out, p + "attn.proj", blk["proj"])
        out[p + "attn.relative_position_bias_table"] = _torch(blk["rel_pos_table"])
        _layer_norm_sd(out, p + "norm2", blk["norm2"])
        _linear_sd(out, p + "mlp.fc1", blk["fc1"])
        _linear_sd(out, p + "mlp.fc2", blk["fc2"])
        out[p + "gamma_1"] = _torch(blk["gamma_1"])
        out[p + "gamma_2"] = _torch(blk["gamma_2"])
    return out


def dpt_state_dict(dp: dict, pretrained: str, scratch: str) -> dict:
    """The JAX DPT tree -> ``{pretrained}act_postprocess{i}.*`` and
    ``{scratch}*`` keys (the readout is absent where the tree holds None)."""
    out = {}
    for i in range(4):
        post = f"{pretrained}act_postprocess{i + 1}"
        if dp["readout"][i] is not None:
            _linear_sd(out, post + ".0.project.0", dp["readout"][i])
        _conv_sd(out, post + ".3", dp["reassemble"][i]["project"])
        if "resample" in dp["reassemble"][i]:
            _conv_sd(out, post + ".4", dp["reassemble"][i]["resample"])
    for i in range(4):
        _conv_sd(out, f"{scratch}layer{i + 1}_rn", dp["rn"][i])
    for j, rid in enumerate((4, 3, 2, 1)):
        fu = dp["fusion"][j]
        for unit, key in (("resConfUnit1", "rcu1"), ("resConfUnit2", "rcu2")):
            for conv in ("conv1", "conv2"):
                _conv_sd(out, f"{scratch}refinenet{rid}.{unit}.{conv}", fu[key][conv])
        _conv_sd(out, f"{scratch}refinenet{rid}.out_conv", fu["out"])
    for slot, conv in ((0, "conv1"), (2, "conv2"), (4, "conv3")):
        _conv_sd(out, f"{scratch}output_conv.{slot}", dp["head"][conv])
    return out


def zoe_state_dict_from_params(params: dict) -> dict:
    """The JAX package's ZoeDepth tree -> the ``ZoeD_M12_N.pt`` layout."""
    out = beit_state_dict(params["beit"], "core.core.pretrained.model.")
    out.update(dpt_state_dict(params["dpt"], "core.core.pretrained.", "core.core.scratch."))
    _conv_sd(out, "conv2", params["conv2"])

    def mlp2(prefix, convs):
        for slot, conv in zip((0, 2), convs):
            _conv_sd(out, f"{prefix}.{slot}", conv)

    mlp2("seed_bin_regressor._net", params["seed_bin_regressor"])
    mlp2("seed_projector._net", params["seed_projector"])
    for i, (proj, attr) in enumerate(zip(params["projectors"], params["attractors"])):
        mlp2(f"projectors.{i}._net", proj)
        mlp2(f"attractors.{i}._net", attr)
    mlp2("conditional_log_binomial.mlp", params["conditional_log_binomial"])
    return out


def zoe_nk_state_dict_from_params(params: dict) -> dict:
    """The JAX package's ZoeDepth-NK tree -> the ``ZoeD_M12_NK.pt`` layout
    (``nk.ZoeDepthNK``'s names). No released NK file is in the repository,
    and the JAX package has no NK loader, so there is no ``load_`` here."""
    out = beit_state_dict(params["beit"], "core.core.pretrained.model.")
    out.update(dpt_state_dict(params["dpt"], "core.core.pretrained.", "core.core.scratch."))
    _conv_sd(out, "conv2", params["conv2"])
    router = params["router"]
    _conv_sd(out, "patch_transformer.embedding_convPxP", router["embed"])
    for i, layer in enumerate(router["layers"]):
        p = f"patch_transformer.transformer_encoder.layers.{i}."
        out[p + "self_attn.in_proj_weight"] = _torch(np.asarray(layer["attn"]["in_proj"]["w"]).T)
        out[p + "self_attn.in_proj_bias"] = _torch(layer["attn"]["in_proj"]["b"])
        _linear_sd(out, p + "self_attn.out_proj", layer["attn"]["out_proj"])
        _linear_sd(out, p + "linear1", layer["fc1"])
        _linear_sd(out, p + "linear2", layer["fc2"])
        _layer_norm_sd(out, p + "norm1", layer["norm1"])
        _layer_norm_sd(out, p + "norm2", layer["norm2"])
    _linear_sd(out, "mlp_classifier.0", router["cls1"])
    _linear_sd(out, "mlp_classifier.2", router["cls2"])

    def mlp2(prefix, convs):
        for slot, conv in zip((0, 2), convs):
            _conv_sd(out, f"{prefix}.{slot}", conv)

    mlp2("seed_projector._net", params["seed_projector"])
    for i, proj in enumerate(params["projectors"]):
        mlp2(f"projectors.{i}._net", proj)
    for name, dom in params["domains"].items():
        mlp2(f"seed_bin_regressors.{name}._net", dom["seed_bin_regressor"])
        for i, attr in enumerate(dom["attractors"]):
            mlp2(f"attractors.{name}.{i}._net", attr)
        mlp2(f"conditional_log_binomial.{name}.mlp", dom["clb"])
    return out


def midas_state_dict_from_params(params: dict) -> dict:
    """The JAX package's DPT_Large tree -> the torch-hub file's layout."""
    out = vit_state_dict(params["vit"], prefix="pretrained.model.")
    out.update(dpt_state_dict(params["dpt"], "pretrained.", "scratch."))
    return out


def _released(blob) -> dict:
    """The state dict of a released file: its ``model`` entry if it has one,
    without DataParallel's ``module.`` prefix, timm's
    ``relative_position_index`` buffers (the port computes them) and the
    encoder's classifier head (``pretrained.model.head``, never run)."""
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    sd = {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}
    return {k: v for k, v in sd.items()
            if not k.endswith("relative_position_index") and ".model.head." not in k}


def _dpt_config(sd: dict, pretrained: str, scratch: str, embed_dim: int) -> DPTConfig:
    return DPTConfig(
        embed_dim=embed_dim,
        features=sd[f"{scratch}layer1_rn.weight"].shape[0],
        reassemble_channels=tuple(sd[f"{pretrained}act_postprocess{i}.3.weight"].shape[0]
                                  for i in range(1, 5)),
        project_readout=f"{pretrained}act_postprocess1.0.project.0.weight" in sd)


def zoe_config_from_state_dict(sd: dict) -> ZoeConfig:
    """A ZoeConfig from a released-layout state dict's shapes (counterpart
    of ``zoe_config_from_params``). ``n_midas_out`` is read from the
    conditional log-binomial's input width (the decoder's 32 output
    channels), not from ``conv2``."""
    pre = "core.core.pretrained.model."
    depth = 1 + max(int(m.group(1)) for k in sd
                    if (m := re.fullmatch(re.escape(pre) + r"blocks\.(\d+)\.attn\.qkv\.weight", k)))
    embed_dim = sd[pre + "patch_embed.proj.weight"].shape[0]
    table = sd[pre + "blocks.0.attn.relative_position_bias_table"]
    window = (int(round((table.shape[0] - 3) ** 0.5)) + 1) // 2
    n_stages = 1 + max(int(m.group(1)) for k in sd
                       if (m := re.fullmatch(r"projectors\.(\d+)\._net\.0\.weight", k)))
    bin_dim = sd["seed_projector._net.2.weight"].shape[0]
    clb_in = sd["conditional_log_binomial.mlp.0.weight"].shape[1]
    return ZoeConfig(
        n_bins=sd["seed_bin_regressor._net.2.weight"].shape[0], bin_embedding_dim=bin_dim,
        n_attractors=tuple(sd[f"attractors.{i}._net.2.weight"].shape[0] for i in range(n_stages)),
        beit=BEiTConfig(embed_dim=embed_dim, depth=depth, num_heads=table.shape[1],
                        pretrain_window=window,
                        hooks=(depth // 4 - 1, depth // 2 - 1, 3 * depth // 4 - 1, depth - 1)),
        dpt=_dpt_config(sd, "core.core.pretrained.", "core.core.scratch.", embed_dim),
        n_midas_out=clb_in - bin_dim - 1)


def load_zoedepth_pt(path: str) -> ZoeDepth:
    """A released ZoeDepth file (e.g. ``ZoeD_M12_N.pt``) as a float32
    ``ZoeDepth`` on the CPU, loaded with ``strict=True``."""
    sd = _released(torch.load(path, map_location="cpu", weights_only=False))
    model = ZoeDepth(zoe_config_from_state_dict(sd))
    model.load_state_dict(sd, strict=True)
    return model


def load_zoedepth_tree(path: str) -> ZoeDepth:
    """The JAX package's ZoeDepth param tree, from an orbax directory (its
    fine-tune's ``save_native``, ``params`` entry) or a ``.npz`` of dotted
    key paths, as a float32 ``ZoeDepth`` on the CPU, loaded strictly."""
    from depthg_tpu_torch.utils.checkpoint_io import read_param_tree

    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in zoe_state_dict_from_params(read_param_tree(path)).items()}
    model = ZoeDepth(zoe_config_from_state_dict(sd))
    model.load_state_dict(sd, strict=True)
    return model


def midas_config_from_state_dict(sd: dict) -> MidasDPTConfig:
    """A MidasDPTConfig from a hub-layout state dict's shapes (as the JAX
    package's ``load_midas_dpt`` derives it)."""
    pre = "pretrained.model."
    depth = 1 + max(int(m.group(1)) for k in sd
                    if (m := re.fullmatch(re.escape(pre) + r"blocks\.(\d+)\.attn\.qkv\.weight", k)))
    pw = sd[pre + "patch_embed.proj.weight"]  # [D, 3, ps, ps]
    d, ps = pw.shape[0], pw.shape[-1]
    n_pos = sd[pre + "pos_embed"].shape[1] - 1
    dcfg = _dpt_config(sd, "pretrained.", "scratch.", d)
    return MidasDPTConfig(
        patch_size=ps, embed_dim=d, depth=depth, num_heads={768: 12, 1024: 16}.get(d, d // 64),
        hooks=(depth // 4 - 1, depth // 2 - 1, 3 * depth // 4 - 1, depth - 1),
        img_size=int(round(n_pos ** 0.5)) * ps, features=dcfg.features,
        reassemble_channels=dcfg.reassemble_channels, project_readout=dcfg.project_readout)


def load_midas_dpt(path: str):
    """A DPT_Large file (``dpt_large-midas-2f21e586.pt``) as a float32
    ``MidasDPT`` on the CPU, loaded with ``strict=True``."""
    sd = _released(torch.load(path, map_location="cpu", weights_only=False))
    model = MidasDPT(midas_config_from_state_dict(sd))
    model.load_state_dict(sd, strict=True)
    return model


# the released file's names -> the port's (``DepthAnythingV2``'s DPT layout)
_DAV2_NAMES = (
    (r"pretrained\.(.+)", r"pretrained.model.\1"),
    (r"depth_head\.projects\.(\d)\.(.+)", lambda m: f"pretrained.act_postprocess"
                                             f"{int(m.group(1)) + 1}.3.{m.group(2)}"),
    (r"depth_head\.resize_layers\.([013])\.(.+)", lambda m: f"pretrained.act_postprocess"
                                                  f"{int(m.group(1)) + 1}.4.{m.group(2)}"),
    (r"depth_head\.scratch\.output_conv1\.(.+)", r"scratch.output_conv.0.\1"),
    (r"depth_head\.scratch\.output_conv2\.0\.(.+)", r"scratch.output_conv.2.\1"),
    (r"depth_head\.scratch\.output_conv2\.2\.(.+)", r"scratch.output_conv.4.\1"),
    (r"depth_head\.scratch\.((?:layer\d_rn|refinenet\d)\..+)", r"scratch.\1"),
)


def depth_anything_v2_state_dict(sd: dict) -> dict:
    """A state dict in the released Depth Anything V2 names -> the port's.
    ``pretrained.mask_token`` (DINOv2's masked-image token, never read at
    inference) is dropped; any other name the published model does not
    have raises."""
    out = {}
    for k, v in sd.items():
        if k == "pretrained.mask_token":
            continue
        for pattern, repl in _DAV2_NAMES:
            m = re.fullmatch(pattern, k)
            if m:
                out[m.expand(repl) if isinstance(repl, str) else repl(m)] = v
                break
        else:
            raise KeyError(f"{k!r} is not a name of the released Depth Anything V2")
    return out


def check_depth_anything_v2_vitl(sd: dict) -> None:
    """Raises ValueError unless ``sd`` (the port's names) has exactly the
    names and shapes of the released vitl (``DepthAnythingV2Config()``: 24
    blocks 1024 wide, a 37 x 37 table, features 256); the 12-block vits and
    vitb files among the refused. The model it is checked against is built
    on the meta device, so nothing is allocated."""
    with torch.device("meta"):
        want = {k: v.shape for k, v in DepthAnythingV2(DepthAnythingV2Config()).state_dict().items()}
    got = {k: v.shape for k, v in sd.items()}
    if got != want:
        off = sorted(k for k in want.keys() | got.keys() if want.get(k) != got.get(k))
        raise ValueError(f"not the released depth_anything_v2_vitl.pth: {len(off)} names missing, "
                         f"extra or of another shape, first {off[:3]}")


def load_depth_anything_v2(path: str) -> DepthAnythingV2:
    """The released ``depth_anything_v2_vitl.pth`` as a float32
    ``DepthAnythingV2`` on the CPU, loaded with ``strict=True``; a file of
    any other layout raises ValueError before the model is built."""
    sd = depth_anything_v2_state_dict(
        _released(torch.load(path, map_location="cpu", weights_only=False)))
    check_depth_anything_v2_vitl(sd)
    model = DepthAnythingV2(DepthAnythingV2Config())
    model.load_state_dict(sd, strict=True)
    return model
