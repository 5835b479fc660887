"""The DINOv2 ViT-g/14-reg backbone of the port (``models.vit``'s
``dinov2_vitg14_reg`` preset: registers, LayerScale, SwiGLU, the
antialiased table resize) against the benchmark's plain reference
(``benchmark/reference/vit_dinov2.py``) on the CPU, at the tiny size of
``benchmark/tests/_tiny_dinov2.py``: 3 blocks 64 wide, 4 heads of 16, 2
registers, SwiGLU hidden 176 by the published formula, patch 14, a 5 x 5
table resized down (56 px, 4 x 4), up (98 px, 7 x 7) and to a non-square
grid (56 x 98). The weights are the benchmark's seeded ones at the
configuration's assumed magnitudes (LayerScale 0.1, registers of std 1),
the block linears at std 0.1 and the queries and keys at 0.2 (the spread
per token that 0.02 and 0.04 give at width 1536).

* float32: the port's features within 1e-4 (relative L2, worst image) of
  the reference's, and the eval step's confusion blocks within 1e-4 of the
  reference's (the same arithmetic: the gaps are rounding);
* bfloat16: within 2e-3 (`BF16_TOL`: both round the same operations to
  bf16, the parameters first; on the CPU they round them in the same
  order, and 2e-3 leaves room for a library product's summation order);
* the reference with the registers, the LayerScale or the SiLU gate
  taken out misses both tolerances;
* a synthetic state dict in the hub's key names, ``mask_token`` included,
  loads through ``utils.ckpt.load_dino_pth`` with ``strict=True``;
* the published preset's widths and parameter count, its patch size
  refused elsewhere, the int8 copy of its linears, and the operation count
  of ``benchmark/counting_dinov2.py`` equal to PyTorch's flop counter on
  the port's eval step (the CRF left out);
* the repairs on the paths a DINOv2 backbone touches: the trainer's
  validation size, ``dino_depth``'s refusal, the pyramid's config (which
  reads no ViT preset), LHP's attention affinity over the patches after
  the registers.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import common, counting_dinov2
from benchmark.drivers import eval_dinov2 as driver
from benchmark.reference import vit_dinov2 as ref
from benchmark.tests._tiny_dinov2 import PRESET, tiny_dinov2_spec, tiny_preset
from benchmark.weights_dinov2 import make_state_dict
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.models import vit as tvit

CPU = torch.device("cpu")
F32_TOL = 1e-4
BF16_TOL = 2e-3
SEED = 2 ** 31 + 5


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    tiny_preset(monkeypatch)
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The worst image's |a - b| / |b|."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return float(((a - b).norm(dim=1) / b.norm(dim=1)).max())


def program_and_weights(res: int = 56):
    cfg = tiny_dinov2_spec(res=res)["config"]
    model, _ = driver.build_program(cfg, SEED, CPU)
    return cfg, model, make_state_dict(cfg, common.stream_seed(SEED, "weights"), CPU)


def image(h: int, w: int) -> torch.Tensor:
    return torch.randn(2, 3, h, w, generator=torch.Generator().manual_seed(3))


@pytest.mark.parametrize("hw", [(56, 56), (98, 98), (56, 98)], ids=["down", "up", "non-square"])
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_backbone_matches_reference(hw, dtype, tol):
    cfg, model, sd = program_and_weights()
    img = image(*hw)
    with torch.no_grad():
        got = tfeat.backbone_features(model.net, img, backbone_dtype=dtype)[0]
        want = ref.vit_features(sd, cfg["backbone"], img, getattr(torch, dtype))
    assert got.shape == (2, 64, hw[0] // 14, hw[1] // 14)
    assert rel(got, want) <= tol


@pytest.mark.parametrize("fault", ["registers", "layer_scale", "gate"])
def test_reference_faults_miss_the_tolerances(fault):
    cfg, model, sd = program_and_weights()
    img = image(56, 56)
    planted = {"registers": {"registers": False}, "layer_scale": {"layer_scale": False},
               "gate": {"gate": "gelu"}}[fault]
    with torch.no_grad():
        got = tfeat.backbone_features(model.net, img)[0]
        got_bf16 = tfeat.backbone_features(model.net, img, backbone_dtype="bfloat16")[0]
        bad = ref.vit_features(sd, cfg["backbone"], img, torch.float32, **planted)
        bad_bf16 = ref.vit_features(sd, cfg["backbone"], img, torch.bfloat16, **planted)
    assert rel(got, bad) > BF16_TOL > F32_TOL
    assert rel(got_bf16, bad_bf16) > BF16_TOL


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_eval_step_matches_reference(dtype, tol):
    spec = tiny_dinov2_spec()
    cfg, tr = spec["config"], spec["traffic"]
    cfg["eval"]["backbone_dtype"] = dtype
    model, step = driver.build_program(cfg, SEED, CPU)
    ring = driver.eval_driver.make_ring(cfg, tr, SEED, CPU)
    outs = {i: step(model, ring[i]["img"], ring[i]["label"]) for i in range(2)}
    feats = driver.program_features(model, cfg, ring, [0, 1])
    got = driver.reference(cfg, SEED, ring, [0, 1], CPU)
    for i in range(2):  # both flip-TTA passes, the mirrored images after the batch
        assert feats[i].shape == got[i][1].shape
        assert feats[i].shape[0] == 2 * tr["batch"]
        for p, r in zip(outs[i], got[i][0]):
            assert int(p.sum()) == int(r.sum()) == driver.eval_driver.labelled(ring[i], 27)
    gaps = driver.gaps(cfg, ring, outs, feats, got)
    assert gaps["label_gap"] <= tol and gaps["feat_gap"] <= tol


def test_hub_state_dict_loads_strictly(tmp_path):
    from depthg_tpu_torch.utils.ckpt import load_dino_pth

    cfg = tvit.make_config("dinov2_vitg14_reg", 14)
    src = tvit.VisionTransformer(cfg).init_weights(torch.Generator().manual_seed(1))
    hub = {**src.state_dict(), "mask_token": torch.zeros(1, cfg.embed_dim)}
    assert {"register_tokens", "blocks.0.ls1.gamma", "blocks.2.ls2.gamma", "blocks.0.mlp.w12.weight",
            "blocks.1.mlp.w3.bias"} <= set(hub)
    torch.save(hub, tmp_path / "dinov2_vitg14_reg4_pretrain.pth")
    dst = tvit.VisionTransformer(cfg)
    dst.load_state_dict(load_dino_pth(str(tmp_path / "dinov2_vitg14_reg4_pretrain.pth")),
                        strict=True)
    assert all(torch.equal(a, b) for a, b in zip(src.state_dict().values(),
                                                 dst.state_dict().values()))
    gamma = dst.blocks[0].ls1.gamma.detach()
    assert torch.equal(gamma, torch.full_like(gamma, tvit.LAYER_SCALE_INIT))


def test_published_preset(monkeypatch):
    monkeypatch.undo()  # the published widths, not the tiny ones
    cfg = tvit.make_config("dinov2_vitg14_reg", 14)
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.n_registers, cfg.n_prefix) == \
        (1536, 40, 24, 4, 5)
    assert tvit.swiglu_hidden(cfg) == 4096 and cfg.img_size // cfg.patch_size == 37
    with torch.device("meta"):
        model = tvit.VisionTransformer(cfg)
    assert 1.13e9 < sum(p.numel() for p in model.parameters()) < 1.14e9
    assert isinstance(model.blocks[0], tvit.LayerScaleBlock)
    assert tuple(model.blocks[0].mlp.w12.weight.shape) == (8192, 1536)
    with pytest.raises(ValueError, match="patch size 14"):
        tvit.make_config("dinov2_vitg14_reg", 8)
    # DINO v1's presets build the block they always did: no LayerScale,
    # GELU MLP, no registers
    with torch.device("meta"):
        v1 = tvit.VisionTransformer(tvit.make_config("vit_small", 8))
    assert type(v1.blocks[0]) is tvit.Block and isinstance(v1.blocks[0].mlp, tvit.Mlp)
    assert v1.register_tokens is None and v1.cfg.n_prefix == 1


def test_int8_copy_quantizes_the_swiglu():
    from depthg_tpu_torch.models.layers import W8A8Linear

    _, model, _ = program_and_weights()
    q = tvit.quantize_vit(model.net.model)
    assert all(isinstance(b.mlp.w12, W8A8Linear) and isinstance(b.mlp.w3, W8A8Linear)
               and b.ls1.gamma.dtype == torch.bfloat16 for b in q.blocks)
    img = image(56, 56)
    with torch.no_grad():
        f32 = tfeat.backbone_features(model.net, img)[0]
        int8 = tfeat.backbone_features(model.net, img, backbone_dtype="int8")[0]
    assert rel(int8, f32) < 5e-2


def test_operation_count_equals_the_flop_counter():
    """The step's model work: the stacked flip-TTA passes through the ViT
    and the head (``inference.tta_code``, as the eval step calls it), the
    linear probe and the cluster dots at the code's resolution (the
    resize's own interpolation products are not model work)."""
    from torch.utils.flop_counter import FlopCounterMode

    from depthg_tpu_torch.inference import tta_code

    cfg = tiny_dinov2_spec()["config"]
    model, _ = driver.build_program(cfg, SEED, CPU)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        code = tta_code(model.net, image(56, 56), fused=True)
        model.linear_probe(code)
        torch.einsum("bchw,nc->bnhw", code, model.cluster_probe.clusters)
    assert counter.get_total_flops() == counting_dinov2.eval_step_flops(cfg, 2)


def test_trainer_validation_size_is_a_multiple_of_the_patch():
    from depthg_tpu_torch.config import Config
    from depthg_tpu_torch.train_segmentation import validation_res

    def res(**kw):
        return validation_res(Config({"arch": "dino", "model_type": "vit_small", **kw}))

    assert res(dino_patch_size=8) == 320 and res(dino_patch_size=16) == 320
    assert res(model_type="dinov2_vitg14_reg", dino_patch_size=14) == 322
    assert res(arch="feature-pyramid", model_type="resnet50") == 320


def test_dino_depth_refuses_a_patch_14_backbone():
    from depthg_tpu_torch.models.featurizer_depth import (DepthFeaturizerConfig,
                                                          DinoDepthFeaturizer)

    with pytest.raises(ValueError, match="patch size 14"):
        DinoDepthFeaturizer(DepthFeaturizerConfig(arch="dinov2_vitg14_reg", patch_size=14))


def test_pyramid_never_builds_the_vit_preset():
    """``arch=feature-pyramid`` builds its ResNet-50 family backbone and
    reads no ViT preset, so a register ViT cannot reach it."""
    from depthg_tpu_torch.inference import fcfg_from_run_cfg
    from depthg_tpu_torch.models.pyramid import PyramidConfig

    run = {"arch": "feature-pyramid", "dino_patch_size": 14, "dim": 70}
    got = fcfg_from_run_cfg({**run, "model_type": "dinov2_vitg14_reg"})
    assert isinstance(got, PyramidConfig) and not hasattr(got, "vit")
    assert got == fcfg_from_run_cfg({**run, "model_type": "vit_small"})


def test_lhp_attention_affinity_skips_the_registers():
    """LHP's attention propagation reads the patches' block of the last
    attention map, after the class token and the registers."""
    from depthg_tpu_torch.models import lhp as tlhp

    _, model, _ = program_and_weights()
    with torch.no_grad():
        _, attn = tfeat.backbone_features(model.net, image(56, 56), need_attn=True)
    n_prefix = 1 + PRESET["n_registers"]
    assert attn.shape[-1] == n_prefix + 16
    got = tlhp._attn_affinity(attn, False, 16)
    assert torch.equal(got, tlhp._attn_affinity(attn[:, :, n_prefix - 1:, n_prefix - 1:], False))
    lhp = tlhp.LHP(tlhp.LHPConfig(dim=16, res=56, patch_size=14, propagation_strategy="attn"))
    lhp.init_weights(torch.Generator().manual_seed(0))
    out = tlhp.lhp_apply(lhp, torch.randn(2, 16, 4, 4), torch.rand(2, 1, 56, 56), attn)
    assert out.shape == (2, 16, 4, 4) and bool(torch.isfinite(out).all())
