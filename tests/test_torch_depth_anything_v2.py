"""The port's Depth Anything V2 (``models/depth_anything_v2.py``) against the
benchmark's plain reference (``benchmark/reference/depth_anything_v2.py``,
written from the published model), on the CPU at the tiny size of
``benchmark/tests/_tiny_dav2.py``: a ViT of 2 blocks 64 wide (4 heads of
16), patch 14, hooks (0, 0, 1, 1), a 5 x 5 table resized to the 4 x 7 grid
of a 56 x 98 image; DPT features 32. Both take one state dict drawn from a
seed under the released names (``benchmark.weights_dav2``), which the port
loads through its loader of those names with ``strict=True``.

Tolerances (relative L2 of the disparity about its mean, worst image: the
variation a min-max normalized PNG shows; the head's constant bias of 2
would otherwise dilute every gap):

* float32 1e-4: the same arithmetic in the same precision, so the gap is
  rounding (measured 0);
* bfloat16 (the port cast by ``generate_depth.to_dtype``, the reference in
  float32) ``BF16``: bf16's 2^-9 relative rounding of every stored weight
  and activation through the two blocks, the ~25 convolutions and resizes
  of the head, and the port's tanh GELU against the published exact one
  (measured 0.0119 to 0.0173 over 8 seeds; 3e-2 leaves 1.7 times that).

The reference with each planted fault (raw taps, the first hook one block
late, the normalization skipped, LayerScale left out) misses both
tolerances. A late hook moves one tap by one block's residual, which at
LayerScale 0.1 is below bf16's rounding at this size, so its bf16 case runs
the blocks at LayerScale 1 (where leaving the gammas out changes nothing).
Also: the released names load strictly (``mask_token`` accepted, never
read), the input rule's buckets, the PNG inversion, ``DPT.decode`` and the
MiDaS and ZoeDepth outputs bit-equal to the decoder before its split, the
int8 backbone, the CLI end to end on the CPU, the published preset and the
operation count of ``benchmark/counting_dav2.py`` equal to PyTorch's flop
counter on the port's forward.
"""

from __future__ import annotations

import ast
import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common, counting_dav2
from benchmark.drivers import depth_dav2 as driver
from benchmark.drivers.depth import make_ring
from benchmark.reference import depth_anything_v2 as ref
from benchmark.run import resolve
from benchmark.tests._tiny_dav2 import tiny_dav2_spec
from benchmark.weights_dav2 import make_state_dict, param_specs
from depthg_tpu_torch import generate_depth as tgd
from depthg_tpu_torch.models import vit as tvit
from depthg_tpu_torch.models.depth_anything_v2 import DepthAnythingV2, DepthAnythingV2Config
from depthg_tpu_torch.models.midas_dpt import MidasDPT, MidasDPTConfig
from depthg_tpu_torch.models.zoedepth import convert, dpt
from depthg_tpu_torch.models.zoedepth.beit import BEiTConfig
from depthg_tpu_torch.models.zoedepth.model import ZoeConfig, ZoeDepth
from depthg_tpu_torch.ops.resize import resize_bilinear

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
F32 = 1e-4
BF16 = 3e-2
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The worst image's |a - b| / |b|, each map taken about its mean."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    a, b = a - a.mean(1, keepdim=True), b - b.mean(1, keepdim=True)
    return float(((a - b).norm(dim=1) / b.norm(dim=1)).max())


def setup(dtype: str, layer_scale: float | None = None, seed: int = SEED):
    """(program model, state dict, image batch, config) at the tiny size."""
    spec = tiny_dav2_spec()
    cfg = spec["config"]
    cfg["infer"]["dtype"] = dtype
    if layer_scale is not None:
        cfg["init"]["layer_scale"] = layer_scale
    _, model = driver.build_program(cfg, seed, CPU)
    sd = make_state_dict(cfg, common.stream_seed(seed, "weights"), CPU)
    return model, sd, make_ring(spec["traffic"], seed, CPU)[0], cfg


FAULTS = {"raw_taps": dict(norm_taps=False), "first_hook_late": dict(hooks=[1, 0, 1, 1]),
          "not_normalized": dict(normalize=False), "layer_scale_left_out": dict(layer_scale=False)}


@pytest.mark.parametrize("seed", [SEED, 5, 9])
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_forward_matches_reference(dtype, tol, seed):
    """The float32 gap is 0; bf16's is in the module's docstring."""
    model, sd, img, cfg = setup(dtype, seed=seed)
    with torch.no_grad():
        got, hooks = model(img)
    want = ref.forward(sd, cfg, img)
    assert got.shape == want.shape == (2, 56, 98) and got.dtype == getattr(torch, dtype)
    assert hooks["out_conv"].shape == (2, 32, 56, 98)
    assert rel(got, want) <= tol


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_each_fault_misses_the_tolerance(dtype, tol, fault):
    late = fault == "first_hook_late" and dtype == "bfloat16"
    model, sd, img, cfg = setup(dtype, layer_scale=1.0 if late else None)
    with torch.no_grad():
        got = model(img)[0]
    assert rel(got, ref.forward(sd, cfg, img)) <= tol
    assert rel(got, ref.forward(sd, cfg, img, **FAULTS[fault])) > tol


def test_released_names_load_strictly(tmp_path, monkeypatch):
    """The seed's state dict is in the released names, ``mask_token``
    included: the port's loader maps it, drops the token (a NaN there reads
    nowhere) and loads strictly; an unknown name raises. The released vitl's
    layout passes ``check_depth_anything_v2_vitl`` (shapes alone, on the
    meta device); a file of a 12-block encoder (vits/vitb's depth) is
    refused by ``load_depth_anything_v2``, which loads the tiny file when
    the tiny configuration stands in for vitl's."""
    model, sd, img, cfg = setup("float32")
    assert {n for n, _, _, _ in param_specs(cfg)} == set(sd)
    assert "pretrained.mask_token" in sd
    sd = dict(sd, **{"pretrained.mask_token": torch.full_like(sd["pretrained.mask_token"],
                                                            float("nan"))})
    mapped = convert.depth_anything_v2_state_dict(sd)
    assert len(mapped) == len(sd) - 1
    assert set(mapped) == set(model.state_dict())
    model.load_state_dict(mapped, strict=True)
    with torch.no_grad():
        assert torch.isfinite(model(img)[0]).all()
    with pytest.raises(KeyError, match="depth_head.extra"):
        convert.depth_anything_v2_state_dict({**sd, "depth_head.extra.weight": sd[
            "depth_head.projects.0.weight"]})

    vitl = resolve("dav2l-depth-b8-518x686")["config"]
    convert.check_depth_anything_v2_vitl(convert.depth_anything_v2_state_dict(
        {n: torch.empty(shape, device="meta") for n, shape, _, _ in param_specs(vitl)}))
    cfg12 = copy.deepcopy(cfg)
    cfg12["encoder"].update(depth=12, num_heads=1, head_dim=64)  # the released heads of 64
    torch.save(make_state_dict(cfg12, 3, CPU), tmp_path / "depth_anything_v2_vits.pth")
    with pytest.raises(ValueError, match="not the released depth_anything_v2_vitl"):
        convert.load_depth_anything_v2(str(tmp_path / "depth_anything_v2_vits.pth"))

    torch.save(sd, tmp_path / "depth_anything_v2_vitl.pth")
    tiny = driver.dav2_config(cfg)
    monkeypatch.setattr(convert, "DepthAnythingV2Config", lambda: tiny)
    loaded = convert.load_depth_anything_v2(str(tmp_path / "depth_anything_v2_vitl.pth"))
    with torch.no_grad():
        assert torch.equal(loaded.eval()(img)[0], model.eval()(img)[0])


def test_bucket_rule():
    """``Resize(518, keep_aspect_ratio, ensure_multiple_of=14, lower_bound)``."""
    assert tgd.dav2_bucket_size(640, 480) == (518, 686)
    assert tgd.dav2_bucket_size(480, 640) == (686, 518)
    assert tgd.dav2_bucket_size(518, 518) == (518, 518)
    assert tgd.dav2_bucket_size(1000, 500) == (518, 1036)
    for ow, oh in ((96, 64), (300, 1200), (1920, 1080)):
        bh, bw = tgd.dav2_bucket_size(ow, oh)
        assert bh % 14 == 0 and bw % 14 == 0 and min(bh, bw) >= 518


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    (root / "val").mkdir()
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate([(56, 42)] * 3 + [(42, 56)] * 2):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(root / "val" / f"im{i}.jpg")
    return root


def _argv(image_dir, out, model, batch=2):
    return ["--data_dir", str(image_dir), "--output_dir", str(out), "--batch_size", str(batch),
            "--model", model]


def test_png_is_inverted_and_buckets_are_the_rule(image_dir, tmp_path):
    """The disparity's PNG is the inverse of a depth model's on the same
    output; the images enter at the rule's bucket (56 x 42 -> 518 x 686
    as rows x columns; 42 x 56 -> 686 x 518), resized bicubically."""
    shapes = []

    def infer(x):
        shapes.append(tuple(x.shape))
        d = x[:, :1] + x[:, 1:2]
        return d, d

    for model in ("zoedepth", "depth_anything_v2"):
        args = tgd.get_args_parser().parse_args(_argv(image_dir, tmp_path / model, model))
        assert tgd.run_pipeline(args, infer, device=CPU) == 5
    assert sorted(shapes[-3:]) == [(1, 3, 518, 686), (2, 3, 518, 686), (2, 3, 686, 518)]
    a = np.asarray(Image.open(tmp_path / "zoedepth" / "val" / "im0_zoedepth.png"), np.int32)
    b = np.asarray(Image.open(tmp_path / "depth_anything_v2" / "val"
                              / "im0_depth_anything_v2.png"), np.int32)
    assert a.shape == b.shape == (42, 56)
    src = Image.open(image_dir / "val" / "im0.jpg").convert("RGB")
    x = np.asarray(src.resize((686, 518), Image.BICUBIC), np.float32) / 255
    d = np.asarray(Image.fromarray(x[..., 0] + x[..., 1], mode="F").resize((56, 42),
                                                                           Image.BILINEAR))
    want = np.round(255 * (1 - (d - d.min()) / (d.max() - d.min())))
    assert np.abs(b - want).max() <= 1


def test_main_refuses_without_weights(image_dir, tmp_path):
    with pytest.raises(SystemExit, match="depth_anything_v2_vitl.pth"):
        tgd.main(_argv(image_dir, tmp_path, "depth_anything_v2") + ["--device", "cpu"])


def test_main_end_to_end_on_the_cpu(image_dir, tmp_path):
    """``main --device cpu --allow_random`` with the tiny configuration in
    float32 and with ``--dtype int8`` (the ViT's block linears w8a8, the
    rest bf16): five 8-bit PNGs at the images' sizes that are not constant,
    and finite features of the 32-channel activation."""
    from depthg_tpu_torch.models.layers import W8A8Linear

    dcfg = driver.dav2_config(tiny_dav2_spec()["config"])
    for dtype in ("float32", "int8"):
        out = tmp_path / dtype
        argv = _argv(image_dir, out, "depth_anything_v2") + [
            "--device", "cpu", "--allow_random", "--dtype", dtype, "--save_features"]
        if dtype == "int8":
            _, net = tgd.build(tgd.get_args_parser().parse_args(argv), CPU, dav2_config=dcfg)
            vit = net.pretrained.model
            assert sum(isinstance(m, W8A8Linear) for m in vit.modules()) == 4 * 2
            assert not any(isinstance(m, torch.nn.Linear) for m in vit.modules())
        assert tgd.main(argv, dav2_config=dcfg) == 5
        pngs = sorted((out / "val").glob("*_depth_anything_v2.png"))
        assert len(pngs) == 5
        for p in pngs:
            a = np.asarray(Image.open(p))
            assert a.dtype == np.uint8 and a.shape in ((42, 56), (56, 42)) and a.max() > a.min()
        feats = np.load(out / "val" / "im0_feats.npy")
        assert feats.shape == (32, 518, 686) and np.isfinite(feats).all()


def _decode_before(self, taps, grid_hw):
    """``DPT.decode`` as it was before its split into ``fuse`` and
    ``head`` (a copy, to hold the outputs bit-equal)."""
    h, w = grid_hw
    maps = []
    for i, tok in enumerate(taps):
        post = getattr(self.pretrained, f"act_postprocess{i + 1}")
        proj = post[0](tok)
        fmap = post[3](proj.transpose(1, 2).reshape(proj.shape[0], -1, h, w))
        if len(post) > 4:
            fmap = post[4](fmap)
        maps.append(fmap)
    s = self.scratch
    l1, l2, l3, l4 = (getattr(s, f"layer{i + 1}_rn")(maps[i]) for i in range(4))
    hooks = {"l4_rn": l4}
    p4 = s.refinenet4(l4, None, l3.shape[-2:])
    hooks["r4"] = p4
    p3 = s.refinenet3(p4, l3, l2.shape[-2:])
    hooks["r3"] = p3
    p2 = s.refinenet2(p3, l2, l1.shape[-2:])
    hooks["r2"] = p2
    p1 = s.refinenet1(p2, l1, (l1.shape[-2] * 2, l1.shape[-1] * 2))
    hooks["r1"] = p1
    head = s.output_conv
    y = head[0](p1)
    y = resize_bilinear(y, (y.shape[-2] * 2, y.shape[-1] * 2), align_corners=True)
    y = F.relu(head[2](y))
    hooks["out_conv"] = y
    y = F.relu(head[4](y))
    return y[:, 0], hooks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_and_the_depth_models_are_bit_equal_to_before(monkeypatch, dtype):
    """MiDaS's and ZoeDepth's outputs, and ``DPT.decode``, equal what the
    decoder gave before its split into ``fuse`` and ``head``."""
    gen = torch.Generator().manual_seed(0)
    d = dict(features=16, reassemble_channels=(8, 16, 32, 32))
    midas = MidasDPT(MidasDPTConfig(embed_dim=64, depth=4, num_heads=4, hooks=(0, 1, 2, 3),
                                    img_size=64, **d)).init_weights(gen).to(dtype).eval()
    zoe = ZoeDepth(ZoeConfig(
        n_bins=8, bin_embedding_dim=16, n_attractors=(2, 2, 1, 1), img_size=(64, 96),
        beit=BEiTConfig(embed_dim=64, depth=4, num_heads=4, pretrain_window=4, hooks=(0, 1, 2, 3)),
        dpt=dpt.DPTConfig(embed_dim=64, **d))).init_weights(gen).to(dtype).eval()
    x = torch.rand(2, 3, 64, 96, generator=gen).to(dtype)
    taps = [torch.randn(2, 1 + 24, 64, generator=gen).to(dtype) for _ in range(4)]

    def outputs():
        with torch.no_grad():
            return (midas(x), zoe(x), midas.decode(taps, (4, 6)))

    now = outputs()
    monkeypatch.setattr(dpt.DPT, "decode", _decode_before)
    before = outputs()
    flat = torch.utils._pytree.tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(flat(now), flat(before)))
    assert len(flat(now)) == len(flat(before)) > 10


def test_normed_taps_are_the_last_blocks_normed_features():
    """``normed_taps`` at the last block is ``forward``'s normed output with
    the class token dropped; the ViT's ``forward`` is untouched."""
    vit = tvit.VisionTransformer(tvit.ViTConfig(patch_size=14, embed_dim=64, depth=3, num_heads=4,
                                                img_size=70, layer_scale=True))
    vit.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 56, 98, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        feats, _, _ = vit(x, n=3)
        taps = vit.normed_taps(x, (2, 0, 2))
    assert [t.shape for t in taps] == [(2, 28, 64)] * 3
    assert torch.equal(taps[0], feats[2][:, 1:]) and torch.equal(taps[1], feats[0][:, 1:])


def test_published_preset_and_size():
    """The preset's widths are the configuration file's; 335.3M parameters
    with ``mask_token`` (the model card's 335M)."""
    cfg = resolve("dav2l-depth-b8-518x686")["config"]
    enc = cfg["encoder"]
    vit = tvit.make_config("dinov2_vitl14", 14)
    got = driver.dav2_config(cfg)
    assert got.vit == vit and got == DepthAnythingV2Config()
    assert (vit.embed_dim, vit.depth, vit.num_heads, vit.img_size // 14) == (
        enc["embed_dim"], enc["depth"], enc["num_heads"], enc["pos_embed_grid"])
    with pytest.raises(ValueError, match="patch size 14"):
        tvit.make_config("dinov2_vitl14", 16)
    n = sum(int(np.prod(s)) for _, s, _, _ in param_specs(cfg))
    assert 335.2e6 < n < 335.4e6
    with torch.device("meta"):
        model = DepthAnythingV2(DepthAnythingV2Config())
    assert sum(p.numel() for p in model.parameters()) == n - enc["embed_dim"]


def test_operation_count_equals_the_flop_counter():
    """``counting_dav2`` from the widths against ``FlopCounterMode`` on the
    port's forward (the eager attention on the CPU: its two products)."""
    model, _, img, cfg = setup("float32")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(img)
    assert counter.get_total_flops() == counting_dav2.step_flops(cfg, 2, 56, 98)


def test_reference_imports_torch_alone():
    path = ROOT / "benchmark" / "reference" / "depth_anything_v2.py"
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "contextlib", "math", "torch"}


def test_reference_runs_without_tf32(monkeypatch):
    seen = []
    real = ref.forward

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(*args, **kwargs)

    monkeypatch.setattr(ref, "forward", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    _, sd, img, cfg = setup("float32")
    ref.disparity_maps(sd, cfg, img, block=1)
    assert seen == [(False, False)] * 2
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def _dataset_layout(root, kind):
    """A one-image dataset of ``kind`` under ``root`` with both depth maps
    side by side: ``zoedepth``'s rising along the columns,
    ``depth_anything_v2``'s along the rows. Returns the dataset class's
    constructor over ``root``, by depth type."""
    from depthg_tpu_torch.data import datasets as D
    from depthg_tpu_torch.data.transforms import RawTransform

    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 255, (8, 12, 3), np.uint8))
    label = Image.fromarray(np.zeros((8, 12), np.uint8))

    def maps(folder, stem):
        folder.mkdir(parents=True, exist_ok=True)
        cols = np.tile(np.arange(12, dtype=np.uint8) * 20, (8, 1))
        rows = np.tile(np.arange(8, dtype=np.uint8)[:, None] * 30, (1, 12))
        for name, v in (("zoedepth", cols), ("depth_anything_v2", rows)):
            Image.fromarray(v).save(folder / f"{stem}_{name}.png")

    raw, rawl = RawTransform(is_label=False), RawTransform(is_label=True)
    if kind == "cocostuff":
        base = root / "cocostuff"
        for sub in ("curated/val2017", "images/val2017", "annotations/val2017"):
            (base / sub).mkdir(parents=True)
        (base / "curated/val2017/Coco164kFull_Stuff_Coarse.txt").write_text("a\n")
        img.save(base / "images/val2017/a.jpg")
        label.save(base / "annotations/val2017/a.png")
        maps(base / "depth/val2017", "a")
        return lambda t: D.Coco(str(root), "val", raw, rawl, coarse_labels=False,
                                exclude_things=False, return_depth=True, depth_type=t)
    if kind == "cityscapes":
        base = root / "cityscapes"
        (base / "leftImg8bit/val/c").mkdir(parents=True)
        (base / "gtFine/val/c").mkdir(parents=True)
        img.save(base / "leftImg8bit/val/c/a_leftImg8bit.png")
        label.save(base / "gtFine/val/c/a_gtFine_labelIds.png")
        maps(base / "depth/val/c", "a_leftImg8bit")
        return lambda t: D.CityscapesSeg(str(root), "val", raw, rawl, return_depth=True,
                                         depth_type=t)
    if kind == "pascalvoc":
        voc = root / "pascalvoc/VOCdevkit/VOC2012"
        for sub in ("ImageSets/Segmentation", "JPEGImages", "SegmentationClass"):
            (voc / sub).mkdir(parents=True)
        (voc / "ImageSets/Segmentation/val.txt").write_text("a\n")
        img.save(voc / "JPEGImages/a.jpg")
        label.save(voc / "SegmentationClass/a.png")
        maps(root / "pascalvoc/zoe_depth/val/JPEGImages", "a")
        raw = RawTransform(is_label=False, res=8)
        return lambda t: D.PascalVOC(str(root), "val", raw, rawl, return_depth=True,
                                     depth_type=t)
    for sub in ("test_rgb", "test_seg13"):
        (root / sub).mkdir(parents=True)
    img.save(root / "test_rgb/a.png")
    label.save(root / "test_seg13/a.png")
    maps(root / "test_zoedepth_depth", "a")
    return lambda t: D.NYUv2(str(root), "val", raw, rawl, return_depth=True, depth_type=t)


@pytest.mark.parametrize("kind", ["cocostuff", "cityscapes", "pascalvoc", "nyuv2"])
def test_datasets_read_the_depth_anything_v2_maps(tmp_path, kind):
    """``depth_type: depth_anything_v2`` reads ``{stem}_depth_anything_v2.png``
    from the folder that holds the ``_zoedepth.png`` maps; ``zoedepth`` still
    reads its own."""
    make = _dataset_layout(tmp_path, kind)
    for t, varies in (("zoedepth", -1), ("depth_anything_v2", -2)):
        ds = make(t)
        depth = np.asarray(ds.__getitem__(0, np.random.default_rng(0))["depth"])[0]
        assert np.ptp(depth, axis=varies).max() > 0 and np.ptp(depth, axis=-3 - varies).max() == 0
