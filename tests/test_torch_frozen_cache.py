"""The frozen backbone's derived weights (``models/frozen_cache.py``), on the CPU.

* Every kept value is bit-equal to a fresh derivation with gradients on
  (where nothing is kept): the bf16 copy of a ViT's parameters; the
  position table in ``"dino"`` mode at 40 x 40 (ViT-S/8 at 320 px, a 28 x 28
  table) and at 37 x 49 (518 x 686 at patch 14, a 37 x 37 table), in
  ``"dinov2"`` mode at 32 x 32 (448 px, antialiased), in float32 and bf16.
  A square image at the table's own grid returns the table itself and
  keeps nothing.
* Invalidation: an in-place update, a ``load_state_dict``, a ``.to()`` and
  a storage swapped in under ``.data`` (the version counter unchanged)
  each derive the value again and drop the older one; a second grid gets
  its own table; a table keeps at most ``vit.TABLE_GRIDS`` grids, the least
  recently used dropped first, and that bound holds every grid that Depth
  Anything V2's input rule gives at aspect ratios from 1:2 to 2:1.
* A source without a version counter (a model built in inference mode) is
  derived on every call, kept nowhere, and counted as a build each time.
* A model built for a bf16 eval (``Segmenter.from_state_dict(...,
  "bfloat16")``) stores its ViT in bf16, passes those parameters as its
  copy, and gives the bits of the float32 model's cast copy.
* Models of one shape built, run and freed in turn (their storages' and
  tensors' addresses reused) never serve each other's values: each output
  equals a fresh uncached run of the same model.
* Nothing is kept while gradients are on; a copy made under
  ``inference_mode`` serves a later ``no_grad`` train forward.
* Threads that ask for one table at once get one value, built once, and
  every other lookup counts as a hit.
* The span counters ``frozen_cache_builds`` / ``frozen_cache_hits``: the
  first ``eval.step``, ``depth.step`` and ``train.step`` build, the next
  ones build nothing and hit 2 an eval step (the copy and the table, the
  ViT stored in float32 or in bf16), 1 a
  Depth Anything V2 step (its bf16 model's table) and 2 a train step at
  the table's own grid (the copy, once per backbone forward; 1 with
  ``fused_pair_forward``).
"""

from __future__ import annotations

import gc
import sys
import threading

import pytest
import torch
from torch.func import functional_call

from depthg_tpu_torch import generate_depth as tgen
from depthg_tpu_torch import inference as tinf
from depthg_tpu_torch.models import depth_anything_v2 as tdav2
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.models import frozen_cache
from depthg_tpu_torch.models import vit as tvit
from depthg_tpu_torch.train import losses as tloss
from depthg_tpu_torch.train import step as tstep
from depthg_tpu_torch.utils import profiling

torch.set_num_threads(1)

VIT = dict(embed_dim=32, depth=2, num_heads=2, patch_size=8, img_size=32)


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def counts():
    return frozen_cache.COUNTS.builds, frozen_cache.COUNTS.hits


def table(side: int, dim: int = 8, dtype=torch.float32, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(1, 1 + side * side, dim, generator=g).to(dtype)


def resized(pos, w, h, ps, mode):
    """``interpolate_pos_encoding`` with gradients on: derived afresh."""
    with torch.enable_grad():
        return tvit.interpolate_pos_encoding(pos, (h // ps) * (w // ps), w, h, ps, mode)


def cached(pos, w, h, ps, mode):
    with torch.no_grad():
        return tvit.interpolate_pos_encoding(pos, (h // ps) * (w // ps), w, h, ps, mode)


def vit(seed: int = 0, **kw) -> tvit.VisionTransformer:
    return tvit.VisionTransformer(tvit.ViTConfig(**{**VIT, **kw})).init_weights(
        torch.Generator().manual_seed(seed)).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("side, w, h, ps, mode", [
    (28, 320, 320, 8, "dino"),     # ViT-S/8 at 320 px
    (37, 686, 518, 14, "dino"),    # Depth Anything V2 at 518 x 686
    (37, 448, 448, 14, "dinov2"),  # DINOv2 at 448 px, antialiased
], ids=["dino-40x40", "dino-37x49", "dinov2-32x32"])
def test_table_is_bit_equal_to_a_fresh_resize(side, w, h, ps, mode, dtype):
    pos = table(side, dtype=dtype)
    b0, h0 = counts()
    first = cached(pos, w, h, ps, mode)
    again = cached(pos, w, h, ps, mode)
    assert again is first and counts() == (b0 + 1, h0 + 1)
    fresh = resized(pos, w, h, ps, mode)
    assert fresh is not first
    assert first.dtype == dtype and first.shape == (1, 1 + (h // ps) * (w // ps), 8)
    assert torch.equal(first, fresh)


def test_native_square_grid_keeps_nothing():
    pos = table(28)
    b0, h0 = counts()
    assert cached(pos, 224, 224, 8, "dino") is pos
    assert counts() == (b0, h0) and frozen_cache._ENTRIES.get(pos) is None


def test_bf16_copy_is_bit_equal_to_a_fresh_cast():
    model = vit(img_size=64)
    b0, h0 = counts()
    with torch.no_grad():
        first = tfeat.bf16_parameters(model)
        assert tfeat.bf16_parameters(model) is first
    assert counts() == (b0 + 1, h0 + 1)
    with torch.enable_grad():
        fresh = tfeat.bf16_parameters(model)
    assert fresh is not first and list(fresh) == [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        assert first[name].dtype == torch.bfloat16
        assert torch.equal(first[name], fresh[name])
        assert torch.equal(first[name], p.detach().to(torch.bfloat16))


def test_in_place_update_load_and_move_rebuild():
    model = vit(img_size=64)
    with torch.no_grad():
        first = tfeat.bf16_parameters(model)
        assert tfeat.bf16_parameters(model) is first
        model.blocks[0].mlp.fc1.weight.mul_(2.0)  # an in-place update (an optimizer step)
        second = tfeat.bf16_parameters(model)
        assert second is not first
        assert torch.equal(second["blocks.0.mlp.fc1.weight"],
                           2 * first["blocks.0.mlp.fc1.weight"])
        model.load_state_dict(vit(seed=1, img_size=64).state_dict())  # a load
        third = tfeat.bf16_parameters(model)
        assert third is not second
        assert torch.equal(third["pos_embed"], model.pos_embed.to(torch.bfloat16))
        model.to(torch.float64)  # a move
        fourth = tfeat.bf16_parameters(model)
        assert fourth is not third
        assert torch.equal(fourth["pos_embed"], model.pos_embed.to(torch.bfloat16))
        assert tfeat.bf16_parameters(model) is fourth
        version = model.pos_embed._version
        model.pos_embed.data = torch.randn_like(model.pos_embed)  # a replaced storage
        assert model.pos_embed._version == version
        fifth = tfeat.bf16_parameters(model)
        assert fifth is not fourth
        assert torch.equal(fifth["pos_embed"], model.pos_embed.to(torch.bfloat16))
    # only the newest weights' copy is kept
    assert list(frozen_cache._ENTRIES[model].values())[0][1] is fifth
    assert len(frozen_cache._ENTRIES[model]) == 1


def test_table_rebuilds_on_update_and_keeps_each_grid():
    pos = table(28)
    a = cached(pos, 320, 320, 8, "dino")
    b = cached(pos, 320, 256, 8, "dino")  # a second grid: its own table
    assert b is not a and b.shape[1] == 1 + 40 * 32
    assert cached(pos, 320, 320, 8, "dino") is a and cached(pos, 320, 256, 8, "dino") is b
    pos.mul_(0.5)
    c = cached(pos, 320, 320, 8, "dino")
    assert c is not a and torch.equal(c, resized(pos, 320, 320, 8, "dino"))
    assert len(frozen_cache._ENTRIES[pos]) == 1  # the older weights' tables are dropped
    moved = pos.to(torch.bfloat16)
    assert torch.equal(cached(moved, 320, 320, 8, "dino"), resized(moved, 320, 320, 8, "dino"))


def test_grids_beyond_the_bound_drop_the_least_recently_used():
    pos = table(28)
    n = tvit.TABLE_GRIDS
    sides = [(8 * k, 320) for k in range(30, 30 + n)]
    tables = [cached(pos, w, h, 8, "dino") for w, h in sides]
    assert cached(pos, *sides[0], 8, "dino") is tables[0]  # now the most recent
    extra = cached(pos, 8 * (30 + n), 320, 8, "dino")
    assert len(frozen_cache._ENTRIES[pos]) == n
    assert cached(pos, *sides[0], 8, "dino") is tables[0]
    assert cached(pos, 8 * (30 + n), 320, 8, "dino") is extra
    b0, _ = counts()
    assert cached(pos, *sides[1], 8, "dino") is not tables[1]  # the oldest, dropped
    assert counts()[0] == b0 + 1


def test_table_bound_holds_every_grid_of_depth_anything_v2s_rule():
    """Every grid that ``generate_depth.dav2_bucket_size`` gives an image of
    aspect ratio 1:2 to 2:1, the table's own 37 x 37 left out (it keeps
    nothing), fits in one table's bound: a collection of photos interleaved
    in any order never evicts a grid it uses again."""
    grids = {(bh // 14, bw // 14) for w in range(100, 1300, 7)
             for h in range(-(-w // 2), 2 * w + 1, 5)
             for bh, bw in [tgen.dav2_bucket_size(w, h)]}
    grids.discard((37, 37))
    assert len(grids) == tvit.TABLE_GRIDS
    assert {min(g) for g in grids} == {37} and max(max(g) for g in grids) == 74


def test_inference_tensor_source_is_derived_and_counted_each_call():
    """Weights made in inference mode have no version counter to key on:
    each call derives afresh, keeps nothing and counts a build."""
    with torch.inference_mode():
        model = vit(img_size=64)
        pos = table(28)
    b0, h0 = counts()
    with torch.no_grad():
        copies = [tfeat.bf16_parameters(model) for _ in range(2)]
        tables = [cached(pos, 320, 320, 8, "dino") for _ in range(2)]
    assert counts() == (b0 + 4, h0)
    assert copies[0] is not copies[1] and tables[0] is not tables[1]
    assert frozen_cache._ENTRIES.get(model) is None and frozen_cache._ENTRIES.get(pos) is None
    for name, p in model.named_parameters():
        assert torch.equal(copies[1][name], p.to(torch.bfloat16))
    assert torch.equal(tables[1], resized(pos.clone(), 320, 320, 8, "dino"))


def segmenter_pair():
    """One checkpoint built as the eval CLI builds it for a bf16 backbone
    and for a float32 one."""
    fcfg = tfeat.FeaturizerConfig(vit_config=tvit.ViTConfig(**VIT), dim=8)
    sd = tinf.Segmenter(fcfg, 5, 7).init_weights(torch.Generator().manual_seed(0)).state_dict()
    return (tinf.Segmenter.from_state_dict(sd, fcfg, "bfloat16"),
            tinf.Segmenter.from_state_dict(sd, fcfg))


def test_bf16_eval_model_stores_its_vit_in_bf16_and_gives_the_same_bits():
    stored, master = segmenter_pair()
    assert all(p.dtype == torch.bfloat16 for p in stored.net.model.parameters())
    assert all(p.dtype == torch.float32 for n, p in stored.named_parameters()
               if not n.startswith("net.model."))
    with torch.no_grad():
        own = tfeat.bf16_parameters(stored.net.model)
    assert all(own[n] is p for n, p in stored.net.model.named_parameters())
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(2, 3, 48, 48, generator=gen)
    label = torch.randint(-1, 5, (2, 48, 48), generator=gen)
    ecfg = tinf.EvalConfig(n_classes=5, extra_clusters=2, label_res=48, fused_tta=True,
                           backbone_dtype="bfloat16")
    step = tinf.make_eval_step(ecfg)
    for got, want in zip(step(stored, img, label), step(master, img, label)):
        assert torch.equal(got, want)
    with torch.inference_mode():
        got = tfeat.backbone_features(stored.net, img, backbone_dtype="bfloat16")[0]
        want = tfeat.backbone_features(master.net, img, backbone_dtype="bfloat16")[0]
    assert torch.equal(got, want)


def net_of(seed: int) -> tfeat.DinoFeaturizer:
    fcfg = tfeat.FeaturizerConfig(vit_config=tvit.ViTConfig(**VIT), dim=8)
    return tfeat.DinoFeaturizer(fcfg).init_weights(torch.Generator().manual_seed(seed)).eval()


def uncached_features(net, img):
    """The bf16 backbone forward with gradients on: a fresh cast and a
    fresh table resize."""
    with torch.enable_grad():
        copy = {n: p.detach().to(torch.bfloat16) for n, p in net.model.named_parameters()}
        feats, _, _ = functional_call(net.model, copy, (img.to(torch.bfloat16),),
                                      {"n": 1, "attn_impl": "xla"})
    return feats[0].detach()


def test_freed_models_never_serve_each_other():
    img = torch.randn(2, 3, 48, 40, generator=torch.Generator().manual_seed(3))
    seen = []
    for seed in range(8):
        net = net_of(seed)
        got = [tfeat.backbone_features(net, img, backbone_dtype="bfloat16")[0]
               for _ in range(2)]
        with torch.no_grad():
            feats, _, _ = functional_call(net.model, tfeat.bf16_parameters(net.model),
                                          (img.to(torch.bfloat16),), {"n": 1})
        want = uncached_features(net, img)
        assert torch.equal(feats[0], want)
        assert torch.equal(got[0], got[1])
        seen.append(got[0])
        del net, got, feats, want
        gc.collect()
    assert not any(torch.equal(seen[0], s) for s in seen[1:])


def test_nothing_kept_under_grad():
    model = vit(img_size=64)
    pos = table(28)
    b0, h0 = counts()
    with torch.enable_grad():
        tfeat.bf16_parameters(model)
        resized(pos, 320, 320, 8, "dino")
    assert counts() == (b0, h0)
    assert frozen_cache._ENTRIES.get(model) is None and frozen_cache._ENTRIES.get(pos) is None


def test_entry_made_in_inference_mode_serves_a_train_forward():
    net = net_of(0)
    img = torch.randn(2, 3, 48, 40, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        inside = tfeat.backbone_features(net, img, backbone_dtype="bfloat16")[0]
    b0, h0 = counts()
    outside = tfeat.backbone_features(net, img, backbone_dtype="bfloat16")[0]  # no_grad
    assert counts() == (b0, h0 + 2)  # the copy and the table
    assert torch.equal(inside, outside)
    kept = frozen_cache._ENTRIES[net.model][("bf16", None)][1]
    assert not any(t.is_inference() for t in kept.values())


def test_threads_share_one_table():
    """More threads than cores ask for one table at once, with the
    interpreter switching threads as often as it can: one build, and every
    other lookup counted as a hit (a lost update would break either)."""
    pos = table(37)
    n_threads, asks = 16, 50
    out, start = [], threading.Barrier(n_threads)

    def ask():
        start.wait()
        for _ in range(asks):
            out.append(cached(pos, 686, 518, 14, "dino"))

    b0, h0 = counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(out) == n_threads * asks and all(o is out[0] for o in out)
    assert counts() == (b0 + 1, h0 + n_threads * asks - 1)


# -- the counters in the steps' spans ------------------------------------------

def eval_call():
    fcfg = tfeat.FeaturizerConfig(vit_config=tvit.ViTConfig(**VIT), dim=8)
    model = tinf.Segmenter(fcfg, 5, 7).init_weights(torch.Generator().manual_seed(0))
    ecfg = tinf.EvalConfig(n_classes=5, extra_clusters=2, label_res=48, fused_tta=True,
                           backbone_dtype="bfloat16")
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(2, 3, 48, 48, generator=gen)  # a 6 x 6 grid against the 4 x 4 table
    label = torch.randint(-1, 5, (2, 48, 48), generator=gen)
    step = tinf.make_eval_step(ecfg)
    return lambda: step(model, img, label)


def eval_bf16_stored_call():
    stored, _ = segmenter_pair()
    ecfg = tinf.EvalConfig(n_classes=5, extra_clusters=2, label_res=48, fused_tta=True,
                           backbone_dtype="bfloat16")
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(2, 3, 48, 48, generator=gen)
    label = torch.randint(-1, 5, (2, 48, 48), generator=gen)
    step = tinf.make_eval_step(ecfg)
    return lambda: step(stored, img, label)


def dav2_call():
    vit_cfg = tvit.ViTConfig(patch_size=14, embed_dim=32, depth=2, num_heads=2, img_size=70,
                             layer_scale=True)
    cfg = tdav2.DepthAnythingV2Config(vit=vit_cfg, hooks=(0, 0, 1, 1), features=8,
                                      out_channels=(8, 8, 16, 16))
    args = tgen.get_args_parser().parse_args(["--model", "depth_anything_v2", "--allow_random",
                                              "--dtype", "bfloat16"])
    infer, _ = tgen.build(args, torch.device("cpu"), dav2_config=cfg)
    img = torch.rand(2, 3, 56, 98, generator=torch.Generator().manual_seed(1))
    return lambda: infer(img)


def train_call(**kw):
    fcfg = tfeat.FeaturizerConfig(arch="vit_small", patch_size=8, dim=8,
                                  vit_config=tvit.ViTConfig(**VIT), dropout=False, drop_rate=0.0)
    hp = tstep.TrainHParams(n_classes=3, backbone_dtype="bfloat16", **kw)
    state = tstep.init_state(fcfg, hp, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"img": torch.randn(4, 3, 32, 32, generator=gen),  # the table's own grid
             "img_pos": torch.randn(4, 3, 32, 32, generator=gen),
             "label": torch.randint(-1, 3, (4, 32, 32), generator=gen),
             "depth": torch.rand(4, 1, 32, 32, generator=gen),
             "depth_pos": torch.rand(4, 1, 32, 32, generator=gen)}
    lcfg = tloss.CorrLossConfig(feature_samples=3, neg_samples=2, depth_sampling="fps",
                                depth_feat_correlation_loss=True)
    return lambda: tstep.train_step(state, batch, hp, lcfg, 0.19, 0.03, generator=gen)


@pytest.mark.parametrize("make, name, builds, hits", [
    (eval_call, "eval.step", 2, 2),
    (eval_bf16_stored_call, "eval.step", 2, 2),
    (dav2_call, "depth.step", 1, 1),
    (train_call, "train.step", 1, 2),
    (lambda: train_call(fused_pair_forward=True), "train.step", 1, 1),
], ids=["eval", "eval-bf16-stored", "depth-dav2", "train", "train-fused-pair"])
def test_span_counters(make, name, builds, hits):
    """The first step builds (``builds`` values, its later lookups hitting),
    each later step builds nothing and hits ``hits`` times, all inside its
    ``backbone`` spans."""
    call = make()
    with profiling.recording():
        for _ in range(3):
            call()
    spans = profiling.collect()["spans"]
    steps = [s for s in spans if s["name"] == name]
    assert len(steps) == 3
    assert steps[0]["frozen_cache_builds"] == builds
    assert steps[0]["frozen_cache_builds"] + steps[0]["frozen_cache_hits"] == hits
    assert [(s["frozen_cache_builds"], s["frozen_cache_hits"]) for s in steps[1:]] == \
        [(0, hits)] * 2
    inner = [s for s in spans if s["name"] == "backbone"]
    assert sum(s["frozen_cache_builds"] + s["frozen_cache_hits"] for s in inner) == 3 * hits
