"""The feature-pyramid featurizer and the CNN backbones of the PyTorch port
(``depthg_tpu_torch/models/pyramid.py``) vs the JAX package's
``depthg_tpu/models/pyramid.py``, on the CPU.

The pyramid's weights (frozen ResNet-50 and head) come from one JAX
``pyramid_featurizer_init`` through ``state_dict_from_jax``; the
``load_model`` files are written to ``tmp_path`` with random tensors in
each checkpoint's own key layout and read by both packages. Inputs are
seeded numpy arrays at 64 px (granularity 4 stacks the 1/4 level on the
image resized to ``out_size`` 16). Tolerances: ResNet activations and
backbone features 1e-5 relative (atol 1e-5); the pyramid's code and low
features 1e-5 relative (atol 1e-5) in eval and train mode; BatchNorm
running statistics after a train-mode forward 1e-6 absolute; the bf16
backbone against float32 a correlation above 0.99 (the JAX test's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.models import pyramid as jpyr
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.models import pyramid as tpyr
from depthg_tpu_torch.utils.ckpt import state_dict_from_jax

torch.set_num_threads(1)
RNG = np.random.default_rng(3)


@pytest.fixture(scope="module")
def jax_g4():
    """One JAX init at granularity 4 (the backbone and every head level);
    lower granularities use its first levels."""
    cfg = jpyr.PyramidConfig(granularity=4, dim=8, out_size=16)
    return jax.device_get(jpyr.pyramid_featurizer_init(jax.random.PRNGKey(0), cfg))


def _pair(params, granularity, continuous=True):
    kw = dict(granularity=granularity, dim=8, out_size=16, continuous=continuous)
    keep = {"vit", "cluster1"} | {f"{p}{i}" for p in ("conv", "cluster")
                                  for i in range(2, granularity + 1)}
    jp = {k: v for k, v in params.items() if k in keep}
    sd = state_dict_from_jax({"net": jp})
    net = tfeat.build(tpyr.PyramidConfig(**kw))
    net.load_state_dict({k[len("net."):]: v for k, v in sd.items()}, strict=True)
    return jpyr.PyramidConfig(**kw), jp, net


def _close(out, ref, what="", rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def test_resnet50_activations_match_jax(jax_g4):
    _, jp, net = _pair(jax_g4, 1)
    x = RNG.standard_normal((2, 3, 64, 64)).astype(np.float32)
    ref = jpyr.resnet50_activations(jp["vit"], jnp.asarray(x), (4, 5, 6, 7))
    with torch.no_grad():
        out = net.model(torch.from_numpy(x), (4, 5, 6, 7))
    for k, side in ((4, 16), (5, 8), (6, 4), (7, 2)):
        assert out[k].shape[-1] == side
        _close(out[k], ref[k], what=f"layer {k}")


@pytest.mark.parametrize("granularity", [1, 2, 3, 4])
@pytest.mark.parametrize("train", [False, True])
def test_pyramid_matches_jax(jax_g4, granularity, train):
    """Eval: running-stat BatchNorm in the head; train: batch statistics,
    and the running statistics move as ``merge_bn_stats`` folds them."""
    jcfg, jp, net = _pair(jax_g4, granularity)
    x = RNG.standard_normal((2, 3, 64, 64)).astype(np.float32)
    ref = jpyr.pyramid_featurizer_apply(jp, jnp.asarray(x), jcfg, train=train)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        out = tfeat.dispatch_apply(net, torch.from_numpy(x), train=train)
    assert out["attn"] is None and out["code"].shape == (2, 8, 16, 16)
    _close(out["feats"], ref["feats"], "low")
    _close(out["code"], ref["code"], "code")
    after = net.state_dict()
    for k in after:
        if k.startswith("model."):
            assert torch.equal(after[k], before[k]), k  # the frozen ResNet never moves
    if not train or granularity == 1:
        assert all(torch.equal(after[k], before[k]) for k in after)
        return
    merged = jpyr.merge_bn_stats({k: v for k, v in jp.items() if k != "vit"},
                                 [ref["bn_stats"]], jcfg.bn_momentum)
    for conv in ref["bn_stats"]:
        for bn in ("bn1", "bn2"):
            for stat, buf in (("mean", "running_mean"), ("var", "running_var")):
                _close(after[f"{conv}.{bn}.{buf}"], merged[conv][bn][stat],
                       f"{conv}.{bn}.{buf}", rtol=0, atol=1e-6)
                assert not torch.equal(after[f"{conv}.{bn}.{buf}"], before[f"{conv}.{bn}.{buf}"])
            assert int(after[f"{conv}.{bn}.num_batches_tracked"]) == 1


def test_log_softmax_clusters_match_jax(jax_g4):
    jcfg, jp, net = _pair(jax_g4, 2, continuous=False)
    x = RNG.standard_normal((1, 3, 64, 64)).astype(np.float32)
    ref = jpyr.pyramid_featurizer_apply(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        out = tfeat.dispatch_apply(net, torch.from_numpy(x))["code"]
    _close(out, ref["code"], "log_softmax code")
    np.testing.assert_allclose(out.exp().sum(1).numpy(), 1.0, atol=1e-5)


def test_bfloat16_backbone(jax_g4):
    """The ResNet runs in bf16, the features and the code come back float32
    and correlate with the float32 forward (the JAX test's bound); int8
    raises, as the JAX package's pyramid does (w8a8 is the ViT's path)."""
    _, _, net = _pair(jax_g4, 2)
    img = torch.from_numpy(RNG.standard_normal((2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        out32 = tfeat.dispatch_apply(net, img)
        out16 = tfeat.dispatch_apply(net, img, backbone_dtype="bfloat16")
    assert out16["code"].dtype == out16["feats"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in net.parameters())
    corr = np.corrcoef(out32["code"].numpy().ravel(), out16["code"].numpy().ravel())[0, 1]
    assert corr > 0.99, corr
    assert not torch.equal(out32["code"], out16["code"])
    with pytest.raises(NotImplementedError, match="w8a8") as refused:
        tfeat.dispatch_apply(net, img, backbone_dtype="int8")
    assert "ROADMAP" not in str(refused.value)
    with pytest.raises(ValueError, match="backbone_dtype"):
        tfeat.dispatch_apply(net, img, backbone_dtype="float16")


def test_train_mode_leaves_the_backbone_on_running_stats():
    """``model.train()`` on the net switches the head's mode only: the
    ResNet's BatchNorm stays in eval mode and its statistics never move."""
    net = tpyr.FeaturePyramidNet(tpyr.PyramidConfig(granularity=2, dim=4, out_size=8))
    net.init_weights(torch.Generator().manual_seed(0))
    net.train()
    assert net.training and not net.model.training
    assert not any(m.training for m in net.model.modules())
    before = {k: v.clone() for k, v in net.model.state_dict().items()}
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    net.model(x)
    tfeat.dispatch_apply(net, x, train=True)
    assert all(torch.equal(v, before[k]) for k, v in net.model.state_dict().items())


def _torchvision_sd(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


@pytest.fixture(scope="module")
def resnet_file_sd():
    """A random ResNet-50 in torchvision's keys (+ its ``fc``, which the
    loaders skip), from the port's own module."""
    net = tpyr.ResNet50().init_weights(torch.Generator().manual_seed(5))
    with torch.no_grad():  # non-trivial running statistics
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(6))
                m.running_var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(7))
    sd = _torchvision_sd(net)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(10, 2048), torch.zeros(10)
    return sd


@pytest.mark.parametrize("model_type", ["resnet50", "robust_resnet50", "mocov2", "densecl"])
def test_load_model_key_quirks_match_jax(resnet_file_sd, tmp_path, model_type):
    """Each ResNet-50 checkpoint layout: the port's ``load_model`` and the
    JAX package's read the same file to the same features."""
    sd = resnet_file_sd
    blob = {"resnet50": sd,
            "robust_resnet50": {"model": {"module.model." + k: v for k, v in sd.items()}},
            "mocov2": {"state_dict": {"module.encoder_q." + k: v for k, v in sd.items()}},
            "densecl": {"state_dict": sd}}[model_type]
    torch.save(blob, tmp_path / tpyr._MODEL_FILES[model_type])
    net, n_feats = tpyr.load_model(model_type, str(tmp_path))
    assert n_feats == 2048 and isinstance(net, tpyr.ResNet50) and not net.training
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k
    jp, jfn, jn = jpyr.load_model(model_type, str(tmp_path))
    x = RNG.standard_normal((1, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        out = tpyr.feature_map(net, torch.from_numpy(x))
    assert jn == n_feats and out.shape == (1, 2048, 2, 2)
    _close(out, jfn(jp, jnp.asarray(x)), model_type)


@pytest.mark.parametrize("model_type,cls,n_feats", [("vgg11", tpyr.VGG11, 512),
                                                     ("densenet121", tpyr.DenseNet121, 1024)])
def test_load_model_other_backbones_match_jax(tmp_path, model_type, cls, n_feats):
    net = cls().init_weights(torch.Generator().manual_seed(8))
    sd = _torchvision_sd(net)
    sd["classifier.weight"] = torch.zeros(3, 3)
    torch.save(sd, tmp_path / tpyr._MODEL_FILES[model_type])
    loaded, nf = tpyr.load_model(model_type, str(tmp_path))
    assert nf == n_feats and isinstance(loaded, cls)
    jp, jfn, jn = jpyr.load_model(model_type, str(tmp_path))
    x = RNG.standard_normal((1, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        out = tpyr.feature_map(loaded, torch.from_numpy(x))
    assert jn == nf and out.shape == (1, n_feats, 2, 2)
    _close(out, jax.jit(jfn)(jp, jnp.asarray(x)), model_type)


def test_load_model_refusals(tmp_path):
    """An unknown type raises before any path join (``data_dir=None`` would
    fail the join); a missing file raises ``FileNotFoundError``; a file
    without a key the backbone needs raises ``KeyError``."""
    with pytest.raises(ValueError, match="No model: resnet18 found"):
        tpyr.load_model("resnet18", None)
    with pytest.raises(FileNotFoundError, match="resnet50-0676ba61.pth"):
        tpyr.load_model("resnet50", str(tmp_path))
    torch.save({"conv1.weight": torch.zeros(64, 3, 7, 7)}, tmp_path / "vgg11-8a719046.pth")
    with pytest.raises(KeyError, match="missing"):
        tpyr.load_model("vgg11", str(tmp_path))
