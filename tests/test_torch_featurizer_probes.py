"""Featurizer, projection head and probes of the PyTorch port vs the JAX
package, on a tiny segmenter (2-block 128-wide ViT at 64 px, code dim 16,
5 classes + 2 extra clusters). Weights come from the JAX package's init and
cross over through ``state_dict_from_jax``. Float32 on both sides (JAX at
``precision="float32"``): atol 1e-4 (same math, other reduction orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu import inference as jinf
from depthg_tpu.models import featurizer as jfeat
from depthg_tpu.models import probes as jprobes
from depthg_tpu.models import vit as jvit
from depthg_tpu_torch import inference as tinf
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.models import vit as tvit
from depthg_tpu_torch.utils.ckpt import state_dict_from_jax

torch.set_num_threads(1)

VIT = dict(embed_dim=128, depth=2, num_heads=2, patch_size=8)


def _pair(feat_type="feat"):
    fj = jfeat.FeaturizerConfig(vit_config=jvit.ViTConfig(**VIT), dim=16,
                                feat_type=feat_type)
    ft = tfeat.FeaturizerConfig(vit_config=tvit.ViTConfig(**VIT), dim=16,
                                feat_type=feat_type)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"net": jfeat.featurizer_init(k1, fj),
              "linear_probe": jprobes.linear_probe_init(k2, 16, 5),
              "cluster_probe": jprobes.cluster_lookup_init(k3, 16, 7)}
    model = tinf.Segmenter.from_state_dict(state_dict_from_jax(params), ft)
    img = np.random.default_rng(0).standard_normal((2, 3, 64, 64)).astype(np.float32)
    return fj, params, model, img


@pytest.mark.parametrize("feat_type", ["feat", "KK"])
def test_featurizer_code_matches_jax(feat_type):
    fj, params, model, img = _pair(feat_type)
    ref = jfeat.featurizer_apply(params["net"], jnp.asarray(img), fj,
                                 precision="float32")
    with torch.no_grad():
        out = tfeat.featurizer_apply(model.net, torch.from_numpy(img))
    assert out["code"].shape == (2, 16, 8, 8)
    np.testing.assert_allclose(out["feats"].numpy(), np.asarray(ref["feats"]),
                               atol=1e-4)
    np.testing.assert_allclose(out["code"].numpy(), np.asarray(ref["code"]),
                               atol=1e-4)


@pytest.mark.parametrize("lowres", [True, False])
@pytest.mark.parametrize("normalized", [True, False])
def test_probe_logits_match_jax(lowres, normalized):
    """Linear logits and cluster log-probs after flip-TTA, on the low-res
    (exact restructuring) and the materializing path."""
    fj, params, model, img = _pair()
    ej = jinf.EvalConfig(n_classes=5, extra_clusters=2, run_crf=False,
                         label_res=40, precision="float32", lowres_probes=lowres)
    et = tinf.EvalConfig(**{f.name: getattr(ej, f.name)
                            for f in dataclasses.fields(tinf.EvalConfig)
                            if f.name != "crf"})
    lin_j, clu_j = jinf.eval_logits(params, jnp.asarray(img), fj, ej,
                                    normalized=normalized)
    with torch.no_grad():
        lin_t, clu_t = tinf.eval_logits(model, torch.from_numpy(img), et,
                                        normalized=normalized)
    assert lin_t.shape == (2, 5, 40, 40) and clu_t.shape == (2, 7, 40, 40)
    np.testing.assert_allclose(lin_t.numpy(), np.asarray(lin_j), atol=1e-4)
    np.testing.assert_allclose(clu_t.numpy(), np.asarray(clu_j), atol=1e-4)


def test_fused_tta_equals_sequential():
    _, _, model, img = _pair()
    x = torch.from_numpy(img)
    with torch.no_grad():
        seq = tinf.tta_code(model.net, x, fused=False)
        fused = tinf.tta_code(model.net, x, fused=True)
    torch.testing.assert_close(fused, seq, rtol=0, atol=1e-5)
