"""The CRF-loss playground (``depthg_tpu_torch/train_crf.py``) and the
checkpoint config printer (``load_pretrained_model_cfg.py``) vs the JAX
package's scripts, on the CPU.

* The playground's objective against the JAX script's ``loss_fn`` (the JAX
  package's ``contrastive_crf_loss`` from a key, the entropy terms of
  discrete codes), the coordinates derived from the key as the JAX loss
  draws them, for continuous and discrete codes, over three Adam steps
  (``torch.optim.Adam`` against ``optax.adam(1e-2)``) from the same table:
  the losses within 1e-5 relative plus 1e-6 at every step (float32 on
  both sides, sums in other orders) and the first step's gradient within
  1e-4 of its largest entry (measured 1.3e-5). The tables are not compared entry by entry:
  Adam divides by |g| + 1e-8, so an entry whose gradient cancels to
  rounding noise moves by up to lr = 1e-2 in either package.
* ``main`` on the CPU over a two-image Coco layout: the playground's PNGs.
* ``load_pretrained_model_cfg.main`` prints what the JAX script prints for
  a Lightning ``.ckpt``, and reads the trainer's ``<tag>.pt``.
"""

import contextlib
import importlib.util
import io
import os
import sys
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from depthg_tpu.config import load_config as jload_config
from depthg_tpu.ops.correlation import norm as jnorm
from depthg_tpu.train.losses import contrastive_crf_loss as jcrf_loss
from depthg_tpu_torch import train_crf
from depthg_tpu_torch.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

OVERRIDES = ["crf_samples=40", "dim=6"]


def _jax_objective(code_space, key, img, cfg, continuous):
    """The JAX script's ``loss_fn`` (``scripts/train_crf.py``)."""
    code = code_space if continuous else jax.nn.log_softmax(code_space, axis=1)
    prepped = jnorm(code) if continuous else jnp.exp(code)
    crf = jcrf_loss(key, img, prepped, int(cfg.crf_samples), float(cfg.alpha),
                    float(cfg.beta), float(cfg.gamma), float(cfg.w1), float(cfg.w2),
                    float(cfg.shift)).mean()
    if continuous:
        return crf, crf

    def entropy(p):
        p = jnp.maximum(p, 1e-7)
        return -(p * jnp.log(p)).sum(axis=1)

    probs = jnp.exp(code)
    reg = (-float(cfg.get("global_ent_weight", 0.01)) * entropy(probs.mean(0, keepdims=True)).mean()
           - float(cfg.get("local_ent_weight", 0.01)) * entropy(probs).mean())
    return crf + reg, crf


def _coords(key, n, h, w):
    """The sample coordinates ``contrastive_crf_loss`` draws from ``key``."""
    kh, kw = jax.random.split(key)
    return (torch.from_numpy(np.asarray(jax.random.randint(kh, (n,), 0, h))).long(),
            torch.from_numpy(np.asarray(jax.random.randint(kw, (n,), 0, w))).long())


@pytest.mark.parametrize("continuous", [True, False])
def test_objective_and_adam_match_the_jax_script(continuous):
    cfg = load_config("local_config.yml", OVERRIDES + [f"continuous={continuous}"])
    jcfg = jload_config("local_config.yml", OVERRIDES + [f"continuous={continuous}"])
    rng = np.random.default_rng(0)
    img = rng.standard_normal((3, 3, 12, 12)).astype(np.float32)
    table = (0.1 * rng.standard_normal((3, 6, 12, 12))).astype(np.float32)

    opt = optax.adam(1e-2)

    def jstep(table, state, key):
        (loss, crf), grad = jax.value_and_grad(
            lambda t: _jax_objective(t, key, jnp.asarray(img), jcfg, continuous),
            has_aux=True)(table)
        updates, state = opt.update(grad, state, table)
        return optax.apply_updates(table, updates), state, loss, crf, grad

    step = jax.jit(jstep)
    jtable, jstate = jnp.asarray(table), opt.init(jnp.asarray(table))
    code_space = torch.from_numpy(table.copy()).requires_grad_()
    topt = torch.optim.Adam([code_space], lr=1e-2)
    for i in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        jtable, jstate, ref_loss, ref_crf, ref_grad = step(jtable, jstate, key)
        topt.zero_grad()
        loss, crf = train_crf.objective(code_space, torch.from_numpy(img), cfg,
                                        coords=_coords(key, 40, 12, 12))
        loss.backward()
        if i == 0:
            scale = float(np.abs(np.asarray(ref_grad)).max())
            assert float(np.abs(code_space.grad.numpy() - np.asarray(ref_grad)).max()) <= \
                1e-4 * scale
        topt.step()
        for got, ref in ((loss, ref_loss), (crf, ref_crf)):
            np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5, atol=1e-6)


def _coco_val(root, n=2, size=48):
    base = join(root, "cocostuff")
    for sub in ("curated/val2017", "images/val2017", "annotations/val2017"):
        os.makedirs(join(base, sub), exist_ok=True)
    rng = np.random.default_rng(0)
    names = [f"v{i}" for i in range(n)]
    with open(join(base, "curated/val2017/Coco164kFull_Stuff_Coarse_7.txt"), "w") as f:
        f.write("\n".join(names))
    for name in names:
        Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8)).save(
            join(base, "images/val2017", name + ".jpg"))
        Image.fromarray(rng.integers(0, 182, (size, size)).astype(np.uint8)).save(
            join(base, "annotations/val2017", name + ".png"))


@pytest.mark.parametrize("continuous", [True, False])
def test_main_writes_the_playground_pngs(tmp_path, continuous):
    _coco_val(str(tmp_path))
    out = train_crf.main([f"data_dir={tmp_path}", f"output_root={tmp_path}", "image_set=val",
                          "n_images=2", "epochs=2", "res=32", "device=cpu",
                          f"continuous={continuous}"] + OVERRIDES)
    assert out["steps"] == 2 and np.isfinite(out["loss"]) and np.isfinite(out["crf"])
    assert sorted(os.listdir(out["out_dir"])) == ["0_code_0.png", "0_img.png",
                                                  "1_code_0.png", "1_img.png"]
    for name in ("0_code_0.png", "1_img.png"):
        png = np.asarray(Image.open(join(out["out_dir"], name)))
        assert png.shape == (16, 16, 3) and png.dtype == np.uint8


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"depthg_scripts_{name}", os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_load_pretrained_model_cfg_prints_what_the_jax_script_prints(tmp_path, monkeypatch):
    from depthg_tpu_torch import load_pretrained_model_cfg
    from depthg_tpu_torch.inference import Segmenter
    from depthg_tpu_torch.models.featurizer import FeaturizerConfig
    from depthg_tpu_torch.models.vit import ViTConfig
    from depthg_tpu_torch.utils.ckpt import export_lightning_ckpt, save_segmenter

    fcfg = FeaturizerConfig(vit_config=ViTConfig(embed_dim=32, depth=1, num_heads=2), dim=8)
    model = Segmenter(fcfg, 5, 5).init_weights(torch.Generator().manual_seed(0))
    run_cfg = {"model_type": "vit_small", "dino_patch_size": 8, "dim": 8, "n_classes": 5,
               "experiment_name": "playground", "lr": 5e-4}
    ckpt = str(tmp_path / "m.ckpt")
    export_lightning_ckpt(ckpt, model.state_dict(), cfg=run_cfg)
    script = _load_script("load_pretrained_model_cfg")
    monkeypatch.setattr(sys, "argv", ["load_pretrained_model_cfg.py", "--path", ckpt])
    with contextlib.redirect_stdout(io.StringIO()) as ref:
        script.main()
    with contextlib.redirect_stdout(io.StringIO()) as got:
        cfg = load_pretrained_model_cfg.main(["--path", ckpt])
    assert got.getvalue() == ref.getvalue() and cfg.experiment_name == "playground"
    pt = str(tmp_path / "last.pt")
    save_segmenter(pt, model.state_dict(), cfg=run_cfg)
    with contextlib.redirect_stdout(io.StringIO()) as got:
        assert load_pretrained_model_cfg.main(["--path", pt]).lr == 5e-4
    assert got.getvalue().splitlines()[0] == pt
