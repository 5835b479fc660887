"""ZoeDepth's full-resolution bins tail (``ops.zoe_bins``) on the CPU.

``ZoeDepth._bins`` equals, bit for bit, the method as it read before its tail
moved into ``zoe_bins.bins_tail_plain``, in float32 and bf16, with and
without the probabilities. ``_bins`` takes the kernel's path only where the
kernel takes the call (the maps bf16 on the kernel's device type, gradients
off, the released head's widths, no probabilities asked for): on the CPU,
in float32, under grad, with ``return_probs`` and at other widths it runs
the module's code; with the kernel's device type set to the CPU it hands the
kernel's entry the maps in the layouts the kernel reads. The entry refuses
CPU tensors. The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses

import pytest
import torch

from depthg_tpu_torch.models.zoedepth import beit as tbeit
from depthg_tpu_torch.models.zoedepth import dpt as tdpt
from depthg_tpu_torch.models.zoedepth import model as tzoe
from depthg_tpu_torch.ops import zoe_bins
from depthg_tpu_torch.ops.resize import resize_bilinear

torch.set_num_threads(2)

# the tiny configuration of tests/test_torch_tracing.py (a 4 x 6 grid of a
# 64 x 96 input against a 6 x 6 pretraining window)
TINY = tzoe.ZoeConfig(n_bins=8, bin_embedding_dim=16, n_attractors=(4, 2, 2, 1),
                      img_size=(64, 96),
                      beit=tbeit.BEiTConfig(embed_dim=64, depth=4, num_heads=4, pretrain_window=6,
                                            hooks=(0, 1, 2, 3)),
                      dpt=tdpt.DPTConfig(embed_dim=64, features=16,
                                         reassemble_channels=(8, 16, 32, 32)))
# the released head's widths on the tiny backbone: 64 bins, a 128-wide
# embedding, 32 + 1 + 128 inputs, a bottleneck of 80
HEAD = dataclasses.replace(TINY, n_bins=64, bin_embedding_dim=128)


def model(cfg, dtype=torch.float32):
    net = tzoe.ZoeDepth(cfg).init_weights(torch.Generator().manual_seed(0))
    return net.to(dtype).eval()


def image(dtype=torch.float32):
    return (torch.rand(2, 3, 64, 96, generator=torch.Generator().manual_seed(1)) * 2 - 1).to(dtype)


def decoder_outputs(net, x):
    dpt = net.core.core
    taps, grid = dpt.pretrained.model(x)
    return dpt.decode(taps, grid)


def former_bins(self, rel_depth, hooks, return_probs):
    """``ZoeDepth._bins`` as it read before its full-resolution tail moved
    into ``ops.zoe_bins``."""
    cfg = self.cfg
    xh = self.conv2(hooks["l4_rn"])
    normed = cfg.bin_centers_type != "softplus"
    _, seed_centers = self.seed_bin_regressor(
        xh, "normed" if normed else "softplus", cfg.min_depth, cfg.max_depth)
    b_prev = ((seed_centers - cfg.min_depth) / (cfg.max_depth - cfg.min_depth)
              if normed else seed_centers)
    prev_emb = self.seed_projector(xh)

    b_centers = seed_centers
    for proj, attr, blk in zip(self.projectors, self.attractors,
                               (hooks["r4"], hooks["r3"], hooks["r2"], hooks["r1"])):
        emb = proj(blk)
        b_prev, b_centers = attr(emb, b_prev, prev_emb, kind=cfg.attractor_kind,
                                 attractor_type=cfg.attractor_type, normed=normed,
                                 min_depth=cfg.min_depth, max_depth=cfg.max_depth)
        prev_emb = emb

    last = hooks["out_conv"]
    rel = rel_depth[:, None]
    if cfg.inverse_midas:
        rel = 1.0 / (rel + 1e-6)
        lo = rel.amin(dim=(1, 2, 3), keepdim=True)  # per image
        hi = rel.amax(dim=(1, 2, 3), keepdim=True)
        rel = (rel - lo) / (hi - lo)
    rel = resize_bilinear(rel, last.shape[-2:], align_corners=True)
    last = torch.cat([last, rel], dim=1)

    emb_up = resize_bilinear(prev_emb, last.shape[-2:], align_corners=True)
    probs = self.conditional_log_binomial(last, emb_up)
    centers_up = resize_bilinear(b_centers, probs.shape[-2:], align_corners=True)
    depth = torch.sum(probs * centers_up, dim=1, keepdim=True)

    out = {"rel_depth": rel_depth, "metric_depth": depth, "feats": emb_up}
    if return_probs:
        out["probs"] = probs
        out["bin_centers"] = centers_up
    return out


@pytest.mark.parametrize("return_probs", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_bins_equals_the_former_bins_bit_for_bit(dtype, return_probs):
    net = model(TINY, dtype)
    with torch.no_grad():
        rel_depth, hooks = decoder_outputs(net, image(dtype))
        got = net._bins(rel_depth, hooks, return_probs)
        want = former_bins(net, rel_depth, hooks, return_probs)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


@pytest.fixture
def tail_calls(monkeypatch):
    """The kernel's entry replaced by the plain version: the calls it got."""
    calls = []

    def stand_in(*args):
        calls.append(args)
        depth, feats, _, _ = zoe_bins.bins_tail_plain(*args)
        return depth, feats

    monkeypatch.setattr(zoe_bins, "bins_tail", stand_in)
    return calls


CASES = {  # case -> (configuration, dtype, kernel's device type the CPU, grad, return_probs)
    "cpu": (HEAD, torch.bfloat16, False, False, False),
    "float32": (HEAD, torch.float32, True, False, False),
    "grad": (HEAD, torch.bfloat16, True, True, False),
    "return_probs": (HEAD, torch.bfloat16, True, False, True),
    "other_widths": (TINY, torch.bfloat16, True, False, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bins_runs_the_module_path_where_the_kernel_does_not_take_the_call(
        monkeypatch, tail_calls, case):
    cfg, dtype, as_kernel_device, grad, return_probs = CASES[case]
    if as_kernel_device:
        monkeypatch.setattr(zoe_bins, "DEVICE_TYPE", "cpu")
    net = model(cfg, dtype)
    with torch.set_grad_enabled(grad):
        out = net(image(dtype), return_probs=return_probs)
    assert tail_calls == []
    assert ("probs" in out) == return_probs
    assert out["metric_depth"].requires_grad == grad


@pytest.mark.parametrize("b", [1, 2])
def test_bins_hands_the_kernel_the_call_it_takes(monkeypatch, tail_calls, b):
    """The control of the cases above: with the kernel's device type set to
    the CPU, a bf16 head at the released widths without gradients reaches
    the kernel's entry once a forward, with the maps in the layouts it reads
    (channels-last out_conv, embedding and centers, a contiguous rel; the
    decoder leaves one image's maps in NCHW), and the forward returns what
    the module path returns."""
    net = model(HEAD, torch.bfloat16)
    x = image(torch.bfloat16)[:b]
    with torch.no_grad():
        want = net(x)
        monkeypatch.setattr(zoe_bins, "DEVICE_TYPE", "cpu")
        got = net(x)
    assert len(tail_calls) == 1
    last, rel, prev_emb, b_centers, clb = tail_calls[0]
    assert clb is net.conditional_log_binomial
    assert tuple(last.shape) == (b, 32, 64, 96) and tuple(rel.shape) == (b, 1, 64, 96)
    assert tuple(prev_emb.shape) == (b, 128, 32, 48) and tuple(b_centers.shape) == (b, 64, 32, 48)
    for t in (last, prev_emb, b_centers):
        assert t.is_contiguous(memory_format=torch.channels_last)
    assert rel.is_contiguous()
    for key in ("rel_depth", "metric_depth", "feats"):
        assert torch.equal(got[key], want[key]), key


def _head_inputs(dtype=torch.bfloat16, b=2, h=8, w=12):
    gen = torch.Generator().manual_seed(2)
    cl = torch.channels_last
    return (torch.rand(b, 32, h, w, generator=gen).to(dtype).contiguous(memory_format=cl),
            torch.rand(b, 1, h, w, generator=gen).to(dtype),
            torch.randn(b, 128, h // 2, w // 2, generator=gen).to(dtype).contiguous(memory_format=cl),
            (torch.rand(b, 64, h // 2, w // 2, generator=gen) * 10).to(dtype)
            .contiguous(memory_format=cl),
            model(HEAD, dtype).conditional_log_binomial)


def test_kernel_entry_refuses_cpu_tensors():
    before = zoe_bins.KERNEL.bins_launches
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        zoe_bins.bins_tail(*_head_inputs())
    assert zoe_bins.KERNEL.bins_launches == before
