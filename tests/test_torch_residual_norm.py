"""The ViT block's residual junction (``ops.residual_norm``) on the CPU.

* Its plain versions against the eager expressions they replace, bit for
  bit: ``LayerScaleBlock``'s ``x + ls1(y)`` and ``Block``'s ``x + y``, then
  ``norm2`` (``models.layers.LayerNorm``), at ViT-S/8's, ViT-B/8's, ViT-L's
  and ViT-g's widths, in bf16 and float32. On the CPU the public entries
  are the plain versions.
* ``models.vit`` on the kernel's device type (pointed at the CPU, the
  launch stood in by the wrapper's checks and the plain versions) against
  the parent's formulas, written out here: a ViT-S/8, a DINOv2-style ViT
  (registers, LayerScale, SwiGLU) and a Depth-Anything-style one (LayerScale,
  ``normed_taps``), features, qkv and taps bit for bit, every junction
  through the entries; a block the kernel refuses raises there, as on the
  card (no fallback to the eager modules).
* Each ValueError the wrapper raises for a tensor of the kernel's device
  type (none of them reaches the kernel), and every ViT preset's width
  passing its checks.

The kernel itself is held to the plain versions on the card in
``tests/test_torch_cuda.py``.
"""

import pytest
import torch

from depthg_tpu_torch.models import vit as tvit
from depthg_tpu_torch.models.layers import LayerNorm
from depthg_tpu_torch.ops import residual_norm as rn

WIDTHS = [384, 768, 1024, 1536]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _block_inputs(d, dtype, seed=0):
    """x [2, 37, d] (a residual stream with an offset), y (a branch output)
    and trained-looking gamma, weight and bias."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(2, 37, d, generator=gen) * 2.0 + 0.5).to(dtype)
    y = torch.randn(2, 37, d, generator=gen).to(dtype)
    gamma = (torch.rand(d, generator=gen) * 0.2).to(dtype)
    norm = LayerNorm(d, eps=1e-6)
    with torch.no_grad():
        norm.weight.copy_(1.0 + 0.1 * torch.randn(d, generator=gen))
        norm.bias.copy_(0.1 * torch.randn(d, generator=gen))
    return x, y, gamma, norm.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("block", ["LayerScaleBlock", "Block"])
def test_plain_versions_are_the_eager_junction_bit_for_bit(block, d, dtype):
    x, y, gamma, norm = _block_inputs(d, dtype, seed=d)
    ls = tvit.LayerScale(d).to(dtype)
    with torch.no_grad():
        ls.gamma.copy_(gamma)
        eager_x = x + ls(y) if block == "LayerScaleBlock" else x + y
        eager_n = norm(eager_x)
        g = ls.gamma if block == "LayerScaleBlock" else None
        got_x, got_n = rn.residual_norm(x, y, g, norm.weight, norm.bias, norm.eps)
        added = rn.residual_add(x, y, g)
        normed = rn.layer_norm(x, norm.weight, norm.bias, norm.eps)
    assert got_x.dtype == got_n.dtype == dtype
    assert torch.equal(_bits(got_x), _bits(eager_x))
    assert torch.equal(_bits(got_n), _bits(eager_n))
    assert torch.equal(_bits(added), _bits(eager_x))
    assert torch.equal(_bits(normed), _bits(norm(x)))


def test_plain_versions_carry_gradients():
    """Off the card the entries are the plain versions, which autograd
    differentiates as it does the eager modules."""
    x, y, gamma, norm = _block_inputs(128, torch.float32)
    x.requires_grad_()
    s, n = rn.residual_norm(x, y, gamma.requires_grad_(), norm.weight, norm.bias, norm.eps)
    (s.sum() + n.square().sum()).backward()
    want = x.detach().clone().requires_grad_()
    s_ref = want + y * gamma.detach()
    (s_ref.sum() + norm(s_ref).square().sum()).backward()
    assert torch.allclose(x.grad, want.grad, rtol=1e-6, atol=1e-6)
    assert gamma.grad is not None


# the parent's formulas, written out: DINO's and DINOv2's blocks with their
# eager modules, then the final norm
def _parent_block(blk, x, impl="xla"):
    y, attn, qkv = blk.attn(blk.norm1(x), impl)
    ls = isinstance(blk, tvit.LayerScaleBlock)
    x = x + (blk.ls1(y) if ls else y)
    h = blk.mlp(blk.norm2(x))
    return x + (blk.ls2(h) if ls else h), attn, qkv


def _parent_forward(model, x, n):
    x = model.prepare_tokens(x)
    feats, qkvs = [], []
    for i, blk in enumerate(model.blocks):
        x, _, qkv = _parent_block(blk, x)
        if len(model.blocks) - i <= n:
            feats.append(model.norm(x))
            qkvs.append(qkv)
    return feats, qkvs


def _parent_taps(model, x, blocks):
    x = model.prepare_tokens(x)
    out = {}
    for i, blk in enumerate(model.blocks[:max(blocks) + 1]):
        x, _, _ = _parent_block(blk, x)
        out[i] = model.norm(x)[:, model.cfg.n_prefix:]
    return [out[i] for i in blocks]


VITS = {
    # ViT-S/8 at its width, 2 blocks
    "vit_s8": dict(patch_size=8, embed_dim=384, depth=2, num_heads=6, img_size=32),
    # DINOv2-style: registers, LayerScale, SwiGLU, the antialiased table
    "dinov2": dict(patch_size=14, embed_dim=256, depth=2, num_heads=4, img_size=56,
                   n_registers=2, layer_scale=True, ffn="swiglu", pos_resize="dinov2"),
    # Depth-Anything-style: LayerScale, GELU MLP, DINO's table resize
    "dav2": dict(patch_size=14, embed_dim=256, depth=4, num_heads=4, img_size=56,
                 layer_scale=True),
}


def _vit(name, dtype):
    model = tvit.VisionTransformer(tvit.ViTConfig(**VITS[name]))
    model.init_weights(torch.Generator().manual_seed(3))
    with torch.no_grad():  # LayerScale and norms off their init, so each term shows
        for p_name, p in model.named_parameters():
            if p_name.endswith(".gamma"):
                p.uniform_(0.05, 0.5, generator=torch.Generator().manual_seed(4))
            elif "norm" in p_name:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(5)))
    return model.to(dtype).requires_grad_(False)


def _stand_in_kernel(monkeypatch):
    """The kernel's device type pointed at the CPU, and its launch stood in
    by the wrapper's checks and the plain versions; the launches it took,
    as (residual, normed) pairs."""
    launches = []

    def launch(x, y, gamma, weight, bias, eps, residual, normed):
        rn._check(x, y, gamma, weight, bias)
        launches.append((residual, normed))
        s = rn.residual_add_plain(x, y, gamma) if residual else x
        return (s if residual else None,
                rn.layer_norm_plain(s, weight, bias, eps) if normed else None)

    monkeypatch.setattr(rn, "DEVICE_TYPE", "cpu")
    monkeypatch.setattr(rn, "_launch", launch)
    return launches


@pytest.fixture
def stand_in_kernel(monkeypatch):
    return _stand_in_kernel(monkeypatch)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(VITS))
def test_vit_through_the_junction_entries_is_the_parent_bit_for_bit(monkeypatch, name, dtype):
    model = _vit(name, dtype)
    ps = model.cfg.patch_size
    x = torch.randn(2, 3, 3 * ps, 4 * ps, generator=torch.Generator().manual_seed(6)).to(dtype)
    with torch.no_grad():
        want_feats, want_qkv = _parent_forward(model, x, n=2)
        eager_feats, _, _ = model(x, n=2)  # the CPU's own path: the eager modules
        if name == "dav2":
            want_taps = _parent_taps(model, x, [0, 1, 3])
            eager_taps = model.normed_taps(x, [0, 1, 3])
        launches = _stand_in_kernel(monkeypatch)
        feats, _, qkvs = model(x, n=2)
        block, norm = [(False, True), (True, True), (True, False)], [(False, True)]
        depth = model.cfg.depth
        assert launches == sum((block + norm * (depth - i <= 2) for i in range(depth)), [])
        if name == "dav2":
            taps = model.normed_taps(x, [0, 1, 3])
            assert launches[-15:] == block + norm + block + norm + block * 2 + norm
    for got, eager, want in zip(feats, eager_feats, want_feats):
        assert torch.equal(_bits(got), _bits(want)) and torch.equal(_bits(eager), _bits(want))
    for got, want in zip(qkvs, want_qkv):
        b, t, _ = want.shape
        want = want.view(b, t, 3, model.cfg.num_heads, -1).permute(2, 0, 3, 1, 4)
        assert torch.equal(_bits(got), _bits(want))
    if name == "dav2":
        for got, eager, want in zip(taps, eager_taps, want_taps):
            assert torch.equal(_bits(got), _bits(want)) and torch.equal(_bits(eager), _bits(want))


@pytest.mark.parametrize("bad", ["norm_in_float32", "gradients_on"])
def test_a_block_the_kernel_refuses_raises_on_its_device(stand_in_kernel, bad):
    """On the kernel's device a block has no eager fallback: a bf16 ViT
    with one norm left in float32 (eager would promote), or a ViT run with
    gradients on and parameters that require them, raises the wrapper's
    ValueError before any launch."""
    model = _vit("dinov2", torch.bfloat16 if bad == "norm_in_float32" else torch.float32)
    x = torch.randn(1, 3, 28, 28, generator=torch.Generator().manual_seed(6))
    if bad == "norm_in_float32":
        model.blocks[0].norm1.float()
        x = x.to(torch.bfloat16)
    else:
        model.requires_grad_(True)
    with torch.no_grad() if bad == "norm_in_float32" else torch.enable_grad():
        with pytest.raises(ValueError):
            model(x)
    assert stand_in_kernel == []


def test_layer_scale_block_reads_its_gammas_and_block_none():
    cfg = tvit.ViTConfig(**VITS["dav2"])
    blk = tvit.LayerScaleBlock(cfg)
    g1, g2 = blk.gammas()
    assert g1 is blk.ls1.gamma and g2 is blk.ls2.gamma
    assert tvit.Block(cfg).gammas() == (None, None)


@pytest.fixture
def kernel_device_cpu(monkeypatch):
    """The wrapper's checks for the kernel's device type, run on the CPU:
    a call that passed them would build and launch, which no case here
    does (``KERNEL.fn`` raises if reached)."""
    monkeypatch.setattr(rn, "DEVICE_TYPE", "cpu")

    def unreachable():
        raise AssertionError("a refused call reached the kernel")

    monkeypatch.setattr(rn.KERNEL, "fn", unreachable)


def _refused_call(bad):
    x, y, gamma, norm = _block_inputs(384, torch.bfloat16)
    w, b, eps = norm.weight.detach(), norm.bias.detach(), norm.eps
    if bad == "float16":
        return lambda: rn.residual_norm(x.half(), y.half(), gamma.half(), w.half(), b.half(), eps)
    if bad == "gamma_float32":
        return lambda: rn.residual_add(x, y, gamma.float())
    if bad == "weight_float32":
        return lambda: rn.layer_norm(x, w.float(), b, eps)
    if bad == "requires_grad":
        return lambda: rn.residual_add(x.float().requires_grad_(), y.float(), None)
    if bad == "parameter_requires_grad":
        return lambda: rn.layer_norm(x, norm.weight, norm.bias, eps)
    if bad == "width_160":
        return lambda: rn.residual_add(x[..., :160].contiguous(), y[..., :160].contiguous(),
                                       None)
    if bad == "width_2176":
        wide = torch.zeros(3, 2176, dtype=torch.bfloat16)
        return lambda: rn.residual_add(wide, wide, None)
    if bad == "y_shape":
        return lambda: rn.residual_add(x, y[:, :36].contiguous(), gamma)
    if bad == "gamma_shape":
        return lambda: rn.residual_add(x, y, gamma[:128].contiguous())
    if bad == "strided":
        return lambda: rn.residual_add(x.transpose(0, 1), y.transpose(0, 1), gamma)
    if bad == "misaligned":
        flat = torch.zeros(4 + 6 * 384, dtype=torch.bfloat16)
        view = flat[4:].view(6, 384)
        return lambda: rn.residual_add(view, view, None)
    if bad == "no_rows":
        empty = torch.zeros(0, 384, dtype=torch.bfloat16)
        return lambda: rn.layer_norm(empty, w, b, eps)
    if bad == "norm_without_weight":
        return lambda: rn.layer_norm(x, None, b, eps)
    raise KeyError(bad)


REFUSED = ["float16", "gamma_float32", "weight_float32", "requires_grad",
           "parameter_requires_grad", "width_160", "width_2176", "y_shape", "gamma_shape",
           "strided", "misaligned", "no_rows", "norm_without_weight"]


@pytest.mark.parametrize("bad", REFUSED)
def test_wrapper_refuses_what_the_kernel_cannot_take(kernel_device_cpu, bad):
    call = _refused_call(bad)
    before = rn.KERNEL.launches
    with pytest.raises(ValueError):
        call()
    assert rn.KERNEL.launches == before


def test_parameters_that_require_grad_pass_while_gradients_are_off(kernel_device_cpu):
    """Under ``torch.no_grad`` a parameter's ``requires_grad`` records
    nothing: the checks pass it, and the call goes on to the kernel."""
    x, _, _, norm = _block_inputs(384, torch.bfloat16)
    with torch.no_grad(), pytest.raises(AssertionError, match="reached the kernel"):
        rn.layer_norm(x, norm.weight, norm.bias, norm.eps)


@pytest.mark.parametrize("arch", sorted(tvit.VIT_PRESETS))
def test_every_preset_width_passes_the_checks(kernel_device_cpu, arch):
    """Each ViT preset's width (ViT-Ti's 192 included) is one the kernel
    takes, with and without LayerScale: the calls go on to the kernel."""
    d = tvit.VIT_PRESETS[arch]["embed_dim"]
    x, y, gamma, norm = _block_inputs(d, torch.bfloat16)
    with torch.no_grad():
        for call in (lambda: rn.residual_norm(x, y, gamma, norm.weight, norm.bias, norm.eps),
                     lambda: rn.residual_add(x, y, None),
                     lambda: rn.layer_norm(x, norm.weight, norm.bias, norm.eps)):
            with pytest.raises(AssertionError, match="reached the kernel"):
                call()
