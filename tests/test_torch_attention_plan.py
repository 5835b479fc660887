"""The attention wrapper's launch plan and its packed-qkv path, on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
what the wrapper decides before a launch is plain Python and is held here:

* ``block_plan``, the bias-free bf16 grid (256-row blocks per (image,
  head), then 128-row blocks), at the shapes the main paths launch: the
  serving buckets' N=1601 at B=1-32, MiDaS's B=8, N=769, 16 heads, the eval
  and train steps;
* ``plan_blocks``: every choice covers each (image, head)'s rows [0, N)
  once, in the order ``csrc/attention.cu`` ``bf16_block`` decodes;
* ``qkv_operands``: the pointers and strides the packed path hands the
  kernel are those of ``split_qkv``'s views;
* ``ARGS``: the packed arguments' layout is the C entry's ``LaunchArgs``;
* the checks that the packed path makes on ``qkv`` itself raise as those
  of the [B, H, N, 64] views do (on a ``meta`` tensor, which reaches the
  path without a card).
"""

import re
from pathlib import Path

import pytest
import torch

from depthg_tpu_torch.ops import attention as tatt

CSRC = Path(tatt.__file__).resolve().parents[1] / "csrc" / "attention.cu"

# (B, heads, N, n_valid) -> 256-row blocks per (image, head) on 132 SMs
PLAN_TABLE = {
    (1, 6, 1601, 1601): 0,     # served bucket 1 without stacked TTA: 78 blocks, one wave
    (2, 6, 1601, 1601): 7,     # bucket 1 (stacked TTA): 84 blocks of 256 rows fit one wave
    (4, 6, 1601, 1601): 5,     # bucket 2
    (8, 6, 1601, 1601): 5,     # bucket 4
    (16, 6, 1601, 1601): 7,    # the eval step: the grid designed at it
    (32, 6, 1601, 1601): 7,    # bucket 16: 10.2 waves, the gain under PLAN_MARGIN
    (8, 16, 769, 769): 3,      # MiDaS: the one-row blocks at the grid's end
    (32, 6, 785, 785): 4,      # the train step: its tail order's gain under PLAN_MARGIN
    (16, 6, 1664, 1601): 7,    # the eval step padded to 1664 rows
}


@pytest.mark.parametrize("shape,big", list(PLAN_TABLE.items()),
                         ids=[f"b{b}_h{h}_n{n}_valid{nv}" for b, h, n, nv in PLAN_TABLE])
def test_block_plan_at_the_main_paths_shapes(shape, big):
    assert tatt.block_plan(*shape, sms=132) == big


@pytest.mark.parametrize("b,h,n,nv", [(1, 6, 1601, 1601), (3, 2, 769, 640), (2, 16, 769, 769),
                                      (1, 2, 1, 1), (2, 2, 128, 64), (2, 2, 257, 129),
                                      (5, 3, 1201, 1201), (2, 6, 1664, 1)])
def test_every_plan_covers_each_row_once(b, h, n, nv):
    """Each choice from ceil(N / 256) down to 0 gives every (image, head)
    the rows [0, N) exactly once, 256-row blocks before 128-row ones, and as
    many blocks as ``csrc/attention.cu`` launches."""
    top = -(-n // 256)
    assert 0 <= tatt.block_plan(b, h, n, nv) <= top
    for big in range(top + 1):
        blocks = tatt.plan_blocks(b, h, n, big)
        small = max(0, -(-(n - 256 * big) // 128))
        assert len(blocks) == (big + small) * b * h
        # the blocks of each (image, head): its big ones, then its small ones
        assert blocks == blocks[:big] * (b * h) + blocks[big * b * h:][:small] * (b * h)
        mine = blocks[:big] + blocks[big * b * h:][:small]
        assert [size for _, size in mine] == [256] * big + [128] * small
        covered = torch.zeros(n, dtype=torch.int64)
        for q0, size in mine:
            covered[q0:min(q0 + size, n)] += 1
        assert torch.all(covered == 1)


def test_block_cost_follows_the_kernels_walk():
    """A block walks its second round only where it holds a row < n_valid,
    its second warpgroup only where rows past its first 64 do."""
    cost = tatt.BLOCK_COST
    assert tatt.block_cost(0, 256, 1601) == cost[(2, 2)]
    assert tatt.block_cost(1536, 256, 1601) == cost[(1, 2)]  # rows 1536-1600
    assert tatt.block_cost(1536, 128, 1601) == cost[(1, 2)]
    assert tatt.block_cost(768, 256, 769) == cost[(1, 1)]    # one row
    assert tatt.block_cost(768, 128, 785) == cost[(1, 1)]    # 17 rows
    assert tatt.block_cost(128, 128, 192) == cost[(1, 1)]    # 64 rows
    assert tatt.block_cost(128, 128, 193) == cost[(1, 2)]


@pytest.mark.parametrize("view", ["contiguous", "batch_slice", "token_slice", "last_axis_slice"])
def test_packed_operands_are_split_qkvs_views(view):
    base = torch.randn(3, 40, 3 * 4 * 64 + 64)
    qkv = {"contiguous": base[..., :768].contiguous(), "batch_slice": base[1:, :, :768],
           "token_slice": base[:, 5:37, :768], "last_axis_slice": base[:, :, 64:]}[view]
    ops = tatt.qkv_operands(qkv, 4)
    views = list(tatt.split_qkv(qkv, 4))
    assert ops[0] == (views[0].data_ptr(), views[0].stride())
    for (ptr, strides), t in zip(ops[1:], views[1:]):
        assert (ptr, strides) == (t.data_ptr(), t.stride()[:3])


def test_packed_arguments_match_the_c_entry():
    """``ARGS`` packs the fields of ``LaunchArgs`` in their order and sizes
    (pointers, long longs, ints, the float, padding to 8 bytes)."""
    src = CSRC.read_text()
    body = re.search(r"struct LaunchArgs \{(.*?)\};", src, re.S).group(1)
    codes = {"void*": "Q", "long long": "q", "int": "i", "float": "f"}
    fmt = ""
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        typ = next(t for t in ("long long", "void", "int", "float") if t in decl)
        names = decl.split(typ, 1)[1].split(",")
        for name in names:
            count = int(re.search(r"\[(\d+)\]", name).group(1)) if "[" in name else 1
            code = codes["void*" if typ == "void" else typ]
            fmt += code * count
    assert re.sub(r"(\d+)(\w)", lambda m: m.group(2) * int(m.group(1)),
                  tatt.ARGS.format.lstrip("<").replace("4x", "")) == fmt
    assert tatt.ARGS.size % 8 == 0


@pytest.mark.parametrize("bad,match", [
    ("head_dim", "head_dim 64"), ("factor", "does not factor"), ("dtype", "float32 or bfloat16"),
    ("n_valid", "n_valid must be"), ("bias_shape", "bias must be"),
    ("bias_dtype", "float32 or bfloat16"), ("valid", "needs CUDA tensors")])
def test_packed_path_checks_raise_as_the_views_do(bad, match):
    """On a device other than the CPU ``attention_qkv`` checks ``qkv``
    itself; each refusal raises as it does on the CPU path's views, and a
    call the kernel could take refuses the device (a ``meta`` tensor: no
    card is needed to reach the path)."""
    kwargs = dict(num_heads=2, scale=0.125, n_valid=None, bias=None)
    qkv = torch.empty(1, 64, 3 * 128, device="meta")
    if bad == "head_dim":
        kwargs["num_heads"] = 4
    elif bad == "factor":
        kwargs["num_heads"] = 5
    elif bad == "dtype":
        qkv = qkv.half()
    elif bad == "n_valid":
        kwargs["n_valid"] = 65
    elif bad == "bias_shape":
        kwargs["bias"] = torch.empty(2, 64, 63, device="meta")
    elif bad == "bias_dtype":
        kwargs["bias"] = torch.empty(2, 64, 64, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        tatt.attention_qkv(qkv, **kwargs)
    if bad != "valid":
        with pytest.raises(ValueError, match=match):
            tatt.attention_qkv(torch.zeros(qkv.shape, dtype=qkv.dtype), **{
                **kwargs, "bias": None if kwargs["bias"] is None else torch.zeros(
                    kwargs["bias"].shape, dtype=kwargs["bias"].dtype)})
