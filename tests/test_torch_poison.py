"""Output memory that held NaN, for the card-side contract checks of the
port's kernels. It holds no tests: ``tests/test_torch_cuda.py``,
``chip_smoke.py`` and ``depthg_tpu_torch/attention_contract_study.py`` import
this one copy.

The wrappers take their outputs from ``torch.empty``, so a kernel that
leaves an element unwritten hands back whatever the memory held, which can
happen to pass. Here the memory holds NaN, and the output's address proves
it. Imports torch only.
"""

import torch

# K1: dtype -> (max abs error, relative error ||out - ref|| / ||ref||)
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 5e-3)}
# (N, n_valid, heads) of fault F6: rows < N in a 256-row block's second
# round of sub-tiles that holds no row < n_valid, which the bf16 kernel
# without a bias left unwritten (N=769: rows 640-767 at n_valid=640,
# 384-511 and 640-767 at 129); 16 heads (BEiT-L, MiDaS) at N=769, the
# eval pad's N=1664 at 6
F6_CASES = ((769, 640, 16), (769, 129, 16), (1664, 1400, 6), (1664, 1, 6))


def poisoned(call, shape, dtype):
    """``call()``'s output, written into memory that held NaN. A block of the
    output's byte size is taken on the current stream, filled with NaN and
    freed; the caching allocator hands that block to the wrapper's first
    ``torch.empty`` of the same size (it picks the best fit, and the pool is
    as it was). Raises if the output lies elsewhere: the poison is proved."""
    junk = torch.empty(shape, dtype=dtype, device="cuda")
    junk.fill_(float("nan"))  # bf16 0x7FC0, float32 0x7FC00000
    ptr = junk.data_ptr()
    del junk
    out = call()
    if out.data_ptr() != ptr:
        raise AssertionError("the output did not land in the poisoned block")
    return out


def poisoned_outputs(call, specs):
    """``call()``'s outputs, each written into memory that held NaN: as
    ``poisoned``, one block per (shape, dtype) of ``specs`` in the order the
    call allocates them, of distinct sizes. The allocator's other free
    blocks are released first, so that none of them fits an output better."""
    torch.cuda.empty_cache()
    junk = [torch.empty(shape, dtype=dtype, device="cuda").fill_(float("nan"))
            for shape, dtype in specs]
    ptrs = [j.data_ptr() for j in junk]
    del junk
    out = call()
    if [o.data_ptr() for o in out] != ptrs:
        raise AssertionError("the outputs did not land in the poisoned blocks")
    return out


def padded_bias(heads, n, dtype, gen):
    """A [heads, n, n] view of [heads, n, round_up(n, 8)] storage on the card
    (the BEiT module's layout), spread like a trained bias."""
    store = torch.randn(heads, n, -(-n // 8) * 8, device="cuda", generator=gen) * 2.0
    return store.to(dtype)[:, :, :n]


def k1_contract(att, qkv, heads, n_valid, bias):
    """K1 through ``att.attention_qkv`` into poisoned memory, against its
    contract: rows >= n_valid exactly 0, the others within ``TOL`` of
    ``att.attention_plain``, no NaN. Returns {"passes", "nan",
    "past_n_valid_nonzero", "max_abs_err", "rel_err"} (the errors over rows
    < n_valid, a NaN there counted as an infinite error)."""
    b, n, d3 = qkv.shape
    out = poisoned(lambda: att.attention_qkv(qkv, heads, 64 ** -0.5, n_valid, bias=bias),
                   (b, n, d3 // 3), qkv.dtype)
    q, k, v = att.split_qkv(qkv, heads)
    ref = att.attention_plain(q, k, v, 64 ** -0.5, n_valid, bias).permute(0, 2, 1, 3).reshape(
        out.shape)
    torch.cuda.synchronize()
    nan = int(torch.isnan(out).sum())
    past = int((out[:, n_valid:] != 0).sum())  # NaN != 0 counts too
    diff = torch.nan_to_num(out[:, :n_valid].float() - ref[:, :n_valid].float(), nan=float("inf"))
    err = diff.abs().max().item()
    rel = (diff.norm() / ref[:, :n_valid].float().norm()).item()
    atol, rtol = TOL[qkv.dtype]
    return {"passes": nan == 0 and past == 0 and err <= atol and rel <= rtol, "nan": nan,
            "past_n_valid_nonzero": past, "max_abs_err": err, "rel_err": rel}
