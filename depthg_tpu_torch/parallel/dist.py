"""Data parallelism across processes: one process per GPU under ``torchrun``
(the process-group half of ``depthg_tpu/parallel/mesh.py``).

The JAX package shards the global batch over a 1-D ``"data"`` mesh and its
results equal the single-device run's. The port keeps that contract with a
``torch.distributed`` process group: rank r holds rows
``[r * B / W, (r + 1) * B / W)`` of every global batch (``P("data")``
order), and what crosses the batch is made global by a collective:

* ``all_reduce_sum`` / ``mean``: sums and means of equal shards (confusion
  blocks, the losses' pointwise means, the logs);
* ``all_gather``: the rows of every rank in rank order, autograd-aware (its
  backward gives each rank the summed gradient of its own rows);
* ``sum_with_grad``: an all-reduced sum whose backward all-reduces the
  gradient (BatchNorm's batch statistics);
* ``average_gradients``: one flat buffer of every gradient, all-reduced
  once per step;
* ``draw_rows``: a random draw shaped by the batch is drawn at the global
  batch from the step's generator on every rank, and each rank keeps its
  rows, so every rank's generator stays in step and the draws equal the
  single-process run's.

Without a process group the world is 1 and every function is the identity,
so the single-device paths are unchanged bit for bit. A group of size 1
(``torchrun --nproc_per_node 1``) runs the collectives; the all-gather is
the identity there (a gather of one rank copies its input). NCCL is the
backend for CUDA; gloo only where the caller names it. Under gloo the
gather is an all-reduce of a zero-filled global buffer (gloo has no
reduce-scatter, and no all-gather of CUDA tensors); under NCCL it is
``all_gather_into_tensor`` with a ``reduce_scatter_tensor`` backward.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as tdist

_BLOCKS = [1]  # row blocks of the batch-shaped draws (see ``row_blocks``)


def active() -> bool:
    """True inside a process group."""
    return tdist.is_available() and tdist.is_initialized()


def world() -> int:
    return tdist.get_world_size() if active() else 1


def rank() -> int:
    return tdist.get_rank() if active() else 0


def is_main() -> bool:
    return rank() == 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_from_env(backend: str | None = None, device: str = "cuda") -> int:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return the world size. Without ``WORLD_SIZE`` in the environment there
    is no group and the world is 1. ``backend`` defaults to NCCL on CUDA
    and gloo on the CPU."""
    if active():
        return world()
    if "WORLD_SIZE" not in os.environ:
        return 1
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    tdist.init_process_group(backend=backend, rank=int(os.environ["RANK"]),
                             world_size=int(os.environ["WORLD_SIZE"]))
    return world()


def check_world(n_devices) -> int:
    """The world size for an ``n_devices`` setting: ``None`` takes the
    group's size (1 without a group); a number must equal it. Raises rather
    than run on fewer devices than asked for."""
    if n_devices is None:
        return world()
    n = int(n_devices)
    if n > 1 and not active():
        raise RuntimeError(
            f"n_devices={n} needs one process per device: start the command with "
            f"torchrun --nproc_per_node {n}")
    if n != world():
        raise RuntimeError(f"n_devices={n} but the process group has {world()} ranks")
    return n


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` inside a group (the card
    the caller named outside one), or the CPU when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and active() and dev.index is None:
        return torch.device("cuda", local_rank())
    return dev


def shard_range(n: int) -> tuple[int, int]:
    """This rank's contiguous rows ``[start, stop)`` of ``n`` global rows;
    ``n`` must divide by the world."""
    w = world()
    if n % w:
        raise ValueError(f"a global batch of {n} rows does not divide over {w} ranks")
    per = n // w
    return rank() * per, (rank() + 1) * per


def shard_rows(x):
    """This rank's rows of a global batch (dim 0)."""
    start, stop = shard_range(x.shape[0])
    return x[start:stop]


def rank_share(indices) -> np.ndarray:
    """This rank's contiguous share of a global batch of item indices, the
    batch first padded with -1 (no item) to divide over the world: the rows
    ``shard_rows(pad_batch(...))`` keeps, named before anything is loaded."""
    idx = np.asarray(indices, np.int64)
    padded = np.concatenate([idx, np.full((-len(idx)) % world(), -1, np.int64)])
    start, stop = shard_range(len(padded))
    return padded[start:stop]


def pad_rows(batch: dict, n: int, fills=(("img", 0), ("label", -1))) -> dict:
    """``batch`` with each key of ``fills`` it holds padded to ``n`` rows of
    its fill value: zero images with labels -1, which the confusion blocks
    ignore. Other keys are left as they are."""
    out = dict(batch)
    for k, fill in fills:
        if k in batch and len(batch[k]) < n:
            v = np.asarray(batch[k])
            out[k] = np.concatenate([v, np.full((n - len(v), *v.shape[1:]), fill, v.dtype)])
    return out


def pad_batch(batch: dict, fills=(("img", 0), ("label", -1))) -> dict:
    """A host eval batch padded only to divide over the world."""
    n = len(batch[fills[0][0]])
    return pad_rows(batch, n + (-n) % world(), fills)


@contextlib.contextmanager
def row_blocks(k: int):
    """Inside, a batch-shaped draw covers ``k`` stacked global batches
    ([img; img_pos] of a fused pair forward): rank r keeps its rows of each."""
    _BLOCKS.append(k)
    try:
        yield
    finally:
        _BLOCKS.pop()


def draw_rows(draw, n_local: int) -> torch.Tensor:
    """``draw(n)`` makes a random tensor whose dim 0 has ``n`` rows. Draw it
    at the global batch (``n_local * world``) and keep this rank's rows, so
    every rank consumes the generator alike and holds the rows the single
    process would."""
    w = world()
    if w == 1:
        return draw(n_local)
    full = draw(n_local * w)
    k = _BLOCKS[-1]
    per = n_local // k
    return full.reshape(k, w, per, *full.shape[1:])[:, rank()].reshape(
        n_local, *full.shape[1:])


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks (no gradient); ``x`` itself outside a group."""
    if not active():
        return x
    out = x.clone()
    tdist.all_reduce(out, group=group)
    return out


def mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of equal-shard means (no gradient)."""
    if not active():
        return x
    return all_reduce_sum(x) / world()


def _gather(x: torch.Tensor, group=None) -> torch.Tensor:
    w = tdist.get_world_size(group)
    if tdist.get_backend(group) == "nccl":
        out = x.new_empty((w * x.shape[0], *x.shape[1:]))
        tdist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    out = x.new_zeros((w, *x.shape))
    out[tdist.get_rank(group)] = x
    tdist.all_reduce(out, group=group)
    return out.reshape(w * x.shape[0], *x.shape[1:])


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        w = tdist.get_world_size(group)
        grad = grad.contiguous()
        if tdist.get_backend(group) == "nccl":
            out = grad.new_empty((grad.shape[0] // w, *grad.shape[1:]))
            tdist.reduce_scatter_tensor(out, grad, group=group)
            return out, None
        total = grad.clone()
        tdist.all_reduce(total, group=group)
        per = grad.shape[0] // w
        r = tdist.get_rank(group)
        return total[r * per:(r + 1) * per], None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of ``x`` (dim 0) in rank order; the backward gives
    each rank the sum over ranks of its rows' gradient. The identity
    outside a group and at world 1."""
    if not active() or tdist.get_world_size(group) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, group)
    return _gather(x, group)


class _SumWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        tdist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        tdist.all_reduce(out)
        return out


def sum_with_grad(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks; its backward sums the gradient over ranks, the
    gradient of every rank's loss through this rank's ``x``."""
    if not active():
        return x
    return _SumWithGrad.apply(x)


def average_gradients(params) -> None:
    """Replace every gradient by its mean over ranks: one all-reduce of one
    flat buffer (each rank's loss is its shard's mean, so the mean of the
    gradients is the gradient of the global batch's loss)."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    tdist.all_reduce(flat)
    flat /= world()
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def barrier() -> None:
    if active():
        tdist.barrier()


def destroy() -> None:
    if active():
        tdist.destroy_process_group()
