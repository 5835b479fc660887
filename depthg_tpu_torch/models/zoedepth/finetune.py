"""ZoeDepth fine-tuning (``depthg_tpu/models/zoedepth/finetune.py``): the
depth losses and the four-group AdamW step.

* ``silog_loss``, ``grad_l1_loss``, ``compute_scale_and_shift`` and
  ``scale_shift_invariant_loss`` are the JAX package's functions: masked
  moments instead of boolean indexing (no host read, the same numbers),
  the prediction resized bilinearly (``align_corners=True``) to the
  target, a safe ``where`` before every log and every ``atan`` so the zero
  sentinels of invalid pixels give no NaN gradient.
* The optimizer is ``torch.optim.AdamW`` with four parameter groups, named
  as ``lr_group_labels`` names them: the BEiT encoder, its relative-position
  tables, the DPT decoder (readout and reassembly layers included) and the
  heads. Each group's learning rate is set before every step from this
  module's copy of optax's ``cosine_onecycle_schedule`` at the step count
  before the update (optax's ``scale_by_learning_rate``), peaking at
  ``lr / factor``. Gradients are clipped first to a global norm as
  ``optax.clip_by_global_norm`` does (scale max / norm, no epsilon).
  optax's ``adamw`` and torch's ``AdamW`` agree: decoupled decay of every
  parameter, eps outside the square root, bias correction; a parameter
  without a gradient gets a zero one, so it decays as under optax.
* ``finetune_step`` is one forward, one backward and one optimizer step
  in place, in the shape of ``train/step.py``. The training forward runs
  the eager attention (``attn_impl="xla"``, the JAX fine-tune's default):
  the attention kernel has no backward.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from depthg_tpu_torch.ops.resize import resize_bilinear

_LOG_ALPHA = 1e-7  # log(x + alpha) guard of the reference's SILog

ENCODER_PREFIX = "core.core.pretrained.model."
DECODER_PREFIXES = ("core.core.pretrained.act_postprocess", "core.core.scratch.")
GROUPS = ("encoder", "pos_enc", "midas", "head")


def _prep(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
    """[B, 1, H, W] everywhere, the prediction resized to the target's size."""
    if target.dim() == 3:
        target = target[:, None]
    if mask.dim() == 3:
        mask = mask[:, None]
    if pred.dim() == 3:
        pred = pred[:, None]
    if pred.shape[-2:] != target.shape[-2:]:
        pred = resize_bilinear(pred, target.shape[-2:], align_corners=True)
    return pred, target, mask.bool()


def silog_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
               beta: float = 0.15, return_interpolated: bool = False):
    """Scale-invariant log loss over all valid pixels of the batch jointly,
    with the unbiased variance: 10 sqrt(var(g) + beta mean(g)^2)."""
    pred, target, mask = _prep(pred, target, mask)
    w = mask.float()
    n = w.sum().clamp_min(1.0)
    p = torch.where(mask, pred, 1.0)
    t = torch.where(mask, target, 1.0)
    g = torch.log(p + _LOG_ALPHA) - torch.log(t + _LOG_ALPHA)
    mean = torch.sum(g * w) / n
    var = torch.sum((g - mean) ** 2 * w) / (n - 1.0).clamp_min(1.0)
    loss = 10.0 * torch.sqrt(var + beta * mean * mean)
    return (loss, pred) if return_interpolated else loss


def _image_grads(x: torch.Tensor, safe: torch.Tensor | None = None):
    """(squared magnitude, atan angle) of forward diffs; where ``safe`` is
    False the diffs are 1, so masked pixels emit no NaN gradient."""
    dx = x[..., 1:, 1:] - x[..., 1:, :-1]
    dy = x[..., 1:, 1:] - x[..., :-1, 1:]
    if safe is not None:
        dx = torch.where(safe, dx, 1.0)
        dy = torch.where(safe, dy, 1.0)
    return dx * dx + dy * dy, torch.atan(dy / (dx + 1e-10))


def grad_l1_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
    """L1 between the squared gradient magnitudes plus L1 between the
    gradient angles, over the mask eroded so both pixels of a diff are valid."""
    pred, target, mask = _prep(pred, target, mask)
    mg = mask[..., 1:, 1:] & mask[..., 1:, :-1] & mask[..., :-1, 1:]
    w = mg.float()
    n = w.sum().clamp_min(1.0)
    pm, pa = _image_grads(pred, mg)
    tm, ta = _image_grads(target, mg)
    return torch.sum((pm - tm).abs() * w) / n + torch.sum((pa - ta).abs() * w) / n


def compute_scale_and_shift(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
    """Per-image least-squares (scale, shift) of pred onto target over the
    mask; [B, H, W] in, two [B] out, zero where the 2x2 system is singular."""
    w = mask.float()
    a00 = torch.sum(w * pred * pred, dim=(1, 2))
    a01 = torch.sum(w * pred, dim=(1, 2))
    a11 = torch.sum(w, dim=(1, 2))
    b0 = torch.sum(w * pred * target, dim=(1, 2))
    b1 = torch.sum(w * target, dim=(1, 2))
    det = a00 * a11 - a01 * a01
    valid = det > 0
    safe_det = torch.where(valid, det, 1.0)
    s = torch.where(valid, (a11 * b0 - a01 * b1) / safe_det, 0.0)
    t = torch.where(valid, (-a01 * b0 + a00 * b1) / safe_det, 0.0)
    return s, t


def scale_shift_invariant_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
    """Masked L1 after each image's scale and shift alignment."""
    pred, target, mask = _prep(pred, target, mask)
    pred, target, mask = pred[:, 0], target[:, 0], mask[:, 0]
    s, t = compute_scale_and_shift(pred, target, mask)
    scaled = s[:, None, None] * pred + t[:, None, None]
    w = mask.float()
    return torch.sum((scaled - target).abs() * w) / w.sum().clamp_min(1.0)


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    """The reference's ``config_zoedepth.json`` train block and clip_grad."""
    lr: float = 0.000161
    wd: float = 0.01
    w_si: float = 1.0
    w_grad: float = 0.0
    beta: float = 0.15
    clip_grad: float = 0.1
    total_steps: int = 1000  # epochs x steps per epoch, for the schedule
    pct_start: float = 0.7
    div_factor: float = 1.0
    final_div_factor: float = 10000.0
    encoder_lr_factor: float = 10.0
    pos_enc_lr_factor: float = 10.0
    midas_lr_factor: float = 1.0
    same_lr: bool = False


def lr_group(name: str) -> str:
    """A parameter's group from its released-layout name: ``encoder`` (BEiT,
    but its relative-position tables, ``pos_enc``), ``midas`` (the whole DPT
    decoder: readout, reassembly, scratch) or ``head`` (everything else)."""
    if name.startswith(ENCODER_PREFIX):
        return "pos_enc" if name.endswith("relative_position_bias_table") else "encoder"
    if name.startswith(DECODER_PREFIXES):
        return "midas"
    return "head"


def lr_group_labels(model: nn.Module) -> dict:
    """{parameter name: group} for every parameter of ``model``."""
    return {name: lr_group(name) for name, _ in model.named_parameters()}


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4):
    """optax's ``cosine_onecycle_schedule``: cosine from peak/div up to the
    peak over the first int(pct_start x steps) counts, then down to
    peak / (div x final_div) at ``transition_steps``, constant after.
    Where optax's first phase would be empty (pct_start x steps < 1) it
    returns NaN; this raises instead."""
    if transition_steps <= 0:
        raise ValueError(f"transition_steps must be positive, got {transition_steps}")
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    if not bounds[0] < bounds[1] < bounds[2]:
        raise ValueError(f"a one-cycle schedule over {transition_steps} steps with pct_start "
                         f"{pct_start} has an empty phase")
    init = peak_value / div_factor
    values = (init, init * div_factor, init * div_factor / (div_factor * final_div_factor))

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (math.cos(math.pi * pct) + 1.0)
        return values[2]

    return schedule


@dataclasses.dataclass
class FinetuneState:
    model: nn.Module
    optimizer: torch.optim.AdamW
    schedules: dict  # group name -> count -> learning rate
    ftcfg: FinetuneConfig
    step: int = 0


def init_state(model: nn.Module, ftcfg: FinetuneConfig) -> FinetuneState:
    """AdamW over the model's parameters in the four groups, each with its
    one-cycle schedule peaking at ``lr / factor``."""
    factors = {"encoder": ftcfg.encoder_lr_factor, "pos_enc": ftcfg.pos_enc_lr_factor,
               "midas": ftcfg.midas_lr_factor, "head": 1.0}
    if ftcfg.same_lr:
        factors = dict.fromkeys(factors, 1.0)
    params = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        params[lr_group(name)].append(p)
    schedules = {g: cosine_onecycle_schedule(max(int(ftcfg.total_steps), 1), ftcfg.lr / factors[g],
                                             ftcfg.pct_start, ftcfg.div_factor,
                                             ftcfg.final_div_factor)
                 for g in GROUPS}
    groups = [{"params": params[g], "name": g, "lr": schedules[g](0)} for g in GROUPS if params[g]]
    opt = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8, weight_decay=ftcfg.wd)
    return FinetuneState(model, opt, schedules, ftcfg)


def finetune_loss(model: nn.Module, batch: dict, ftcfg: FinetuneConfig):
    """w_si x SILog (+ w_grad x GradL1 on the resized prediction) of the
    metric depth; ``batch``: image [B, 3, H, W], depth and mask [B, 1, Ht, Wt].
    The forward takes the eager attention: the kernel has no backward."""
    pred = model(batch["image"], attn_impl="xla")["metric_depth"]
    l_si, pred_i = silog_loss(pred, batch["depth"], batch["mask"], beta=ftcfg.beta,
                              return_interpolated=True)
    loss = ftcfg.w_si * l_si
    logs = {"loss/silog": l_si}
    if ftcfg.w_grad > 0:
        l_grad = grad_l1_loss(pred_i, batch["depth"], batch["mask"])
        loss = loss + ftcfg.w_grad * l_grad
        logs["loss/grad_l1"] = l_grad
    logs["loss/total"] = loss
    return loss, logs


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm / norm where their global norm
    is at least ``max_norm`` (optax's form); returns the norm (on the
    device: nothing here waits for it)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def apply_gradients(state: FinetuneState) -> None:
    """The update from the gradients in ``.grad``, in place: the clip, each
    group's learning rate at the current count, AdamW; the count advances."""
    opt = state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if state.ftcfg.clip_grad > 0:
        clip_by_global_norm_([p.grad for p in params], state.ftcfg.clip_grad)
    for g in opt.param_groups:
        g["lr"] = state.schedules[g["name"]](state.step)
    opt.step()
    state.step += 1


def finetune_step(state: FinetuneState, batch: dict) -> dict:
    """One step in place: forward (eager attention), one backward and
    ``apply_gradients``. Returns the logs as detached tensors on the batch's
    device."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, logs = finetune_loss(state.model, batch, state.ftcfg)
    loss.backward()
    apply_gradients(state)
    return {k: v.detach() for k, v in logs.items()}
