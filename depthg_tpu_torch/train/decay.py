"""Decay schedules as pure functions of the global step (the port's copy of
``depthg_tpu/train/decay.py``; plain Python, no array library).

The reference mutates its config in place inside ``training_step``
(``src/train_segmentation.py:352-389``) — weights/shifts decay multiplicatively
every ``decay_every_steps``, FPS sampling is switched off after
``fps_until_step``, and ``feature_samples`` shrinks (a *shape* change). Here
every schedule is a deterministic host-side function ``f(step) -> value``
computed before the train step; shape-affecting values (feature_samples,
depth_sampling mode) simply change the shapes of that step's tensors.

Event timing is preserved exactly: a mutation the reference performs at the
END of step k (when ``k % every == 0``) first affects step k+1. The legacy
``fps_sample_decay`` bug — decay fires at step 0 too
(``src/train_segmentation.py:365-375``) — is reproduced.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DecayConfig:
    depth_loss_decay: bool = False
    decay_every_steps: int = 300
    depth_loss_decay_factor: float = 1.0
    fix_depth_feat_shift: bool = False
    depth_feat_weight: float = 0.0
    depth_feat_shift: float = 0.0
    fps_until_step: int = 0
    post_fps_samples: int = 11
    fps_sample_decay: bool = False
    fps_sample_decay_every_steps: int = 300
    fps_sample_decay_factor: float = 0.9
    fps_min_samples: int = 0
    feature_samples: int = 11
    depth_sampling: str = "fps"


def from_cfg(cfg) -> DecayConfig:
    return DecayConfig(
        depth_loss_decay=bool(cfg.depth_loss_decay),
        decay_every_steps=int(cfg.decay_every_steps),
        depth_loss_decay_factor=float(cfg.depth_loss_decay_factor),
        fix_depth_feat_shift=bool(cfg.fix_depth_feat_shift),
        depth_feat_weight=float(cfg.depth_feat_weight),
        depth_feat_shift=float(cfg.depth_feat_shift),
        fps_until_step=int(cfg.fps_until_step),
        post_fps_samples=int(cfg.post_fps_samples),
        fps_sample_decay=bool(cfg.fps_sample_decay),
        fps_sample_decay_every_steps=int(cfg.fps_sample_decay_every_steps),
        fps_sample_decay_factor=float(cfg.fps_sample_decay_factor),
        fps_min_samples=int(cfg.fps_min_samples),
        feature_samples=int(cfg.feature_samples),
        depth_sampling=str(cfg.depth_sampling),
    )


def _events_before(step: int, every: int, include_zero: bool) -> int:
    """Number of end-of-step decay events strictly before ``step``."""
    if step <= 0:
        return 0
    count = (step - 1) // every  # events at every, 2*every, ... <= step-1
    if include_zero:
        count += 1  # the step-0 event (legacy bug path)
    return count


def depth_feat_weight(dcfg: DecayConfig, step: int) -> float:
    if not dcfg.depth_loss_decay:
        return dcfg.depth_feat_weight
    n = _events_before(step, dcfg.decay_every_steps, include_zero=False)
    return dcfg.depth_feat_weight * dcfg.depth_loss_decay_factor ** n


def depth_feat_shift(dcfg: DecayConfig, step: int) -> float:
    if not dcfg.depth_loss_decay or dcfg.fix_depth_feat_shift:
        return dcfg.depth_feat_shift
    n = _events_before(step, dcfg.decay_every_steps, include_zero=False)
    return dcfg.depth_feat_shift * dcfg.depth_loss_decay_factor ** n


def sampling_schedule(dcfg: DecayConfig, step: int) -> tuple[str, int]:
    """(depth_sampling mode, feature_samples) in effect for ``step``."""
    mode = dcfg.depth_sampling
    samples = dcfg.feature_samples

    if dcfg.fps_sample_decay:
        n = _events_before(step, dcfg.fps_sample_decay_every_steps, include_zero=True)
        for _ in range(n):
            samples = int(samples * dcfg.fps_sample_decay_factor)
            if samples < dcfg.fps_min_samples:
                samples = dcfg.fps_min_samples

    # fps_until_step: the reference overwrites (mode, samples) at the END of
    # every step >= until, and the sample decay (if enabled) then re-decays
    # the overwritten value on its event steps — so the step after a decay
    # event trains with int(post * factor) samples
    # (``src/train_segmentation.py:361-375``).
    if dcfg.fps_until_step > 0 and step > dcfg.fps_until_step:
        mode = "none"
        samples = dcfg.post_fps_samples
        if dcfg.fps_sample_decay and (step - 1) % dcfg.fps_sample_decay_every_steps == 0:
            samples = int(samples * dcfg.fps_sample_decay_factor)
            if samples < dcfg.fps_min_samples:
                samples = dcfg.fps_min_samples
    return mode, samples


class ExponentialDecay:
    """Generic scheduler matching ``src/depth_decay_modules.py:33-41``."""

    def __init__(self, init_value, decay_rate: float, update_every: int, min_value):
        assert decay_rate > 0
        self.init_value, self.decay_rate = init_value, decay_rate
        self.update_every, self.min_value = update_every, min_value
        self.return_type = type(init_value)

    def __call__(self, step: int):
        k = step // self.update_every
        if k == 0:
            return self.init_value
        return self.return_type(max(self.init_value * self.decay_rate ** k, self.min_value))


class LinearDecay:
    """Generic scheduler matching ``src/depth_decay_modules.py:44-52``."""

    def __init__(self, init_value, decay_rate: float, update_every: int, min_value):
        assert decay_rate > 0
        self.init_value, self.decay_rate = init_value, decay_rate
        self.update_every, self.min_value = update_every, min_value
        self.return_type = type(init_value)

    def __call__(self, step: int):
        k = step // self.update_every
        if k == 0:
            return self.init_value
        return self.return_type(max(self.init_value - k * self.decay_rate, self.min_value))


def get_depth_scheduler(version: str):
    if version == "exp":
        return ExponentialDecay
    if version == "lin":
        return LinearDecay
    raise NotImplementedError(version)
