"""Learning-rate schedules, the JAX package's: pure functions of the step.

The step is a tensor (an int32 device tensor in training) and so is the
result, computed on the step's device: a captured training step reads the
step counter afresh on every replay, where a Python float lr would be baked
into the graph.
"""

from __future__ import annotations

import math

import torch


def _as_step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, *, peak_lr: float, warmup_steps: int) -> torch.Tensor:
    s = _as_step(step)
    return peak_lr * torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    s = _as_step(step)
    warm = torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)
    progress = torch.clamp((s - warmup_steps) / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
    cos = final_frac + (1.0 - final_frac) * 0.5 * (1.0 + torch.cos(math.pi * progress))
    return peak_lr * warm * cos
