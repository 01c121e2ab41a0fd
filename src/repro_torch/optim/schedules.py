"""LR schedules as functions of the int32 step tensor (port of
``repro.optim.schedules``), computed in float32 on the step's device."""

from __future__ import annotations

import math

import torch


def linear_warmup(step, *, peak_lr, warmup_steps):
    s = step.to(torch.float32)
    return peak_lr * torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, *, peak_lr, warmup_steps, total_steps, min_ratio=0.1):
    s = step.to(torch.float32)
    warm = (s + 1.0) / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup_steps, warm, cos)
