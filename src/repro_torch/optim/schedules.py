"""Learning-rate schedules: ``step -> lr`` callables on a 0-d int32
step tensor, computed on the step's device in float32 (no host sync), as
the JAX package's schedules are on traced steps.  WSD is MiniCPM's
warmup–stable–decay (arXiv:2404.06395).
"""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def _warm(s: torch.Tensor, warmup: int):
    return torch.clamp(s / max(warmup, 1), max=1.0) if warmup else 1.0


def cosine(lr: float, total_steps: int, warmup: int = 0,
           final_frac: float = 0.1):
    def fn(step):
        s = step.float()
        prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return lr * _warm(s, warmup) * (final_frac + (1 - final_frac) * cos)
    return fn


def wsd(lr: float, total_steps: int, warmup: int = 0,
        decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup → Stable (flat) → Decay: the last ``decay_frac`` of
    training decays exponentially to ``final_frac``·lr."""
    decay_start = int(total_steps * (1 - decay_frac))

    def fn(step):
        s = step.float()
        decay_prog = torch.clamp(
            (s - decay_start) / max(total_steps - decay_start, 1), 0.0, 1.0)
        return lr * _warm(s, warmup) * torch.pow(final_frac, decay_prog)
    return fn
