"""Gradient clipping (counterpart of paddle_tpu/optimizer/clip.py).

A clip maps [(param, grad), ...] to the same list with clipped grads, in
the grads' dtypes. The global norm sums the grads' squares in f32 in the
order it is given them: the train step gives them by sorted parameter
name, as the reference's `functional_update` does; an eager
`Optimizer.step()` in the optimizer's parameter order, as the reference's
eager step does.
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def _apply(self, params_grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        return self._apply(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _apply(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each grad on its own: g * clip_norm / (||g|| + 1e-12) where ||g||
    exceeds clip_norm (the norm in g's dtype, the scale rounded to it)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _apply(self, params_grads):
        out = []
        for p, g in params_grads:
            n = torch.sqrt(torch.sum(torch.square(g)))
            scale = torch.where(n > self.clip_norm,
                                self.clip_norm / (n + 1e-12),
                                torch.ones_like(n))
            out.append((p, g * scale.to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All grads by one scale, clip_norm / max(global norm, clip_norm),
    the global norm over every grad's f32 square."""

    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads):
        total = None
        for g in grads:
            s = torch.sum(torch.square(g.float()))
            total = s if total is None else total + s
        return torch.sqrt(total)

    def _apply(self, params_grads):
        if not params_grads:
            return params_grads
        gn = self.global_norm([g for _, g in params_grads])
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        return [(p, (g.float() * scale).to(g.dtype)) for p, g in params_grads]


__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]
