"""Gradient clipping (ref: ``paddle_tpu/optimizer/clip.py``).

Each clip maps the list of gradients an optimizer step holds (one per
parameter, in the optimizer's order) to a new list, before the update; no
gradient is changed in place. The global norm sums each gradient's
squares in f32.
"""

import torch


class ClipByValue:
    """ref: clip.py GradientClipByValue"""

    def __init__(self, min, max=None):
        if max is None:
            min, max = -abs(min), abs(min)
        self.min, self.max = min, max

    def __call__(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


def _scale(clip_norm, norm):
    """``min(1, clip_norm / max(norm, 1e-12))`` in f32."""
    return torch.clamp(torch.div(clip_norm, torch.clamp(norm, min=1e-12)),
                       max=1.0)


class ClipByNorm:
    """Per-tensor L2 clip (ref: clip.py GradientClipByNorm)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        return [g * _scale(self.clip_norm,
                           torch.sqrt(torch.sum(torch.square(g))))
                for g in grads]


class ClipByGlobalNorm:
    """Global-norm clip (ref: clip.py GradientClipByGlobalNorm)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        scale = _scale(self.clip_norm, global_norm(grads))
        return [(g * scale).to(g.dtype) for g in grads]


def global_norm(grads):
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.to(torch.float32))) for g in grads])))
