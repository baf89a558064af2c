"""Weight regularization (ref: ``paddle_tpu/optimizer/regularizer.py``).

Applied as a gradient transform before the update (``grad += coeff *
sign(w)`` or ``coeff * w``), on the lists of gradients and parameters an
optimizer step holds.
"""

import torch


class L2Decay:
    def __init__(self, coeff):
        self.coeff = coeff

    def __call__(self, grads, params):
        return [g + self.coeff * p for g, p in zip(grads, params)]


class L1Decay:
    def __init__(self, coeff):
        self.coeff = coeff

    def __call__(self, grads, params):
        return [g + self.coeff * torch.sign(p) for g, p in zip(grads, params)]
