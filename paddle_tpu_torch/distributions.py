"""Probability distributions (ref: ``paddle_tpu/distributions.py``):
``Uniform``, ``Normal``, ``Categorical`` and ``MultivariateNormalDiag``
with ``sample``, ``log_prob``, ``entropy`` and ``kl_divergence``.

``sample(generator, shape=())`` draws from an explicit
``torch.Generator`` (the reference's explicit PRNG key), on the
generator's device, which must be the parameters'. The draws are torch's,
so they differ from the reference's; the rest is the reference's math.
Parameters are f32 tensors on the device of the tensors given (the CPU
for Python numbers and numpy arrays).
"""

import math

import torch


def _f32(v):
    return torch.as_tensor(v).to(torch.float32)


class Distribution:
    def sample(self, generator, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    """U[low, high) (ref: ``distributions.py:30``)."""

    def __init__(self, low, high):
        self.low = _f32(low)
        self.high = _f32(high)

    def sample(self, generator, shape=()):
        shape = tuple(shape) + torch.broadcast_shapes(self.low.shape,
                                                      self.high.shape)
        u = torch.rand(shape, generator=generator, device=generator.device)
        return self.low + u * (self.high - self.low)

    def log_prob(self, value):
        value = torch.as_tensor(value, device=self.low.device)
        inside = (value >= self.low) & (value < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def entropy(self):
        return torch.log(self.high - self.low)


class Normal(Distribution):
    """N(loc, scale^2) (ref: ``distributions.py:51``)."""

    def __init__(self, loc, scale):
        self.loc = _f32(loc)
        self.scale = _f32(scale)

    def sample(self, generator, shape=()):
        shape = tuple(shape) + torch.broadcast_shapes(self.loc.shape,
                                                      self.scale.shape)
        return self.loc + self.scale * torch.randn(
            shape, generator=generator, device=generator.device)

    def log_prob(self, value):
        var = self.scale ** 2
        return (-((value - self.loc) ** 2) / (2 * var)
                - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)

    def kl_divergence(self, other):
        """KL(self || other), both Normal (ref: ``distributions.py:73``)."""
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


class Categorical(Distribution):
    """Over unnormalized logits ``[..., K]`` (ref:
    ``distributions.py:80``)."""

    def __init__(self, logits):
        self.logits = _f32(logits)

    def _log_probs(self):
        return self.logits - torch.logsumexp(self.logits, -1, keepdim=True)

    def sample(self, generator, shape=()):
        """``shape + logits.shape[:-1]`` class ids (int64)."""
        shape = tuple(shape)
        n = math.prod(shape)
        probs = torch.softmax(self.logits, -1).reshape(
            -1, self.logits.shape[-1])
        draws = torch.multinomial(probs, n, replacement=True,
                                  generator=generator)     # [batch, n]
        return draws.T.reshape(shape + tuple(self.logits.shape[:-1]))

    def log_prob(self, value):
        lp = self._log_probs()
        idx = torch.as_tensor(value, device=lp.device).long()[..., None]
        return torch.take_along_dim(lp, idx, -1)[..., 0]

    def entropy(self):
        lp = self._log_probs()
        return -torch.sum(torch.exp(lp) * lp, -1)

    def kl_divergence(self, other):
        lp = self._log_probs()
        lq = other._log_probs()
        return torch.sum(torch.exp(lp) * (lp - lq), -1)


class MultivariateNormalDiag(Distribution):
    """Diagonal Gaussian; ``scale`` holds the standard deviations ``[...,
    D]`` (ref: ``distributions.py:108``)."""

    def __init__(self, loc, scale):
        self.loc = _f32(loc)
        self.scale = _f32(scale)

    def sample(self, generator, shape=()):
        shape = tuple(shape) + tuple(self.loc.shape)
        return self.loc + self.scale * torch.randn(
            shape, generator=generator, device=generator.device)

    def log_prob(self, value):
        d = self.loc.shape[-1]
        z = (value - self.loc) / self.scale
        return (-0.5 * torch.sum(z * z, -1)
                - torch.sum(torch.log(self.scale), -1)
                - 0.5 * d * math.log(2 * math.pi))

    def entropy(self):
        d = self.loc.shape[-1]
        return (0.5 * d * (1.0 + math.log(2 * math.pi))
                + torch.sum(torch.log(self.scale), -1))

    def kl_divergence(self, other):
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * torch.sum(var_ratio + t1 - 1.0 - torch.log(var_ratio),
                               -1)
