"""The port's distributions against the JAX package's, on the CPU:
``log_prob``, ``entropy`` and ``kl_divergence`` of Uniform, Normal,
Categorical and MultivariateNormalDiag within 1e-5 on the same
parameters (broadcast batches among them), and ``sample`` from an
explicit generator held to shape, range, moments and seeded
determinism."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import distributions as J
from paddle_tpu_torch import distributions as P

TOL = dict(rtol=1e-5, atol=1e-5)


def R(*shape, seed=0, lo=-1.0, hi=1.0):
    rs = np.random.RandomState(seed)
    return (rs.rand(*shape) * (hi - lo) + lo).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def g(seed):
    return torch.Generator().manual_seed(seed)


def test_uniform():
    low, high = R(3, 4, seed=1, lo=-2, hi=0), R(4, seed=2, lo=0.5, hi=2)
    pu, ju = P.Uniform(low, high), J.Uniform(low, high)
    value = R(3, 4, seed=3, lo=-2.5, hi=2.5)
    _close(pu.log_prob(torch.from_numpy(value)), ju.log_prob(value))
    _close(pu.entropy(), ju.entropy())
    edge = np.stack([low[0], high[None].repeat(3, 0)[0]])
    _close(P.Uniform(low[0], high).log_prob(torch.from_numpy(edge)),
           J.Uniform(low[0], high).log_prob(edge))
    s = pu.sample(g(0), (500,))
    assert s.shape == (500, 3, 4)
    assert bool((s >= pu.low).all()) and bool((s < pu.high).all())
    np.testing.assert_allclose(s.mean(0).numpy(), (low + high) / 2,
                               atol=0.1)
    assert torch.equal(s, pu.sample(g(0), (500,)))
    assert not torch.equal(s, pu.sample(g(1), (500,)))
    assert P.Uniform(0.0, 1.0).sample(g(0)).shape == ()


def test_normal():
    loc, scale = R(2, 3, seed=4), R(3, seed=5, lo=0.3, hi=2.0)
    pn, jn = P.Normal(loc, scale), J.Normal(loc, scale)
    other_loc, other_scale = R(3, seed=6), R(2, 3, seed=7, lo=0.5, hi=1.5)
    value = R(4, 2, 3, seed=8, lo=-3, hi=3)
    _close(pn.log_prob(torch.from_numpy(value)), jn.log_prob(value))
    _close(pn.entropy(), jn.entropy())
    _close(pn.kl_divergence(P.Normal(other_loc, other_scale)),
           jn.kl_divergence(J.Normal(other_loc, other_scale)))
    _close(pn.kl_divergence(pn), jnp.zeros((2, 3)))
    s = P.Normal(1.5, 0.5).sample(g(0), (20000,))
    assert abs(float(s.mean()) - 1.5) < 0.02
    assert abs(float(s.std()) - 0.5) < 0.02
    assert pn.sample(g(2), (5,)).shape == (5, 2, 3)
    assert torch.equal(pn.sample(g(2), (5,)), pn.sample(g(2), (5,)))


def test_categorical():
    logits = R(3, 5, seed=9, lo=-2, hi=2)
    pc, jc = P.Categorical(logits), J.Categorical(logits)
    other = R(3, 5, seed=10, lo=-1, hi=3)
    for value in (np.array([0, 4, 2], np.int32), np.array([3], np.int32)):
        _close(pc.log_prob(torch.from_numpy(value)), jc.log_prob(value))
    _close(pc.entropy(), jc.entropy())
    _close(pc.kl_divergence(P.Categorical(other)),
           jc.kl_divergence(J.Categorical(other)))
    s = pc.sample(g(0), (4000,))
    assert s.shape == (4000, 3) and s.dtype == torch.int64
    freq = torch.stack([(s == k).float().mean(0) for k in range(5)], -1)
    np.testing.assert_allclose(freq.numpy(), torch.softmax(
        torch.from_numpy(logits), -1).numpy(), atol=0.03)
    assert torch.equal(s, pc.sample(g(0), (4000,)))
    assert P.Categorical(logits[0]).sample(g(1), (2, 7)).shape == (2, 7)


def test_multivariate_normal_diag():
    loc, scale = R(2, 4, seed=11), R(2, 4, seed=12, lo=0.4, hi=1.6)
    pm, jm = P.MultivariateNormalDiag(loc, scale), J.MultivariateNormalDiag(
        loc, scale)
    value = R(3, 2, 4, seed=13, lo=-2, hi=2)
    _close(pm.log_prob(torch.from_numpy(value)), jm.log_prob(value))
    _close(pm.entropy(), jm.entropy())
    oloc, oscale = R(4, seed=14), R(4, seed=15, lo=0.5, hi=2.0)
    _close(pm.kl_divergence(P.MultivariateNormalDiag(oloc, oscale)),
           jm.kl_divergence(J.MultivariateNormalDiag(oloc, oscale)))
    s = pm.sample(g(3), (8000,))
    assert s.shape == (8000, 2, 4)
    np.testing.assert_allclose(s.mean(0).numpy(), loc, atol=0.06)
    np.testing.assert_allclose(s.std(0).numpy(), scale, rtol=0.05)
    assert torch.equal(s, pm.sample(g(3), (8000,)))


@pytest.mark.parametrize("cls", ["Uniform", "Normal", "Categorical",
                                 "MultivariateNormalDiag"])
def test_the_base_class_names_the_methods(cls):
    assert issubclass(getattr(P, cls), P.Distribution)
    for meth in ("sample", "log_prob", "entropy", "kl_divergence"):
        assert callable(getattr(getattr(P, cls), meth))
    with pytest.raises(NotImplementedError):
        P.Distribution().entropy()
