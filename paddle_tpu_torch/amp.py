"""Automatic mixed precision (ref: ``paddle_tpu/amp.py``).

A :class:`Policy` casts the whole model: master parameters stay f32 in
the optimizer, the forward runs on compute-dtype copies of them, the loss
comes back in f32, and the gradients reach the masters in f32. This is
the reference's whole-model cast, not ``torch.autocast`` (which picks a
dtype per op): ``minimize`` evaluates the loss through
``torch.func.functional_call`` with the cast copies in place of the
parameters and floating buffers, so autograd carries the gradient through
the casts to the masters.

bf16 needs no loss scaling. The fp16 dynamic ``LossScaler`` is not ported
and raises.
"""

import dataclasses

import torch
from torch import nn

from paddle_tpu_torch.optimizer.optimizers import Minimizer


@dataclasses.dataclass
class Policy:
    """Param storage / compute / output dtypes."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        return _cast_floating(tree, self.compute_dtype)


def _cast_floating(tree, dtype):
    """Cast the floating tensors of a dict/list/tuple tree; pass the rest
    through."""
    if isinstance(tree, dict):
        return {k: _cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def bf16_policy():
    return Policy(torch.float32, torch.bfloat16, torch.float32)


class LossScaler:
    """The fp16 dynamic loss scaler (ref: ``amp.py:57``): not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the fp16 LossScaler is not ported")


class _Bound(nn.Module):
    """``forward(*a, **k) = fn(model, *a, **k)``, so that
    ``functional_call`` can swap the model's parameters for a call of any
    loss function (``model.loss`` is not ``model.forward``)."""

    def __init__(self, model, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(self.model, *args, **kwargs)


class MixedPrecisionOptimizer(Minimizer):
    """``decorate``'s wrapper: :meth:`minimize` runs the loss on
    compute-dtype copies of the parameters and steps :attr:`inner` on the
    f32 masters, whose f32 gradients its clip and regularizer see. Its
    state is the reference's ``{"inner": ...}``."""

    def __init__(self, optimizer, policy):
        self.inner = optimizer
        self.policy = policy

    def zero_grad(self, set_to_none=True):
        self.inner.zero_grad(set_to_none=set_to_none)

    def params(self):
        return self.inner.params()

    def apply_gradients(self, loss=None, gate=None):
        return self.inner.apply_gradients(loss, gate)

    def state_tree(self, named):
        return {"inner": self.inner.state_tree(named)}

    def load_state_tree(self, named, tree):
        if "inner" not in tree:
            raise KeyError("an amp optimizer takes {'inner': state}")
        self.inner.load_state_tree(named, tree["inner"])

    def _minimize(self, model, loss_fn, args, kwargs, gate=None):
        """``loss_fn(model, *args, **kwargs)`` with every floating
        parameter and buffer cast to the compute dtype (floating inputs
        too), the loss cast to f32, its backward into the masters, and one
        update of the inner optimizer. Gradients stay on the masters after
        the step. A buffer the loss updates in place (batch norm's running
        statistics) is updated in the compute dtype and stored back at
        its own: the reference passes the state as an argument, which
        ``amp.py:179`` casts and ``amp.py:182`` casts back."""
        self.inner.zero_grad(set_to_none=True)
        params = {"model." + name: self.policy.cast_to_compute(p)
                  for name, p in model.named_parameters()}
        buffers = {"model." + name: (b, self.policy.cast_to_compute(b))
                   for name, b in model.named_buffers()}
        loss = torch.func.functional_call(
            _Bound(model, loss_fn),
            {**params, **{k: c for k, (_, c) in buffers.items()}},
            tuple(self.policy.cast_to_compute(list(args))), kwargs)
        with torch.no_grad():
            for buf, cast in buffers.values():
                buf.copy_(cast)
        loss = loss.to(torch.float32)
        loss.backward()
        loss = loss.detach()
        return loss, self.inner.apply_gradients(loss, gate)


def decorate(optimizer, policy=None, scaler=None):
    """ref: ``amp.py:152`` — wrap an optimizer (or a wrapper such as
    ``Lookahead``) so that ``minimize`` runs the forward in the compute
    dtype on f32 master weights. fp16 and a loss scaler (which fp16
    needs) are not ported."""
    policy = policy or bf16_policy()
    if scaler is not None or policy.compute_dtype == torch.float16:
        raise NotImplementedError("fp16 mixed precision needs the loss "
                                  "scaler, which is not ported")
    return MixedPrecisionOptimizer(optimizer, policy)
