"""Learning-rate schedules (ref: ``paddle_tpu/optimizer/lr_scheduler.py``).

Each schedule is a function ``step -> lr``. ``step`` is the optimizer's
int32 step count, a 0-d tensor on the parameters' device (an int is
taken too), and the rate comes back as an f32 0-d tensor on that device,
computed in f32 op by op as the reference computes it from its int32
step, so the update reads it without a host round trip. A Python scalar
divided by a tensor goes through :func:`torch.div`: torch's ``c / t``
multiplies ``c`` by ``1 / t``, which rounds differently.
"""

import math

import torch


def _step(step):
    return torch.as_tensor(step, dtype=torch.int32).to(torch.float32)


def _cos(x):
    """cos of an f32 tensor, correctly rounded to f32 (evaluated in f64):
    XLA's f32 cos is, torch's may be one ulp off, and near the end of a
    cosine schedule ``1 + cos`` cancels and magnifies that ulp."""
    return torch.cos(x.to(torch.float64)).to(torch.float32)


def constant(lr):
    def sched(step):
        return torch.full((), lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return sched


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    def sched(step):
        s = torch.clamp(_step(step), min=1.0)
        return learning_rate * d_model ** -0.5 * torch.minimum(
            s ** -0.5, s * warmup_steps ** -1.5)
    return sched


def _epochs(step, decay_steps, staircase):
    e = _step(step) / decay_steps
    return torch.floor(e) if staircase else e


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    def sched(step):
        return learning_rate * torch.pow(
            decay_rate, _epochs(step, decay_steps, staircase))
    return sched


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    def sched(step):
        return learning_rate * torch.exp(
            -decay_rate * _epochs(step, decay_steps, staircase))
    return sched


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    def sched(step):
        return torch.div(learning_rate, 1.0 + decay_rate * _epochs(
            step, decay_steps, staircase))
    return sched


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    def sched(step):
        s = _step(step)
        if cycle:
            ds = decay_steps * torch.clamp(torch.ceil(s / decay_steps),
                                           min=1.0)
        else:
            ds = decay_steps
            s = torch.clamp(s, max=decay_steps)
        return (learning_rate - end_learning_rate) * \
            torch.pow(1.0 - s / ds, power) + end_learning_rate
    return sched


def piecewise_decay(boundaries, values):
    def sched(step):
        s = _step(step)
        lr = torch.full((), values[0], dtype=torch.float32, device=s.device)
        for b, v in zip(boundaries, values[1:]):
            lr = torch.where(s >= b, v, lr)
        return lr
    return sched


def cosine_decay(learning_rate, step_each_epoch, epochs):
    def sched(step):
        ep = torch.floor(_step(step) / step_each_epoch)
        return learning_rate * 0.5 * (_cos(ep * math.pi / epochs) + 1.0)
    return sched


def cosine_decay_steps(learning_rate, total_steps, min_lr=0.0):
    """Continuous cosine over steps (modern variant)."""
    def sched(step):
        t = torch.clamp(_step(step) / total_steps, max=1.0)
        return min_lr + (learning_rate - min_lr) * 0.5 * (
            1 + _cos(math.pi * t))
    return sched


def linear_lr_warmup(base_sched, warmup_steps, start_lr, end_lr):
    base = base_sched if callable(base_sched) else constant(base_sched)

    def sched(step):
        s = _step(step)
        warm = start_lr + (end_lr - start_lr) * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, base(step))
    return sched


def make_schedule(lr):
    """Normalize float | callable to a schedule fn."""
    return lr if callable(lr) else constant(lr)
