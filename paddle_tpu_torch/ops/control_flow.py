"""Control-flow ops (ref: ``paddle_tpu/ops/control_flow.py``): loops,
conditionals, scans and the functional TensorArray.

The port is eager. Where the reference's ``lax.while_loop``, ``lax.cond``
and ``lax.switch`` decide on the device, inside one compiled program, the
port reads the predicate (or branch index) on the host: **one host read a
decision**, which on the card waits for the work queued before it. The
loops are Python loops over the body, one iteration's kernels after the
other. Nothing here is hidden behind ``torch.compile``.

The arrays of ``create_array`` / ``array_write`` / ``array_read`` /
``array_length`` stay functional, as the reference's: a write returns a
new array (the reference's ``.at[i].set``) and leaves its input as it was.
"""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.rnn import tree_leaves, tree_map
from paddle_tpu_torch.ops.tensor_ops import creation_device


def _host_bool(pred):
    """The decision, read on the host."""
    return bool(pred.item() if isinstance(pred, torch.Tensor) else pred)


def _host_int(index):
    return int(index.item() if isinstance(index, torch.Tensor) else index)


@register_op("while_loop")
def while_loop(cond, body, loop_vars):
    """``loop_vars = body(loop_vars)`` while ``cond(loop_vars)``; one host
    read of the condition an iteration (ref: ``ops/control_flow.py:20``)."""
    while _host_bool(cond(loop_vars)):
        loop_vars = body(loop_vars)
    return loop_vars


@register_op("cond")
def cond(pred, true_fn, false_fn, *operands):
    """ref: ``ops/control_flow.py:26``; one host read of ``pred``."""
    return true_fn(*operands) if _host_bool(pred) else false_fn(*operands)


@register_op("case")
def case(pred_fn_pairs, default=None):
    """The first pair whose predicate holds runs; else ``default``, else
    the last pair's function (ref: ``ops/control_flow.py:32``)."""
    for pred, fn in pred_fn_pairs:
        if _host_bool(pred):
            return fn()
    return (default if default is not None else pred_fn_pairs[-1][1])()


@register_op("switch_case")
def switch_case(branch_index, branch_fns, *operands):
    """The branch at ``branch_index``, clamped into range as
    ``lax.switch`` clamps it."""
    i = min(max(_host_int(branch_index), 0), len(branch_fns) - 1)
    return branch_fns[i](*operands)


@register_op("scan")
def scan(f, init, xs, length=None, reverse=False, unroll=1):
    """``lax.scan``: ``carry, y = f(carry, x)`` over the leading axis of
    ``xs`` (a tensor, a nest of them, or None with ``length``); returns
    ``(carry, ys)`` with the ys stacked. ``unroll`` is accepted and has
    nothing to do here."""
    del unroll
    n = length if length is not None else tree_leaves(xs)[0].shape[0]
    steps = range(n - 1, -1, -1) if reverse else range(n)
    carry, ys = init, []
    for t in steps:
        x_t = None if xs is None else tree_map(lambda a: a[t], xs)
        carry, y = f(carry, x_t)
        ys.append(y)
    if reverse:
        ys.reverse()
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *a: torch.stack(a), *ys)


@register_op("fori_loop")
def fori_loop(lower, upper, body, init):
    """``init = body(i, init)`` for ``i`` in ``[lower, upper)``."""
    for i in range(_host_int(lower), _host_int(upper)):
        init = body(i, init)
    return init


@register_op("stop_gradient")
def stop_gradient(x):
    return x.detach()


@register_op("create_array")
def create_array(size, element_shape, dtype=None, device=None):
    """A fixed-capacity TensorArray: zeros ``[size, *element_shape]``
    (f32 unless ``dtype``), on ``device`` (see ``tensor_ops.placement``)."""
    return torch.zeros((size,) + tuple(element_shape),
                       dtype=dtype if dtype is not None else torch.float32,
                       device=creation_device(device))


@register_op("array_write")
def array_write(array, i, x):
    """A new array equal to ``array`` with ``x`` at ``i``; ``array`` is
    left as it was."""
    idx = torch.as_tensor(i, device=array.device).long().reshape(1)
    return array.index_put((idx,), x.to(array.dtype)[None])


@register_op("array_read")
def array_read(array, i):
    return array[i]


@register_op("array_length")
def array_length(array):
    """The static capacity, as an int32 scalar."""
    return torch.tensor(array.shape[0], dtype=torch.int32,
                        device=array.device)


@register_op("print")
def print_op(x, message="", summarize=8):
    """Print ``message`` and the first ``summarize`` entries of x (all
    when <= 0) on the host, and return x unchanged (ref:
    ``ops/control_flow.py:107``)."""
    shown = x.reshape(-1)[:summarize] if summarize and summarize > 0 else x
    print(f"{message}{shown.detach().cpu().numpy()}")
    return x
