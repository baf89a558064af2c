"""Captured Program IR (ref: ``paddle_tpu/core/program.py``).

The reference's Program is a traced JAX function: a jaxpr in memory and
StableHLO as its serialized form. The port's is a function traced with
``make_fx`` (on fake copies of the example arguments, so nothing runs):
an FX graph of aten ops and of the kernels' ``torch.library`` ops
(``paddle_tpu_torch::<kernel>``, ``ops/cuda/core.py define_op``) in
memory, and ``torch.export`` as the serialized form, as
``io/inference.py`` exports.

Changes from the reference, each for want of its JAX counterpart:

* the port has no StableHLO: :meth:`Program.lower` returns the
  ``torch.export`` ``ExportedProgram`` and :meth:`Program.to_text` its
  text, where the reference's ``to_stablehlo`` gives StableHLO text;
* :meth:`Program.compile` returns the eager callable (the reference's
  ``jax.jit``; no ``torch.compile`` here);
* :func:`flop_estimate` counts with ``torch.utils.flop_counter``'s
  ``FlopCounterMode`` on meta copies (2·m·n·k a product, as XLA's cost
  analysis counts), where the reference asks XLA's cost analysis.
"""

import collections

import torch
from torch.fx.experimental.proxy_tensor import make_fx

#: an input's or output's shape and dtype (the reference's ``aval``)
Aval = collections.namedtuple("Aval", "shape dtype")


def op_name(target):
    """A graph node's op as the program lists it: an aten op by its bare
    name (``tanh``), any other library op as ``namespace::name``."""
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        ns = target.namespace
        base = packet.__name__
        return base if ns == "aten" else f"{ns}::{base}"
    return getattr(target, "__name__", str(target))


def _aval(node):
    val = node.meta.get("val")
    return Aval(tuple(val.shape), val.dtype) if val is not None else None


class Program:
    """A captured computation: the callable and its traced graph."""

    def __init__(self, fn, graph=None, example_args=None, name="program"):
        self.fn = fn
        self.graph = graph
        self.example_args = example_args
        self.name = name

    @staticmethod
    def capture(fn, *example_args, name="program", **example_kwargs):
        """Trace ``fn(*example_args, **example_kwargs)`` with ``make_fx``
        on fake copies of the arguments. On CUDA tensors the kernel
        wrappers call their ops, which trace through their fake
        implementations; on CPU tensors they take the plain versions."""
        gm = make_fx(lambda *a: fn(*a, **example_kwargs),
                     tracing_mode="fake")(*example_args)
        return Program(fn, graph=gm, example_args=example_args, name=name)

    def _nodes(self, op):
        if self.graph is None:
            raise ValueError("Program not captured; call Program.capture")
        return [n for n in self.graph.graph.nodes if n.op == op]

    # --- introspection (the OpDesc-level view of the captured graph) ---
    def ops(self):
        """The graph's op names in program order."""
        return [op_name(n.target) for n in self._nodes("call_function")]

    def num_ops(self):
        return len(self.ops())

    def input_avals(self):
        return [_aval(n) for n in self._nodes("placeholder")]

    def output_avals(self):
        out = self._nodes("output")[0]
        leaves = torch.utils._pytree.tree_leaves(out.args[0])
        return [_aval(n) for n in leaves if isinstance(n, torch.fx.Node)]

    # --- lowering / serialization ---
    def lower(self, *args):
        """The ``torch.export`` program of ``fn`` on ``args`` (the example
        arguments by default): the reference's ``lower``/StableHLO."""
        args = args or self.example_args
        gm = make_fx(self.fn, tracing_mode="fake")(*args)
        return torch.export.export(gm, tuple(args), strict=False)

    def to_text(self, *args):
        """The exported program's text (the reference's
        ``to_stablehlo``)."""
        return str(self.lower(*args))

    def compile(self, *args):
        """The eager callable."""
        return self.fn

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def flop_estimate(fn, *example_args):
    """FLOPs of ``fn(*example_args)`` counted by ``FlopCounterMode`` on
    meta copies of the tensor arguments: the kernels take their plain
    versions there, so their products count, and nothing runs."""
    from torch.utils.flop_counter import FlopCounterMode

    from paddle_tpu_torch.ops.cuda import core
    margs = [torch.empty_like(a, device="meta")
             if isinstance(a, torch.Tensor) else a for a in example_args]
    with core.shapes_only(), FlopCounterMode(display=False) as counter:
        fn(*margs)
    return float(counter.get_total_flops())
