"""Op registry: name -> callable, with per-op metadata.

The port's own copy of ``paddle_tpu/core/registry.py:16-56``. A
:class:`~paddle_tpu_torch.static.desc.ProgramDesc` names its ops, and
``build_fn`` resolves each name back to a callable here; ``list_ops``
gives the registered surface, which the tests hold against the
reference's.
"""

import functools


class OpRegistry:
    """Name -> callable registry with per-op metadata."""

    def __init__(self):
        self._ops = {}

    def register(self, name, fn=None, **meta):
        if fn is None:
            return functools.partial(self.register, name, **meta)
        if name in self._ops:
            raise KeyError(f"Op '{name}' already registered")
        self._ops[name] = (fn, meta)
        return fn

    def get(self, name):
        if name not in self._ops:
            raise KeyError(f"Op '{name}' is not registered")
        return self._ops[name][0]

    def meta(self, name):
        return self._ops[name][1]

    def __contains__(self, name):
        return name in self._ops

    def list_ops(self):
        return sorted(self._ops)


GLOBAL_OP_REGISTRY = OpRegistry()


def register_op(name, **meta):
    """Decorator: register a function as a named framework op::

        @register_op("softmax")
        def softmax(x, axis=-1): ...
    """
    return GLOBAL_OP_REGISTRY.register(name, **meta)
