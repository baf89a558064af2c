"""Op-level ProgramDesc: serializable op sequences run through the
registry (ref: ``paddle_tpu/static/desc.py``).

A ProgramDesc is feeds, then ops, then fetches; each op names a
registered op (``core/registry.py``) with its input and output var names
and its attrs. ``to_json`` / ``parse_from_string`` use the reference's
JSON (``"version": 1``, the same keys), so a text written by either
package parses in the other. ``build_fn`` resolves each op through
``GLOBAL_OP_REGISTRY`` into a plain function of the feeds: autograd runs
through it, and on CUDA tensors the registered ops that wrap kernels
(``layer_norm``: K1; ``multihead_attention(use_flash=True)``: K2, and K3
on the backward; ``fused_xent``: K5/K6; ``paged_decode_attention``: K7)
launch them.
"""

import dataclasses
import json

import paddle_tpu_torch.ops  # noqa: F401  (registers every op)
from paddle_tpu_torch.core.enforce import EnforceError, enforce
from paddle_tpu_torch.core.registry import GLOBAL_OP_REGISTRY


@dataclasses.dataclass
class OpDesc:
    """One op invocation (ref framework.proto:43 OpDesc)."""
    type: str
    inputs: list          # var names, positional
    outputs: list         # var names bound to (tupled) results
    attrs: dict = dataclasses.field(default_factory=dict)

    def to_dict(self):
        return {"type": self.type, "inputs": list(self.inputs),
                "outputs": list(self.outputs), "attrs": dict(self.attrs)}

    @staticmethod
    def from_dict(d):
        return OpDesc(d["type"], list(d["inputs"]), list(d["outputs"]),
                      dict(d.get("attrs", {})))


@dataclasses.dataclass
class ProgramDesc:
    """A feed -> ops -> fetch block (ref framework.proto:174 BlockDesc)."""
    feeds: list
    ops: list
    fetches: list

    def append_op(self, type_, inputs, outputs, **attrs):
        enforce(type_ in GLOBAL_OP_REGISTRY,
                "op '%s' is not registered", type_)
        self.ops.append(OpDesc(type_, list(inputs), list(outputs), attrs))
        return self

    def to_json(self):
        return json.dumps({
            "version": 1,
            "feeds": list(self.feeds),
            "fetches": list(self.fetches),
            "ops": [op.to_dict() for op in self.ops],
        }, indent=2)

    @staticmethod
    def parse_from_string(text):
        d = json.loads(text)
        enforce(d.get("version") == 1, "unsupported ProgramDesc version")
        return ProgramDesc(list(d["feeds"]),
                           [OpDesc.from_dict(o) for o in d["ops"]],
                           list(d["fetches"]))

    def build_fn(self):
        """``fn(*feeds) -> {fetch: value}`` with every op resolved through
        the registry; an op missing from it raises ``EnforceError`` naming
        the op."""
        resolved = []
        for op in self.ops:
            if op.type not in GLOBAL_OP_REGISTRY:
                raise EnforceError(
                    f"ProgramDesc op '{op.type}' is not in the op registry")
            resolved.append((GLOBAL_OP_REGISTRY.get(op.type), op))

        def fn(*args):
            enforce(len(args) == len(self.feeds),
                    "expected %d feeds, got %d", len(self.feeds), len(args))
            env = dict(zip(self.feeds, args))
            for impl, op in resolved:
                try:
                    ins = [env[n] for n in op.inputs]
                except KeyError as e:
                    raise EnforceError(
                        f"op '{op.type}' reads undefined var {e}") from e
                out = impl(*ins, **op.attrs)
                if len(op.outputs) == 1:
                    env[op.outputs[0]] = out
                else:
                    enforce(len(out) == len(op.outputs),
                            "op '%s' produced %d outputs, desc names %d",
                            op.type, len(out), len(op.outputs))
                    env.update(zip(op.outputs, out))
            missing = [n for n in self.fetches if n not in env]
            enforce(not missing, "fetch vars never produced: %s", missing)
            return {n: env[n] for n in self.fetches}

        return fn

    def to_static_program(self, name="main"):
        """The desc as a :class:`StaticProgram` for ``Executor.run``."""
        from paddle_tpu_torch.static.program import StaticProgram
        fn = self.build_fn()
        return StaticProgram(
            lambda **feeds: fn(*[feeds[n] for n in self.feeds]),
            self.feeds, self.fetches, name=name)


def program_desc(feeds, fetches):
    return ProgramDesc(list(feeds), [], list(fetches))
