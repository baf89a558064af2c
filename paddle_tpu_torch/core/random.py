"""The generators a training step draws from, as JSON-safe state (ref:
``paddle_tpu/core/random.py``).

The reference keeps one global key stream and checkpoints it
(``get_state``/``set_state``). The port has no global stream: each model
draws its dropout masks from its own ``dropout_gen`` and ``Dpsgd`` its
noise from its own ``generator``. :func:`step_generators` names them for
a model and an optimizer; :func:`get_state` turns their states into lists
of ints that a checkpoint's meta sidecar can carry, and :func:`set_state`
puts them back, so a resumed or rolled-back run draws the masks the
uninterrupted run draws.
"""

import torch


def model_generators(model):
    """``{"dropout_gen": gen}`` when the model has one, else ``{}``."""
    gen = getattr(model, "dropout_gen", None)
    return {"dropout_gen": gen} if gen is not None else {}


def step_generators(model, optimizer=None):
    """The model's generators and, through any wrappers (``.inner``), the
    optimizer's (``"optimizer"``: Dpsgd's noise)."""
    gens = model_generators(model)
    while optimizer is not None:
        gen = getattr(optimizer, "generator", None)
        if gen is not None:
            gens["optimizer"] = gen
        optimizer = getattr(optimizer, "inner", None)
    return gens


def get_state(gens):
    """JSON-serializable snapshot ``{name: [byte, ...]}`` of each
    generator's state."""
    return {name: [int(b) for b in g.get_state().tolist()]
            for name, g in gens.items()}


def set_state(gens, data):
    """Restore a :func:`get_state` snapshot; None is a no-op. Every
    generator must be in the snapshot and no other."""
    if data is None:
        return
    if sorted(data) != sorted(gens):
        raise KeyError(f"generator states for {sorted(data)}, the step "
                       f"draws from {sorted(gens)}")
    for name, g in gens.items():
        g.set_state(torch.tensor(data[name], dtype=torch.uint8))
