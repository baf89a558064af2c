"""Program/Executor compatibility API (ref: ``paddle_tpu/static/program.py``).

``Executor.run(program, feed={name: array}, fetch_list=[names])`` calls a
named-input program on the Executor's place (the card unless the CPU is
asked for), with the reference's checks: missing feeds, the output count
against the declared names, unknown fetch names, each an ``EnforceError``.
Its cache is keyed, as the reference's, by (program, names, shapes,
dtypes); an entry is the program's callable (the port runs eagerly: the
reference's entry is a ``jax.jit``).

``check_nan_inf`` is the reference's flag as a module setting: default
False, ``PT_FLAGS_check_nan_inf`` from the environment at import,
:func:`configure` to change it. When on, every run's outputs go through
``core/enforce.check_numerics``.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.enforce import check_numerics, enforce
from paddle_tpu_torch.core.program import Program
from paddle_tpu_torch.core.settings import env_default
from paddle_tpu_torch.ops.tensor_ops import placement

_SETTINGS = {"check_nan_inf": env_default("check_nan_inf", False)}


def configure(**settings):
    """Set the module's settings (``check_nan_inf``); None leaves a
    setting as it is. Returns the settings."""
    for key, val in settings.items():
        if key not in _SETTINGS:
            raise KeyError(f"unknown static setting {key!r}")
        if val is not None:
            _SETTINGS[key] = val
    return dict(_SETTINGS)


class StaticProgram:
    """A named-input program: ``fn(**feeds) -> {name: output}`` (or a
    tuple in ``output_names`` order)."""

    def __init__(self, fn, input_names, output_names, name="main"):
        self.fn = fn
        self.input_names = list(input_names)
        self.output_names = list(output_names)
        self.name = name

    def capture(self, example_feed):
        args = [example_feed[n] for n in self.input_names]
        return Program.capture(lambda *a: self.fn(**dict(
            zip(self.input_names, a))), *args, name=self.name)


def program_from_fn(fn, input_names, output_names, name="main"):
    return StaticProgram(fn, input_names, output_names, name)


def _feed_tensor(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.asarray(value), device=device)


class Executor:
    """Runs :class:`StaticProgram`\\ s on ``place`` (ref: executor.py
    Executor)."""

    def __init__(self, place="cuda"):
        self.place = resolve_device(place)
        self._cache = {}
        self.cache_hits = 0

    def run(self, program, feed=None, fetch_list=None):
        feed = feed or {}
        enforce(set(program.input_names) <= set(feed), "missing feeds: %s",
                set(program.input_names) - set(feed))
        args = [_feed_tensor(feed[n], self.place)
                for n in program.input_names]
        key = (id(program),
               tuple((n, tuple(a.shape), str(a.dtype))
                     for n, a in zip(program.input_names, args)))
        if key in self._cache:
            self.cache_hits += 1
        else:
            names = program.input_names
            self._cache[key] = lambda *a: program.fn(**dict(zip(names, a)))
        with placement(self.place):
            outs = self._cache[key](*args)
        if _SETTINGS["check_nan_inf"]:
            check_numerics(outs, f"outputs of program '{program.name}'")
        if fetch_list is None:
            return outs
        if not isinstance(outs, dict):
            seq = outs if isinstance(outs, (list, tuple)) else (outs,)
            enforce(len(seq) == len(program.output_names),
                    "program returned %d outputs but declares %d names",
                    len(seq), len(program.output_names))
            outs = dict(zip(program.output_names, seq))
        missing = [n for n in fetch_list if n not in outs]
        enforce(not missing, "unknown fetch names: %s", missing)
        return [outs[n] for n in fetch_list]

    def train_from_dataset(self, model, optimizer, loss_fn, dataset,
                           config=None, sparse_tables=None, batch_size=None):
        """The threaded-ingestion training loop on this Executor's place
        (``static/trainer.py train_from_dataset``). The reference passes
        a jitted ``train_step`` and its state; the port's Trainer takes
        the model, optimizer and loss function."""
        from paddle_tpu_torch.static.trainer import train_from_dataset
        return train_from_dataset(model, optimizer, loss_fn, dataset,
                                  config=config, batch_size=batch_size,
                                  device=self.place,
                                  sparse_tables=sparse_tables)
