"""Checkpoints: save and restore training state (ref:
``paddle_tpu/io/checkpoint.py``).

A state is a nested dict of tensors keyed by name (the Trainer's is
``{"params": {name: tensor}, "opt": <the optimizer's state_tree>}``), so
a checkpoint never depends on object ids. A step is one directory
``<path>/<step>/state.pt`` written by ``torch.save`` into a temporary
directory beside it and moved into place with ``os.replace``: a step
that :meth:`CheckpointManager.steps` lists is always whole. Beside it
``<step>.meta.json`` holds the crc32 of each tensor's raw bytes (bf16
included), with its dtype and shape, and the caller's meta (the
Trainer's data cursor, generator states and guardian state); it lands
before the step directory, so every listed step has one. A restore
checks each candidate against its crc32 manifest and degrades to the
previous step when one is corrupt or unreadable.

Not ported: orbax (JAX-side) and remote mirrors (``io/fs.py`` schemes,
``strict_mirror``), which raise.
"""

import binascii
import json
import os
import shutil

import numpy as np
import torch

from paddle_tpu_torch.testing.chaos import fault_point

META_SUFFIX = ".meta.json"
STATE_FILE = "state.pt"


def _flatten(state, prefix=""):
    """Nested dict of tensors -> ``{"a/b/c": tensor}`` in the dict's
    order (``/`` joins levels; parameter names keep their dots)."""
    out = {}
    for key, val in state.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "/"))
        else:
            out[name] = val
    return out


def _unflatten_like(template, flat, prefix=""):
    return {key: (_unflatten_like(val, flat, f"{prefix}{key}/")
                  if isinstance(val, dict) else flat[f"{prefix}{key}"])
            for key, val in template.items()}


def _raw_bytes(t):
    """A CPU tensor's bytes as a uint8 numpy view (bf16 too)."""
    return t.detach().reshape(-1).contiguous().view(torch.uint8).numpy()


def crc_manifest(state):
    """Per-tensor crc32 of the raw bytes, keyed by the flattened name,
    with dtype and shape so a reshaped corruption cannot collide."""
    man = {}
    for key, t in _flatten(state).items():
        t = torch.as_tensor(t).detach().cpu()
        man[key] = {"crc32": int(binascii.crc32(_raw_bytes(t))),
                    "dtype": str(t.dtype), "shape": list(t.shape)}
    return man


def _to_cpu(state):
    return {k: torch.as_tensor(t).detach().cpu()
            for k, t in _flatten(state).items()}


def save_persistables(state, path, step=None):
    """Save a state (ref: ``io.py:509``) as ``<path>[/<step>]/state.pt``,
    written into a temporary directory and renamed into place. Returns
    the directory."""
    path = os.path.abspath(path)
    target = os.path.join(path, str(step)) if step is not None else path
    parent = os.path.dirname(target)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp-{os.path.basename(target)}-"
                               f"{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(_to_cpu(state), f)
            f.flush()
            os.fsync(f.fileno())
        fault_point("checkpoint.save")
        if os.path.exists(target):
            shutil.rmtree(target)
        os.replace(tmp, target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return target


def load_persistables(path, template, step=None):
    """Load a state saved by :func:`save_persistables` into the structure
    of ``template`` (ref: ``io.py:787``), as CPU tensors. Every leaf must
    be present with the template's dtype and shape."""
    target = os.path.join(path, str(step)) if step is not None else path
    flat = torch.load(os.path.join(target, STATE_FILE), map_location="cpu",
                      weights_only=True)
    want = _flatten(template)
    if sorted(flat) != sorted(want):
        raise KeyError(f"checkpoint leaves differ from the template: "
                       f"{sorted(set(flat) ^ set(want))[:5]}")
    for key, like in want.items():
        like = torch.as_tensor(like)
        got = flat[key]
        if got.dtype != like.dtype or tuple(got.shape) != tuple(like.shape):
            raise ValueError(f"{key}: {got.dtype} {tuple(got.shape)} in the "
                             f"checkpoint, the template has {like.dtype} "
                             f"{tuple(like.shape)}")
    return _unflatten_like(template, flat)


def _stack_leaves(subs):
    """Stack the leaves of same-structured trees along a new axis 0
    (torch tensors with ``torch.stack``, arrays with ``np.stack``)."""
    first = subs[0]
    if isinstance(first, dict):
        return {k: _stack_leaves([s[k] for s in subs]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(subs)
    return np.stack(subs)


def _index_leaves(tree, i):
    if isinstance(tree, dict):
        return {k: _index_leaves(v, i) for k, v in tree.items()}
    return tree[i]


def _first_leaf(tree):
    while isinstance(tree, dict):
        if not tree:
            return None
        tree = next(iter(tree.values()))
    return tree


def stack_layer_tree(tree):
    """A per-layer param tree in the scan-over-layers layout (ref:
    ``io/checkpoint.py:110``): wherever a dict's keys are exactly
    ``"0".."n-1"`` and each value is a dict, the per-index subtrees are
    stacked leaf-wise along a new leading layer axis and the dict becomes
    ``{"layer": stacked}`` (:class:`nn.ScanLayers`' layout). Leaves may be
    numpy arrays or torch tensors."""
    if not isinstance(tree, dict) or not tree:
        return tree
    idx = [str(i) for i in range(len(tree))]
    if sorted(tree) == sorted(idx) and all(isinstance(tree[i], dict)
                                           for i in idx):
        return {"layer": _stack_leaves([stack_layer_tree(tree[i])
                                        for i in idx])}
    return {k: stack_layer_tree(v) for k, v in tree.items()}


def unstack_layer_tree(tree):
    """The inverse of :func:`stack_layer_tree` (ref:
    ``io/checkpoint.py:132``): every ``{"layer": stacked}`` subtree splits
    into ``{"0": ..., "n-1": ...}``, for paths that step layers one by one
    (``GPTDecoder``'s KV caches)."""
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"layer"} and isinstance(tree["layer"], dict):
        leaf = _first_leaf(tree["layer"])
        if leaf is not None:
            return {str(i): unstack_layer_tree(_index_leaves(tree["layer"],
                                                             i))
                    for i in range(leaf.shape[0])}
    return {k: unstack_layer_tree(v) for k, v in tree.items()}


def latest_step(path):
    """Newest step directory under ``path``, or None."""
    try:
        steps = [int(d) for d in os.listdir(path) if d.isdigit()]
    except (FileNotFoundError, NotADirectoryError):
        return None
    return max(steps) if steps else None


class CheckpointManager:
    """Keep-last-N rotation, the save interval, crc32 manifests and
    verified restore on a local directory (ref: ``checkpoint.py:169``)."""

    def __init__(self, path, max_to_keep=3, save_interval_steps=1,
                 strict_mirror=None):
        if "://" in str(path) or strict_mirror is not None:
            raise NotImplementedError(
                "checkpoint mirrors (io/fs.py schemes, strict_mirror) are "
                "not ported; give a local directory")
        self.path = os.path.abspath(path)
        os.makedirs(self.path, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval_steps

    def _meta_path(self, step):
        return os.path.join(self.path, f"{int(step)}{META_SUFFIX}")

    def _write_meta(self, step, state, meta):
        payload = {"step": int(step), "crc32": crc_manifest(state),
                   "meta": meta or {}}
        tmp = self._meta_path(step) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._meta_path(step))

    def read_meta(self, step):
        """The caller's meta dict saved with ``step``; {} when there is
        none."""
        try:
            with open(self._meta_path(step)) as f:
                return json.load(f).get("meta") or {}
        except (OSError, ValueError):
            return {}

    def save(self, step, state, force=False, meta=None):
        """Save when ``step`` is a multiple of the save interval, or always
        with ``force`` (a preemption flushes the step at the boundary).
        ``meta`` (JSON-serializable) rides the step's sidecar and comes
        back from :meth:`read_meta`. Returns whether the step was
        saved."""
        if not (force or step % self.save_interval == 0):
            return False
        state = _to_cpu(state)
        self._write_meta(step, state, meta)
        save_persistables(state, self.path, step)
        steps = self.steps()
        for old in steps[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.path, str(old)))
        self._prune_meta(steps[-self.max_to_keep:])
        return True

    def _prune_meta(self, keep_steps):
        keep = {int(s) for s in keep_steps}
        for name in os.listdir(self.path):
            stem = name[:-len(META_SUFFIX)]
            if (name.endswith(META_SUFFIX) and stem.isdigit()
                    and int(stem) not in keep):
                os.remove(os.path.join(self.path, name))

    def steps(self):
        """Restorable step numbers, ascending."""
        try:
            return sorted(int(d) for d in os.listdir(self.path)
                          if d.isdigit())
        except (FileNotFoundError, NotADirectoryError):
            return []

    def _manifest_mismatches(self, step, state):
        try:
            with open(self._meta_path(step)) as f:
                manifest = json.load(f).get("crc32") or {}
        except (OSError, ValueError):
            return []
        actual = crc_manifest(state)
        return [key for key, spec in manifest.items()
                if actual.get(key) != spec]

    def _restore_verified(self, step, template, verify):
        """The state of ``step`` when it loads and (with ``verify``)
        matches its manifest, else None."""
        try:
            if verify:
                fault_point("checkpoint.verify")
            state = load_persistables(self.path, template, step)
        except Exception as e:      # any unreadable step degrades
            self._last_restore_exc = e
            print(f"[checkpoint] WARNING: restore of step {step} failed "
                  f"({type(e).__name__}: {e})")
            return None
        bad = self._manifest_mismatches(step, state) if verify else []
        if bad:
            print(f"[checkpoint] WARNING: step {step} failed integrity "
                  f"verification on {len(bad)} leaves (e.g. {bad[0]!r})")
            return None
        return state

    def restore(self, template, step=None, verify=True):
        """Restore the newest healthy step (or exactly ``step``) into the
        structure of ``template``; returns ``(state, step)``, or ``(None,
        None)`` when there is no step. With ``verify`` each candidate is
        checked against its crc32 manifest and a corrupt or unreadable
        one degrades to the previous step; when every candidate fails it
        raises."""
        explicit = step is not None
        self._last_restore_exc = None
        cand = [int(step)] if explicit else self.steps()[::-1]
        for s in cand:
            state = self._restore_verified(s, template, verify)
            if state is not None:
                return state, s
        if cand:
            if explicit and self._last_restore_exc is not None:
                raise self._last_restore_exc
            raise RuntimeError(
                f"no checkpoint step under {self.path} survived integrity "
                f"verification (tried {cand})")
        return None, None
