"""Checkpoints: save and restore training state (ref:
``paddle_tpu/io/checkpoint.py``).

A state is a nested dict of tensors keyed by name (the Trainer's is
``{"params": {name: tensor}, "opt": <the optimizer's state_tree>,
"buffers": {name: tensor}}``), so a checkpoint never depends on object
ids. A step is one directory ``<path>/<step>/state.pt`` written by
``torch.save`` into a temporary directory beside it and moved into place
with ``os.replace``: a step that :meth:`CheckpointManager.steps` lists
is always whole. Beside it ``<step>.meta.json`` holds the crc32 of each
tensor's raw bytes (bf16 included), with its dtype and shape, and the
caller's meta (the Trainer's data cursor, generator states and guardian
state); it lands before the step directory, so every listed step has
one. A restore checks each candidate against its crc32 manifest and
degrades to the previous step when one is corrupt or unreadable.

Saves run in the background, as the reference's orbax saves do:
:meth:`CheckpointManager.save` snapshots the state with copies on the
current stream, so the next step's in-place updates on that stream come
after them (a device clone when the card has room, else pinned host
memory; a CPU tensor is cloned), and hands the write to one writer
thread, which copies the device snapshot into pinned buffers (one a
dtype) on a stream of its own, keeps them for the next save, and writes
them. :meth:`wait` makes
every queued save durable and raises the first failure of any;
:meth:`close` drains, stops the thread and gives a queued mirror push a
last try. ``restore`` waits first. ``background=False`` writes inside
``save``.

A scheme path (``mem://bucket/ck``, ``io/fs.py``) stages under a
deterministic local directory (a hash of the path under the temporary
directory) and every saved step is mirrored to the remote tree with the
integrity manifest and, last, a ``COMMIT`` marker: discovery and restore
see only committed steps, so a torn push is never resumed from. A push
that fails after retries is queued for the next save
(``checkpoint.mirror_degraded``) unless ``strict_mirror``, when it
raises from ``wait``/``close``. A host with an empty staging directory
restores from the remote tree.

The reference's ``strict_mirror`` flag (default False) is a module
setting, with ``background`` (True): change them with :func:`configure`.
"""

import hashlib
import json
import os
import queue
import shutil
import tempfile
import threading
import zlib

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.testing.chaos import fault_point

META_SUFFIX = ".meta.json"
STATE_FILE = "state.pt"
#: pushed last into each mirrored step directory: its presence commits it
COMMIT_MARKER = "COMMIT"
#: the integrity manifest's name inside a mirrored step directory
META_NAME = "INTEGRITY.json"

_SETTINGS = {"strict_mirror": False, "background": True}


def configure(strict_mirror=None, background=None):
    """Set the defaults of new managers; None leaves a setting as it is.
    Returns the settings."""
    for key, val in (("strict_mirror", strict_mirror),
                     ("background", background)):
        if val is not None:
            _SETTINGS[key] = bool(val)
    return dict(_SETTINGS)


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
    with dtype and shape so a reshaped corruption cannot collide.
    ``zlib.crc32`` (the reference's ``binascii.crc32``, the same sum)
    lets other threads run while it reads a large tensor."""
    man = {}
    for key, t in _flatten(state).items():
        t = torch.as_tensor(t).detach().cpu()
        man[key] = {"crc32": int(zlib.crc32(_raw_bytes(t))),
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
        file = os.path.join(tmp, STATE_FILE)
        # a path, not a Python file: torch's writer then writes each
        # tensor's bytes with other threads free to run
        torch.save(_to_cpu(state), file)
        fd = os.open(file, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        fault_point("checkpoint.save")
        if os.path.exists(target):
            shutil.rmtree(target)
        os.replace(tmp, target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return target


def load_persistables(path, template, step=None, optional=()):
    """Load a state saved by :func:`save_persistables` into the structure
    of ``template`` (ref: ``io.py:787``), as CPU tensors. Every leaf must
    be present with the template's dtype and shape, but for a top-level
    key in ``optional`` that the checkpoint lacks whole: its template
    leaves come back as they are, with a warning (a checkpoint written
    before the key existed)."""
    target = os.path.join(path, str(step)) if step is not None else path
    flat = torch.load(os.path.join(target, STATE_FILE), map_location="cpu",
                      weights_only=True)
    want = _flatten(template)
    for key in optional:
        sub = _flatten({key: template.get(key, {})})
        if sub and not any(k in flat for k in sub):
            print(f"[checkpoint] WARNING: {target} holds no {key!r}; "
                  f"keeping the current {key}")
            flat.update({k: torch.as_tensor(v) for k, v in sub.items()})
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


def _snapshot(state):
    """The state flattened to tensors that no later step writes, and the
    CUDA event after their copies (None when every leaf was on the CPU).
    A device tensor is copied on the current stream, so kernels queued on
    it after this (the next step's in-place updates) run after the copy:
    into a device clone when the card has room for two of the state's
    device bytes (a few milliseconds of the loop; the writer moves it to
    the host), else without blocking into pinned host memory (whose
    allocation then costs the loop about a second a GB). A CPU tensor is
    cloned."""
    flat = {k: torch.as_tensor(t).detach() for k, t in _flatten(state).items()}
    dev = [t for t in flat.values() if t.is_cuda]
    need = sum(t.numel() * t.element_size() for t in dev)
    on_device = bool(dev) and torch.cuda.mem_get_info(dev[0].device)[0] \
        > 2 * need
    out = {}
    for key, t in flat.items():
        if not t.is_cuda:
            out[key] = t.clone(memory_format=torch.contiguous_format)
        elif on_device:
            out[key] = t.clone()
        else:
            out[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out[key].copy_(t, non_blocking=True)
    event = None
    if dev:
        event = torch.cuda.Event()
        event.record()
    return out, event


def _dtype_sizes(tensors):
    """``{dtype: elements}`` of the CUDA tensors among ``tensors``."""
    sizes = {}
    for t in tensors:
        if t.is_cuda:
            sizes[t.dtype] = sizes.get(t.dtype, 0) + t.numel()
    return sizes


def _to_host(flat, event, staging):
    """Wait for a snapshot's copies and bring its device clones to the
    host: each into its slice of a pinned buffer of its dtype
    (``staging({dtype: elements})`` returns them), copied on a stream of
    their own, so neither the training stream nor its launches wait.
    Returns the host tensors; the device clones are freed by the caller
    dropping them."""
    if event is None:
        return flat
    event.synchronize()
    sizes = _dtype_sizes(flat.values())
    if not sizes:
        return flat
    bufs = staging(sizes)
    stream = torch.cuda.Stream(device=next(
        t.device for t in flat.values() if t.is_cuda))
    out, off = {}, dict.fromkeys(sizes, 0)
    with torch.cuda.stream(stream):
        for key, t in flat.items():
            if not t.is_cuda:
                out[key] = t
                continue
            at = off[t.dtype]
            host = bufs[t.dtype][at:at + t.numel()].view(t.shape)
            host.copy_(t, non_blocking=True)
            out[key] = host
            off[t.dtype] = at + t.numel()
    stream.synchronize()
    return out


_STOP = object()


class CheckpointManager:
    """Keep-last-N rotation, the save interval, crc32 manifests, verified
    restore, background saves and remote mirrors (ref:
    ``checkpoint.py:160``). A context manager: leaving it closes it."""

    def __init__(self, path, max_to_keep=3, save_interval_steps=1,
                 strict_mirror=None, background=None):
        from paddle_tpu_torch.io import fs as _fs
        self.strict_mirror = bool(_SETTINGS["strict_mirror"]
                                  if strict_mirror is None
                                  else strict_mirror)
        self.background = bool(_SETTINGS["background"] if background is None
                               else background)
        self._mirror_pending = []       # steps whose remote push failed
        scheme, _ = _fs.split_scheme(path)
        if scheme is not None:
            # a deterministic staging directory: the same remote path
            # stages in the same place, so a restarted worker restores
            # what it staged
            self._remote = str(path).rstrip("/")
            self._fs = _fs
            tag = hashlib.sha1(self._remote.encode()).hexdigest()[:16]
            self.path = os.path.join(tempfile.gettempdir(),
                                     "pt_torch_ckpt_staging", tag)
        else:
            self._remote = None
            self.path = os.path.abspath(path)
        os.makedirs(self.path, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval_steps
        self._last_saved = None         # the newest step handed to save
        self._queue = None              # the writer thread's jobs
        self._thread = None
        self._errors = []               # failures of background writes
        self._lock = threading.Lock()
        self._pinned = None             # the writer's staging buffers

    # -- the writer --------------------------------------------------------
    def _start_writer(self):
        self._queue = queue.Queue(maxsize=1)
        self._thread = threading.Thread(target=self._writer_loop,
                                        daemon=True, name="checkpoint-save")
        self._thread.start()

    def _writer_loop(self):
        while True:
            job = self._queue.get()
            try:
                if job is _STOP:
                    return
                self._write(job)
            except BaseException as e:   # noqa: B036 - raised by wait()
                with self._lock:
                    self._errors.append(e)
            finally:
                self._queue.task_done()

    def _write(self, job):
        """Make one snapshot ``[step, tensors, event, meta]`` durable: its
        tensors to the host (the device clones freed at once), manifest,
        state file, rename, pruning, then the mirror push."""
        step, flat, event, meta = job
        flat = job[1] = _to_host(flat, event, self._staging)
        self._write_meta(step, flat, meta)
        save_persistables(flat, self.path, step)
        steps = self._local_steps()
        for old in steps[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.path, str(old)),
                          ignore_errors=True)
        _metrics.counter("checkpoint.saves").inc()
        self._mirror_save(step)
        self._prune_meta(self._local_steps())

    def _staging(self, sizes):
        """The pinned buffers, one a dtype, that the writer stages device
        snapshots in: kept from save to save (a pinned allocation costs
        about half a second a GB), each sized to the snapshot's elements
        of its dtype, since ``torch.save`` writes a buffer whole."""
        if self._pinned is None or {d: t.numel() for d, t in
                                    self._pinned.items()} != sizes:
            self._pinned = None
            self._pinned = {d: torch.empty(n, dtype=d, pin_memory=True)
                            for d, n in sizes.items()}
        return self._pinned

    def reserve(self, state):
        """Allocate the pinned staging buffers for a state of this form now
        (before a loop starts), so that the first save does not: the loop's
        launches wait while a pinned allocation pins its pages."""
        sizes = _dtype_sizes(torch.as_tensor(t)
                             for t in _flatten(state).values())
        if sizes:
            self._staging(sizes)

    def _raise_pending(self):
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    def wait(self):
        """Block until every queued save is durable (mirror push
        included); raise the first failure of a background write."""
        if self._queue is not None:
            self._queue.join()
        self._raise_pending()

    def close(self):
        """Drain the queued saves, give a queued mirror push one last try,
        and stop the writer thread. Raises a background write's failure
        after the thread has stopped. The manager can save again after."""
        try:
            if self._queue is not None:
                self._queue.join()
            if self._remote is not None and self._mirror_pending:
                try:
                    self._mirror_save(self._mirror_pending[-1])
                except Exception as e:
                    print(f"[checkpoint] WARNING: final mirror flush failed "
                          f"({e!r}); steps {self._mirror_pending} remain "
                          "local-only")
        finally:
            if self._thread is not None:
                self._queue.put(_STOP)
                self._thread.join()
                self._thread = self._queue = None
            self._pinned = None
        self._raise_pending()
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- mirrors -------------------------------------------------------------
    def _mirror_one(self, step):
        """Publish one staged step: clear a torn remnant, push the files,
        the integrity manifest, then the COMMIT marker last."""
        dst = f"{self._remote}/{step}"
        if self._fs.fs_exists(dst):
            self._fs.remove_tree(dst)
        self._fs.put_tree(os.path.join(self.path, str(step)), dst)
        meta = self._meta_path(step)
        if os.path.exists(meta):
            with open(meta, "rb") as src:
                payload = src.read()
            with self._fs.fs_open(f"{dst}/{META_NAME}", "wb") as f:
                f.write(payload)
        with self._fs.fs_open(f"{dst}/{COMMIT_MARKER}", "wb") as f:
            f.write(b"committed")

    def _mirror_save(self, step):
        """Push the step and any earlier step whose push failed, then
        prune the remote tree by committed-step retention (never by the
        local listing: a fresh host stages only what it touched). A push
        that still fails after retries is queued for the next save, or
        raised with ``strict_mirror``."""
        if self._remote is None:
            return
        fault_point("checkpoint.mirror")
        todo = [s for s in self._mirror_pending
                if os.path.isdir(os.path.join(self.path, str(s)))]
        if step not in todo:
            todo.append(step)
        failed = []
        for s in sorted(todo):
            try:
                self._mirror_one(s)
            except Exception as e:
                _metrics.counter("checkpoint.mirror_degraded").inc()
                if self.strict_mirror:
                    self._mirror_pending = [x for x in sorted(todo)
                                            if x >= s]
                    raise
                failed.append(s)
                print(f"[checkpoint] WARNING: mirror of step {s} to "
                      f"{self._remote} failed after retries ({e!r}); "
                      "queued for next save")
        self._mirror_pending = failed
        committed = sorted(self._remote_steps())
        if committed and not failed:
            cutoff = committed[-self.max_to_keep:][0]
            for name in self._fs.listdir(self._remote):
                if name.isdigit() and int(name) < cutoff:
                    self._fs.remove_tree(f"{self._remote}/{name}")

    def _remote_steps(self, committed_only=True):
        """Steps in the remote tree; by default only those whose COMMIT
        landed (a torn step is skipped and counted)."""
        if self._remote is None or not self._fs.fs_exists(self._remote):
            return []
        steps = []
        for n in self._fs.listdir(self._remote):
            if not n.isdigit():
                continue
            if committed_only and not self._fs.fs_exists(
                    f"{self._remote}/{n}/{COMMIT_MARKER}"):
                _metrics.counter("checkpoint.torn_skips").inc()
                continue
            steps.append(int(n))
        return steps

    def _fetch_remote(self, step):
        """Pull a committed remote step into staging when it is not
        staged; a step without COMMIT is refused."""
        if self._remote is None:
            return
        local = os.path.join(self.path, str(step))
        if os.path.isdir(local):
            return
        fault_point("checkpoint.fetch")
        enforce(self._fs.fs_exists(
            f"{self._remote}/{step}/{COMMIT_MARKER}"),
            f"remote checkpoint step {step} at {self._remote} has no "
            f"{COMMIT_MARKER} marker (torn mirror from a crashed writer?) "
            "— refusing to restore from it")
        self._fs.get_tree(f"{self._remote}/{step}", local)
        marker = os.path.join(local, COMMIT_MARKER)
        if os.path.exists(marker):
            os.remove(marker)
        fetched_meta = os.path.join(local, META_NAME)
        if os.path.exists(fetched_meta):
            os.replace(fetched_meta, self._meta_path(step))

    def _reconcile_staging(self, committed):
        """Drop staged steps the remote tree does not hold (an older run
        on this host, or a push that never landed)."""
        stale = [d for d in os.listdir(self.path)
                 if d.isdigit() and int(d) not in committed]
        for d in stale:
            shutil.rmtree(os.path.join(self.path, d), ignore_errors=True)
        if stale:
            self._prune_meta(committed)

    # -- manifest and meta ---------------------------------------------------
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

    def _prune_meta(self, keep_steps):
        keep = {int(s) for s in keep_steps}
        for name in os.listdir(self.path):
            stem = name[:-len(META_SUFFIX)]
            if (name.endswith(META_SUFFIX) and stem.isdigit()
                    and int(stem) not in keep):
                try:
                    os.remove(os.path.join(self.path, name))
                except OSError:
                    pass

    # -- save and restore ----------------------------------------------------
    def save(self, step, state, force=False, meta=None, version=None):
        """Save when ``step`` is a multiple of the save interval, or always
        with ``force`` (a preemption flushes the step at the boundary; a
        step already saved is not saved twice). ``meta``
        (JSON-serializable) rides the step's sidecar and comes back from
        :meth:`read_meta`; ``version`` rides it as
        ``meta["model_version"]``. The state is copied to the host before
        this returns; the write lands in the background (see
        :meth:`wait`). Raises a failure of an earlier background write.
        Returns whether the step was saved."""
        self._raise_pending()
        if not (force or step % self.save_interval == 0):
            return False
        if force and self._last_saved == int(step):
            return True
        if version is not None:
            meta = dict(meta or {})
            meta["model_version"] = str(version)
        flat, event = _snapshot(state)
        job = [int(step), flat, event, meta]
        self._last_saved = int(step)
        if not self.background:
            self._write(job)
            return True
        if self._thread is None:
            self._start_writer()
        self._queue.put(job)
        return True

    def _local_steps(self):
        try:
            return sorted(int(d) for d in os.listdir(self.path)
                          if d.isdigit())
        except (FileNotFoundError, NotADirectoryError):
            return []

    def steps(self):
        """Restorable step numbers, ascending: the committed remote steps
        when mirrored (the remote tree is authoritative), else the local
        step directories. A save still in flight is not listed yet."""
        if self._remote is not None:
            return sorted(self._remote_steps())
        return self._local_steps()

    def _manifest_mismatches(self, step, state):
        try:
            with open(self._meta_path(step)) as f:
                manifest = json.load(f).get("crc32") or {}
        except (OSError, ValueError):
            return []
        actual = crc_manifest(state)
        return [key for key, spec in manifest.items()
                if actual.get(key) != spec]

    def _restore_verified(self, step, template, verify, optional):
        """The state of ``step`` when it loads and (with ``verify``)
        matches its manifest, else None. A mirrored step that fails is
        re-fetched from the remote tree once."""
        for attempt in ("local", "refetch"):
            if attempt == "refetch":
                if self._remote is None:
                    break
                shutil.rmtree(os.path.join(self.path, str(step)),
                              ignore_errors=True)
                try:
                    os.remove(self._meta_path(step))
                except OSError:
                    pass
            try:
                if verify:
                    fault_point("checkpoint.verify")
                self._fetch_remote(step)
                state = load_persistables(self.path, template, step,
                                          optional)
                bad = self._manifest_mismatches(step, state) if verify else []
            except Exception as e:      # any unreadable step degrades
                self._last_restore_exc = e
                print(f"[checkpoint] WARNING: restore of step {step} failed "
                      f"({type(e).__name__}: {e})")
                continue
            if not bad:
                return state
            _metrics.counter("checkpoint.corrupt_leaves").inc(len(bad))
            print(f"[checkpoint] WARNING: step {step} failed integrity "
                  f"verification on {len(bad)} leaves (e.g. {bad[0]!r})")
        _metrics.counter("checkpoint.integrity_fallbacks").inc()
        return None

    def restore(self, template, step=None, verify=True, optional=()):
        """Wait for the queued saves, then restore the newest healthy step
        (or exactly ``step``) into the structure of ``template``; returns
        ``(state, step)``, or ``(None, None)`` when there is no step.
        With ``verify`` each candidate is checked against its crc32
        manifest and a corrupt or unreadable one degrades (to a mirror
        re-fetch, then to the previous step); when every candidate fails
        it raises. ``optional``: top-level keys of the template that an
        older checkpoint may lack (:func:`load_persistables`)."""
        self.wait()
        explicit = step is not None
        self._last_restore_exc = None
        if explicit:
            cand = [int(step)]
        elif self._remote is not None:
            cand = sorted(self._remote_steps(), reverse=True)
            self._reconcile_staging(set(cand))
        else:
            cand = self._local_steps()[::-1]
        for s in cand:
            state = self._restore_verified(s, template, verify, optional)
            if state is not None:
                _metrics.counter("checkpoint.restores").inc()
                return state, s
        if cand:
            if explicit and self._last_restore_exc is not None:
                raise self._last_restore_exc
            raise RuntimeError(
                f"no checkpoint step under {self._remote or self.path} "
                f"survived integrity verification (tried {cand})")
        return None, None
