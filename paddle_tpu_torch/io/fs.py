"""Filesystems by URL scheme, for checkpoint mirrors (ref:
``paddle_tpu/io/fs.py``, standard library only, kept as the port's own
copy).

One registry keyed by scheme. A path without ``://`` is local
(:class:`LocalFS`); ``register_filesystem("gs", impl)`` plugs in a
backend with the six primitives ``open``, ``exists``, ``isdir``,
``listdir``, ``makedirs`` and ``remove``. :class:`MemFS` is the
in-process object store (implicit directories) that tests register and
a real adapter copies. Callers never dispatch on the scheme:

    from paddle_tpu_torch.io import fs
    with fs.fs_open("mem://bucket/part-0", "rb") as f: ...
    local = fs.ensure_local("mem://bucket/part-0")

Operations on a scheme path retry transient failures through
``core/retry.py``'s :func:`default_policy`; local ones never retry (a
local failure is a bug or a full disk).
"""

import hashlib
import io
import os
import shutil
import tempfile
import threading

from paddle_tpu_torch.core import retry as _retry
from paddle_tpu_torch.core.enforce import EnforceError

_REGISTRY = {}
_LOCK = threading.Lock()


def _policy_for(path):
    """The retry policy for a scheme path; None for a local one."""
    scheme, _ = split_scheme(path)
    return _retry.default_policy() if scheme is not None else None


def _call(policy, fn, *args, **kwargs):
    if policy is None:
        return fn(*args, **kwargs)
    return policy.call(fn, *args, **kwargs)


def split_scheme(path):
    """``'gs://b/k'`` -> ``('gs', 'b/k')``; ``'/local/p'`` -> ``(None,
    '/local/p')``."""
    if "://" in str(path):
        scheme, _, rest = str(path).partition("://")
        return scheme, rest
    return None, str(path)


def register_filesystem(scheme, fs):
    """Plug a filesystem in for a URL scheme."""
    with _LOCK:
        _REGISTRY[scheme] = fs


def get_filesystem(path):
    """``(filesystem, path)`` for a possibly scheme-prefixed path."""
    scheme, _ = split_scheme(path)
    if scheme is None:
        return _LOCAL, path
    with _LOCK:
        fs = _REGISTRY.get(scheme)
    if fs is None:
        raise EnforceError(
            f"no filesystem registered for scheme '{scheme}://' — call "
            f"paddle_tpu_torch.io.fs.register_filesystem({scheme!r}, impl) "
            "(see MemFS for the 6-primitive template)")
    return fs, path


class LocalFS:
    """The POSIX filesystem."""

    def open(self, path, mode="rb"):
        if "w" in mode or "a" in mode:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
        return open(path, mode)

    def exists(self, path):
        return os.path.exists(path)

    def isdir(self, path):
        return os.path.isdir(path)

    def listdir(self, path):
        if not os.path.isdir(path):
            # FileNotFoundError, as MemFS gives: an answer, which the
            # retry layer does not retry
            raise FileNotFoundError(path)
        return sorted(os.listdir(path))

    def makedirs(self, path):
        os.makedirs(path, exist_ok=True)

    def remove(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)


_LOCAL = LocalFS()


class MemFS:
    """An in-process object store: blobs under flat keys, directories
    implicit in the keys. A write lands when its file is closed."""

    def __init__(self):
        self._blobs = {}
        self._lock = threading.Lock()

    def _key(self, path):
        return split_scheme(path)[1].rstrip("/")

    def open(self, path, mode="rb"):
        k = self._key(path)
        if "r" in mode and "w" not in mode:
            with self._lock:
                if k not in self._blobs:
                    raise FileNotFoundError(path)
                data = self._blobs[k]
            return io.BytesIO(data) if "b" in mode else \
                io.StringIO(data.decode())
        store = self

        class _Writer(io.BytesIO if "b" in mode else io.StringIO):
            def close(self):
                if not self.closed:
                    data = self.getvalue()
                    with store._lock:
                        store._blobs[k] = (data if isinstance(data, bytes)
                                           else data.encode())
                super().close()

        return _Writer()

    def exists(self, path):
        k = self._key(path)
        with self._lock:
            return k in self._blobs or any(
                b.startswith(k + "/") for b in self._blobs)

    def isdir(self, path):
        k = self._key(path)
        with self._lock:
            return any(b.startswith(k + "/") for b in self._blobs)

    def listdir(self, path):
        k = self._key(path)
        pre = k + "/" if k else ""
        with self._lock:
            names = {b[len(pre):].split("/", 1)[0]
                     for b in self._blobs if b.startswith(pre)}
        return sorted(names)

    def makedirs(self, path):
        pass    # directories are implicit

    def remove(self, path):
        k = self._key(path)
        with self._lock:
            for b in [b for b in self._blobs
                      if b == k or b.startswith(k + "/")]:
                del self._blobs[b]


def fs_open(path, mode="rb"):
    """Open a local or scheme path; a scheme path's open retries."""
    fs, p = get_filesystem(path)
    return _call(_policy_for(path), fs.open, p, mode)


def fs_exists(path):
    fs, p = get_filesystem(path)
    return fs.exists(p)


_CACHE_DIR = None


def _cache_dir():
    global _CACHE_DIR
    if _CACHE_DIR is None:
        _CACHE_DIR = tempfile.mkdtemp(prefix="pt_torch_fs_cache_")
    return _CACHE_DIR


def ensure_local(path, cache_dir=None):
    """A local path for ``path``: itself when local; else a copy
    downloaded once into the cache (``cache_dir``, or a per-process
    temporary directory) and kept there until :func:`clear_cache`. Each
    download lands in a fresh temporary file renamed into place, so a
    failed try leaves nothing."""
    scheme, rest = split_scheme(path)
    if scheme is None:
        return path
    digest = hashlib.sha1(str(path).encode()).hexdigest()[:16]
    name = os.path.basename(rest.rstrip("/")) or "blob"
    base = os.path.join(cache_dir or _cache_dir(), scheme,
                        f"{digest}_{name}")
    if not os.path.exists(base):
        fs, _ = get_filesystem(path)
        os.makedirs(os.path.dirname(base), exist_ok=True)

        def attempt():
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(base),
                                       prefix=name + ".")
            try:
                with fs.open(path, "rb") as src, \
                        os.fdopen(fd, "wb") as dst:
                    shutil.copyfileobj(src, dst)
                os.replace(tmp, base)
            except BaseException:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise

        _call(_policy_for(path), attempt)
    return base


def clear_cache():
    """Drop the per-process :func:`ensure_local` cache directory."""
    global _CACHE_DIR
    if _CACHE_DIR is not None and os.path.isdir(_CACHE_DIR):
        shutil.rmtree(_CACHE_DIR, ignore_errors=True)
    _CACHE_DIR = None


def put_tree(local_dir, remote_dir):
    """Copy a local directory tree to ``remote_dir``, each file its own
    unit of retry (both ends reopened on every try)."""
    fs, _ = get_filesystem(remote_dir)
    policy = _policy_for(remote_dir)

    def copy_one(srcp, dst):
        with open(srcp, "rb") as src, fs.open(dst, "wb") as out:
            shutil.copyfileobj(src, out)

    for root, _dirs, files in os.walk(local_dir):
        rel = os.path.relpath(root, local_dir)
        for name in sorted(files):
            dst = remote_dir.rstrip("/") + (
                "/" if rel == "." else f"/{rel}/") + name
            _call(policy, copy_one, os.path.join(root, name), dst)


def get_tree(remote_dir, local_dir):
    """Copy ``remote_dir``'s tree into ``local_dir`` atomically: into a
    temporary directory beside it, renamed into place when whole (an
    existing ``local_dir`` is replaced). Raises FileNotFoundError when
    the source does not exist."""
    fs, p = get_filesystem(remote_dir)
    if not fs.exists(p):
        raise FileNotFoundError(remote_dir)
    policy = _policy_for(remote_dir)

    def fetch_one(rpath, lpath):
        with fs.open(rpath, "rb") as src, open(lpath, "wb") as dst:
            shutil.copyfileobj(src, dst)

    def walk(rdir, ldir):
        os.makedirs(ldir, exist_ok=True)
        for name in _call(policy, fs.listdir, rdir):
            rpath = rdir.rstrip("/") + "/" + name
            lpath = os.path.join(ldir, name)
            if _call(policy, fs.isdir, rpath):
                walk(rpath, lpath)
            else:
                _call(policy, fetch_one, rpath, lpath)

    local_dir = os.path.abspath(local_dir)
    parent = os.path.dirname(local_dir)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".pt_get_tree_", dir=parent)
    try:
        walk(remote_dir, tmp)
        try:
            os.replace(tmp, local_dir)
        except OSError:
            shutil.rmtree(local_dir, ignore_errors=True)
            os.replace(tmp, local_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def remove_tree(path):
    fs, p = get_filesystem(path)
    _call(_policy_for(path), fs.remove, p)


def listdir(path):
    fs, p = get_filesystem(path)
    return _call(_policy_for(path), fs.listdir, p)
