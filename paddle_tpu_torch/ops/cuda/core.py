"""The one launch layer of the port's CUDA kernels.

The counterpart of ``paddle_tpu/ops/pallas/core.py:78 kernel_call``, the
JAX package's single ``pl.pallas_call`` site. It owns:

* the build: every ``paddle_tpu_torch/csrc/*.cu`` is compiled by ``nvcc``
  for ``sm_90a`` (one process per source, all started together) and
  linked into one shared library with a plain C interface, at first use,
  into ``paddle_tpu_torch/csrc/build/<hash of the sources>/``. A later
  run with the same sources loads the library it finds there. A failed
  compile raises with nvcc's output;
* the ``ctypes`` binding: ``argtypes`` set on every entry, ``c_void_p``
  for each pointer and the stream;
* the launch check: every C entry returns ``cudaGetLastError()`` and
  :class:`Kernel` raises when it is not 0;
* a plain-integer launch count per kernel (:attr:`Kernel.launches`);
* the op layer (:func:`define_op`): every kernel is the ``torch.library``
  op ``torch.ops.paddle_tpu_torch.<name>``, defined with
  ``Library.define``/``impl`` for the CUDA key and a fake (meta)
  implementation, so that ``torch.export`` and ``make_fx`` trace the card
  path (on fake CUDA tensors where there is no card) and a loaded program
  calls the same kernels. The op's CUDA implementation is the only caller
  of :class:`Kernel`: it holds everything that needs real memory or a
  real device (pointers, alignment, the SM count, route plans, scratch),
  and the launch counts are taken there, so a loaded program's launches
  count too. Its schema mutates no argument. ``Library`` rather than
  ``torch.library.custom_op``: both trace and export alike, and the
  ``Library`` op costs less host time a call (``PERF.md``,
  ``tools/torch_op_overhead.py``);
* the device rule (:func:`on_card`): tensors on the CPU take the kernel's
  plain PyTorch version, tensors on a CUDA device take the kernel, and
  anything else raises, but for tensors on the ``meta`` device inside
  :func:`shapes_only` (no data: the plain version's shapes and products,
  which ``observability/perf.py cost_flops`` counts; the ops' fake
  implementations give shapes but no products, since
  ``FlopCounterMode`` has no formula for an op of this package). There
  is no flag and no fallback: a kernel that fails on the card raises.

The online-softmax (m, l, acc) combiner of ``core.py:220-269`` lives in
device code, in the kernels themselves (``csrc/flash_attention.cu``;
``csrc/decode_attention.cu``, whose split route also merges the
partials of its splits in the last block of each to finish), with the
same rule that a fully masked row gives exactly 0.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_ROOT = os.path.join(CSRC, "build")
LIB_NAME = "libpaddle_tpu_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: storage-type codes of csrc/common.cuh
F32, BF16, I8 = 0, 1, 2
_CODES = {torch.float32: F32, torch.bfloat16: BF16, torch.int8: I8}

#: largest dynamic shared memory a block may take on the H100
MAX_SMEM = 232448

_lib = None
_lib_lock = threading.Lock()
_TLS = threading.local()

#: the ops' namespace: ``torch.ops.paddle_tpu_torch.<kernel name>``
OP_NAMESPACE = "paddle_tpu_torch"
_OPS = torch.library.Library(OP_NAMESPACE, "DEF")


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the port's kernels are built from "
                           f"{CSRC}")
    return found


def _sources():
    names = sorted(n for n in os.listdir(CSRC)
                   if n.endswith((".cu", ".cuh")))
    return [os.path.join(CSRC, n) for n in names]


def build_dir():
    """The build directory of the current sources: a hash of the flags
    and of every source's name and bytes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build():
    """Compile and link the kernel library if this build directory does
    not hold it yet; returns its path. Each ``nvcc -c`` writes its
    ``-Xptxas=-v`` report (registers, shared memory, spills) beside the
    library as ``<source>.o.ptxas.txt``. Objects go to a directory of this
    process's own and the library appears by an atomic rename, so two
    processes building at once cannot mix their files."""
    out = build_dir()
    lib = os.path.join(out, LIB_NAME)
    if os.path.exists(lib):
        return lib
    work = os.path.join(out, f"tmp{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    nvcc = _nvcc()
    cus = [p for p in _sources() if p.endswith(".cu")]
    procs = []
    for src in cus:
        obj = os.path.join(work, os.path.basename(src) + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, obj, proc in procs:
        log, _ = proc.communicate()
        with open(os.path.join(out, os.path.basename(obj) + ".ptxas.txt"),
                  "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {os.path.basename(src)} exited "
                          f"{proc.returncode}:\n{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    tmp = os.path.join(work, LIB_NAME)
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", tmp, *[obj for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"kernel link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class Kernel:
    """One kernel of the port: its C entries, one per route, and its
    launch counts.

    ``routes`` maps a route's name to its ``(symbol, argtypes)``; the
    first is the base route (``"simt"`` unless the kernel names it
    otherwise), and a kernel with one entry has only that one.
    ``__call__(*args, route=...)`` forwards the arguments to that route's
    entry (the base route's by default), raises if the entry returns a
    CUDA error, and only then adds one to :attr:`launches` and to
    :attr:`route_launches` of the route."""

    def __init__(self, name, routes, replaces, source, route_sources=None):
        self.name = name
        self.routes = {r: (sym, list(types))
                       for r, (sym, types) in routes.items()}
        self.base_route = next(iter(self.routes))
        self.replaces = replaces      # file:line of the TPU kernel
        self.source = source          # the CUDA source in this repo
        #: each route's CUDA source (the base route's is ``source``)
        self.route_sources = {r: (route_sources or {}).get(r, source)
                              for r in self.routes}
        self.launches = 0
        self.route_launches = dict.fromkeys(self.routes, 0)
        self._fns = {}
        #: the kernel's op (``torch.ops.paddle_tpu_torch.<name>.default``),
        #: set by :func:`define_op`
        self.op = None

    def _entry(self, route):
        if route not in self._fns:
            symbol, argtypes = self.routes[route]
            fn = getattr(library(), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._fns[route] = fn
        return self._fns[route]

    def __call__(self, *args, route=None):
        route = route or self.base_route
        err = self._entry(route)(*args)
        if err != 0:
            text = library().ptt_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed "
                               f"({route} route): CUDA error {err} "
                               f"({text})")
        self.launches += 1
        self.route_launches[route] += 1


#: every kernel of the port, by name (the counts chip_smoke.py reads)
KERNELS = {}


def register(name, symbol, argtypes, replaces, source, routes=None,
             route_sources=None, route="simt"):
    """Register a kernel whose base route (``route``, ``"simt"`` unless
    given) is the C entry ``symbol`` in ``source``. ``routes`` adds
    further named routes, ``{route: (symbol, argtypes)}`` (the tensor
    cores' ``"tc"``, K1's ``"row"``, K7's ``"split"``, K4's ``"gemm"``),
    whose sources are ``route_sources[route]`` where they have files of
    their own."""
    kernel = Kernel(name, {route: (symbol, argtypes), **(routes or {})},
                    replaces, source, route_sources)
    KERNELS[name] = kernel
    return kernel


def define_op(kernel, schema, cuda, fake):
    """Define ``kernel`` as the op ``paddle_tpu_torch::<kernel.name>``
    with ``schema`` (the argument list and the returns, e.g. ``"(Tensor
    x, float eps) -> Tensor"``): ``cuda`` is its implementation for CUDA
    tensors (the one caller of the kernel's entries), ``fake`` its fake
    implementation, which returns outputs of the shapes and dtypes
    ``cuda`` returns, without data. No implementation is registered for
    the CPU: the wrappers take the plain versions there (the device rule).
    Returns the op's default overload, also kept as ``kernel.op``."""
    _OPS.define(kernel.name + schema)
    _OPS.impl(kernel.name, cuda, "CUDA")
    torch.library.register_fake(f"{OP_NAMESPACE}::{kernel.name}", fake,
                                lib=_OPS)
    kernel.op = getattr(getattr(torch.ops, OP_NAMESPACE),
                        kernel.name).default
    return kernel.op


def reset_launches():
    for kernel in KERNELS.values():
        kernel.launches = 0
        kernel.route_launches = dict.fromkeys(kernel.routes, 0)


def launch_counts():
    return {name: k.launches for name, k in KERNELS.items()}


def route_counts():
    """``{name: {route: launches}}`` of the kernels with more than one
    route."""
    return {name: dict(k.route_launches) for name, k in KERNELS.items()
            if len(k.routes) > 1}


_resident = {}


def resident_slots(symbol, *args):
    """The resident block slots of one kernel instantiation on the
    current card: its SM count times the blocks an SM holds, as the C
    entry ``symbol(*args, int* out)`` reads them from the CUDA occupancy
    calculator under the launch's own shared-memory settings (the route
    plans size their work split by it). Raises if the entry fails; read
    once a process for each card and arguments."""
    dev = torch.cuda.current_device()
    key = (symbol, args, dev)
    if key not in _resident:
        fn = getattr(library(), symbol)
        fn.argtypes = [ctypes.c_int] * len(args) + [
            ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        n = ctypes.c_int(0)
        err = fn(*args, ctypes.byref(n))
        if err != 0 or n.value < 1:
            text = library().ptt_error_string(err).decode()
            raise RuntimeError(f"{symbol}{args}: CUDA error {err} ({text}), "
                               f"{n.value} blocks an SM")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _resident[key] = sms * n.value
    return _resident[key]


def wave_busy(blocks, sms):
    """The share of the SM slots of all waves (one block per SM) that hold
    a block: ``blocks / (ceil(blocks / sms) * sms)``."""
    return blocks / (-(-blocks // sms) * sms)


@contextlib.contextmanager
def shapes_only():
    """On this thread, inside: tensors all on the ``meta`` device take the
    plain version (they hold no data, so nothing runs), for counting a
    step's products."""
    prev = getattr(_TLS, "shapes_only", False)
    _TLS.shapes_only = True
    try:
        yield
    finally:
        _TLS.shapes_only = prev


def on_card(*tensors):
    """The device rule. False when every tensor lies on the CPU (the
    caller runs the plain PyTorch version), True when every tensor lies
    on one CUDA device, real or fake (the caller calls the kernel's op:
    a fake CUDA tensor, as ``torch.export`` traces with where there is no
    card, reaches its fake implementation); raises for
    anything else, such as a mix of devices, or the ``meta`` device
    outside :func:`shapes_only`. ``None`` entries are skipped."""
    devs = {t.device for t in tensors if t is not None}
    if not devs:
        raise ValueError("on_card: no tensors given")
    if all(d.type == "cpu" for d in devs) or (
            getattr(_TLS, "shapes_only", False)
            and all(d.type == "meta" for d in devs)):
        return False
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return True
    raise ValueError("kernel inputs must all lie on the CPU or all on one "
                     f"CUDA device, got {sorted(map(str, devs))}")


def dtype_code(t, allowed):
    """The C storage-type code of ``t``; raises for a type the kernel does
    not take."""
    if t.dtype not in allowed:
        raise TypeError(f"kernel takes {[str(a) for a in allowed]}, got "
                        f"{t.dtype}")
    return _CODES[t.dtype]


def ptr(t):
    """A tensor's device pointer for ctypes (None for an absent
    operand)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream(t):
    """PyTorch's current stream on ``t``'s device, for ctypes."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_contiguous(**tensors):
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


VP, I32, F32_ARG = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
