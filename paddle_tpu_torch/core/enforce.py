"""Error checking — the PADDLE_ENFORCE family, Python-native.

Ref: /root/reference/paddle/fluid/platform/enforce.h:286 (PADDLE_ENFORCE,
PADDLE_ENFORCE_EQ/NE/GT/GE/LT/LE/NOT_NULL with demangled stack traces).
Python tracebacks already carry the stack; we add structured error types and
shape/dtype-specific checks used throughout the op library.

The port's own copy of ``paddle_tpu/core/enforce.py``: the same checks,
with ``check_numerics`` walking nested dicts/lists of torch tensors.
"""


class EnforceError(RuntimeError):
    """Framework invariant violation (ref: platform::EnforceNotMet)."""


def enforce(cond, msg="", *args):
    if not cond:
        raise EnforceError(msg % args if args else str(msg))


def enforce_eq(a, b, msg=""):
    if a != b:
        raise EnforceError(f"Expected {a!r} == {b!r}. {msg}")


def enforce_ne(a, b, msg=""):
    if a == b:
        raise EnforceError(f"Expected {a!r} != {b!r}. {msg}")


def enforce_gt(a, b, msg=""):
    if not a > b:
        raise EnforceError(f"Expected {a!r} > {b!r}. {msg}")


def enforce_ge(a, b, msg=""):
    if not a >= b:
        raise EnforceError(f"Expected {a!r} >= {b!r}. {msg}")


def enforce_lt(a, b, msg=""):
    if not a < b:
        raise EnforceError(f"Expected {a!r} < {b!r}. {msg}")


def enforce_le(a, b, msg=""):
    if not a <= b:
        raise EnforceError(f"Expected {a!r} <= {b!r}. {msg}")


def enforce_not_none(x, name="value"):
    if x is None:
        raise EnforceError(f"{name} must not be None")
    return x


def enforce_rank(x, rank, name="tensor"):
    if x.ndim != rank:
        raise EnforceError(f"{name} must have rank {rank}, got shape {x.shape}")
    return x


def enforce_shape_match(a, b, msg=""):
    if tuple(a.shape) != tuple(b.shape):
        raise EnforceError(f"Shape mismatch: {a.shape} vs {b.shape}. {msg}")


def check_numerics(tree, label="tensors"):
    """Host-side NaN/Inf validation of a nested dict/list of tensors.

    Ref: /root/reference/paddle/fluid/platform/flags.cc:44
    (FLAGS_check_nan_inf validates every op output at the executor level).
    Raises EnforceError naming the bad leaves."""
    import torch

    bad = []

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        elif isinstance(x, torch.Tensor) and x.is_floating_point():
            finite = torch.isfinite(x)
            if not bool(finite.all()):
                n_nan = int(torch.isnan(x).sum())
                n_inf = int(torch.isinf(x).sum())
                bad.append(f"{path} (nan={n_nan}, inf={n_inf})")

    walk(tree, "")
    if bad:
        raise EnforceError(
            f"check_nan_inf: non-finite values in {label}: " + ", ".join(bad))
    return tree
