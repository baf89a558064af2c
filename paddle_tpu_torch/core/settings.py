"""Module settings read from the environment (ref:
``paddle_tpu/core/flags.py:19-30``, the ``PT_FLAGS_<name>`` override).

The port keeps the reference's flags as module settings with the flags'
defaults, each changed through its module's ``configure()``. A setting
that the reference lets a run set from the environment alone (the step
telemetry's) takes its default from :func:`env_default` at import, so
``PT_FLAGS_telemetry=1 python train.py`` instruments a run in both
packages.
"""

import os

PREFIX = "PT_FLAGS_"


def env_default(name, default):
    """``default``, or ``PT_FLAGS_<name>`` from the environment coerced to
    the default's type (a bool is true for ``1``, ``true`` or ``yes``)."""
    env = os.environ.get(PREFIX + name)
    if env is None:
        return default
    ty = type(default) if default is not None else str
    if ty is bool:
        return env.lower() in ("1", "true", "yes")
    return ty(env)
