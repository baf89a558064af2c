"""Where the port's entry points run.

Entry points take ``device=`` and default to ``"cuda"``. With no CUDA
device they raise instead of quietly continuing on the CPU; the CPU is
used only when the caller asks for it (``device="cpu"``, as the tests do).
"""

import torch

from paddle_tpu_torch.core.enforce import EnforceError


def resolve_device(device="cuda"):
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present, or names a device type the port does not run
    on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise EnforceError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise EnforceError(f"unsupported device {dev} (cuda or cpu)")
    return dev
