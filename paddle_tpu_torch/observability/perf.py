"""The card's peak, a step's counted FLOPs, MFU and device memory (ref:
``paddle_tpu/observability/perf.py``), for the Trainer's step telemetry.

* :func:`peak_flops` is the card's dense bf16 peak from a table keyed by
  ``torch.cuda.get_device_name()`` (``PT_PEAK_FLOPS`` overrides it); an
  unknown card, or none, gives None, and then :func:`mfu` is None.
* :func:`cost_flops` counts one forward and backward of a loss with
  ``torch.utils.flop_counter.FlopCounterMode`` on ``meta`` copies of the
  model's parameters, buffers and the batch: nothing runs, no generator
  or buffer moves, and every hand-written kernel takes its plain
  version there (``ops/cuda/core.py shapes_only``), so the count is the
  same whether the step launches the kernels or not. FlopCounterMode counts
  the products and convolutions (the reference's XLA cost analysis also
  counts elementwise work, a small share of a training step's), and the
  optimizer's update is not run.
* :func:`device_memory_stats` reads the caching allocator under the
  reference's keys; None on the CPU.
"""

import os

import torch

#: dense bf16 tensor-core peaks, FLOP/s, by a substring of the device
#: name (NVIDIA's H100 datasheet: SXM5 989.4 T, PCIe 756 T, NVL 835 T;
#: the SXM5 part reports itself as "H100 80GB HBM3")
PEAKS = (("H100 NVL", 835e12), ("H100 PCIe", 756e12),
         ("H100 80GB HBM3", 989.4e12), ("H100 SXM", 989.4e12))


def peak_flops(device=None):
    """The card's dense bf16 peak in FLOP/s: ``PT_PEAK_FLOPS`` when set,
    else :data:`PEAKS` by the device's name; None without a card or for
    a card the table does not hold."""
    if "PT_PEAK_FLOPS" in os.environ:
        return float(os.environ["PT_PEAK_FLOPS"])
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in PEAKS:
        if key in name:
            return peak
    return None


def _meta(t):
    return torch.empty_like(t, device="meta").requires_grad_(
        t.requires_grad)


def cost_flops(loss_fn, model, *args):
    """Counted FLOPs of ``loss_fn(model, *args)`` and its backward, on
    meta copies (see the module docstring); 0.0 when the count fails.
    ``loss_fn`` is called once, with meta tensors (``args[i].is_meta``):
    a loss function with side effects can tell that call apart."""
    from torch.utils.flop_counter import FlopCounterMode

    from paddle_tpu_torch.ops.cuda import core
    try:
        swap = {name: _meta(t) for name, t in model.named_parameters()}
        swap.update({name: _meta(t) for name, t in model.named_buffers()})
        margs = [_meta(a) if isinstance(a, torch.Tensor) else a
                 for a in args]

        class _Bound(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.model = model

            def forward(self, *a):
                return loss_fn(self.model, *a)

        swap = {"model." + k: v for k, v in swap.items()}
        with core.shapes_only(), FlopCounterMode(display=False) as counter:
            loss = torch.func.functional_call(_Bound(), swap, tuple(margs))
            leaves = [v for v in swap.values() if v.requires_grad]
            if loss.requires_grad and leaves:
                torch.autograd.grad(loss.float(), leaves, allow_unused=True)
        return float(counter.get_total_flops())
    except Exception:
        return 0.0


def mfu(flops_per_step, step_s, peak=None):
    """Achieved share of the card's peak for one step, or None."""
    peak = peak_flops() if peak is None else peak
    if not flops_per_step or not step_s or step_s <= 0 or not peak:
        return None
    return flops_per_step / step_s / peak


def device_memory_stats(device=None):
    """``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit",
    "largest_alloc_size"}`` of a CUDA device from the caching allocator:
    bytes allocated now and at the peak, the device's total memory, and
    the largest block allocated now. None without a card."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    largest = 0
    for seg in torch.cuda.memory_snapshot():
        for block in seg.get("blocks", ()):
            if block.get("state") == "active_allocated":
                largest = max(largest, int(block.get("size", 0)))
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.mem_get_info(device)[1]),
            "largest_alloc_size": largest}
