"""Host cost of a call through a ``torch.library`` op on the card: the
measurement behind the port's op layer (``paddle_tpu_torch/ops/cuda/core.py
define_op``).

    python3 tools/torch_op_overhead.py [--calls N] [--rounds R]

Times, in turn and ``--rounds`` times, a loop of ``--calls`` calls
(the card synchronized around each loop, under ``torch.inference_mode``
as the serving engine steps) of:

* ``bare``: the implementation below called directly (``torch.empty_like``
  of an ``[8, 768]`` f32 tensor, the host work of a launch's output);
* ``library``: the same implementation as an op defined with
  ``torch.library.Library.define``/``impl`` and a fake implementation;
* ``custom_op``: the same as a ``torch.library.custom_op``;
* ``k1_direct`` and ``k1_op``: K1 at ``[8, 768]`` f32 through its CUDA
  implementation called directly and through its op
  (``torch.ops.paddle_tpu_torch.layer_norm``).

Prints one JSON line with µs per call (each round's reading and the
median) and the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=5000)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_op_overhead: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.cuda import layer_norm as ln

    def impl(x, g, eps):
        return torch.empty_like(x)

    lib = torch.library.Library("ptt_overhead", "DEF")
    lib.define("empty(Tensor x, Tensor g, float eps) -> Tensor")
    lib.impl("empty", impl, "CUDA")
    torch.library.register_fake("ptt_overhead::empty", impl, lib=lib)

    @torch.library.custom_op("ptt_overhead::empty2", mutates_args=(),
                             device_types="cuda")
    def empty2(x: torch.Tensor, g: torch.Tensor,
               eps: float) -> torch.Tensor:
        return torch.empty_like(x)

    empty2.register_fake(impl)
    gen = torch.Generator().manual_seed(0)
    x, g, b = (torch.randn(*s, generator=gen).cuda()
               for s in ((8, 768), (768,), (768,)))
    lib_op = torch.ops.ptt_overhead.empty.default
    calls = {
        "bare": lambda: impl(x, g, 1e-5),
        "library": lambda: lib_op(x, g, 1e-5),
        "custom_op": lambda: empty2(x, g, 1e-5),
        "k1_direct": lambda: ln._layer_norm_cuda(x, g, b, 1e-5),
        "k1_op": lambda: ln.layer_norm_kernel(x, g, b, 1e-5),
    }

    def per_call(fn):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(args.calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / args.calls * 1e6

    us = {name: [] for name in calls}
    with torch.inference_mode():
        for _ in range(args.rounds):
            for name, fn in calls.items():
                us[name].append(per_call(fn))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    median = {k: sorted(v)[len(v) // 2] for k, v in us.items()}
    print(json.dumps(dict(us_per_call=us, median_us=median,
                          calls=args.calls, card=smi,
                          torch=torch.__version__)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
