"""Check and time the port's fused MLP kernel (K4) alone, on one card:
chip_smoke.py's K4 cases (``chip_smoke.mlp_cases``) without the rest of
that script, as a quick loop for MLP kernel work.

    python3 tools/torch_mlp_bench.py [--untimed] [--rounds N] [--profile]

The cases are GPTConfig.small()'s widths (768/3072) in f32 at decode's 8
rows, verify's 32 and the 512- and 256-row prefill chunks (each timed
with its plain version, ``F.linear`` + gelu + ``F.linear`` and the
bound), ragged rows and I on both sides of the split/gemm threshold, and
one bf16 case on the tensor cores. It prints one JSON line a case (route,
error, times) and exits 1 if a check failed.

``--rounds N`` adds, for each timed shape, the kernel and the library
call timed in turn N times in one process, kernel first in every round
(each reading ``chip_smoke.time_ms``'s mean of 20 runs), with the
readings, their medians and the verdict: ``met`` where every kernel
reading is below every library reading, ``missed`` where every one is
above, else ``unresolved``. ``--profile`` adds, for each timed shape,
one call under torch.profiler (``chip_smoke.kernel_profile``, L2 warm):
the device ms of each CUDA kernel the call ran (a route's passes and its
merge or reduction). Then the card's name and power limit. Needs a CUDA
device.
"""

import argparse
import json
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (at the repo root: the K4 cases)


def operands(dev, rows, inter):
    """x, w1, b1, w2, b2 at 768/``inter`` in f32, drawn as mlp_cases
    draws them."""
    g = torch.Generator().manual_seed(9)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    return (randn(rows, 768), randn(768, inter, scale=0.036),
            randn(inter, scale=0.02), randn(inter, 768, scale=0.036),
            randn(768, scale=0.02))


def profiled(dev, rows, inter):
    """Device ms of each CUDA kernel of one K4 call."""
    from paddle_tpu_torch.ops.cuda import mlp
    args = operands(dev, rows, inter)
    ms, launches, by_name = chip_smoke.kernel_profile(
        lambda: mlp.mlp_kernel(*args))
    return dict(rows=rows, inter=inter, device_ms=ms, launches=launches,
                kernels={k[:90]: v for k, v in by_name.items()})


def interleaved(dev, rounds, rows, inter):
    """K4 and ``F.linear`` + gelu + ``F.linear``, timed in turn."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import mlp
    x, w1, b1, w2, b2 = operands(dev, rows, inter)
    w1t, w2t = w1.t(), w2.t()
    kernel, library = [], []
    for _ in range(rounds):
        kernel.append(chip_smoke.time_ms(
            lambda: mlp.mlp_kernel(x, w1, b1, w2, b2)))
        library.append(chip_smoke.time_ms(
            lambda: F.linear(F.gelu(F.linear(x, w1t, b1)), w2t, b2)))
    verdict = ("met" if max(kernel) < min(library) else
               "missed" if min(kernel) > max(library) else "unresolved")
    return dict(rows=rows, inter=inter,
                route=mlp.mlp_route(torch.float32, 768, inter, 768, rows),
                kernel_ms=kernel, library_ms=library,
                kernel_median=statistics.median(kernel),
                library_median=statistics.median(library), verdict=verdict)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--untimed", action="store_true")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mlp_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi()
    g = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    failed = 0
    try:
        for case in chip_smoke.mlp_cases(randn, timed=not a.untimed):
            print(json.dumps(dict(case, card=smi)), flush=True)
    except AssertionError as e:
        failed += 1
        print(json.dumps(dict(failed=str(e), card=smi)), flush=True)
    for rows, inter in chip_smoke.MLP_TIMED if a.profile else ():
        print(json.dumps(dict(profiled(dev, rows, inter), card=smi)),
              flush=True)
    for rows, inter in chip_smoke.MLP_TIMED if a.rounds else ():
        print(json.dumps(dict(interleaved(dev, a.rounds, rows, inter),
                              card=smi)), flush=True)
    print(smi, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
