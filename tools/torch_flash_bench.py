"""Check and time the port's flash-attention kernels (K2 forward, K3
backward dq and dk/dv) alone, on one card: chip_smoke.py's K2/K3 case
(``chip_smoke.flash_cases``) without the rest of that script, as a quick
loop for attention kernel work.

    python3 tools/torch_flash_bench.py [--shapes gpt,gpt_f32,bert,...]
                                       [--untimed] [--cpu-plain]
                                       [--rounds N] [--profile]
                                       [--tree DIR]

Shapes ([B, H, Tq, Tk, D], dtype, causal, key mask): ``gpt`` GPTConfig
.small()'s train step [16, 12, 512, 512, 64] bf16 causal, ``gpt_f32`` the
same in f32 (K3 on its tf32x3 route, K2 on SIMT), ``bert`` BertConfig.base()'s [64, 12, 512, 512, 64] bf16,
``bert_large`` BertConfig.large()'s [8, 16, 512, 512, 64] bf16, and
``ragged``, the tc route's edge cases (Tq != Tk, key masks with fully
masked rows, T not a multiple of 64, D = 128), ``serve``, serving's first
prefill chunk [1, 12, 512, 512, 64] f32 causal (the simt route, split
into chunks and merged), ``simt``, the simt route's ragged cases (f32
at D = 16-128, bf16 at D = 16; K3 takes tf32x3 at f32 D = 64), ``x3``,
K3's tf32x3 edge cases (Tq != Tk, key masks with fully masked rows, T
not a multiple of 64, Tq = Tk = 2048), and ``simt32``, GPT's shape at
D = 32 in f32 (K3's SIMT route). For each case
it prints one
JSON line: per kernel its route, its error readings (each output, its
rows that see few partners and those that see none, each on its own
scale), and unless ``--untimed`` its device time, plain and library
times and bound. A check that fails prints its readings and the script
goes on to the next case; it exits 1 if any failed.

``--cpu-plain`` adds, for each case, K3's outputs held against the plain
backward computed on the CPU from the same inputs (the kernel's own out
and lse), beside the plain backward on the card against the same CPU
result, and the names of the card kernels the plain backward ran
(torch.profiler): a reading of exactly 0 on the card can then be told
apart from a kernel that agrees with the plain version only because both
sum in the same order.

``--profile`` adds, for each case, one K2 call under torch.profiler
(``chip_smoke.kernel_profile``, L2 warm): the device ms of each CUDA
kernel it ran (the forward kernel and, where the plan splits, the merge).

``--rounds N`` adds, for each case, the kernels against the library
timed in turn N times in one process, kernel first in every round: K2
against SDPA's forward, and K3 (dq and dk/dv captured in one graph)
against the library backward (``chip_smoke.sdpa_backward``). Each
reading is ``chip_smoke.time_ms``'s mean of 20 runs; per pair it prints
the readings, their median and the verdict: ``met`` where every kernel
reading is below every library reading, ``missed`` where every one is
above, else ``unresolved``. Then the card's name and power limit. Needs
a CUDA device.

``--tree DIR`` runs the case and the kernels of another checkout of the
repo (say a parent commit unpacked with ``git archive`` into a gitignored
directory), so that two versions are timed in one call on one card: run
parent, change, change, parent, one process each.
"""

import argparse
import importlib
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the K2/K3 case of the tree's chip_smoke.py, imported by main()
chip_smoke = None

BF16, F32 = torch.bfloat16, torch.float32
#: name -> [(B, H, Tq, Tk, D, dtype, causal, key-mask lengths)]
SHAPES = {
    "gpt": [(16, 12, 512, 512, 64, BF16, True, None)],
    "gpt_f32": [(16, 12, 512, 512, 64, F32, True, None)],
    "bert": [(64, 12, 512, 512, 64, BF16, False, None)],
    "bert_large": [(8, 16, 512, 512, 64, BF16, False, None)],
    "ragged": [(1, 4, 100, 300, 64, BF16, True, None),
               (3, 4, 200, 200, 64, BF16, True, (200, 137, 0)),
               (3, 4, 200, 200, 128, BF16, False, (190, 61, 0)),
               (2, 3, 130, 130, 128, BF16, True, None),
               (2, 3, 70, 70, 64, BF16, False, None),
               (1, 4, 300, 100, 128, BF16, True, (77,))],
    "serve": [(1, 12, 512, 512, 64, F32, True, None)],
    "simt": [(2, 3, 200, 200, 64, F32, True, None),
             (1, 4, 100, 300, 32, F32, True, None),
             (2, 2, 130, 130, 128, F32, False, (43, 0)),
             (1, 2, 70, 70, 16, BF16, True, (0,))],
    "x3": [(1, 4, 100, 300, 64, F32, True, None),
           (1, 4, 300, 100, 64, F32, True, (77,)),
           (3, 4, 200, 200, 64, F32, True, (200, 137, 0)),
           (2, 3, 70, 70, 64, F32, False, None),
           (1, 2, 2048, 2048, 64, F32, False, None),
           (1, 2, 2048, 2048, 64, F32, True, None)],
    "simt32": [(16, 12, 512, 512, 32, F32, True, None)],
}


def inputs(dev, gen, b, h, tq, tk, d, dtype, lengths):
    """q, k, v, dO and the key mask, drawn as ``chip_smoke.flash_cases``
    draws them."""
    q, do = (torch.randn(b, h, tq, d, generator=gen).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn(b, h, tk, d, generator=gen).to(dev, dtype)
            for _ in range(2))
    mask = None
    if lengths is not None:
        mask = (torch.arange(tk, device=dev)[None, :]
                < torch.tensor(lengths, device=dev)[:, None])
    return q, k, v, do, mask


def cpu_plain(dev, gen, b, h, tq, tk, d, dtype, causal, lengths):
    """K3 and the card's plain backward, each against the plain backward
    on the CPU from the same inputs, and the card kernels that plain
    backward launched."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    q, k, v, do, mask = inputs(dev, gen, b, h, tq, tk, d, dtype, lengths)
    scale = d ** -0.5
    out, lse = fa.flash_attention_kernel(q, k, v, scale, causal, mask)
    args = (q, k, v, out, lse, do, scale, causal, mask)
    got = fa.flash_attention_bwd_kernel(*args)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        card = fa.flash_attention_bwd_plain(*args)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type.name == "CUDA"})
    cpu = fa.flash_attention_bwd_plain(*(
        a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    rows = {}
    for label, x, y, z in zip(("dq", "dk", "dv"), got, card, cpu):
        z = z.to(dev)
        rows[label] = dict(kernel_vs_card_plain=chip_smoke.scaled_err(x, y),
                           kernel_vs_cpu_plain=chip_smoke.scaled_err(x, z),
                           card_plain_vs_cpu_plain=chip_smoke.scaled_err(
                               y, z))
    return dict(readings=rows, plain_card_kernels=names)


def profiled(dev, gen, b, h, tq, tk, d, dtype, causal, lengths):
    """Device ms of each CUDA kernel of one K2 call."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    q, k, v, _, mask = inputs(dev, gen, b, h, tq, tk, d, dtype, lengths)
    ms, launches, by_name = chip_smoke.kernel_profile(
        lambda: fa.flash_attention_kernel(q, k, v, d ** -0.5, causal, mask))
    return dict(device_ms=ms, launches=launches,
                kernels={k_[:90]: t for k_, t in by_name.items()})


def verdict(kernel, library):
    """``met``, ``missed`` or ``unresolved`` (see ``--rounds``)."""
    if max(kernel) < min(library):
        return "met"
    if min(kernel) > max(library):
        return "missed"
    return "unresolved"


def interleaved(dev, gen, rounds, b, h, tq, tk, d, dtype, causal, lengths):
    """K2 and K3 against the library, timed in turn ``rounds`` times."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    q, k, v, do, mask = inputs(dev, gen, b, h, tq, tk, d, dtype, lengths)
    scale = d ** -0.5
    out, lse = fa.flash_attention_kernel(q, k, v, scale, causal, mask)
    delta = (do.float() * out.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, scale, causal, mask)
    sdpa_mask = None if mask is None else mask[:, None, None, :]
    is_causal = causal and tq == tk and mask is None
    backward, captured = chip_smoke.sdpa_backward(q, k, v, do, scale,
                                                  is_causal, mask)
    pairs = {
        "flash_attention": (
            lambda: fa.flash_attention_kernel(q, k, v, scale, causal, mask),
            lambda: F.scaled_dot_product_attention(
                q, k, v, sdpa_mask, is_causal=is_causal, scale=scale),
            True),
        "flash_attention_bwd_dq+dkv": (
            lambda: (fa.flash_attention_bwd_dq_kernel(*bwd),
                     fa.flash_attention_bwd_dkv_kernel(*bwd)),
            backward, captured)}
    times = {name: ([], []) for name in pairs}
    for _ in range(rounds):
        for name, (kernel, library, graph) in pairs.items():
            times[name][0].append(chip_smoke.time_ms(kernel))
            times[name][1].append(chip_smoke.time_ms(library, graph=graph))
    return {name: dict(kernel_ms=kt, library_ms=lt,
                       kernel_median=statistics.median(kt),
                       library_median=statistics.median(lt),
                       verdict=verdict(kt, lt))
            for name, (kt, lt) in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="gpt,bert,bert_large,ragged")
    ap.add_argument("--untimed", action="store_true")
    ap.add_argument("--cpu-plain", action="store_true")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--tree", default=ROOT)
    a = ap.parse_args()
    global chip_smoke
    sys.path.insert(0, os.path.abspath(a.tree))
    chip_smoke = importlib.import_module("chip_smoke")
    if not torch.cuda.is_available():
        print("torch_flash_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi()
    failed = 0
    for name in a.shapes.split(","):
        for b, h, tq, tk, d, dtype, causal, lengths in SHAPES[name]:
            gen = torch.Generator().manual_seed(7)
            row = dict(name=name, tree=a.tree, shape=[b, h, tq, tk, d],
                       dtype=str(dtype), causal=causal, kv_mask=lengths,
                       card=smi)
            try:
                row["cases"] = chip_smoke.flash_cases(
                    dev, gen, b, h, tq, tk, d, dtype, causal, lengths,
                    timed=not a.untimed)
            except AssertionError as e:
                failed += 1
                row["failed"] = str(e)
            if a.cpu_plain:
                row["cpu_plain"] = cpu_plain(
                    dev, torch.Generator().manual_seed(7), b, h, tq, tk, d,
                    dtype, causal, lengths)
            if a.profile:
                row["profile"] = profiled(
                    dev, torch.Generator().manual_seed(7), b, h, tq, tk, d,
                    dtype, causal, lengths)
            if a.rounds:
                row["rounds"] = interleaved(
                    dev, torch.Generator().manual_seed(7), a.rounds, b, h,
                    tq, tk, d, dtype, causal, lengths)
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    print(smi, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
