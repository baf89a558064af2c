"""Check and time the port's layer norm (K1) and paged decode attention (K7)
alone, on one card: chip_smoke.py's K1 and K7 cases (``chip_smoke
.layer_norm_cases``, ``chip_smoke.decode_cases``) and its K1 readings at
the training shapes, without the rest of that script, as a quick loop for
work on the two kernels.

    python3 tools/torch_ln_decode_bench.py [--rounds N] [--timing-only]
                                            [--k7-blocks 8,16]

Prints one JSON line for the floor of ``chip_smoke.time_ms`` (a CUDA
graph of one empty kernel), one per K1 case and per K7 case as
chip_smoke.py's kernel phase gives them (errors, routes, and for the
timed cases kernel, plain and library times and the bound), and one per K1
training shape ([8192, 768] and [32768, 768] bf16), beside a copy of
the same bytes (``y.copy_(x)``). ``--k7-blocks`` times K7 at its two timed
shapes (8 slots with lengths from RandomState(0), and 32 slots x 2048
tokens; 12 heads, hd 64, page size 64, bf16) under each given
``SPLIT_BLOCKS_PER_SM`` of the split plan. ``--rounds N`` then times, in
one process, K1 and ``F.layer_norm`` in turn N times at each timed K1
shape, and K7 N times at its two timed shapes, beside the floor each
round, and prints the medians and the range: a margin under the spread
of single readings is judged from these. ``--timing-only`` prints only
those rounds and needs nothing of chip_smoke.py but ``time_ms`` (the
floor where it has ``floor_ms``), so a copy of this script times an
earlier commit's kernels from inside that commit's tree. Then the card's
name and power limit. Needs a CUDA device.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (at the repo root: the K1/K7 cases)

LN_SHAPES = ((8, torch.float32), (512, torch.float32),
             (8192, torch.bfloat16), (32768, torch.bfloat16))


def _spread(xs):
    return dict(median=float(np.median(xs)), min=float(min(xs)),
                max=float(max(xs)), rounds=len(xs))


def _decode_inputs(dev, randn, rs, lengths, pmax, heads=12, hd=64, ps=64):
    """A bf16 pool of ``len(lengths) x pmax`` pages, every row written, a
    page table that is a seeded permutation, the lengths and a query."""
    from paddle_tpu_torch.ops.attention import init_page_pool, paged_write
    slots = len(lengths)
    n = slots * pmax
    pool = init_page_pool(n, heads, ps, hd, dtype=torch.bfloat16,
                          device=dev)
    ptab = torch.from_numpy(rs.permutation(n).astype(np.int32)).reshape(
        slots, pmax).to(dev)
    paged_write(pool, randn(n * ps, heads, hd), randn(n * ps, heads, hd),
                ptab.reshape(-1).long().repeat_interleave(ps),
                torch.arange(ps, device=dev).repeat(n))
    lens = torch.tensor([int(v) for v in lengths], dtype=torch.int32,
                        device=dev)
    return pool, ptab, lens, randn(slots, heads, hd)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--timing-only", action="store_true")
    ap.add_argument("--k7-blocks", type=lambda v: [int(b) for b in
                                                   v.split(",")],
                    default=[])
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ln_decode_bench: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi()
    g = torch.Generator().manual_seed(7)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def floor():
        return (chip_smoke.floor_ms(dev) if hasattr(chip_smoke, "floor_ms")
                else None)

    if not a.timing_only:
        print(json.dumps(dict(phase="floor", ms=floor())), flush=True)
        for case in chip_smoke.layer_norm_cases(randn):
            print(json.dumps(dict(kernel="layer_norm", **case)), flush=True)
        for case in chip_smoke.decode_cases(dev, randn):
            print(json.dumps(dict(kernel="decode_attention", **case)),
                  flush=True)
    ln_inputs = {}
    for rows, dtype in LN_SHAPES:
        x = randn(rows, 768, dtype=dtype)
        gam, bet = randn(768, dtype=dtype) * 0.1 + 1.0, randn(
            768, dtype=dtype) * 0.1
        ln_inputs[(rows, str(dtype))] = (x, gam, bet)
        if rows > 512 and not a.timing_only:
            y = torch.empty_like(x)
            print(json.dumps(dict(kernel="layer_norm", shape=[rows, 768],
                                  dtype=str(dtype),
                                  **chip_smoke.ln_timing(x, gam, bet),
                                  copy_ms=chip_smoke.time_ms(
                                      lambda: y.copy_(x)))),
                  flush=True)
    rs = np.random.RandomState(0)
    k7 = [_decode_inputs(dev, randn, rs, list(rs.randint(1, 1025, 8)), 16),
          _decode_inputs(dev, randn, rs, [2048] * 32, 32)]
    for blocks in a.k7_blocks:
        da.SPLIT_BLOCKS_PER_SM = blocks
        for pool, ptab, lens, q in k7:
            ms = chip_smoke.time_ms(lambda: da.paged_decode_kernel(
                q, pool["k"], pool["v"], ptab, lens, 0.125))
            print(json.dumps(dict(kernel="decode_attention",
                                  slots=len(lens), blocks_per_sm=blocks,
                                  kernel_ms=ms)), flush=True)
    if a.rounds:
        for (rows, dtype), (x, gam, bet) in ln_inputs.items():
            kern, lib, floors = [], [], []
            for _ in range(a.rounds):
                floors.append(floor())
                kern.append(chip_smoke.time_ms(
                    lambda: ln.layer_norm_kernel(x, gam, bet, 1e-5)))
                lib.append(chip_smoke.time_ms(
                    lambda: torch.nn.functional.layer_norm(
                        x, (768,), gam, bet, 1e-5)))
            print(json.dumps(dict(
                kernel="layer_norm", shape=[rows, 768], dtype=dtype,
                kernel_ms=_spread(kern), library_ms=_spread(lib),
                floor_ms=floors, kernel_below_every_library=max(kern)
                < min(lib))), flush=True)
        for pool, ptab, lens, q in k7:
            kern, floors = [], []
            for _ in range(a.rounds):
                floors.append(floor())
                kern.append(chip_smoke.time_ms(
                    lambda: da.paged_decode_kernel(q, pool["k"], pool["v"],
                                                   ptab, lens, 0.125)))
            print(json.dumps(dict(
                kernel="decode_attention", slots=len(lens),
                live_tokens=int(lens.sum()), kernel_ms=_spread(kern),
                floor_ms=floors)), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
