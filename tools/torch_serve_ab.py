"""A/B of chip_smoke.py's serve phase across source trees, on one card.

    python3 tools/torch_serve_ab.py TREE [TREE ...] [--waves 2]

Each TREE is a checkout of the repo, such as an earlier commit unpacked
with ``git archive`` into a gitignored directory. For each TREE, in the
order given, a fresh process puts that tree first on ``sys.path``, builds
its kernels, and runs its own ``chip_smoke.serve``: GPTConfig.small()
(weights from seed 0, dropout 0) behind ServingEngine(num_slots=8,
page_size=64, max_len=1024, prefill_len=512, bf16 cache), one warm-up
request, then ``--waves`` waves of 16 prompts uniform in [64, 512] plus
one of 700 tokens, 64 new tokens each. Give the trees interleaved
(A B B A) so that a drift of the shared host shows as such.

Prints one JSON line per tree and wave (decoded tokens/s, p50 TTFT, p50
step ms, steps), then the card's name and power limit. Needs a CUDA
device.
"""

import argparse
import json
import os
import subprocess
import sys

KEYS = ("decoded_tokens_per_s", "p50_ttft_ms", "p50_step_ms", "wall_s",
        "steps", "generated_tokens")


def one(tree, waves):
    """Run the serve phase of ``tree`` in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.ops.cuda import core
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    core.build()
    core.library()
    cfg = GPTConfig.small()
    cfg.dropout = 0.0
    model = GPTDecoder(cfg, device="cuda", seed=0)
    kw = dict(num_slots=8, page_size=64, max_len=1024, prefill_len=512,
              cache_dtype=torch.bfloat16)
    chip_smoke.serve(model, 1, (64, 64), None, 4, kw, seed=1)   # warm-up
    torch.cuda.synchronize()
    for wave in range(waves):
        _, _, stats = chip_smoke.serve(model, 16, (64, 512), 700, 64, kw,
                                       seed=0)
        print(json.dumps(dict(tree=os.path.relpath(tree), wave=wave,
                              **{k: stats[k] for k in KEYS})), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--one", action="store_true",
                    help=argparse.SUPPRESS)     # the per-tree child
    args = ap.parse_args()
    if args.one:
        one(args.trees[0], args.waves)
        return 0
    for tree in args.trees:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree,
             "--waves", str(args.waves)],
            stdout=subprocess.PIPE, text=True, timeout=600, check=True)
        print(out.stdout, end="", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
