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

With ``--shared`` each tree runs its ``chip_smoke.py`` serve_shared
wave instead (32 requests over 4 shared system prompts, odd ids sampled;
trees from the commit that added that phase on): per wave one run
through the prefix cache at ``chip_smoke.SHARED_PAGES`` pages and one
with the cache off and a full pool, then ``chip_smoke.sampling_ms`` (the
host time of one call of the sampler and of the greedy argmax).

Prints one JSON line per tree and wave (decoded tokens/s, p50 TTFT, p50
step ms, steps); without ``--shared`` also one line per tree with the
device ms of one first prefill chunk (512 tokens of one request into an
empty bf16 pool, through the model's ``paged_prefill_chunk``, under
``chip_smoke.kernel_profile``, L2 warm) and its largest kernels; then the
card's name and power limit. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

KEYS = ("decoded_tokens_per_s", "p50_ttft_ms", "p50_step_ms", "wall_s",
        "steps", "generated_tokens")


def one(tree, waves, shared=False):
    """Run the serve phase (or the serve_shared wave) of ``tree`` in this
    process."""
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
    name = os.path.relpath(tree)
    if shared:
        shared_waves(chip_smoke, model, kw, name, waves)
        return
    chip_smoke.serve(model, 1, (64, 64), None, 4, kw, seed=1)   # warm-up
    torch.cuda.synchronize()
    for wave in range(waves):
        _, _, stats = chip_smoke.serve(model, 16, (64, 512), 700, 64, kw,
                                       seed=0)
        print(json.dumps(dict(tree=os.path.relpath(tree), wave=wave,
                              **{k: stats[k] for k in KEYS})), flush=True)
    print(json.dumps(dict(tree=os.path.relpath(tree),
                          **chunk_ms(chip_smoke, model, kw))), flush=True)


def chunk_ms(chip_smoke, model, kw, top=8):
    """Device ms, launches and the ``top`` largest kernels (ms by name) of
    one first prefill chunk of ``kw["prefill_len"]`` tokens."""
    import numpy as np
    import torch
    n, ps = kw["prefill_len"], kw["page_size"]
    pools = model.init_paged_caches(n // ps + 1, ps, dtype=kw["cache_dtype"])
    table = torch.arange(n // ps, dtype=torch.int32, device="cuda")[None]
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, model.cfg.vocab_size, (1, n)).astype(np.int32)).cuda()
    starts = torch.zeros(1, dtype=torch.int32)
    lengths = torch.tensor([n], dtype=torch.int32)
    with torch.inference_mode():
        ms, launches, by_name = chip_smoke.kernel_profile(
            lambda: model.paged_prefill_chunk(prompt, starts, lengths, pools,
                                              table))
    return dict(chunk_device_ms=ms, chunk_launches=launches,
                chunk_kernels={k[:70]: v for k, v in
                               by_name.most_common(top)})


def shared_waves(chip_smoke, model, kw, name, waves):
    wave_reqs = chip_smoke.shared_wave(model.cfg.vocab_size,
                                       chip_smoke.SHARED_SEED)
    runs = (("cached", dict(kw, num_pages=chip_smoke.SHARED_PAGES)),
            ("cache_off", dict(kw, prefix_cache=False)))
    chip_smoke.drive(model, runs[0][1], wave_reqs[:2])          # warm-up
    for wave in range(waves):
        for run, run_kw in runs:
            _, _, stats = chip_smoke.drive(model, run_kw, wave_reqs)
            print(json.dumps(dict(tree=name, wave=wave, run=run,
                                  **{k: stats[k] for k in KEYS})),
                  flush=True)
        print(json.dumps(dict(tree=name, wave=wave, **chip_smoke.sampling_ms(
            model.cfg.vocab_size, kw["num_slots"]))), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--shared", action="store_true",
                    help="run the serve_shared wave")
    ap.add_argument("--one", action="store_true",
                    help=argparse.SUPPRESS)     # the per-tree child
    args = ap.parse_args()
    if args.one:
        one(args.trees[0], args.waves, args.shared)
        return 0
    for tree in args.trees:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree,
             "--waves", str(args.waves)] + ["--shared"] * args.shared,
            stdout=subprocess.PIPE, text=True, timeout=600, check=True)
        print(out.stdout, end="", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
