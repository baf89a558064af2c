"""Host time of the engine's export hooks on the card: the part of
``chip_smoke.py``'s export phase that grows with the model's depth.

    python3 tools/torch_export_cost.py [--repeat N] [--after-kernels]

Builds chip_smoke.py's serve engine (GPTConfig.small(), weights from
seed 0, ServeConfig(num_slots=8, page_size=64, max_len=1024,
prefill_len=512, bf16 cache)) with 8 running requests, then times, in
one process and in this order, ``--repeat`` rounds of
``compiled_decode()``, ``compiled_verify()`` (on a draft engine over the
same model) and ``export_decode()`` into a temporary directory: the first
round carries the warm-up of ``make_fx`` and ``torch.export`` in a fresh
interpreter, the later ones do not. ``--after-kernels`` first runs
``chip_smoke.kernel_cases`` (the state the export phase starts from).
Prints one JSON line of seconds per hook and round, and the card's name
and power limit.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--after-kernels", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_export_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    core.build()
    if args.after_kernels:
        cs.kernel_cases(torch.device("cuda"))
        torch.cuda.empty_cache()
    cfg = GPTConfig.small()
    cfg.dropout = 0.0
    model = GPTDecoder(cfg, device="cuda", seed=0)
    kw = dict(num_slots=8, page_size=64, max_len=1024, prefill_len=512,
              cache_dtype=torch.bfloat16)
    eng = ServingEngine(model, ServeConfig(**kw))
    rs = np.random.RandomState(21)
    for _ in range(kw["num_slots"]):
        eng.submit(rs.randint(0, cfg.vocab_size, 100).astype(np.int32),
                   max_new=32)
    while eng._queue:
        eng.step()
    spec = ServingEngine(model, ServeConfig(**kw, draft=True, spec_k=3))
    root = tempfile.mkdtemp(prefix="export_cost_")
    hooks = {"compiled_decode": eng.compiled_decode,
             "compiled_verify": spec.compiled_verify,
             "export_decode": lambda: eng.export_decode(
                 os.path.join(root, "decode"))}
    seconds = {name: [] for name in hooks}
    for _ in range(args.repeat):
        for name, hook in hooks.items():
            t = time.perf_counter()
            hook()
            seconds[name].append(time.perf_counter() - t)
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(dict(seconds=seconds, after_kernels=args.after_kernels,
                          card=cs.nvidia_smi(),
                          torch=torch.__version__)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
