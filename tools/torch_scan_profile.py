"""The GPT training step unrolled against scan-over-layers, on one card.

    python3 tools/torch_scan_profile.py [--rounds 2]

Builds chip_smoke.py's train step (GPT.loss of GPTConfig.small() under
amp.decorate(Adam(1e-4), bf16_policy()), dropout 0, weights from seed 0,
one fixed seeded batch of 16 x 512) twice, with unrolled blocks and with
``scan_layers=True`` (remat "nothing"), and for each, in turn for
``--rounds`` rounds: 7 steps (the p50 of the last 5 on the host clock,
each ending with a host read of the loss), then one step under
torch.profiler (chip_smoke.kernel_profile: device ms and CUDA kernel
launches). Prints one JSON line per model and round with the number of
parameter leaves the optimizer and amp's cast walk. Needs a CUDA device.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_scan_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Adam
    torch.backends.cuda.matmul.allow_tf32 = False
    core.build()
    smi = cs.nvidia_smi()
    for rnd in range(args.rounds):
        for scan in (False, True):
            cfg = GPTConfig.small()
            cfg.dropout = 0.0
            cfg.scan_layers = scan
            model = GPT(cfg, device="cuda", seed=0)
            opt = amp.decorate(Adam(model.parameters(), 1e-4),
                               amp.bf16_policy())
            ids = torch.from_numpy(np.random.RandomState(0).randint(
                0, cfg.vocab_size, (16, 512))).cuda()

            def step():
                float(opt.minimize(model, cs.loss_of, ids))
            times = []
            for _ in range(7):
                t0 = time.perf_counter()
                step()
                times.append(time.perf_counter() - t0)
            ms, launches, by_name = cs.kernel_profile(step)
            cs.emit(dict(round=rnd, scan_layers=scan,
                         leaves=len(list(model.parameters())),
                         p50_step_ms=float(np.median(times[2:])) * 1e3,
                         device_ms=ms, kernel_launches=launches,
                         top={k[:50]: v for k, v in
                              by_name.most_common(5)}, card=smi))
            del model, opt
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
