"""Where the time of the PyTorch port's serving step goes, on one card.

    python3 tools/torch_serve_profile.py [--steps 20] [--out DIR]

Builds the serving path chip_smoke.py drives (GPTConfig.small() with
weights from a seed, ServingEngine(num_slots=8, page_size=64,
max_len=1024, prefill_len=512, bf16 cache)), fills all 8 slots, and
profiles with torch.profiler:

* ``decode``: ``--steps`` steady decode steps (8 active slots, no
  admission) — host wall time per step, device time per step (the sum of
  the CUDA kernels, which run on one stream and do not overlap), the
  device's idle share, kernel launches per step, and device time by
  kernel name (every kernel);
* ``prefill``: one admission of a 512-token prompt (one first-chunk
  prefill call) measured the same way.

Prints one JSON line per part and writes the Chrome traces under
``--out`` (default ``chiprun_out/``). Needs a CUDA device.
"""

import argparse
import collections
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _kernel_times(prof):
    """(total device µs, launches, {name: µs}) of the CUDA kernels. The
    device-side spans of ``record_function`` annotations (such as
    ``Optimizer.step``) cover kernels already counted and are skipped."""
    by_name = collections.Counter()
    launches = 0
    for evt in prof.events():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        us = evt.time_range.elapsed_us()
        by_name[evt.name] += us
        launches += 1
    return sum(by_name.values()), launches, by_name


def _profiled(fn, trace_path):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    return wall, prof


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    core.library()
    cfg = GPTConfig.small()
    cfg.dropout = 0.0
    model = GPTDecoder(cfg, device="cuda", seed=0)
    eng = ServingEngine(model, ServeConfig(
        num_slots=8, page_size=64, max_len=1024, prefill_len=512,
        cache_dtype=torch.bfloat16))
    rs = np.random.RandomState(0)
    for n in rs.randint(64, 513, 8):
        eng.submit(rs.randint(0, cfg.vocab_size, n).astype(np.int32),
                   max_new=args.steps + 40)
    for _ in range(10):                 # admission + warm decode steps
        eng.step()
    assert len(eng._running) == 8 and not eng._queue

    def decode():
        for _ in range(args.steps):
            eng.step()

    kind = torch.cuda.get_device_name(0)
    per = args.steps
    wall, prof = _profiled(decode, os.path.join(args.out,
                                                "serve_decode.json"))
    busy_us, launches, by_name = _kernel_times(prof)
    print(json.dumps(dict(
        part="decode", device=kind, steps=per, step_ms=wall / per * 1e3,
        device_ms_per_step=(busy_us / per / 1e3) if busy_us else None,
        idle_share=(1 - busy_us / 1e6 / wall) if busy_us else None,
        launches_per_step=launches / per,
        top_kernels_ms_per_step={name[:80]: us / per / 1e3
                                 for name, us in by_name.most_common()})),
        flush=True)

    # one first-chunk prefill of a 512-token prompt
    eng2 = ServingEngine(model, ServeConfig(
        num_slots=8, page_size=64, max_len=1024, prefill_len=512,
        cache_dtype=torch.bfloat16))
    eng2.submit(rs.randint(0, cfg.vocab_size, 64).astype(np.int32),
                max_new=1)
    eng2.drain()                        # warm the admission path
    eng2.submit(rs.randint(0, cfg.vocab_size, 512).astype(np.int32),
                max_new=1)
    wall, prof = _profiled(eng2.step, os.path.join(args.out,
                                                   "serve_prefill.json"))
    busy_us, launches, by_name = _kernel_times(prof)
    print(json.dumps(dict(
        part="prefill", device=kind, prompt=512, wall_ms=wall * 1e3,
        device_ms=busy_us / 1e3 if busy_us else None,
        idle_share=(1 - busy_us / 1e6 / wall) if busy_us else None,
        launches=launches,
        top_kernels_ms={name[:80]: us / 1e3
                        for name, us in by_name.most_common(12)})),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
