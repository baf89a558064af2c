"""chip_smoke.py's serve_fleet untraced window, repeated, on one card.

    python3 tools/torch_trace_overhead.py [--windows 3] [--replicas 4]

GPTConfig.small() (weights from seed 0, dropout 0) behind serve_fleet's
FleetRouter (``chip_smoke.fleet_serve_kw``, ``fleet_stream`` and
``fleet_run``: 4n warm-up and 8n timed requests, the busiest replica
killed when ``--replicas`` is ``chip_smoke.FLEET_KILL_AT``). Each window
runs in ABBA order: traced, untraced (``trace_fleet`` off and the flight
ring at 0, as bench.py:1004-1039 turns them off), untraced, traced. The
first window also warms the process (kernels loaded, allocator filled)
and is reported beside the others.

Prints one JSON line per run (window, position, traced, tokens/s, p50
round ms), then one line with each window's two ratios (untraced /
traced tokens/s, untraced second and untraced first), the pooled ratio
over all windows and the spread of the traced and the untraced runs,
then the card's name and power limit. Needs a CUDA device.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.observability import flight
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.serving import fleet
    if not torch.cuda.is_available():
        raise SystemExit("torch_trace_overhead: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    core.build()
    core.library()
    cfg = GPTConfig.small()
    cfg.dropout = 0.0
    model = GPTDecoder(cfg, device="cuda", seed=0)
    kw = cs.fleet_serve_kw()
    n = args.replicas
    stream = cs.fleet_stream(cfg.vocab_size,
                             (cs.FLEET_WARM + cs.FLEET_TIMED) * n)
    was_trace = fleet.configure()["trace_fleet"]
    was_ring = flight.configure()["ring"]
    tps = {True: [], False: []}
    pairs = []
    for w in range(args.windows):
        got = []
        for pos, traced in enumerate((True, False, False, True)):
            if not traced:
                fleet.configure(trace_fleet=False)
                flight.configure(ring=0)
            try:
                router, line = cs.fleet_run(model, n, stream, kw,
                                            kill=n == cs.FLEET_KILL_AT)
            finally:
                fleet.configure(trace_fleet=was_trace)
                flight.configure(ring=was_ring)
            router.close()
            got.append(line["tokens_per_s"])
            tps[traced].append(line["tokens_per_s"])
            print(json.dumps(dict(window=w, position=pos, traced=traced,
                                  replicas=n,
                                  tokens_per_s=line["tokens_per_s"],
                                  p50_round_ms=line["p50_round_ms"],
                                  completed=line["completed"])),
                  flush=True)
        t1, u1, u2, t2 = got
        pairs.append([u1 / t1, u2 / t2])
    t = np.array(tps[True]).reshape(-1, 2)
    u = np.array(tps[False]).reshape(-1, 2)
    print(json.dumps(dict(
        replicas=n, windows=args.windows, pairs=pairs,
        trace_overhead=float(u.sum() / t.sum()),
        trace_overhead_after_first=(float(u[1:].sum() / t[1:].sum())
                                    if args.windows > 1 else None),
        traced_tokens_per_s=tps[True], untraced_tokens_per_s=tps[False],
        traced_cv=float(t.std() / t.mean()),
        untraced_cv=float(u.std() / u.mean()))), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
