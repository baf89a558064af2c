"""Where the time of the PyTorch port's training step goes, on one card.

    python3 tools/torch_train_profile.py
        [--model gpt|bert|bert_large|transformer|seq2seq] [--steps 5]
        [--out DIR]

Builds the training step chip_smoke.py drives under
amp.decorate(Adam(1e-4), bf16_policy()), dropout 0 and weights from a
seed: ``--model gpt`` (the default) GPT.loss of GPTConfig.small() on one
fixed seeded batch of 16 x 512; ``--model bert`` BertForPretraining.loss
of BertConfig.base() on one fixed seeded batch of 64 x 512 with 76
masked positions per row (chip_smoke.py's bert_train phase);
``--model bert_large`` BertConfig.large() on chip_smoke.py's bert_large
batch of 8 x 512; ``--model transformer`` Transformer.loss of
TransformerConfig.big() on chip_smoke.py's transformer_big batch of
32 x 256; ``--model seq2seq`` the seq2seq phase's f32 Adam(3e-2) step of
Seq2SeqConfig() on its batch of 64 (no amp: that phase trains in f32).
It runs 2
warm-up steps, and profiles ``--steps`` steady steps
with torch.profiler: host wall time per step, device time per step (the
sum of the CUDA kernels, which run on one stream and do not overlap), the
device's idle share, kernel launches per step (every CUDA kernel, and the
port's own kernels by their launch counts and, for K4 and K5, by route),
peak device memory, and device time per step by kernel name.

Prints one JSON line and writes the Chrome trace under ``--out``
(default ``chiprun_out/``) as ``<model>_train_step.json``. Needs a CUDA
device.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (at the repo root: bert_batch)


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
        by_name[evt.name] += evt.time_range.elapsed_us()
        launches += 1
    return sum(by_name.values()), launches, by_name


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("gpt", "bert", "bert_large",
                                        "transformer", "seq2seq"),
                    default="gpt")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Adam
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    core.library()
    if args.model == "gpt":
        from paddle_tpu_torch.models.gpt import GPT, GPTConfig
        cfg, batch, seq = GPTConfig.small(), 16, 512
        config = "GPTConfig.small()"
        cfg.dropout = 0.0
        model = GPT(cfg, device="cuda", seed=0)
        data = (torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (batch, seq))).cuda(),)

        def loss_fn(m, x):
            return m.loss(x)
    elif args.model == "transformer":
        from paddle_tpu_torch.models.transformer import (Transformer,
                                                         TransformerConfig)
        cfg, batch, seq = TransformerConfig.big(), 32, 256
        config = "TransformerConfig.big()"
        cfg.dropout = 0.0
        model = Transformer(cfg, device="cuda", seed=0)
        data = tuple(a.cuda() for a in chip_smoke.transformer_batch(
            np.random.RandomState(0), cfg.tgt_vocab, batch, seq))

        def loss_fn(m, *a):
            return m.loss(*a)
    elif args.model == "seq2seq":
        from paddle_tpu_torch.models import seq2seq as s2s
        cfg, batch, seq = s2s.Seq2SeqConfig(), 64, 32
        config = "Seq2SeqConfig()"
        model = s2s.AttentionSeq2Seq(cfg, device="cuda", seed=0)
        data = tuple(a.cuda() for a in chip_smoke.seq2seq_batch(
            np.random.RandomState(9), cfg.tgt_vocab, batch, seq, seq, 8))

        def loss_fn(m, src, lengths, tgt_in, tgt, tgt_lengths):
            return s2s.nmt_loss(m(src, lengths, tgt_in), tgt, tgt_lengths)
    else:
        from paddle_tpu_torch.models.bert import (BertConfig,
                                                  BertForPretraining)
        large = args.model == "bert_large"
        cfg = BertConfig.large() if large else BertConfig.base()
        batch, seq = (8 if large else 64), 512
        config = "BertConfig.large()" if large else "BertConfig.base()"
        cfg.dropout = 0.0
        model = BertForPretraining(cfg, device="cuda", seed=0)
        ids, labels, nsp, mlm_mask, _, _, pos = chip_smoke.bert_batch(
            np.random.RandomState(5 if large else 0), cfg.vocab_size, batch,
            seq, 76)
        pos = pos.cuda()
        data = tuple(a.cuda() for a in (ids, labels, nsp, mlm_mask))

        def loss_fn(m, *a):
            return m.loss(*a, mask_positions=pos)
    if args.model == "seq2seq":
        opt, policy = Adam(model.parameters(), 3e-2), "f32"
    else:
        opt = amp.decorate(Adam(model.parameters(), 1e-4),
                           amp.bf16_policy())
        policy = "bf16"

    def step():
        return float(opt.minimize(model, loss_fn, *data))

    for _ in range(2):                   # warm-up
        step()
    torch.cuda.synchronize()
    core.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    losses = []
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            losses.append(step())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(args.out,
                                          f"{args.model}_train_step.json"))
    busy_us, launches, by_name = _kernel_times(prof)
    per = args.steps
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(dict(
        part="train_step", device=torch.cuda.get_device_name(0), card=smi,
        config=config, batch=batch, seq=seq, policy=policy,
        steps=per, losses=losses, step_ms=wall / per * 1e3,
        device_ms_per_step=(busy_us / per / 1e3) if busy_us else None,
        idle_share=(1 - busy_us / 1e6 / wall) if busy_us else None,
        launches_per_step=launches / per,
        port_launches_per_step={k: n / per
                                for k, n in core.launch_counts().items()},
        port_routes_per_step={k: {r: n / per for r, n in v.items()}
                              for k, v in core.route_counts().items()},
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        top_kernels_ms_per_step={name[:120]: us / per / 1e3
                                 for name, us in by_name.most_common(20)})),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
