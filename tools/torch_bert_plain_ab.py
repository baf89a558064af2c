"""A training step on one card, through the kernels and through their
plain versions: do the two give the same loss trajectory?

    python3 tools/torch_bert_plain_ab.py [--model bert|gpt]
                                         [--swap all|k4k5] [--steps 12]

Runs chip_smoke.py's training setup twice from the same weights (dropout
0, weights from seed 0, amp.decorate(Adam(1e-4), bf16_policy()), one
fixed seeded batch): ``--model bert`` (the default) its bert_train step,
BertConfig.base() with BertForPretraining.loss over 76 masked positions
per row at 64 x 512; ``--model gpt`` its train step, GPT.loss of
GPTConfig.small() at 16 x 512. Once as the port runs it (every kernel on
the card), once with kernel wrappers replaced by their plain PyTorch
versions, still on the card: ``--swap all`` every kernel of the path,
``--swap k4k5`` only K4 (the fused MLP) and K5 (the cross-entropy
statistics), whose bf16 tensor-core routes the f32 crosschecks never
reach. The second run is a diagnostic of this script only: the port
itself has no such switch. Prints one JSON line with both loss lists,
their largest difference, and the launches of each run. Needs a CUDA
device.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (at the repo root: bert_batch)


def _plain_wrappers(swap):
    """{(module, name): plain stand-in} for each kernel wrapper of the
    training paths (``swap == "all"``), or for K4's and K5's alone."""
    from paddle_tpu_torch.ops.cuda import (flash_attention as fa,
                                           layer_norm as ln, mlp, xent as xe)
    if swap == "k4k5":
        return {(mlp, "mlp_kernel"): mlp.mlp_plain,
                (xe, "xent_stats_kernel"): xe.xent_stats_plain}
    return {
        (ln, "layer_norm_kernel"): ln.layer_norm_plain,
        (ln, "add_layer_norm_kernel"): ln.add_layer_norm_plain,
        (fa, "flash_attention_kernel"):
            lambda q, k, v, scale, causal=False, kv_mask=None:
            fa.chunked_attention(q, k, v, scale, causal, kv_mask,
                                 return_lse=True),
        (fa, "flash_attention_bwd_kernel"): fa.flash_attention_bwd_plain,
        (mlp, "mlp_kernel"): mlp.mlp_plain,
        (xe, "xent_stats_kernel"): xe.xent_stats_plain,
        (xe, "xent_bwd_kernel"): xe.xent_bwd_plain,
    }


def run(model_name, steps):
    """Losses and launches of ``steps`` training steps from seed 0."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Adam
    if model_name == "bert":
        cfg = BertConfig.base()
        cfg.dropout = 0.0
        model = BertForPretraining(cfg, device="cuda", seed=0)
        ids, labels, nsp, mlm_mask, _, _, pos = chip_smoke.bert_batch(
            np.random.RandomState(0), cfg.vocab_size, 64, 512, 76)
        pos = pos.cuda()
        args = tuple(a.cuda() for a in (ids, labels, nsp, mlm_mask))

        def loss_fn(m, *a):
            return m.loss(*a, mask_positions=pos)
    else:
        cfg = GPTConfig.small()
        cfg.dropout = 0.0
        model = GPT(cfg, device="cuda", seed=0)
        args = (torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (16, 512))).cuda(),)
        loss_fn = chip_smoke.loss_of
    opt = amp.decorate(Adam(model.parameters(), 1e-4), amp.bf16_policy())
    core.reset_launches()
    losses = [float(opt.minimize(model, loss_fn, *args))
              for _ in range(steps)]
    return losses, {k: n for k, n in core.launch_counts().items() if n}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("bert", "gpt"), default="bert")
    ap.add_argument("--swap", choices=("all", "k4k5"), default="all")
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bert_plain_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels, kernel_launches = run(args.model, args.steps)
    torch.cuda.empty_cache()
    wrappers = _plain_wrappers(args.swap)
    saved = {key: getattr(*key) for key in wrappers}
    for (module, name), fn in wrappers.items():
        setattr(module, name, fn)
    try:
        plain, plain_launches = run(args.model, args.steps)
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(dict(
        part="plain_ab", model=args.model, swap=args.swap,
        device=torch.cuda.get_device_name(0), card=smi,
        config=("BertConfig.base()" if args.model == "bert"
                else "GPTConfig.small()"),
        batch=64 if args.model == "bert" else 16, seq=512,
        policy="bf16", steps=args.steps, kernel_losses=kernels,
        plain_losses=plain,
        max_loss_diff=max(abs(a - b) for a, b in zip(kernels, plain)),
        kernel_launches=kernel_launches, plain_launches=plain_launches)),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
