"""A training step on one card, through the kernels and through their
plain versions: do the two give the same loss trajectory?

    python3 tools/torch_bert_plain_ab.py [--model bert|bert_large|gpt]
                                         [--swap all|k4k5|k2k3|sdpa|none]
                                         [--steps 12]

Runs chip_smoke.py's training setup twice from the same weights (dropout
0, weights from seed 0, amp.decorate(Adam(1e-4), bf16_policy()), one
fixed seeded batch): ``--model bert`` (the default) its bert_train step,
BertConfig.base() with BertForPretraining.loss over 76 masked positions
per row at 64 x 512; ``--model bert_large`` its bert_large step,
BertConfig.large() at 8 x 512 on the same phase's seeded batch;
``--model gpt`` its train step, GPT.loss of GPTConfig.small() at
16 x 512. Once as the port runs it (every kernel on the card), once with
kernel wrappers replaced by their plain PyTorch versions, still on the
card: ``--swap all`` every kernel of the path, ``--swap k4k5`` only K4
(the fused MLP) and K5 (the cross-entropy statistics), ``--swap k2k3``
only K2 and K3 (flash attention forward and backward): the bf16
tensor-core routes that the f32 crosschecks never reach; ``--swap none``
none, a control that runs the kernels twice and shows how far two runs
of the same path drift apart; ``--swap sdpa`` K2 and K3 by PyTorch's
``scaled_dot_product_attention`` and its autograd backward (another bf16
flash attention, as a yardstick of the drift such kernels give). The
swaps are a diagnostic of this script only: the port itself has no such
switch. Prints one JSON line with both runs' losses (``kernel_losses``,
``swap_losses``), their largest difference, and the launches of each
run. Needs a CUDA device.
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


SWAPS = ("all", "k4k5", "k2k3", "sdpa", "none")
#: batch rows of each model's step (bert_large: chip_smoke's bert_large)
BATCH = {"bert": 64, "bert_large": 8, "gpt": 16}
CONFIG = {"bert": "BertConfig.base()", "bert_large": "BertConfig.large()",
          "gpt": "GPTConfig.small()"}


def _sdpa_forward(q, k, v, scale, causal=False, kv_mask=None):
    """K2's stand-in for ``--swap sdpa``: PyTorch's attention (no lse:
    its backward stand-in recomputes the forward)."""
    import torch.nn.functional as F
    mask = None if kv_mask is None else kv_mask[:, None, None, :]
    out = F.scaled_dot_product_attention(q, k, v, mask, is_causal=causal,
                                         scale=scale)
    return out, torch.zeros(q.shape[:3], dtype=torch.float32,
                            device=q.device)


def _sdpa_backward(q, k, v, out, lse, do, scale, causal=False,
                   kv_mask=None):
    """K3's stand-in for ``--swap sdpa``: the autograd backward of
    PyTorch's attention."""
    import torch.nn.functional as F
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    mask = None if kv_mask is None else kv_mask[:, None, None, :]
    with torch.enable_grad():
        o = F.scaled_dot_product_attention(qg, kg, vg, mask,
                                           is_causal=causal, scale=scale)
        return torch.autograd.grad(o, (qg, kg, vg), do)


def _plain_wrappers(swap):
    """{(module, name): plain stand-in} for each kernel wrapper of the
    training paths (``swap == "all"``), or for K4's and K5's alone."""
    from paddle_tpu_torch.ops.cuda import (flash_attention as fa,
                                           layer_norm as ln, mlp, xent as xe)
    flash = {
        (fa, "flash_attention_kernel"):
            lambda q, k, v, scale, causal=False, kv_mask=None:
            fa.chunked_attention(q, k, v, scale, causal, kv_mask,
                                 return_lse=True),
        (fa, "flash_attention_bwd_kernel"): fa.flash_attention_bwd_plain}
    if swap == "k4k5":
        return {(mlp, "mlp_kernel"): mlp.mlp_plain,
                (xe, "xent_stats_kernel"): xe.xent_stats_plain}
    if swap == "k2k3":
        return flash
    if swap == "none":
        return {}
    if swap == "sdpa":
        return {(fa, "flash_attention_kernel"): _sdpa_forward,
                (fa, "flash_attention_bwd_kernel"): _sdpa_backward}
    return {
        (ln, "layer_norm_kernel"): ln.layer_norm_plain,
        (ln, "add_layer_norm_kernel"): ln.add_layer_norm_plain,
        **flash,
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
    if model_name in ("bert", "bert_large"):
        large = model_name == "bert_large"
        cfg = BertConfig.large() if large else BertConfig.base()
        cfg.dropout = 0.0
        model = BertForPretraining(cfg, device="cuda", seed=0)
        ids, labels, nsp, mlm_mask, _, _, pos = chip_smoke.bert_batch(
            np.random.RandomState(5 if large else 0), cfg.vocab_size,
            BATCH[model_name], 512, 76)
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


def swapped(swap, model_name, steps):
    """:func:`run` with the kernel wrappers of ``swap`` replaced."""
    wrappers = _plain_wrappers(swap)
    saved = {key: getattr(*key) for key in wrappers}
    for (module, name), fn in wrappers.items():
        setattr(module, name, fn)
    try:
        return run(model_name, steps)
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=tuple(BATCH), default="bert")
    ap.add_argument("--swap", choices=SWAPS, default="all")
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bert_plain_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels, kernel_launches = run(args.model, args.steps)
    torch.cuda.empty_cache()
    swap, swap_launches = swapped(args.swap, args.model, args.steps)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(dict(
        part="plain_ab", model=args.model, swap=args.swap,
        device=torch.cuda.get_device_name(0), card=smi,
        config=CONFIG[args.model], batch=BATCH[args.model], seq=512,
        policy="bf16", steps=args.steps, kernel_losses=kernels,
        swap_losses=swap,
        max_loss_diff=max(abs(a - b) for a, b in zip(kernels, swap)),
        kernel_launches=kernel_launches, swap_launches=swap_launches)),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
