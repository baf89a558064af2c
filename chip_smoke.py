"""Drive the PyTorch/CUDA port's serving, GPT training and BERT pretraining
paths on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — needs a CUDA device (exits non-zero without one); prints the
   card's name and power limit from nvidia-smi; turns TF32 off.
2. build   — compiles the kernels from paddle_tpu_torch/csrc with nvcc.
3. kernel  — each kernel (K1 layer norm, K2 flash attention, K3 flash
   backward dq and dk/dv, K4 fused MLP, K5 fused cross-entropy statistics,
   K6 its backward dh and dw/db, K7 paged decode attention, K8 fused
   residual add + layer norm) at the serving, training or BERT path's
   shapes and at ragged shapes, against its
   plain PyTorch version on the same inputs, with the stated tolerance
   (the serving kernels' outputs absolutely; the training path's each on
   its own scale max |plain|, bf16 K6 within 2^-8 of it since its second
   product takes the dlogits in bf16); times the kernel, the plain version
   and, where one exists, one PyTorch library call computing the same
   function, beside the least time the card could take (bytes over
   3.35 TB/s or operations over the peak rate of the input type). K4
   and K5 (the tc route) also at BertConfig.base()'s and .large()'s
   shapes.
4. serve   — GPTConfig.small() at full width (random weights from a
   seed) behind ServingEngine(num_slots=8, page_size=64, max_len=1024,
   prefill_len=512, bf16 cache): 16 prompts uniform in [64, 512] plus one
   of 700 tokens (chunked prefill), 64 new tokens each. The launch counts
   are zeroed just before and read just after; each serving kernel (K1,
   K2, K4, K7) must have run.
5. crosscheck — two of those requests replayed teacher-forced on the
   card and on the CPU (plain path, f32 cache, same weights); logits must
   agree within the stated tolerance.
6. int8    — a short serve with an int8 KV pool.
7. train   — the GPT training step at full width (GPTConfig.small(),
   dropout 0, weights from a seed): GPT.loss, its backward and
   amp.decorate(Adam(1e-4), bf16_policy()), batch 16 x seq 512 of one
   fixed seeded batch; 2 warm-up steps, then 10 timed steps with the
   launch counts zeroed just before and read just after. Each training
   kernel (K1-K6) must launch its expected count per step, the loss must
   be finite at every step and fall from the first step to the last.
8. train crosscheck — one f32 step (TF32 off) of GPTConfig.small() at
   batch 2 x seq 128 on the card and on the CPU plain path from the same
   weights: loss and every parameter's gradient must agree.
9. bert_train — bench.py's BERT row on the card: BertConfig.base()
   (dropout 0, weights from a seed), BertForPretraining.loss with 76
   gathered MLM positions per row, its backward and
   amp.decorate(Adam(1e-4), bf16_policy()), batch 64 x seq 512 of one
   fixed seeded batch; 2 warm-up and 10 timed steps with the launch
   counts zeroed just before. Each kernel of the path (K1-K6, K8) must
   launch its expected count per step; the loss must be finite and fall.
10. bert_crosscheck — one f32 step (TF32 off) of BertConfig.base() at
   batch 2 x seq 128 with a padded attention mask (K2/K3 with kv_mask),
   token types and 19 mask positions per row, on the card and on the CPU
   plain path: loss and every parameter's gradient must agree.
11. bert_large — BertConfig.large() (H = 1024, 24 layers) at full width
   and depth, batch 8 x seq 512 (bench.py's 64 cut to 8), 1 warm-up and
   3 timed bf16 Adam steps: every kernel of the path launches its count
   per step (K5/K6 at H = 1024) and every loss is finite.

K4 and K5 have two routes each: bf16 with widths that are multiples of 8
takes the tensor cores (the TMA + wgmma mainloop of csrc/gemm.cuh), f32
the SIMT kernel. Every K4 and K5 case records the route it took and must
have taken that one; every K4 and K5 launch of train, bert_train and
bert_large must be on the tensor cores, every K4 launch of serve on the
SIMT kernel.

Then the {"kernels": [...]} line (each kernel with the launches of its
own path: serve for K1, K2, K4's SIMT row and K7, train for K3, K4's tc
row ("mlp.tc"), K5 and K6, bert for K8; "variant" names the route), the
nvidia-smi line, and the contract line {"ok": true, "device": {...}}.
Any failed phase raises, and the script exits non-zero without the
contract line.
"""

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES = 3.35e12                     # H100 SXM HBM3
PEAK_OPS = {torch.float32: 67e12,        # f32 outside the tensor cores
            torch.bfloat16: 989e12,      # dense bf16 tensor cores
            torch.int8: 1979e12}         # dense int8 tensor cores
F32_TOL = 1e-4     # f32 kernels: sums in another order than cuBLAS/torch
BF16_TOL = 3e-2    # bf16 storage: one bf16 rounding of outputs ~ 2^-8 rel
XENT_BF16_TOL = 2.0 ** -8   # bf16 K6: gch rounded to bf16 (2^-9 rel) for
                            # its second product; f32 outputs
SERVE_LOGIT_TOL = 5e-2   # bf16 KV cache on the card vs f32 cache on CPU
TRAIN_LOSS_TOL = 1e-4    # f32 train step, card vs CPU plain path
TRAIN_GRAD_TOL = 1e-3    # relative L2 of each parameter's gradient: sums
                         # in other orders, embedding gradients by atomics
                         # in an order that changes from run to run

#: the kernels each path must launch
SERVE_KERNELS = ("layer_norm", "flash_attention", "mlp", "decode_attention")
TRAIN_KERNELS = ("layer_norm", "flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "mlp", "xent_stats",
                 "xent_bwd_dh", "xent_bwd_dwb")
BERT_KERNELS = TRAIN_KERNELS + ("add_layer_norm",)
#: the kernels with a tensor-core route (bf16) beside their SIMT one
TC_KERNELS = ("mlp", "xent_stats")


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, graph=True):
    """Mean device time of ``fn`` over ``iters`` runs. ``fn`` is captured
    once as a CUDA graph, and each replay is bracketed by its own CUDA
    events right after a 256 MiB memset: the memset evicts the 50 MB L2
    (inputs are read cold, as the model reads its weights) and keeps the
    device busy while the host enqueues the replay, so host launch time
    stays out of the reading. ``graph=False`` brackets plain calls
    instead (for autograd backward calls, timed as library yardsticks at
    sizes where a call takes milliseconds)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cuda_graph):
            fn()
        run = cuda_graph.replay
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    marks = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def route_of(name, fn, *args):
    """``(fn(*args), the route its launch of kernel ``name`` took)``."""
    from paddle_tpu_torch.ops.cuda import core
    before = dict(core.KERNELS[name].route_launches)
    out = fn(*args)
    after = core.KERNELS[name].route_launches
    taken = [r for r in after if after[r] != before[r]]
    if len(taken) != 1:
        raise AssertionError(f"{name}: one launch expected, routes {taken}")
    return out, taken[0]


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check(name, err, tol):
    if not (err <= tol):
        raise AssertionError(f"{name}: max |kernel - plain| = {err} > {tol}")


def scaled_err(got, want):
    """``(max |got - want|, that over max |want|)``; where ``want`` is all
    zero the second is 0 if ``got`` matches it exactly, else inf."""
    if not want.numel():
        return 0.0, 0.0
    err = max_err(got, want)
    top = float(want.float().abs().max())
    return err, (err / top if top > 0 else
                 (0.0 if err == 0 else float("inf")))


def held(name, got, want, dtype, tol=None):
    """Hold each output against its own plain version on its own scale:
    max |kernel - plain| <= tol * max |plain| (tol 1e-4 in f32, 3e-2 in
    bf16, unless given), so the limit is a small fraction of each output's
    largest value whatever its magnitude; an output whose plain version is
    all zero must come out exactly zero. Returns the case's fields: the
    largest absolute error over the outputs, the worst error over its
    output's scale, and tol."""
    if tol is None:
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    errs, rel = [], 0.0
    for a, b in zip(got, want):
        err, r = scaled_err(a, b)
        errs.append(err)
        rel = max(rel, r)
    if not (rel <= tol):
        raise AssertionError(f"{name}: max |kernel - plain| / max |plain| "
                             f"= {rel} > {tol}")
    return dict(max_abs_err=max(errs), rel_err=rel, tol=tol)


def xent_unreached(labels, vocab):
    """``(rows, vocab_rows)`` bool masks: the rows whose label is outside
    ``[0, vocab)`` and the vocab rows that no label hits. Their dlogits
    are the softmax term alone, ``(p - sn) g``; wherever a label hits,
    the label term ``-(sp - sn) g`` outweighs it many times over."""
    lab = labels.long()
    miss = (lab < 0) | (lab >= vocab)
    hit = torch.zeros(vocab, dtype=torch.bool, device=labels.device)
    hit[lab[~miss]] = True
    return miss, ~hit


def held_xent_bwd(name, got, want, labels, vocab, dtype):
    """Hold K6's outputs, ``[dh]`` or ``[dw, db]``, each on its own scale
    (as :func:`held`) and again on the entries no label reaches (dh's
    rows with an out-of-range label, dw's rows and db's entries that no
    label hits) on their own scale: there only the softmax term acts, so
    a fault in it (the bias, logz) shows that the label term hides in
    the whole output. bf16 dh and dw at XENT_BF16_TOL (the second product
    takes gch in bf16); db, summed from the f32 gch, and every f32 output
    at F32_TOL. Every part is measured before any is judged, so a failure
    prints them all. Returns the case's fields: the largest absolute
    error over the whole outputs and each part's reading."""
    miss, unhit = xent_unreached(labels, vocab)
    names = ("dh",) if len(got) == 1 else ("dw", "db")
    parts, failed = {}, []
    for out, a, b in zip(names, got, want):
        tol = (XENT_BF16_TOL if dtype == torch.bfloat16 and out != "db"
               else F32_TOL)
        sel = miss if out == "dh" else unhit
        for part, x, y in ((out, a, b), (f"{out} unreached", a[sel],
                                          b[sel])):
            if not y.numel():
                continue
            err, rel = scaled_err(x, y)
            parts[part] = dict(max_abs_err=err, rel_err=rel, tol=tol)
            if not (rel <= tol):
                failed.append(part)
    if failed:
        raise AssertionError(f"{name}: {', '.join(failed)} over tolerance; "
                             f"parts {json.dumps(parts)}")
    return dict(max_abs_err=max(parts[o]["max_abs_err"] for o in names),
                parts=parts)


def xent_cases(dev, gen, n, vocab, hid, dtype, ls=0.0, oob=False,
               timed=False):
    """K5 and K6 on one vocab head: ``h [n, hid]`` against ``W [vocab,
    hid]`` (the tied vh layout) and an f32 bias, made from ``gen``, logz
    from the plain statistics, label smoothing ``ls``. Every 97th row
    has the ignore label -100, and with ``oob`` every 7th and every 9th
    (from row 1) is out of range too, so that no label reaches some rows
    (:func:`held_xent_bwd`). Returns the three cases by kernel name; K5
    is held at F32_TOL (f32 statistics from either storage type).
    ``timed`` adds each kernel's time, its plain version's, one library
    call's (the forward of ``F.cross_entropy(F.linear(h, w, b))`` for
    K5, its autograd backward, all three outputs, for K6) and the
    bound."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import xent as xe

    def randn(*shape, dt=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dt)

    h = randn(n, hid, dt=dtype)
    w = randn(vocab, hid, dt=dtype, scale=0.05)
    bias = randn(vocab, scale=0.1)
    labels = torch.randint(0, vocab, (n,), generator=gen).to(dev)
    labels[3::97] = -100                 # the ignore index: never hits
    if oob:
        labels[::7] = vocab + 3          # out of range: never hits
        labels[1::9] = -2
    inputs = (h, w, bias, labels)
    shape = [n, vocab, hid]
    stats, stats_route = route_of("xent_stats", xe.xent_stats_kernel,
                                  *inputs)
    pstats = xe.xent_stats_plain(*inputs)
    logz = pstats[0] + torch.log(pstats[1])
    gg = randn(n, scale=1.0 / n)
    sn, sp = (ls / (vocab - 1), 1.0 - ls) if ls else (0.0, 1.0)
    bwd_args = (h, w, bias, labels, logz, gg, sn, sp)
    dh, dw, db = xe.xent_bwd_kernel(*bwd_args)
    pdh, pdw, pdb = xe.xent_bwd_plain(*bwd_args)
    base = dict(shape=shape, dtype=str(dtype), label_smoothing=ls,
                out_of_range_labels=oob)
    what = f"{shape} {dtype} ls={ls}"
    cases = {"xent_stats": dict(base, route=stats_route,
                                **held(f"xent_stats {what}", stats, pstats,
                                       torch.float32)),
             "xent_bwd_dh": dict(base, **held_xent_bwd(
                 f"xent_bwd_dh {what}", [dh], [pdh], labels, vocab,
                 dtype)),
             "xent_bwd_dwb": dict(base, **held_xent_bwd(
                 f"xent_bwd_dwb {what}", [dw, db], [pdw, pdb], labels,
                 vocab, dtype))}
    if not timed:
        return cases
    ops = 2.0 * n * vocab * hid
    hl, wl = (t_.detach().requires_grad_(True) for t_ in (h, w))
    bl = bias.to(dtype).requires_grad_(True)
    rows = F.cross_entropy(F.linear(hl, wl, bl), labels, reduction="none",
                           ignore_index=-100)
    cases["xent_stats"].update(
        kernel_ms=time_ms(lambda: xe.xent_stats_kernel(*inputs)),
        plain_ms=time_ms(lambda: xe.xent_stats_plain(*inputs)),
        library_ms=time_ms(lambda: F.cross_entropy(
            F.linear(h, w, bl.detach()), labels, reduction="none")))
    cases["xent_stats"]["bound_ms"], cases["xent_stats"]["bound_by"] = \
        bound_ms(nbytes(*inputs) + 16 * n, ops, dtype)
    plain = time_ms(lambda: xe.xent_bwd_plain(*bwd_args))
    library = time_ms(lambda: torch.autograd.grad(
        rows, (hl, wl, bl), gg, retain_graph=True), graph=False)
    for name, fn, outs in (("xent_bwd_dh", xe.xent_bwd_dh_kernel, (dh,)),
                           ("xent_bwd_dwb", xe.xent_bwd_dwb_kernel,
                            (dw, db))):
        case = cases[name]
        case.update(kernel_ms=time_ms(lambda: fn(*bwd_args)),
                    plain_ms=plain, library_ms=library)
        case["bound_ms"], case["bound_by"] = bound_ms(
            nbytes(*inputs, logz, gg, *outs), 2 * ops, dtype)
    return cases


def attended_pairs(tq, tk, causal):
    """(query, key) pairs a causal (bottom-right) or full attention
    computes per head."""
    if not causal:
        return tq * tk
    return sum(min(tk, max(0, i + (tk - tq) + 1)) for i in range(tq))


# --------------------------------------------------------------- kernels

def kernel_cases(dev):
    """Per kernel: the serving path's shapes first (the case reported in
    the kernels line), then the ragged set."""
    from paddle_tpu_torch.ops.attention import (init_page_pool,
                                                paged_write)
    from paddle_tpu_torch.ops.cuda import (decode_attention as da,
                                           flash_attention as fa,
                                           layer_norm as ln, mlp)
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    results = {}

    # K1 layer norm: decode rows (8 slots) and prefill rows (512)
    cases = []
    for rows, dtype in ((8, torch.float32), (512, torch.float32),
                        (13, torch.float32), (37, torch.bfloat16)):
        x = randn(rows, 768, dtype=dtype)
        gam = randn(768, dtype=dtype) * 0.1 + 1.0
        bet = randn(768, dtype=dtype) * 0.1
        y, m, r = ln.layer_norm_kernel(x, gam, bet, 1e-5)
        py, pm, pr = ln.layer_norm_plain(x, gam, bet, 1e-5)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err = max(max_err(y, py), max_err(m, pm), max_err(r, pr))
        check(f"layer_norm {rows}x768 {dtype}", err, tol)
        case = dict(shape=[rows, 768], dtype=str(dtype), max_abs_err=err,
                    tol=tol)
        if dtype == torch.float32 and rows in (8, 512):
            case["kernel_ms"] = time_ms(
                lambda: ln.layer_norm_kernel(x, gam, bet, 1e-5))
            case["plain_ms"] = time_ms(
                lambda: ln.layer_norm_plain(x, gam, bet, 1e-5))
            case["library_ms"] = time_ms(
                lambda: torch.nn.functional.layer_norm(x, (768,), gam, bet,
                                                       1e-5))
            case["bound_ms"], case["bound_by"] = bound_ms(
                nbytes(x, gam, bet, y, m, r), 8 * x.numel(), dtype)
        cases.append(case)
    results["layer_norm"] = cases

    # K2 flash attention: first-chunk prefill [1, 12, 512, 64] causal
    cases = []
    for b, h, tq, tk, dtype, causal, masked in (
            (1, 12, 512, 512, torch.float32, True, False),
            (2, 3, 200, 200, torch.float32, True, False),
            (1, 4, 100, 300, torch.float32, True, False),
            (2, 2, 130, 130, torch.float32, False, True),
            (1, 4, 256, 256, torch.bfloat16, True, False)):
        q, k, v = (randn(b, h, t, 64, dtype=dtype)
                   for t in (tq, tk, tk))
        mask = None
        if masked:
            mask = torch.ones(b, tk, dtype=torch.bool, device=dev)
            mask[0, tk // 2:] = False
            mask[1, :] = False               # fully masked rows -> 0
        scale = 1.0 / 8.0
        out, lse = fa.flash_attention_kernel(q, k, v, scale, causal, mask)
        pout, plse = fa.chunked_attention(q, k, v, scale, causal, mask,
                                          return_lse=True)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err = max_err(out, pout)
        if masked and float(out[1].abs().max()) != 0.0:
            raise AssertionError("flash: fully masked rows are not 0")
        lse_err = max_err(lse, plse) if not masked else 0.0
        check(f"flash {b}x{h}x{tq}x{tk} {dtype}", max(err, lse_err), tol)
        case = dict(shape=[b, h, tq, tk, 64], dtype=str(dtype),
                    causal=causal, masked=masked, max_abs_err=err,
                    lse_err=lse_err, tol=tol)
        if len(cases) == 0:
            pairs = sum(min(tk, i + (tk - tq) + 1) for i in range(tq))
            case["kernel_ms"] = time_ms(lambda: fa.flash_attention_kernel(
                q, k, v, scale, causal))
            case["plain_ms"] = time_ms(lambda: fa.chunked_attention(
                q, k, v, scale, causal))
            case["library_ms"] = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=scale))
            case["bound_ms"], case["bound_by"] = bound_ms(
                nbytes(q, k, v, out, lse), 4.0 * b * h * pairs * 64, dtype)
        cases.append(case)
    results["flash_attention"] = cases

    # K4 fused MLP: decode rows (8) and prefill rows (512) at 768/3072
    cases = []
    for rows, inter, dtype in ((8, 3072, torch.float32),
                               (512, 3072, torch.float32),
                               (13, 3000, torch.float32),
                               (40, 3072, torch.bfloat16)):
        x = randn(rows, 768, dtype=dtype)
        w1 = randn(768, inter, dtype=dtype, scale=0.036)
        b1 = randn(inter, dtype=dtype, scale=0.02)
        w2 = randn(inter, 768, dtype=dtype, scale=0.036)
        b2 = randn(768, dtype=dtype, scale=0.02)
        out, route = route_of("mlp", mlp.mlp_kernel, x, w1, b1, w2, b2)
        ref = mlp.mlp_plain(x.float(), w1.float(), b1.float(), w2.float(),
                            b2.float())
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err = max_err(out, ref)
        check(f"mlp {rows}x768x{inter} {dtype}", err, tol)
        case = dict(shape=[rows, 768, inter, 768], dtype=str(dtype),
                    route=route, max_abs_err=err, tol=tol)
        if dtype == torch.float32 and inter == 3072 and rows in (8, 512):
            w1t, w2t = w1.t(), w2.t()
            case["kernel_ms"] = time_ms(
                lambda: mlp.mlp_kernel(x, w1, b1, w2, b2))
            case["plain_ms"] = time_ms(
                lambda: mlp.mlp_plain(x, w1, b1, w2, b2))
            case["library_ms"] = time_ms(
                lambda: torch.nn.functional.linear(
                    torch.nn.functional.gelu(
                        torch.nn.functional.linear(x, w1t, b1)), w2t, b2))
            case["bound_ms"], case["bound_by"] = bound_ms(
                nbytes(x, w1, b1, w2, b2, out),
                2.0 * rows * inter * (768 + 768), dtype)
        cases.append(case)
    results["mlp"] = cases

    # K7 paged decode: 8 slots x 12 heads, ps 64, hd 64, bf16 pool
    cases = []
    rs = np.random.RandomState(0)
    for lengths, pool_dtype in (
            (list(rs.randint(1, 1025, 8)), torch.bfloat16),
            ([0, 1, 63, 64, 65, 700, 1024, 129], torch.bfloat16),
            ([0, 5, 64, 300, 1000, 17, 128, 1], torch.int8),
            ([37, 0, 200, 64, 1, 511, 66, 900], torch.float32)):
        s_slots, h, hd, ps, pmax = 8, 12, 64, 64, 16
        n = s_slots * pmax
        kv_dtype = torch.int8 if pool_dtype == torch.int8 else None
        pool = init_page_pool(n, h, ps, hd,
                              dtype=(torch.float32 if kv_dtype else
                                     pool_dtype),
                              kv_dtype=kv_dtype, device=dev)
        perm = torch.from_numpy(rs.permutation(n).astype(np.int32))
        ptab = perm.reshape(s_slots, pmax).to(dev)
        ids = ptab.reshape(-1).long()
        rows = n * ps
        paged_write(pool, randn(rows, h, hd), randn(rows, h, hd),
                    ids.repeat_interleave(ps),
                    torch.arange(ps, device=dev).repeat(n))
        lens = torch.tensor([int(v) for v in lengths], dtype=torch.int32,
                            device=dev)
        q = randn(s_slots, h, hd)
        scale = 1.0 / 8.0
        ks, vs = pool.get("k_scale"), pool.get("v_scale")
        out = da.paged_decode_kernel(q, pool["k"], pool["v"], ptab, lens,
                                     scale, ks, vs)
        ref = da.paged_attention_plain(q, pool["k"], pool["v"], ptab, lens,
                                       scale, ks, vs)
        err = max_err(out, ref)
        check(f"decode {lengths} {pool_dtype}", err, F32_TOL)
        zero = [i for i, v in enumerate(lengths) if v == 0]
        if zero and float(out[zero].abs().max()) != 0.0:
            raise AssertionError("decode: a length-0 slot is not exactly 0")
        case = dict(lengths=[int(v) for v in lengths],
                    pool=str(pool_dtype), max_abs_err=err, tol=F32_TOL)
        if len(cases) == 0:
            live = int(lens.sum())
            elem = pool["k"].element_size()
            read = (2 * live * h * hd * elem + nbytes(q, ptab, lens, out))
            case["kernel_ms"] = time_ms(lambda: da.paged_decode_kernel(
                q, pool["k"], pool["v"], ptab, lens, scale))
            case["plain_ms"] = time_ms(lambda: da.paged_attention_plain(
                q, pool["k"], pool["v"], ptab, lens, scale))
            case["library_ms"] = None
            case["bound_ms"], case["bound_by"] = bound_ms(
                read, 4.0 * live * h * hd, pool_dtype)
        cases.append(case)
    results["decode_attention"] = cases
    return results


def train_kernel_cases(dev):
    """The training path's kernels at the train step's shapes (GPTConfig
    .small(), batch 16 x seq 512, bf16 compute) — the case reported in the
    kernels line comes first — then the same shapes in f32 and ragged
    shapes; plus K1, K2 and K4 at the train step's shapes."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import (flash_attention as fa,
                                           layer_norm as ln, mlp)
    g = torch.Generator(device="cpu").manual_seed(1)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    results = {"flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": [],
               "xent_stats": [], "xent_bwd_dh": [], "xent_bwd_dwb": [],
               "train_shapes": []}

    # K1, K2, K4 at the train step's shapes (bf16 rows of 16 x 512)
    x = randn(8192, 768, dtype=bf16)
    gam, bet = randn(768, dtype=bf16) * 0.1 + 1.0, randn(768, dtype=bf16)
    case = dict(kernel="layer_norm", shape=[8192, 768], dtype="bf16",
                **held("layer_norm train shape",
                       ln.layer_norm_kernel(x, gam, bet, 1e-5),
                       ln.layer_norm_plain(x, gam, bet, 1e-5), bf16),
                kernel_ms=time_ms(lambda: ln.layer_norm_kernel(
                    x, gam, bet, 1e-5)),
                plain_ms=time_ms(lambda: ln.layer_norm_plain(
                    x, gam, bet, 1e-5)),
                library_ms=time_ms(lambda: F.layer_norm(
                    x, (768,), gam, bet, 1e-5)))
    case["bound_ms"], case["bound_by"] = bound_ms(
        2 * nbytes(x) + nbytes(gam, bet) + 8 * 8192, 8 * x.numel(), bf16)
    results["train_shapes"].append(case)

    w1, b1 = randn(768, 3072, dtype=bf16, scale=0.036), randn(
        3072, dtype=bf16, scale=0.02)
    w2, b2 = randn(3072, 768, dtype=bf16, scale=0.036), randn(
        768, dtype=bf16, scale=0.02)
    out, route = route_of("mlp", mlp.mlp_kernel, x, w1, b1, w2, b2)
    case = dict(kernel="mlp", shape=[8192, 768, 3072, 768], dtype="bf16",
                route=route,
                **held("mlp train shape", [out], [mlp.mlp_plain(
                    x.float(), w1.float(), b1.float(), w2.float(),
                    b2.float())], bf16),
                kernel_ms=time_ms(lambda: mlp.mlp_kernel(x, w1, b1, w2, b2)),
                plain_ms=time_ms(lambda: mlp.mlp_plain(x, w1, b1, w2, b2)),
                library_ms=time_ms(lambda: F.linear(F.gelu(F.linear(
                    x, w1.t(), b1)), w2.t(), b2)))
    case["bound_ms"], case["bound_by"] = bound_ms(
        nbytes(x, w1, b1, w2, b2, out), 2.0 * 8192 * 3072 * 1536, bf16)
    results["train_shapes"].append(case)

    # K2 and K3: [16, 12, 512, 512, 64] causal bf16 first
    for b, h, tq, tk, d, dtype, causal, masked in (
            (16, 12, 512, 512, 64, bf16, True, False),
            (16, 12, 512, 512, 64, torch.float32, True, False),
            (2, 3, 200, 200, 64, torch.float32, True, False),
            (1, 4, 100, 300, 32, torch.float32, True, False),
            (2, 2, 130, 130, 128, torch.float32, False, True),
            (1, 2, 70, 70, 16, bf16, True, True)):
        q, do = randn(b, h, tq, d, dtype=dtype), randn(b, h, tq, d,
                                                       dtype=dtype)
        k, v = randn(b, h, tk, d, dtype=dtype), randn(b, h, tk, d,
                                                      dtype=dtype)
        mask = None
        if masked:
            mask = torch.ones(b, tk, dtype=torch.bool, device=dev)
            mask[0, tk // 3:] = False
            mask[-1, :] = False              # fully masked rows -> 0
        scale = d ** -0.5
        out, lse = fa.flash_attention_kernel(q, k, v, scale, causal, mask)
        got = fa.flash_attention_bwd_kernel(q, k, v, out, lse, do, scale,
                                            causal, mask)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, scale,
                                            causal, mask)
        shape = [b, h, tq, tk, d]
        name = f"flash backward {shape} {dtype}"
        if masked and float(got[0][-1].abs().max()) != 0.0:
            raise AssertionError(f"{name}: fully masked rows are not 0")
        base = dict(shape=shape, dtype=str(dtype), causal=causal,
                    masked=masked)
        dq_case = dict(base, **held(name + " dq", got[:1], want[:1], dtype))
        dkv_case = dict(base, **held(name + " dk/dv", got[1:], want[1:],
                                     dtype))
        if not results["flash_attention_bwd_dq"]:
            # the train step's case: kernel, plain (dq, dk and dv at
            # once) and the library backward of the same attention
            pairs = b * h * attended_pairs(tq, tk, causal)
            delta = (do.float() * out.float()).sum(-1)
            bwd = (q, k, v, do, lse, delta, scale, causal)
            dq_case["kernel_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_dq_kernel(*bwd))
            dkv_case["kernel_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_dkv_kernel(*bwd))
            plain = time_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, out, lse, do, scale, causal))
            qg, kg, vg = (t_.detach().requires_grad_(True)
                          for t_ in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qg, kg, vg,
                                                  is_causal=True,
                                                  scale=scale)
            library = time_ms(lambda: torch.autograd.grad(
                sdpa, (qg, kg, vg), do, retain_graph=True), graph=False)
            for case, products, outs in ((dq_case, 3, got[:1]),
                                         (dkv_case, 4, got[1:])):
                case["plain_ms"], case["library_ms"] = plain, library
                case["bound_ms"], case["bound_by"] = bound_ms(
                    nbytes(q, k, v, do, lse, delta, *outs),
                    2.0 * products * pairs * d, dtype)
        results["flash_attention_bwd_dq"].append(dq_case)
        results["flash_attention_bwd_dkv"].append(dkv_case)
        if (b, dtype) == (16, bf16):
            case = dict(kernel="flash_attention", shape=shape, dtype="bf16",
                        causal=True,
                        max_abs_err=max_err(out, fa.chunked_attention(
                            q, k, v, scale, causal)),
                        kernel_ms=time_ms(lambda: fa.flash_attention_kernel(
                            q, k, v, scale, causal)),
                        plain_ms=time_ms(lambda: fa.chunked_attention(
                            q, k, v, scale, causal)),
                        library_ms=time_ms(
                            lambda: F.scaled_dot_product_attention(
                                q, k, v, is_causal=True, scale=scale)))
            check("flash train shape", case["max_abs_err"], BF16_TOL)
            case["bound_ms"], case["bound_by"] = bound_ms(
                nbytes(q, k, v, out, lse),
                4.0 * b * h * attended_pairs(tq, tk, causal) * d, bf16)
            results["train_shapes"].append(case)

    # K5 and K6: [16 x 511, 768] rows against the tied [32000, 768] table
    # (timed), then f32 and ragged shapes
    for i, spec in enumerate((
            (8176, 32000, 768, bf16, 0.0, False),
            (8176, 32000, 768, torch.float32, 0.0, False),
            (78, 300, 128, torch.float32, 0.1, True),
            (130, 1000, 768, torch.float32, 0.0, True),
            (37, 65, 96, bf16, 0.1, True),
            (1000, 5000, 640, bf16, 0.0, False),
            (300, 2000, 1024, bf16, 0.1, True),
            (130, 1000, 1024, torch.float32, 0.0, True),
            (200, 3000, 576, bf16, 0.0, True))):
        for name, case in xent_cases(dev, g, *spec, timed=i == 0).items():
            results[name].append(case)
    return results


def bert_kernel_cases(dev):
    """K8 at the BERT step's shape ([64 x 512, 768] bf16, the case reported
    in the kernels line), in f32 and at ragged shapes; then K1-K6 at the
    BERT step's shapes (bf16; attention not causal, with a padded
    key mask in a ragged case; a 30522 vocab with an f32 bias), each
    timed beside its plain version, its bound and one library call."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import (flash_attention as fa,
                                           layer_norm as ln, mlp)
    g = torch.Generator(device="cpu").manual_seed(2)
    bf16 = torch.bfloat16
    rows, hid, inter, vocab, n_mask = 64 * 512, 768, 3072, 30522, 64 * 76

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    results = {"add_layer_norm": [], "bert_shapes": []}

    # K8: the train shape in bf16 and f32, then R not a multiple of the 8
    # rows per block, C not a multiple of 32, C not a multiple of the
    # 16-byte pack, and a view whose data is not 16-byte aligned
    for r_, c_, dtype, offset in ((rows, hid, bf16, 0),
                                  (rows, hid, torch.float32, 0),
                                  (1000, 200, bf16, 0),
                                  (37, 96, torch.float32, 0),
                                  (13, 770, bf16, 0),
                                  (29, 768, torch.float32, 1)):
        x = randn(r_ * c_ + offset, dtype=dtype)[offset:].view(r_, c_)
        h = randn(r_, c_, dtype=dtype)
        gam = randn(c_, dtype=dtype, scale=0.1) + 1.0
        bet = randn(c_, dtype=dtype, scale=0.1)
        got = ln.add_layer_norm_kernel(x, h, gam, bet, 1e-5)
        case = dict(shape=[r_, c_], dtype=str(dtype), misaligned=bool(offset),
                    **held(f"add_layer_norm {[r_, c_]} {dtype}", got,
                           ln.add_layer_norm_plain(x, h, gam, bet, 1e-5),
                           dtype))
        if not results["add_layer_norm"]:
            case.update(
                kernel_ms=time_ms(lambda: ln.add_layer_norm_kernel(
                    x, h, gam, bet, 1e-5)),
                plain_ms=time_ms(lambda: ln.add_layer_norm_plain(
                    x, h, gam, bet, 1e-5)),
                library_ms=time_ms(lambda: F.layer_norm(
                    x + h, (c_,), gam, bet, 1e-5)),
                library="F.layer_norm(x + h): two library calls")
            case["bound_ms"], case["bound_by"] = bound_ms(
                nbytes(x, h, gam, bet, *got), 10 * x.numel(), dtype)
        results["add_layer_norm"].append(case)

    # K1 (emb_ln) and K4 at the 32768 rows of the step
    x = randn(rows, hid, dtype=bf16)
    gam, bet = randn(hid, dtype=bf16) * 0.1 + 1.0, randn(hid, dtype=bf16)
    got = ln.layer_norm_kernel(x, gam, bet, 1e-5)
    case = dict(kernel="layer_norm", shape=[rows, hid], dtype="bf16",
                **held("layer_norm bert shape", got,
                       ln.layer_norm_plain(x, gam, bet, 1e-5), bf16),
                kernel_ms=time_ms(lambda: ln.layer_norm_kernel(
                    x, gam, bet, 1e-5)),
                plain_ms=time_ms(lambda: ln.layer_norm_plain(
                    x, gam, bet, 1e-5)),
                library_ms=time_ms(lambda: F.layer_norm(
                    x, (hid,), gam, bet, 1e-5)))
    case["bound_ms"], case["bound_by"] = bound_ms(
        nbytes(x, gam, bet, *got), 8 * x.numel(), bf16)
    results["bert_shapes"].append(case)

    # K4 (the tc route) at BertConfig.base()'s [32768, 768] x [768, 3072]
    # and BertConfig.large()'s bert_large rows (8 x 512) x [1024, 4096]
    del x
    for r_, h_, i_, config in ((rows, hid, inter, "BertConfig.base()"),
                               (8 * 512, 1024, 4096, "BertConfig.large()")):
        x = randn(r_, h_, dtype=bf16)
        w1, b1 = randn(h_, i_, dtype=bf16, scale=h_ ** -0.5), randn(
            i_, dtype=bf16, scale=0.02)
        w2, b2 = randn(i_, h_, dtype=bf16, scale=i_ ** -0.5), randn(
            h_, dtype=bf16, scale=0.02)
        out, route = route_of("mlp", mlp.mlp_kernel, x, w1, b1, w2, b2)
        case = dict(kernel="mlp", config=config, shape=[r_, h_, i_, h_],
                    dtype="bf16", route=route,
                    **held(f"mlp {config}", [out], [mlp.mlp_plain(
                        x.float(), w1.float(), b1.float(), w2.float(),
                        b2.float())], bf16),
                    kernel_ms=time_ms(lambda: mlp.mlp_kernel(
                        x, w1, b1, w2, b2)),
                    plain_ms=time_ms(lambda: mlp.mlp_plain(
                        x, w1, b1, w2, b2)),
                    library_ms=time_ms(lambda: F.linear(F.gelu(F.linear(
                        x, w1.t(), b1)), w2.t(), b2)))
        case["bound_ms"], case["bound_by"] = bound_ms(
            nbytes(x, w1, b1, w2, b2, out), 2.0 * r_ * i_ * 2 * h_, bf16)
        results["bert_shapes"].append(case)
        del x, out, w1, w2

    # K2 and K3: [64, 12, 512, 512, 64] bf16 not causal (timed), then a
    # ragged batch padded by a key mask
    for b, h, t, dtype, lengths in ((64, 12, 512, bf16, None),
                                    (3, 12, 200, bf16, (200, 137, 61)),
                                    (2, 4, 90, torch.float32, (90, 33))):
        q, k, v, do = (randn(b, h, t, 64, dtype=dtype) for _ in range(4))
        mask = None
        if lengths is not None:
            mask = (torch.arange(t, device=dev)[None, :]
                    < torch.tensor(lengths, device=dev)[:, None])
        scale = 0.125
        out, lse = fa.flash_attention_kernel(q, k, v, scale, False, mask)
        pout, plse = fa.chunked_attention(q, k, v, scale, False, mask,
                                          return_lse=True)
        shape = [b, h, t, t, 64]
        name = f"flash {shape} {dtype} mask={lengths}"
        fwd = dict(kernel="flash_attention", shape=shape, dtype=str(dtype),
                   causal=False, kv_mask=lengths,
                   **held(name, [out], [pout], dtype))
        held(name + " lse", [lse], [plse], torch.float32)
        got = fa.flash_attention_bwd_kernel(q, k, v, out, lse, do, scale,
                                            False, mask)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, scale,
                                            False, mask)
        dq = dict(fwd, kernel="flash_attention_bwd_dq",
                  **held(name + " dq", got[:1], want[:1], dtype))
        dkv = dict(fwd, kernel="flash_attention_bwd_dkv",
                   **held(name + " dk/dv", got[1:], want[1:], dtype))
        if lengths is None:
            ops = 2.0 * b * h * t * t * 64
            fwd.update(
                kernel_ms=time_ms(lambda: fa.flash_attention_kernel(
                    q, k, v, scale, False)),
                plain_ms=time_ms(lambda: fa.chunked_attention(
                    q, k, v, scale, False)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=scale)))
            fwd["bound_ms"], fwd["bound_by"] = bound_ms(
                nbytes(q, k, v, out, lse), 2 * ops, dtype)
            delta = (do.float() * out.float()).sum(-1)
            bwd = (q, k, v, do, lse, delta, scale, False)
            plain = time_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, out, lse, do, scale, False))
            qg, kg, vg = (t_.detach().requires_grad_(True)
                          for t_ in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
            library = time_ms(lambda: torch.autograd.grad(
                sdpa, (qg, kg, vg), do, retain_graph=True), graph=False)
            for case, fn, products, outs in (
                    (dq, fa.flash_attention_bwd_dq_kernel, 3, got[:1]),
                    (dkv, fa.flash_attention_bwd_dkv_kernel, 4, got[1:])):
                case.update(kernel_ms=time_ms(lambda: fn(*bwd)),
                            plain_ms=plain, library_ms=library)
                case["bound_ms"], case["bound_by"] = bound_ms(
                    nbytes(q, k, v, do, lse, delta, *outs),
                    products * ops, dtype)
            del sdpa, qg, kg, vg
        results["bert_shapes"] += [fwd, dq, dkv]
        del q, k, v, do, out, got, want, pout

    # K5 and K6: 64 x 76 gathered rows against the tied [30522, H] table
    # and the f32 MLM bias, at BertConfig.base()'s H = 768 and
    # BertConfig.large()'s H = 1024
    for width, config in ((hid, "BertConfig.base()"),
                          (1024, "BertConfig.large()")):
        for name, case in xent_cases(dev, g, n_mask, vocab, width, bf16,
                                     timed=True).items():
            results["bert_shapes"].append(dict(kernel=name, config=config,
                                               **case))
    return results


# ------------------------------------------------------------------ serve

def serve(model, num_requests, prompt_range, long_prompt, max_new, cfg_kw,
          seed):
    """Submit a wave and drain it step by step; returns (engine, request
    ids, stats)."""
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    eng = ServingEngine(model, ServeConfig(**cfg_kw))
    rs = np.random.RandomState(seed)
    vocab = model.cfg.vocab_size
    lens = list(rs.randint(prompt_range[0], prompt_range[1] + 1,
                           num_requests))
    if long_prompt:
        lens.append(long_prompt)
    rids = [eng.submit(rs.randint(0, vocab, n).astype(np.int32),
                       max_new=max_new) for n in lens]
    steps = []
    t0 = time.perf_counter()
    while eng._queue or eng._running:
        s0 = time.perf_counter()
        eng.step()
        steps.append(time.perf_counter() - s0)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = [eng.requests[r] for r in rids]
    gen = sum(len(r.tokens) for r in reqs)
    for r in reqs:
        if r.status != "done" or len(r.tokens) != max_new:
            raise AssertionError(f"request {r.id}: {r.status}, "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"request {r.id}: token out of range")
    ttft = sorted((r.first_token_t - r.submit_t) * 1e3 for r in reqs)
    stats = dict(requests=len(reqs), prompt_lens=[int(n) for n in lens],
                 generated_tokens=gen, wall_s=wall,
                 decoded_tokens_per_s=gen / wall,
                 p50_ttft_ms=float(np.median(ttft)),
                 p50_step_ms=float(np.median(steps)) * 1e3,
                 steps=len(steps), decode_steps=eng.decode_steps,
                 prefill_calls=eng.prefill_calls,
                 kv_pool_bytes=eng.kv_pool_bytes())
    return eng, rids, stats


@torch.inference_mode()
def teacher_forced_logits(model, prompt, tokens, page_size, prefill_len,
                          cache_dtype, kv_dtype=None):
    """Replay ``prompt`` then ``tokens[:-1]`` through the served path
    (chunked paged prefill, then one paged decode step per token) in one
    slot; returns the logits that chose each of ``tokens``
    ``[len(tokens), V]``."""
    dev = model.device
    total = len(prompt) + len(tokens)
    pages = -(-total // page_size)
    caches = model.init_paged_caches(pages, page_size, dtype=cache_dtype,
                                     kv_dtype=kv_dtype)
    ptab = torch.arange(pages, dtype=torch.int32, device=dev)[None, :]
    out = []
    for start in range(0, len(prompt), prefill_len):
        clen = min(prefill_len, len(prompt) - start)
        window = torch.zeros((1, prefill_len), dtype=torch.int32)
        window[0, :clen] = torch.from_numpy(prompt[start:start + clen])
        logits, caches = model.paged_prefill_chunk(
            window.to(dev), torch.tensor([start], dtype=torch.int32),
            torch.tensor([clen], dtype=torch.int32), caches, ptab)
    out.append(logits[0].float().cpu())
    one = torch.ones(1, dtype=torch.bool, device=dev)
    for i, tok in enumerate(tokens[:-1]):
        length = torch.tensor([len(prompt) + i], dtype=torch.int32,
                              device=dev)
        logits, caches = model.paged_decode_step(
            torch.tensor([tok], dtype=torch.int32, device=dev), caches,
            ptab, length, one)
        out.append(logits[0].float().cpu())
    return torch.stack(out)


def crosscheck(card_model, cpu_model, reqs, page_size, prefill_len):
    """Teacher-force each request's card tokens through the card (bf16
    cache) and the CPU plain path (f32 cache); compare the logits."""
    rows = []
    for req in reqs:
        card = teacher_forced_logits(card_model, req.prompt, req.tokens,
                                     page_size, prefill_len,
                                     torch.bfloat16)
        cpu = teacher_forced_logits(cpu_model, req.prompt, req.tokens,
                                    page_size, prefill_len, torch.float32)
        err = float((card - cpu).abs().max())
        agree = float((cpu.argmax(-1).numpy()
                       == np.asarray(req.tokens)).mean())
        check(f"crosscheck request {req.id}", err, SERVE_LOGIT_TOL)
        rows.append(dict(request=req.id, prompt_len=int(req.prompt.size),
                         logits_max_abs_err=err, tol=SERVE_LOGIT_TOL,
                         greedy_agreement=agree))
    return rows


# ------------------------------------------------------------------ train

def loss_of(model, ids):
    return model.loss(ids)


def bert_loss_of(model, ids, mlm_labels, nsp_labels, mlm_mask,
                 token_type_ids=None, attention_mask=None,
                 mask_positions=None):
    """BertForPretraining.loss with every input positional, so that
    ``minimize`` carries them all (and casts the float ones)."""
    return model.loss(ids, mlm_labels, nsp_labels, mlm_mask,
                      token_type_ids=token_type_ids,
                      attention_mask=attention_mask,
                      mask_positions=mask_positions)


def train(model, opt, loss_fn, args, warmup, steps):
    """``warmup`` steps, then ``steps`` timed steps of ``opt.minimize`` of
    ``loss_fn`` on the fixed batch ``args``, with the launch counts and
    the peak-memory statistic zeroed just before the timed steps. Each
    step ends by reading its loss on the host, so its wall time covers
    its device work. Returns (losses of every step, timed step seconds,
    launches, launches by route of the kernels that have two)."""
    from paddle_tpu_torch.ops.cuda import core
    losses, times = [], []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            core.reset_launches()
        t0 = time.perf_counter()
        losses.append(float(opt.minimize(model, loss_fn, *args)))
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    return losses, times, core.launch_counts(), core.route_counts()


def train_launches_per_step(layers):
    """Each GPT training kernel's launches per step: K1 twice per block
    plus ln_f, K2/K3/K4 once per block, K5 and K6 once."""
    return {"layer_norm": 2 * layers + 1, "flash_attention": layers,
            "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers, "mlp": layers,
            "xent_stats": 1, "xent_bwd_dh": 1, "xent_bwd_dwb": 1}


def bert_launches_per_step(layers):
    """Each BERT pretraining kernel's launches per step: K8 twice per
    layer (the post-norm residuals), K1 for emb_ln and mlm_ln, K2/K3/K4
    once per layer, K5 and K6 once (the MLM head)."""
    return {"add_layer_norm": 2 * layers, "layer_norm": 2,
            "flash_attention": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers, "mlp": layers,
            "xent_stats": 1, "xent_bwd_dh": 1, "xent_bwd_dwb": 1}


def check_routes(what, routes, route, kernels=None):
    """Every launch of ``kernels`` (default :data:`TC_KERNELS`) in a run
    took ``route``, and there was at least one."""
    wrong = {k: routes[k] for k in kernels or TC_KERNELS
             if routes[k][route] == 0 or sum(routes[k].values())
             != routes[k][route]}
    if wrong:
        raise AssertionError(f"{what}: launches not all on the {route} "
                             f"route: {wrong}")


def check_launches(what, launches, steps, want):
    wrong = {k: (launches[k] / steps, n) for k, n in want.items()
             if launches[k] != n * steps}
    if wrong:
        raise AssertionError(f"{what} launches per step (got, want): "
                             f"{wrong}")


def train_crosscheck(make_model, loss_fn, args):
    """One f32 Adam step of ``loss_fn`` on the card and on the CPU plain
    path, each on a model from ``make_model(device)`` (the same weights):
    (loss card, loss CPU, per-parameter gradient errors, the card run's
    launches). A parameter whose gradient is 0 in exact arithmetic (the
    key bias, which softmax cancels) carries only rounding noise, so each
    error is relative to the larger of its own gradient's norm and 1e-3
    of the largest one."""
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Adam
    out = {}
    for dev in ("cuda", "cpu"):
        model = make_model(dev)
        opt = Adam(model.parameters(), 1e-4)
        core.reset_launches()
        loss = float(opt.minimize(model, loss_fn,
                                  *(a.to(dev) for a in args)))
        out[dev] = (loss, {n: p.grad.detach().cpu()
                           for n, p in model.named_parameters()},
                    core.launch_counts())
    (lc, gc, launches), (lp, gp, _) = out["cuda"], out["cpu"]
    top = max(float(g.norm()) for g in gp.values())
    errs = {n: float((gc[n] - gp[n]).norm())
            / max(float(gp[n].norm()), 1e-3 * top) for n in gp}
    return lc, lp, errs, launches


# ------------------------------------------------------------------- main

def train_phase(cfg, smi):
    """The training path at full width; returns (stats, launches)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.optimizer import Adam
    batch, seq, warmup, steps = 16, 512, 2, 10
    model = GPT(cfg, device="cuda", seed=0)
    opt = amp.decorate(Adam(model.parameters(), 1e-4), amp.bf16_policy())
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()
    losses, times, launches, routes = train(model, opt, loss_of, (ids,),
                                            warmup, steps)
    check_launches("train", launches, steps,
                   train_launches_per_step(cfg.num_layers))
    check_routes("train", routes, "tc")
    return dict(step_stats("train", "GPTConfig.small()", batch, seq, losses,
                           times, launches, smi), routes=routes), launches


def step_stats(what, config, batch, seq, losses, times, launches, smi,
               must_fall=True):
    """The training phase's line; raises unless every loss is finite and
    (``must_fall``) the loss fell from the first step to the last."""
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    if must_fall and not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: loss did not fall {losses}")
    steps = len(times)
    return dict(config=config, batch=batch, seq=seq, policy="bf16",
                optimizer="Adam(1e-4)", warmup=len(losses) - steps,
                steps=steps, losses=losses,
                tokens_per_s=batch * seq * steps / sum(times),
                p50_step_ms=float(np.median(times)) * 1e3,
                mean_step_ms=float(np.mean(times)) * 1e3,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches_per_step={k: n / steps
                                   for k, n in launches.items()},
                card=smi)


def bert_batch(rs, vocab, batch, seq, n_mask, pad_row0=None,
               segment_b=None):
    """A seeded pretraining batch, as ``bench.py``'s ``_bench_mlm`` makes
    it: ids, sorted distinct ``mask_positions`` with their labels,
    ``nsp_labels`` and an ``mlm_mask`` of ones. ``pad_row0`` pads row 0
    after that many tokens (an ``attention_mask``, the positions drawn
    below it); ``segment_b`` starts segment B there (``token_type_ids``).
    Returns the ``bert_loss_of`` arguments after the model, on the
    CPU."""
    ids = rs.randint(0, vocab, (batch, seq))
    att = types = None
    if pad_row0 is not None:
        att = np.ones((batch, seq), np.float32)
        att[0, pad_row0:] = 0.0
    if segment_b is not None:
        types = np.zeros((batch, seq), np.int64)
        types[:, segment_b:] = 1
    pos = np.stack([np.sort(rs.choice(
        pad_row0 if (i == 0 and pad_row0) else seq, n_mask, replace=False))
        for i in range(batch)])
    labels = rs.randint(0, vocab, (batch, n_mask))
    nsp = rs.randint(0, 2, (batch,))
    mlm_mask = np.ones((batch, n_mask), np.float32)
    return tuple(None if a is None else torch.from_numpy(a) for a in (
        ids, labels, nsp, mlm_mask, types, att, pos))


def bert_train_phase(smi):
    """``bench.py``'s BERT row on the card: BertConfig.base() (dropout 0,
    weights from seed 0) under amp.decorate(Adam(1e-4), bf16_policy()) on
    one fixed batch of 64 x 512 with 76 masked positions per row; returns
    (stats, launches)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import Adam
    batch, seq, n_mask, warmup, steps = 64, 512, 76, 2, 10
    cfg = BertConfig.base()
    cfg.dropout = 0.0
    model = BertForPretraining(cfg, device="cuda", seed=0)
    opt = amp.decorate(Adam(model.parameters(), 1e-4), amp.bf16_policy())
    ids, labels, nsp, mlm_mask, _, _, pos = bert_batch(
        np.random.RandomState(0), cfg.vocab_size, batch, seq, n_mask)
    pos = pos.cuda()

    def loss_fn(m, *a):
        return m.loss(*a, mask_positions=pos)

    args = tuple(a.cuda() for a in (ids, labels, nsp, mlm_mask))
    losses, times, launches, routes = train(model, opt, loss_fn, args,
                                            warmup, steps)
    check_launches("bert_train", launches, steps,
                   bert_launches_per_step(cfg.num_layers))
    check_routes("bert_train", routes, "tc")
    stats = step_stats("bert_train", "BertConfig.base()", batch, seq,
                       losses, times, launches, smi)
    return dict(stats, masked_positions=n_mask, routes=routes), launches


def bert_large_phase(smi):
    """BertConfig.large() (24 layers, H = 1024, 16 heads, I = 4096, 335 M
    params) at full width and depth on the card: dropout 0, weights from
    seed 0, amp.decorate(Adam(1e-4), bf16_policy()), one fixed seeded
    batch of 8 x 512 with 76 masked positions per row (bench.py's BERT
    batch of 64 cut to 8 to keep the phase short); 1 warm-up and 3 timed
    steps with the launch counts zeroed just before. Every kernel of the
    path must launch its count per step (K5 and K6 once: the width they
    refused before) and every loss must be finite; 4 steps are too few to
    ask the loss to fall. Returns (stats, launches)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import Adam
    batch, seq, n_mask, warmup, steps = 8, 512, 76, 1, 3
    cfg = BertConfig.large()
    cfg.dropout = 0.0
    model = BertForPretraining(cfg, device="cuda", seed=0)
    opt = amp.decorate(Adam(model.parameters(), 1e-4), amp.bf16_policy())
    ids, labels, nsp, mlm_mask, _, _, pos = bert_batch(
        np.random.RandomState(5), cfg.vocab_size, batch, seq, n_mask)
    pos = pos.cuda()

    def loss_fn(m, *a):
        return m.loss(*a, mask_positions=pos)

    args = tuple(a.cuda() for a in (ids, labels, nsp, mlm_mask))
    losses, times, launches, routes = train(model, opt, loss_fn, args,
                                            warmup, steps)
    check_launches("bert_large", launches, steps,
                   bert_launches_per_step(cfg.num_layers))
    check_routes("bert_large", routes, "tc")
    stats = step_stats("bert_large", "BertConfig.large()", batch, seq,
                       losses, times, launches, smi, must_fall=False)
    return dict(stats, masked_positions=n_mask, hidden_size=cfg.hidden_size,
                layers=cfg.num_layers, routes=routes), launches


def crosscheck_phase(phase, config, make_model, loss_fn, args, batch, seq,
                     kernels, **extra):
    """One f32 step on the card against the CPU plain path (see
    ``train_crosscheck``); emits the phase line, then raises if the loss
    or a gradient is outside its tolerance, or if one of ``kernels`` did
    not launch on the card."""
    loss_card, loss_cpu, errs, launches = train_crosscheck(make_model,
                                                           loss_fn, args)
    worst = max(errs, key=errs.get)
    emit(dict(phase=phase, config=config, batch=batch, seq=seq,
              dtype="float32", allow_tf32=False, **extra,
              loss_card=loss_card, loss_cpu=loss_cpu, loss_tol=TRAIN_LOSS_TOL,
              grad_rel_err_max=errs[worst], grad_rel_err_worst=worst,
              grad_tol=TRAIN_GRAD_TOL, params=len(errs),
              launches={k: launches[k] for k in kernels}))
    check(f"{phase} loss", abs(loss_card - loss_cpu), TRAIN_LOSS_TOL)
    check(f"{phase} gradient of {worst}", errs[worst], TRAIN_GRAD_TOL)
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{phase}: kernels not launched {missing}")


def kernel_table(results, mlp_tc, paths):
    """The rows of the {"kernels": [...]} line. K4 has a row per route
    (simt at serving's shape, "mlp.tc" at GPT training's case
    ``mlp_tc``), every other kernel one: flash and decode at their first
    case, the others at their first timed case; a row's case must have
    taken the row's route. ``paths`` holds each path's launch counts
    (serve, train, bert, bert_large)."""
    from paddle_tpu_torch.ops.cuda import core
    rows = []
    for name, kernel in core.KERNELS.items():
        case = results[name][0] if name in ("flash_attention",
                                            "decode_attention") \
            else next(c for c in results[name] if "kernel_ms" in c)
        path = ("serve" if name in SERVE_KERNELS else
                "train" if name in TRAIN_KERNELS else "bert")
        variant = ("tc" if name.startswith("xent") else "simt")
        rows.append((name, kernel, case, path, variant))
        if name == "mlp":
            rows.append(("mlp.tc", kernel, mlp_tc, "train", "tc"))
    table = []
    for name, kernel, case, path, variant in rows:
        if case.get("route", variant) != variant:
            raise AssertionError(f"{name}: its case took the "
                                 f"{case['route']} route, not {variant}")
        base = name.split(".")[0]
        table.append(dict(
            name=name, route="cuda", variant=variant, source=kernel.source,
            replaces=kernel.replaces, launches=paths[path][base],
            launches_path=path,
            launches_train=paths["train"][base],
            launches_bert=paths["bert"][base],
            launches_bert_large=paths["bert_large"][base],
            max_abs_err=case["max_abs_err"],
            ms=case["kernel_ms"], plain_ms=case["plain_ms"],
            bound_ms=case["bound_ms"],
            bound_by=case["bound_by"],
            library_ms=case["library_ms"],
            shape=case.get("shape", case.get("lengths")),
            dtype=case.get("dtype")))
    return table


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, GPTDecoder
    from paddle_tpu_torch.ops.cuda import core

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", kind=kind, count=torch.cuda.device_count(),
              nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, allow_tf32=False))
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    lib = core.build()
    core.library()
    ptxas = []
    for path in sorted(glob.glob(os.path.join(os.path.dirname(lib),
                                              "*.ptxas.txt"))):
        with open(path) as f:
            ptxas += [ln.strip() for ln in f if "Used" in ln]
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              library=os.path.relpath(lib), ptxas=ptxas))
    torch.cuda.synchronize()

    dev = torch.device("cuda")
    results = kernel_cases(dev)
    results.update(train_kernel_cases(dev))
    results.update(bert_kernel_cases(dev))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mlp_tc = next(c for c in results["train_shapes"]      # K4's tc row
                  if c["kernel"] == "mlp")
    for name, cases in results.items():
        for case in cases:
            # K4 and K5 take the tensor cores in bf16 (every case here has
            # widths that are multiples of 8) and the SIMT kernel in f32
            want = "tc" if "bfloat16" in str(case.get("dtype")) or \
                case.get("dtype") == "bf16" else "simt"
            if case.get("route", want) != want:
                raise AssertionError(f"{case.get('kernel', name)} "
                                     f"{case.get('shape')}: took the "
                                     f"{case['route']} route, not {want}")
            emit(dict(phase="kernel", kernel=case.pop("kernel", name),
                      **case))

    cfg = GPTConfig.small()
    cfg.dropout = 0.0
    model = GPTDecoder(cfg, device="cuda", seed=0)
    serve_kw = dict(num_slots=8, page_size=64, max_len=1024,
                    prefill_len=512, cache_dtype=torch.bfloat16)
    serve(model, 1, (64, 64), None, 4, serve_kw, seed=1)    # warm-up
    torch.cuda.synchronize()
    core.reset_launches()
    eng, rids, stats = serve(model, 16, (64, 512), 700, 64, serve_kw,
                             seed=0)
    launches = core.launch_counts()
    serve_routes = core.route_counts()
    torch.cuda.synchronize()
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serve path: "
                             f"{missing}")
    check_routes("serve", serve_routes, "simt", ("mlp",))
    emit(dict(phase="serve", config="GPTConfig.small()",
              **{k: v for k, v in serve_kw.items() if k != "cache_dtype"},
              cache_dtype="bfloat16", launches=launches,
              routes={"mlp": serve_routes["mlp"]}, **stats))

    cpu_model = GPTDecoder(cfg, device="cpu", seed=0)
    pick = [eng.requests[rids[-1]], eng.requests[rids[0]]]
    rows = crosscheck(model, cpu_model, pick, 64, 512)
    torch.cuda.synchronize()
    emit(dict(phase="crosscheck", rows=rows))

    int8_kw = dict(serve_kw, kv_dtype=torch.int8)
    core.reset_launches()
    _, _, stats8 = serve(model, 4, (64, 512), 600, 16, int8_kw, seed=2)
    torch.cuda.synchronize()
    launches8 = core.launch_counts()
    if launches8["decode_attention"] == 0:
        raise AssertionError("int8 serve did not launch the decode kernel")
    emit(dict(phase="int8", kv_dtype="int8", launches=launches8,
              **{k: v for k, v in stats8.items() if k != "prompt_lens"}))

    del model, eng
    torch.cuda.empty_cache()
    train_stats, train_launches = train_phase(cfg, smi)
    emit(dict(phase="train", **train_stats))

    small = GPTConfig.small()
    small.dropout = 0.0
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, small.vocab_size, (2, 128)))
    crosscheck_phase("train_crosscheck", "GPTConfig.small()",
                     lambda dev: GPT(small, device=dev, seed=0), loss_of,
                     (ids,), 2, 128, TRAIN_KERNELS)

    torch.cuda.empty_cache()
    bert_stats, bert_launches = bert_train_phase(smi)
    emit(dict(phase="bert_train", **bert_stats))

    torch.cuda.empty_cache()
    base = BertConfig.base()
    base.dropout = 0.0
    batch = bert_batch(np.random.RandomState(4), base.vocab_size, 2, 128, 19,
                       pad_row0=90, segment_b=60)
    crosscheck_phase(
        "bert_crosscheck", "BertConfig.base()",
        lambda dev: BertForPretraining(base, device=dev, seed=0),
        bert_loss_of, batch, 2, 128, BERT_KERNELS,
        attention_mask="row 0 padded after 90 tokens",
        token_type_ids="segment B from position 60", mask_positions=19)

    torch.cuda.empty_cache()
    large_stats, large_launches = bert_large_phase(smi)
    emit(dict(phase="bert_large", **large_stats))

    table = kernel_table(results, mlp_tc, {
        "serve": launches, "train": train_launches, "bert": bert_launches,
        "bert_large": large_launches})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
