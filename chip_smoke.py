"""Drive the PyTorch/CUDA port's serving path on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — needs a CUDA device (exits non-zero without one); prints the
   card's name and power limit from nvidia-smi; turns TF32 off.
2. build   — compiles the kernels from paddle_tpu_torch/csrc with nvcc.
3. kernel  — each kernel (K1 layer norm, K2 flash attention, K4 fused MLP,
   K7 paged decode attention) at the serving path's shapes and at ragged
   shapes, against its plain PyTorch version on the same inputs, with the
   stated tolerance; times the kernel, the plain version and, where one
   exists, one PyTorch library call computing the same function, beside
   the least time the card could take (bytes over 3.35 TB/s or operations
   over the peak rate of the input type).
4. serve   — GPTConfig.small() at full width (random weights from a
   seed) behind ServingEngine(num_slots=8, page_size=64, max_len=1024,
   prefill_len=512, bf16 cache): 16 prompts uniform in [64, 512] plus one
   of 700 tokens (chunked prefill), 64 new tokens each. The launch counts
   are zeroed just before and read just after; each kernel must have run.
5. crosscheck — two of those requests replayed teacher-forced on the
   card and on the CPU (plain path, f32 cache, same weights); logits must
   agree within the stated tolerance.
6. int8    — a short serve with an int8 KV pool.

Then the {"kernels": [...]} line, the nvidia-smi line, and the contract
line {"ok": true, "device": {...}}. Any failed phase raises, and the
script exits non-zero without the contract line.
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
SERVE_LOGIT_TOL = 5e-2   # bf16 KV cache on the card vs f32 cache on CPU


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20):
    """Mean device time of ``fn`` over ``iters`` runs. ``fn`` is captured
    once as a CUDA graph, and each replay is bracketed by its own CUDA
    events right after a 256 MiB memset: the memset evicts the 50 MB L2
    (inputs are read cold, as the model reads its weights) and keeps the
    device busy while the host enqueues the replay, so host launch time
    stays out of the reading."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    marks = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
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


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check(name, err, tol):
    if not (err <= tol):
        raise AssertionError(f"{name}: max |kernel - plain| = {err} > {tol}")


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
        out = mlp.mlp_kernel(x, w1, b1, w2, b2)
        ref = mlp.mlp_plain(x.float(), w1.float(), b1.float(), w2.float(),
                            b2.float())
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err = max_err(out, ref)
        check(f"mlp {rows}x768x{inter} {dtype}", err, tol)
        case = dict(shape=[rows, 768, inter, 768], dtype=str(dtype),
                    max_abs_err=err, tol=tol)
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


# ------------------------------------------------------------------- main

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
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
    torch.cuda.synchronize()
    for name, cases in results.items():
        for case in cases:
            emit(dict(phase="kernel", kernel=name, **case))

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
    torch.cuda.synchronize()
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    emit(dict(phase="serve", config="GPTConfig.small()",
              **{k: v for k, v in serve_kw.items() if k != "cache_dtype"},
              cache_dtype="bfloat16", launches=launches, **stats))

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

    table = []
    for name, kernel in core.KERNELS.items():
        main_case = results[name][0] if name in ("flash_attention",
                                                 "decode_attention") \
            else next(c for c in results[name] if "kernel_ms" in c)
        table.append(dict(
            name=name, route="cuda", source=kernel.source,
            replaces=kernel.replaces, launches=launches[name],
            max_abs_err=main_case["max_abs_err"],
            ms=main_case["kernel_ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"],
            shape=main_case.get("shape", main_case.get("lengths"))))
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
