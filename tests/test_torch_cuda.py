"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
fixture, never at import). On the card, with no JAX installed there:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: 1e-4 abs in f32 for outputs of order 1 (sums taken in
another order than the plain version's cuBLAS/torch reductions); bf16
outputs within 3e-2 (one bf16 rounding of values of order 1). The
training kernels' outputs (K3, K5, K6, K8) range over many magnitudes, so
each is held on its own scale: max |kernel - plain| <= tol * max |plain|.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

F32_TOL = 1e-4
BF16_TOL = 3e-2
SERVE_KERNELS = ("layer_norm", "flash_attention", "mlp", "decode_attention")
TRAIN_KERNELS = ("layer_norm", "flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "mlp", "xent_stats",
                 "xent_bwd_dh", "xent_bwd_dwb")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0, dev="cuda", dtype=torch.float32):
    return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)


def _held(got, want, tol):
    """Each output within ``tol`` of its own largest plain value (exactly
    0 where the plain version is all 0)."""
    for a, w in zip(got, want):
        err = float((a.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), (err, tol)


def test_layer_norm_kernel(cuda):
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    g = torch.Generator().manual_seed(0)
    for rows, cols in ((1, 64), (13, 768), (70, 100)):
        x = _randn(g, rows, cols, scale=3.0)
        gam, bet = _randn(g, cols), _randn(g, cols)
        got = ln.layer_norm_kernel(x, gam, bet, 1e-5)
        want = ln.layer_norm_plain(x, gam, bet, 1e-5)
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols,offset", [
    (8, 768, 0), (8192, 768, 0), (3, 1024, 0), (5, 200, 0), (13, 770, 0),
    (2, 4096, 0), (29, 768, 1)])
def test_layer_norm_row_route(cuda, dtype, rows, cols, offset):
    """K1 on the route ln_route picks: the row route at C = 768 and 1024,
    at C of whole packs that are not whole warps of packs, and on a view
    that does not start on 16 bytes (copied); the simt route at C off
    the pack and past the row route's widest."""
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    g = torch.Generator().manual_seed(rows + cols)
    x = _randn(g, rows * cols + offset, scale=3.0,
               dtype=dtype)[offset:].view(rows, cols)
    gam = _randn(g, cols, dtype=dtype) * 0.1 + 1.0
    bet = _randn(g, cols, dtype=dtype) * 0.1
    core.reset_launches()
    got = ln.layer_norm_kernel(x, gam, bet, 1e-5)
    want = ln.layer_norm_plain(x, gam, bet, 1e-5)
    route = ln.ln_route(dtype, cols)
    assert core.route_counts()["layer_norm"][route] == 1
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for a, b in zip(got, want):
        assert float((a.float() - b.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_layer_norm_kernel(cuda, dtype):
    """K8 against its plain version: 16-byte packs (C a multiple of the
    pack), element-wise rows (ragged C, and a misaligned view), and R not
    a multiple of the 8 rows per block."""
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    g = torch.Generator().manual_seed(7)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for rows, cols, offset in ((1, 64, 0), (13, 768, 0), (70, 100, 0),
                               (37, 96, 0), (9, 770, 0), (11, 256, 1)):
        buf = _randn(g, rows * cols + offset, scale=3.0, dtype=dtype)
        x = buf[offset:].view(rows, cols)
        h = _randn(g, rows, cols, dtype=dtype)
        gam = _randn(g, cols, scale=0.1, dtype=dtype) + 1.0
        bet = _randn(g, cols, scale=0.1, dtype=dtype)
        got = ln.add_layer_norm_kernel(x, h, gam, bet, 1e-5)
        want = ln.add_layer_norm_plain(x, h, gam, bet, 1e-5)
        assert got[0].dtype == dtype
        _held(got, want, tol)


def test_add_layer_norm_card_gradients_are_the_cpu_gradients(cuda):
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.ops.cuda.layer_norm import add_layer_norm_fused
    g = torch.Generator().manual_seed(8)
    leaves = [_randn(g, 3, 5, 96, dev="cpu"), _randn(g, 3, 5, 96, dev="cpu"),
              _randn(g, 96, dev="cpu"), _randn(g, 96, dev="cpu")]
    dy = _randn(g, 3, 5, 96, dev="cpu")
    grads = {}
    core.reset_launches()
    for dev in ("cuda", "cpu"):
        ts = [a.to(dev).requires_grad_(True) for a in leaves]
        add_layer_norm_fused(*ts, begin_norm_axis=2).backward(dy.to(dev))
        grads[dev] = [a.grad.cpu() for a in ts]
    assert core.launch_counts()["add_layer_norm"] == 1
    _held(grads["cuda"], grads["cpu"], F32_TOL)


def test_masked_attention_launches_the_flash_kernels(cuda):
    """A key-padding mask ([B, 1, 1, T], as BERT builds it) rides K2 with
    kv_mask, and its backward K3, with the CPU's output and gradients."""
    from paddle_tpu_torch.ops.attention import multihead_attention
    from paddle_tpu_torch.ops.cuda import core
    g = torch.Generator().manual_seed(9)
    x = _randn(g, 2, 40, 128, dev="cpu")
    ws = [_randn(g, 128, 128, scale=0.1, dev="cpu") for _ in range(4)]
    bs = [_randn(g, 128, scale=0.1, dev="cpu") for _ in range(4)]
    mask = torch.ones(2, 1, 1, 40)
    mask[0, ..., 25:] = 0.0
    outs, grads, counts = {}, {}, {}
    for dev in ("cuda", "cpu"):
        core.reset_launches()
        xx = x.to(dev).requires_grad_(True)
        out = multihead_attention(xx, *(w.to(dev) for w in ws),
                                  *(b.to(dev) for b in bs), 2,
                                  mask=mask.to(dev), use_flash=True)
        out.sum().backward()
        outs[dev], grads[dev] = out.detach().cpu(), xx.grad.cpu()
        counts[dev] = core.launch_counts()
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts["cuda"][name] == 1, counts["cuda"]
        assert counts["cpu"][name] == 0, counts["cpu"]
    _held([outs["cuda"], grads["cuda"]], [outs["cpu"], grads["cpu"]],
          F32_TOL)


# K2's and K3's bf16 tc route rounds P (and dS) to bf16 for the products
# that take them (2^-9 relative each) and each output once: every output
# is held at 2^-6 of its largest plain value (the card reads 2.0e-3 to
# 7.7e-3, the largest K3's dv at BERT-large's shape; faults planted in
# the kernels read 0.1 to 7, CHANGES.md), and K2's out also within
# BF16_TOL absolutely.
FLASH_BF16_TOL = 2.0 ** -6
#: (b, h, tq, tk, d, causal, masked): Tq != Tk causal, T not a multiple of
#: 64 or of the 128-row tile, a key mask with a fully masked batch row
_FLASH_CASES = {
    torch.float32: [(2, 3, 70, 70, 64, True, False),
                    (1, 2, 30, 100, 32, True, False),
                    (2, 2, 65, 65, 128, False, True),
                    # the simt route's split plans (chunks merged): the
                    # serve shape, Tq not a multiple of 64 with Tk > Tq
                    # and masked rows, D = 16 and 128, Tq > Tk
                    (1, 12, 512, 512, 64, True, False),
                    (3, 2, 200, 330, 64, True, True),
                    (2, 2, 190, 190, 16, True, True),
                    (1, 2, 250, 120, 128, True, False),
                    (2, 3, 100, 260, 32, False, True),
                    # few heads over many keys: 1023 kv tiles (the most
                    # an item's code names) split, 1094 not
                    (1, 12, 64, 65472, 64, False, False),
                    (1, 12, 64, 70000, 64, False, False)],
    torch.bfloat16: [(2, 3, 70, 70, 64, True, False),
                     (1, 4, 100, 300, 64, True, False),
                     (1, 2, 300, 100, 128, True, False),
                     (2, 2, 65, 65, 128, False, True),
                     (3, 2, 200, 200, 64, True, True),
                     (2, 3, 130, 130, 128, True, True)],
}


def _flash_mask(b, tk, dev):
    """Batch row 0 attends its first third of the keys, the last row
    none (its rows must come out exactly 0), any other row all."""
    mask = torch.ones(b, tk, dtype=torch.bool, device=dev)
    mask[0, tk // 3:] = False
    mask[-1] = False
    return mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_causal_offset_tails_and_mask(cuda, dtype):
    """K2 against chunked_attention: f32 (the simt route) within F32_TOL
    absolutely; bf16 at D = 64 and 128 (the tc route) on its own scale at
    FLASH_BF16_TOL and within BF16_TOL absolutely, against the f32 plain
    version of the same bf16 inputs; lse on the rows that see a key within
    F32_TOL of its scale, and in f32 also within F32_TOL absolutely; fully
    masked rows exactly 0."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    g = torch.Generator().manual_seed(1)
    for b, h, tq, tk, d, causal, masked in _FLASH_CASES[dtype]:
        q = _randn(g, b, h, tq, d, dtype=dtype)
        k = _randn(g, b, h, tk, d, dtype=dtype)
        v = _randn(g, b, h, tk, d, dtype=dtype)
        mask = _flash_mask(b, tk, cuda) if masked else None
        out, lse = fa.flash_attention_kernel(q, k, v, d ** -0.5, causal,
                                             mask)
        ref, rlse = fa.chunked_attention(q.float(), k.float(), v.float(),
                                         d ** -0.5, causal, mask,
                                         return_lse=True)
        assert out.dtype == dtype
        if dtype == torch.float32:
            assert float((out - ref).abs().max()) <= F32_TOL
        else:
            _held([out], [ref], FLASH_BF16_TOL)
            assert float((out.float() - ref).abs().max()) <= BF16_TOL
        if masked:
            assert float(out[-1].abs().max()) == 0.0
            lse, rlse = lse[:-1], rlse[:-1]
        if causal and tq > tk:
            lse, rlse = lse[..., tq - tk:], rlse[..., tq - tk:]
        _held([lse], [rlse], F32_TOL)
        if dtype == torch.float32:
            assert float((lse - rlse).abs().max()) <= F32_TOL


# K4's tc route (bf16): rows 1, 13, 130 (a partial 128-row tile) and 8197
# (64 tiles and 5 rows), I in {3000, 3072, 4096} (3000: a partial tile of
# every width), H = Hout in {768, 1024}
_MLP_TC_SHAPES = [(rows, hid, inter) for rows in (1, 13, 130, 8197)
                  for inter in (3000, 3072, 4096) for hid in (768, 1024)]


# K4's f32 routes: rows on both sides of the split/gemm threshold (32)
# and of the split route's row tiles (8, 16, 32), a gemm tile's 64 and 128
# rows and pass 2's splits; I = 3000 (a partial unit, k tile and column
# tile) and 3072; and narrow widths
_MLP_F32_SHAPES = ([(1, 64, 40), (17, 96, 200), (33, 768, 3072)]
                   + [(rows, 768, inter)
                      for rows in (1, 8, 9, 31, 32, 33, 255, 256, 513, 2048)
                      for inter in (3000, 3072)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_kernel_row_and_intermediate_tails(cuda, dtype):
    """K4 against its plain version in f32. f32 takes the split route up
    to 32 rows and the gemm route past them (abs, or relative beyond 1);
    bf16 takes the tensor cores, its output held at BF16_TOL on its own
    scale: one bf16 rounding of the activation and of the output. Each
    launch is counted on the route mlp_route gives, and on no other."""
    from paddle_tpu_torch.ops.cuda import core, mlp
    g = torch.Generator().manual_seed(2)
    shapes = (_MLP_F32_SHAPES if dtype == torch.float32
              else _MLP_TC_SHAPES)
    for rows, hid, inter in shapes:
        x = _randn(g, rows, hid, dtype=dtype)
        w1 = _randn(g, hid, inter, scale=hid ** -0.5, dtype=dtype)
        b1 = _randn(g, inter, scale=0.1, dtype=dtype)
        w2 = _randn(g, inter, hid, scale=inter ** -0.5, dtype=dtype)
        b2 = _randn(g, hid, scale=0.1, dtype=dtype)
        before = dict(core.KERNELS["mlp"].route_launches)
        got = mlp.mlp_kernel(x, w1, b1, w2, b2)
        want = mlp.mlp_plain(*(t.float() for t in (x, w1, b1, w2, b2)))
        route = mlp.mlp_route(dtype, hid, inter, hid, rows)
        assert route == ("tc" if dtype == torch.bfloat16 else
                         "split" if rows <= 32 else "gemm")
        after = core.KERNELS["mlp"].route_launches
        assert {r: n - before[r] for r, n in after.items()} == {
            r: int(r == route) for r in after}, (rows, hid, inter)
        assert got.dtype == dtype and got.shape == (rows, hid)
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= F32_TOL * max(
                1.0, float(want.abs().max()))
        else:
            _held([got], [want], BF16_TOL)


@pytest.mark.parametrize("rows", [64, 2048, 8192])
def test_mlp_split_route_at_many_rows(cuda, rows):
    """bf16 K4 at widths the tensor cores cannot take (H = 100, I = 3004)
    runs the split route at any rows; at many rows its plan falls to few
    splits, each block walking a wide slice 32 columns at a time, and
    the output is held at BF16_TOL against the f32 plain version."""
    from paddle_tpu_torch.ops.cuda import core, mlp
    g = torch.Generator().manual_seed(13)
    hid, inter, bf16 = 100, 3004, torch.bfloat16
    x = _randn(g, rows, hid, dtype=bf16)
    w1 = _randn(g, hid, inter, scale=hid ** -0.5, dtype=bf16)
    b1 = _randn(g, inter, scale=0.1, dtype=bf16)
    w2 = _randn(g, inter, hid, scale=inter ** -0.5, dtype=bf16)
    b2 = _randn(g, hid, scale=0.1, dtype=bf16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, splits = mlp.split_plan(rows, inter, sms)
    assert splits == 1 or rows < 8192
    assert mlp.mlp_route(bf16, hid, inter, hid, rows) == "split"
    before = core.KERNELS["mlp"].route_launches["split"]
    got = mlp.mlp_kernel(x, w1, b1, w2, b2)
    assert core.KERNELS["mlp"].route_launches["split"] == before + 1
    _held([got], [mlp.mlp_plain(*(t.float() for t in (x, w1, b1, w2,
                                                      b2)))], BF16_TOL)


def test_resident_slots_are_the_h100s(cuda):
    """The blocks an SM holds, as the plans read them from the occupancy
    calculator, are those the CPU plan tests take as the H100's
    (test_torch_kernels.py H100_GEMM_SLOTS and H100_FLASH_SLOTS): the gemm
    route's kernel 2 at either tile height, K2's simt kernel 4, 3, 2 and
    1 by head dim (f32; bf16 at 16 and 32 as f32)."""
    from paddle_tpu_torch.ops.cuda import core
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    gemm = {bm: core.resident_slots("ptt_mlp_gemm_resident", bm) // sms
            for bm in (128, 64)}
    assert gemm == {128: 2, 64: 2}
    f32 = {d: core.resident_slots("ptt_flash_attention_resident", core.F32,
                                  d) // sms for d in (16, 32, 64, 128)}
    assert f32 == {16: 4, 32: 3, 64: 2, 128: 1}
    assert {d: core.resident_slots("ptt_flash_attention_resident",
                                   core.BF16, d) // sms
            for d in (16, 32)} == {16: 4, 32: 3}


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_decode_kernel_ragged_pools(cuda, pool):
    from paddle_tpu_torch.ops.attention import init_page_pool, paged_write
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    g = torch.Generator().manual_seed(3)
    lengths = [0, 1, 7, 8, 9, 31]
    s, h, hd, ps, pmax = len(lengths), 3, 64, 8, 4
    n = s * pmax
    kv = torch.int8 if pool == "int8" else None
    dtype = torch.bfloat16 if pool == "bf16" else torch.float32
    p = init_page_pool(n, h, ps, hd, dtype=dtype, kv_dtype=kv, device=cuda)
    ptab = torch.from_numpy(np.random.RandomState(0).permutation(n)
                            .astype(np.int32)).reshape(s, pmax).to(cuda)
    ids = ptab.reshape(-1).long().repeat_interleave(ps)
    offs = torch.arange(ps, device=cuda).repeat(n)
    paged_write(p, _randn(g, n * ps, h, hd), _randn(g, n * ps, h, hd), ids,
                offs)
    q = _randn(g, s, h, hd)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    args = (q, p["k"], p["v"], ptab, lens, 0.125, p.get("k_scale"),
            p.get("v_scale"))
    got = da.paged_decode_kernel(*args)
    want = da.paged_attention_plain(*args)
    assert float((got - want).abs().max()) <= F32_TOL
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd,ps,lengths", [
    (64, 64, [0, 1, 63, 64, 65, 1024, 700, 129]),
    (128, 64, [1, 0, 128, 129, 1000, 5]),
    (256, 16, [0, 17, 16, 255, 256, 3]),
    (40, 8, [8, 9, 0, 1, 127, 64]),
    (8, 32, [31, 32, 33, 0, 511, 512]),
    (64, 16, [1000, 0, 999, 17])])
def test_decode_split_route(cuda, pool, hd, ps, lengths):
    """K7's split route against the plain version at head dims 8-256 and
    page sizes 8-64, lengths 0 and 1 and on and one past the splits'
    boundaries: within F32_TOL, exactly 0 at length 0, bitwise equal in
    two launches, every launch on the split route."""
    from paddle_tpu_torch.ops.attention import init_page_pool, paged_write
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    g = torch.Generator().manual_seed(hd + ps)
    s, h = len(lengths), 4
    pmax = -(-max(lengths) // ps)
    n = s * pmax
    kv = torch.int8 if pool == "int8" else None
    dtype = torch.bfloat16 if pool == "bf16" else torch.float32
    p = init_page_pool(n, h, ps, hd, dtype=dtype, kv_dtype=kv, device=cuda)
    ptab = torch.from_numpy(np.random.RandomState(1).permutation(n)
                            .astype(np.int32)).reshape(s, pmax).to(cuda)
    ids = ptab.reshape(-1).long().repeat_interleave(ps)
    offs = torch.arange(ps, device=cuda).repeat(n)
    paged_write(p, _randn(g, n * ps, h, hd), _randn(g, n * ps, h, hd), ids,
                offs)
    q = _randn(g, s, h, hd)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    args = (q, p["k"], p["v"], ptab, lens, hd ** -0.5, p.get("k_scale"),
            p.get("v_scale"))
    assert da.decode_route(hd) == "split"
    core.reset_launches()
    got = da.paged_decode_kernel(*args)
    again = da.paged_decode_kernel(*args)
    assert core.route_counts()["decode_attention"] == {"simt": 0,
                                                       "split": 2}
    want = da.paged_attention_plain(*args)
    assert float((got - want).abs().max()) <= F32_TOL
    assert torch.equal(got, again)
    zero = [i for i, v in enumerate(lengths) if v == 0]
    assert float(got[zero].abs().max()) == 0.0


def test_decode_split_route_in_a_cuda_graph(cuda):
    """The split route's launch pair replays from a CUDA graph: new
    lengths and queries written into the captured tensors between
    replays give the plain version's answers (nothing read on the
    host)."""
    from paddle_tpu_torch.ops.attention import init_page_pool, paged_write
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    g = torch.Generator().manual_seed(5)
    s, h, hd, ps, pmax = 4, 12, 64, 64, 8
    n = s * pmax
    p = init_page_pool(n, h, ps, hd, dtype=torch.bfloat16, device=cuda)
    ptab = torch.arange(n, dtype=torch.int32, device=cuda).reshape(s, pmax)
    paged_write(p, _randn(g, n * ps, h, hd), _randn(g, n * ps, h, hd),
                ptab.reshape(-1).long().repeat_interleave(ps),
                torch.arange(ps, device=cuda).repeat(n))
    q = _randn(g, s, h, hd)
    lens = torch.tensor([5, 0, 300, 512], dtype=torch.int32, device=cuda)
    da.paged_decode_kernel(q, p["k"], p["v"], ptab, lens, 0.125)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.paged_decode_kernel(q, p["k"], p["v"], ptab, lens, 0.125)
    for new in ([1, 64, 65, 0], [512, 511, 0, 129]):
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        q.copy_(_randn(g, s, h, hd))
        graph.replay()
        want = da.paged_attention_plain(q, p["k"], p["v"], ptab, lens,
                                        0.125)
        assert float((out - want).abs().max()) <= F32_TOL
        assert float(out[new.index(0)].abs().max()) == 0.0


def test_tiny_serve_runs_every_kernel(cuda):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    eng = ServingEngine(GPTDecoder(cfg, device="cuda"), ServeConfig(
        num_slots=2, page_size=8, max_len=48, prefill_len=16))
    rs = np.random.RandomState(0)
    core.reset_launches()
    for n in (5, 30, 12):
        eng.submit(rs.randint(0, cfg.vocab_size, n), max_new=6)
    done = eng.drain()
    assert len(done) == 3 and all(len(r.tokens) == 6 for r in done)
    counts = core.launch_counts()
    assert all(counts[k] > 0 for k in SERVE_KERNELS), counts


def _shared_prefix_prompts(vocab, rs):
    head = rs.randint(0, vocab, 16)
    return [np.concatenate([head, rs.randint(0, vocab, n)])
            for n in (3, 9, 0, 20)] + [rs.randint(0, vocab, 11)]


def test_prefix_cache_on_and_off_token_exact_on_card(cuda):
    """Greedy tokens with the prefix cache on (hits, a copy-on-write)
    equal those with it off, through every serving kernel."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    model = GPTDecoder(cfg, device="cuda", seed=3)
    prompts = _shared_prefix_prompts(cfg.vocab_size,
                                     np.random.RandomState(1))
    outs = []
    for cache in (True, False):
        eng = ServingEngine(model, ServeConfig(
            num_slots=2, page_size=8, max_len=64, prefill_len=16,
            prefix_cache=cache))
        core.reset_launches()
        for p in prompts:
            eng.submit(p, max_new=12)
        eng.drain()
        assert all(core.launch_counts()[k] > 0 for k in SERVE_KERNELS)
        outs.append([eng.requests[i].tokens for i in range(len(prompts))])
        if cache:
            assert eng.prefill_tokens_skipped > 0 and eng.cow_copies > 0
    assert outs[0] == outs[1]


def test_shared_pages_bitwise_unchanged_on_card(cuda):
    """A second request repeating the first one's two cached pages maps
    page 0, copies page 1 (its match ends inside it), prefills under the
    write floor and decodes 33 tokens: both cached pages of every layer's
    pool stay bitwise as published, and the private copy holds page 1's
    rows bitwise."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    eng = ServingEngine(GPTDecoder(cfg, device="cuda", seed=4), ServeConfig(
        num_slots=2, page_size=8, max_len=64, prefill_len=16,
        cache_dtype=torch.bfloat16))
    head = np.random.RandomState(2).randint(0, cfg.vocab_size, 20)
    first = eng.submit(head, max_new=40)
    eng.step()
    cached = list(eng.requests[first].shared_pages)
    assert len(cached) == 2
    idx = torch.tensor(cached, device="cuda")
    before = [{k: t[idx].clone() for k, t in pool.items()}
              for pool in eng._caches]
    second = eng.submit(head[:16], max_new=40)
    for _ in range(33):
        eng.step()
    req = eng.requests[second]
    assert req.shared_pages == cached[:1] and eng.cow_copies == 1
    assert len(req.tokens) == 34                 # prefill + 33 steps
    copy = req.pages[0]
    for old, pool in zip(before, eng._caches):
        for name, t in pool.items():
            assert torch.equal(t[idx], old[name]), name
            assert torch.equal(t[copy][..., :15, :] if t.ndim == 4
                               else t[copy][:15],
                               old[name][1][..., :15, :] if t.ndim == 4
                               else old[name][1][:15]), name


def test_sampled_wave_repeats_on_card(cuda):
    """The same sampled wave (temperature, top-k, top-p, seeds) on two
    fresh engines gives the same tokens."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    model = GPTDecoder(cfg, device="cuda", seed=5)
    prompts = _shared_prefix_prompts(cfg.vocab_size,
                                     np.random.RandomState(3))
    outs = []
    for _ in range(2):
        eng = ServingEngine(model, ServeConfig(
            num_slots=3, page_size=8, max_len=64, prefill_len=16,
            num_pages=12))
        for i, p in enumerate(prompts):
            eng.submit(p, max_new=16, temperature=0.9, top_k=40 * (i % 2),
                       top_p=0.9 if i % 3 else 0.0, seed=i)
        eng.drain()
        outs.append([eng.requests[i].tokens for i in range(len(prompts))])
    assert outs[0] == outs[1]


def test_verify_call_on_card_matches_cpu(cuda):
    """One speculative verify call (3 slots with windows of 4, 2 and 4,
    bf16 pools on the card, f32 on the CPU, the same prompts prefilled on
    both): each position's ``verify_head`` logits within 5e-2 of the
    CPU plain path's, K1 launched on its row route and K4 on SIMT, and no
    flash attention (every row takes the continuation branch)."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.ops.cuda import core
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=4, intermediate_size=1024, max_position=256,
                    dropout=0.0)
    rs = np.random.RandomState(6)
    rows = np.asarray([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    lengths = np.asarray([37, 9, 60], np.int32)
    window = rs.randint(0, 512, (3, 4)).astype(np.int32)
    wins = np.asarray([4, 2, 4], np.int32)
    logits = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        model = GPTDecoder(cfg, device=dev, seed=2).eval()
        pools = model.init_paged_caches(9, 32, dtype=dtype)
        table = torch.from_numpy(rows).to(dev)
        with torch.no_grad():
            for s, n in enumerate(lengths):
                prompt = np.zeros((1, 64), np.int32)
                prompt[0, :n] = np.random.RandomState(s).randint(0, 512, n)
                model.paged_prefill_chunk(
                    torch.from_numpy(prompt).to(dev),
                    torch.zeros(1, dtype=torch.int32),
                    torch.tensor([int(n)], dtype=torch.int32), pools,
                    table[s:s + 1])
            core.reset_launches()
            hidden, _ = model.paged_verify_chunk(
                torch.from_numpy(window).to(dev), torch.from_numpy(lengths),
                torch.from_numpy(wins).to(dev), pools, table)
            logits[dev] = torch.stack([model.verify_head(hidden[:, i])
                                       for i in range(4)], 1).float().cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            counts, routes = core.launch_counts(), core.route_counts()
    live = torch.from_numpy(np.arange(4)[None, :] < wins[:, None])
    err = (logits["cuda"] - logits["cpu"]).abs().amax(-1)[live]
    assert float(err.max()) <= 5e-2, err
    assert counts["flash_attention"] == 0
    assert counts["layer_norm"] == routes["layer_norm"]["row"] == 5
    assert counts["mlp"] == routes["mlp"]["split"] == 2


def test_sampling_uniforms_equal_on_cpu_and_card(cuda):
    """The Philox uniforms are bit-identical on the CPU and the card, and
    so are the sampled tokens of the same logits."""
    from paddle_tpu_torch.serving.sampling import sample, uniforms
    seeds = torch.tensor([0, 7, 2 ** 32 - 1, 123456789])
    counts = torch.tensor([0, 1, 63, 1000])
    cpu = uniforms(42, seeds, counts, 32000)
    card = uniforms(42, seeds.cuda(), counts.cuda(), 32000)
    assert torch.equal(card.cpu(), cpu)
    logits = torch.randn(4, 32000, generator=torch.Generator().manual_seed(0))
    knobs = (torch.tensor([0.8, 1.0, 0.0, 1.3]), torch.tensor([50, 0, 0, 5]),
             torch.tensor([0.95, 0.0, 0.0, 0.5]))
    want = sample(logits, *knobs, seeds, counts, 42)
    got = sample(logits.cuda(), *(k.cuda() for k in knobs), seeds.cuda(),
                 counts.cuda(), 42)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b,h,tq,tk,d,dtype,causal,masked", [
    (2, 3, 70, 70, 64, torch.float32, True, False),
    (1, 2, 30, 100, 32, torch.float32, True, False),
    (2, 2, 65, 65, 128, torch.float32, False, True),
    (1, 2, 100, 40, 16, torch.float32, True, False),
    (2, 3, 130, 130, 64, torch.bfloat16, True, False),
    (1, 4, 100, 300, 64, torch.bfloat16, True, False),
    (1, 2, 300, 100, 128, torch.bfloat16, True, False),
    (3, 2, 200, 200, 64, torch.bfloat16, False, True),
    (2, 3, 130, 130, 128, torch.bfloat16, True, True),
])
def test_flash_backward_kernel(cuda, b, h, tq, tk, d, dtype, causal, masked):
    """K3 against its plain version from K2's own out and lse: f32 within
    F32_TOL of each output's scale; bf16 (the tc route at D = 64 and 128,
    the simt route below) each output on its own scale at FLASH_BF16_TOL
    against the plain version in f32 of the same bf16 inputs; the rows of
    a fully masked batch row and the masked keys exactly 0."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    g = torch.Generator().manual_seed(4)
    q, dout = (_randn(g, b, h, tq, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(g, b, h, tk, d, dtype=dtype) for _ in range(2))
    mask = _flash_mask(b, tk, cuda) if masked else None
    scale = d ** -0.5
    out, lse = fa.flash_attention_kernel(q, k, v, scale, causal, mask)
    got = fa.flash_attention_bwd_kernel(q, k, v, out, lse, dout, scale,
                                        causal, mask)
    want = fa.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), lse, dout.float(),
        scale, causal, mask)
    assert all(a.dtype == dtype for a in got)
    _held(got, want, F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL)
    if masked:
        assert float(got[0][-1].abs().max()) == 0.0
        assert float(got[1][0, :, tk // 3:].abs().max()) == 0.0
        assert float(got[2][-1].abs().max()) == 0.0


def test_flash_takes_the_tensor_core_route_by_the_rule(cuda):
    """bf16 K2 and K3 at D = 64 and 128 launch on the tc route (its count
    rises, no other route's does); bf16 at D = 32 takes the simt route;
    f32 at D = 64 K2's simt route and K3's tf32x3 route, f32 at D = 32 the
    simt routes; each still right. An input that does not start on 16
    bytes (TMA's alignment) is copied and still takes the tc route (bf16)
    or K3's tf32x3 route (f32)."""
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    g = torch.Generator().manual_seed(13)
    names = ("flash_attention", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")

    def run(d, dtype, misaligned=False):
        q, k, v, do = (_randn(g, 2, 2, 96, d, dtype=dtype)
                       for _ in range(4))
        if misaligned:
            buf = torch.empty(q.numel() + 1, dtype=dtype, device=cuda)
            q = buf[1:].view_as(q).copy_(q)
            assert q.data_ptr() % 16
        before = {n: dict(core.KERNELS[n].route_launches) for n in names}
        out, lse = fa.flash_attention_kernel(q, k, v, d ** -0.5, True)
        got = fa.flash_attention_bwd_kernel(q, k, v, out, lse, do,
                                            d ** -0.5, True)
        after = {n: core.KERNELS[n].route_launches for n in names}
        ref = fa.chunked_attention(q.float(), k.float(), v.float(),
                                   d ** -0.5, True)
        want = fa.flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), out.float(), lse, do.float(),
            d ** -0.5, True)
        tol = F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
        _held([out, *got], [ref, *want], tol)
        return {n: {r: after[n][r] - before[n][r] for r in after[n]}
                for n in names}

    def taken(counts):
        return [r for r, n in counts.items() if n]

    for d, dtype, route, bwd_route in (
            (64, torch.bfloat16, "tc", "tc"),
            (128, torch.bfloat16, "tc", "tc"),
            (32, torch.bfloat16, "simt", "simt"),
            (64, torch.float32, "simt", "tf32x3"),
            (32, torch.float32, "simt", "simt")):
        assert fa.flash_route(dtype, d) == route
        assert fa.flash_bwd_route(dtype, d) == bwd_route
        for name, counts in run(d, dtype).items():
            want = route if name == "flash_attention" else bwd_route
            assert counts[want] == 1 and taken(counts) == [want], (
                name, d, dtype, counts)
    for dtype, bwd_route in ((torch.bfloat16, "tc"),
                             (torch.float32, "tf32x3")):
        for name, counts in run(64, dtype, misaligned=True).items():
            want = ("tc" if dtype == torch.bfloat16 else "simt") \
                if name == "flash_attention" else bwd_route
            assert taken(counts) == [want] and counts[want] == 1, (
                name, dtype, counts)


# K6's bf16 route feeds the second product gch rounded to bf16 (one
# rounding, 2^-9 relative, per dlogit), so its dh and dw are held at 2^-8
# of their largest plain value; db (summed from the f32 gch), its f32
# routes (3xTF32, SIMT) and K5 at F32_TOL.
XENT_BF16_TOL = 2.0 ** -8


def _held_xent_bwd(got, want, labels, v, dtype):
    """K6's ``(dh, dw, db)``, each held on its own scale and again on the
    entries no label reaches (dh's rows with an out-of-range label, dw's
    rows and db's entries no label hits) on their own scale: there only
    the softmax term acts, which the label term hides in the whole
    output."""
    lab = labels.long()
    miss = (lab < 0) | (lab >= v)
    unhit = torch.ones(v, dtype=torch.bool, device=labels.device)
    unhit[lab[~miss]] = False
    assert miss.any() and unhit.any()
    tol = F32_TOL if dtype == torch.float32 else XENT_BF16_TOL
    for a, w, sel, t in zip(got, want, (miss, unhit, unhit),
                            (tol, tol, F32_TOL)):
        _held([a, a[sel]], [w, w[sel]], t)


@pytest.mark.parametrize("n,v,hid,dtype,ls", [
    (78, 300, 128, torch.float32, 0.1),
    (130, 1000, 768, torch.float32, 0.0),
    (37, 65, 96, torch.bfloat16, 0.0),
    (4864, 30522, 768, torch.bfloat16, 0.0),   # BERT's MLM head
    (8176, 32000, 768, torch.bfloat16, 0.0),   # GPT's train step
    (300, 2000, 1024, torch.bfloat16, 0.1),    # BERT-large's width
    (130, 1000, 1024, torch.float32, 0.0),
    (50, 300, 64, torch.bfloat16, 0.0),        # one box: a zero box pads
    (200, 3000, 576, torch.bfloat16, 0.1),     # 9 boxes: odd ring parts
    (4088, 32000, 768, torch.float32, 0.0),    # the program path's head
    (37, 300, 96, torch.float32, 0.1),         # ragged: a vocab tail
    (45, 700, 66, torch.float32, 0.0),         # H % 4 != 0: SIMT
])
def test_xent_kernels(cuda, n, v, hid, dtype, ls):
    """K5 and K6 against their plain versions (F32_TOL in f32, on each
    output's scale and on the entries no label reaches), each launch on
    its route: f32 3xTF32 where H % 4 == 0, else SIMT; bf16 the tensor
    cores (K5 where H % 8 == 0)."""
    from paddle_tpu_torch.ops.cuda import core, xent
    names = ("xent_stats", "xent_bwd_dh", "xent_bwd_dwb")
    if dtype == torch.float32:
        route = dict.fromkeys(names, "tf32x3" if hid % 4 == 0 else "simt")
    else:
        route = dict.fromkeys(names, "tc")
        route["xent_stats"] = "tc" if hid % 8 == 0 else "simt"
    before = {k: dict(core.KERNELS[k].route_launches) for k in names}
    g = torch.Generator().manual_seed(5)
    h = _randn(g, n, hid, dtype=dtype)
    w = _randn(g, v, hid, scale=0.05, dtype=dtype)
    bias = _randn(g, v, scale=0.1)
    labels = torch.randint(0, v, (n,), generator=g).to(cuda)
    labels[::7] = v + 3                       # out of range: never hits
    want = xent.xent_stats_plain(h, w, bias, labels)
    _held(xent.xent_stats_kernel(h, w, bias, labels), want, F32_TOL)
    logz = want[0] + torch.log(want[1])
    gg = _randn(g, n, scale=0.01)
    sn, sp = (ls / (v - 1), 1.0 - ls) if ls else (0.0, 1.0)
    _held_xent_bwd(
        xent.xent_bwd_kernel(h, w, bias, labels, logz, gg, sn, sp),
        xent.xent_bwd_plain(h, w, bias, labels, logz, gg, sn, sp), labels,
        v, dtype)
    for k in names:
        after = core.KERNELS[k].route_launches
        assert {r: after[r] - before[k][r] for r in after} == {
            r: int(r == route[k]) for r in after}, (k, after)


@pytest.mark.parametrize("n,v,hid", [
    (300, 30522, 768),       # a vocab tail: 30522 = 119 x 256 + 58
    (300, 30522, 1024),
    (4864, 30522, 768),      # BERT's MLM head
    (4864, 30522, 1024),     # BERT-large's
    (130, 1000, 96),         # H not a multiple of 64: the K tail
])
def test_xent_stats_tensor_core_route(cuda, n, v, hid):
    """K5's tc route (bf16) against its plain version at F32_TOL on each
    statistic's scale, with the vocab tail, the ignore label and labels
    out of range on both sides."""
    from paddle_tpu_torch.ops.cuda import core, xent
    g = torch.Generator().manual_seed(10)
    h = _randn(g, n, hid, dtype=torch.bfloat16)
    w = _randn(g, v, hid, scale=0.05, dtype=torch.bfloat16)
    bias = _randn(g, v, scale=0.1)
    labels = torch.randint(0, v, (n,), generator=g).to(cuda)
    labels[3::97] = -100
    labels[::7] = v + 3
    labels[1::9] = -2
    labels[5] = v - 1                         # the last column hits
    before = core.KERNELS["xent_stats"].route_launches["tc"]
    got = xent.xent_stats_kernel(h, w, bias, labels)
    assert core.KERNELS["xent_stats"].route_launches["tc"] == before + 1
    _held(got, xent.xent_stats_plain(h, w, bias, labels), F32_TOL)


def test_k4_k5_take_the_tensor_core_route_by_the_rule(cuda):
    """bf16 K4 and K5 with widths that are multiples of 8 launch on the
    tc route (its count rises, no other route's does); H = 100 in bf16
    takes K4's split route and K5's simt route, f32 at 40 rows K4's gemm
    route and K5's tf32x3 route, each still right."""
    from paddle_tpu_torch.ops.cuda import core, mlp, xent
    g = torch.Generator().manual_seed(12)

    def mlp_case(hid, dtype):
        x = _randn(g, 40, hid, dtype=dtype)
        ws = (_randn(g, hid, 256, scale=0.1, dtype=dtype),
              _randn(g, 256, dtype=dtype),
              _randn(g, 256, hid, scale=0.1, dtype=dtype),
              _randn(g, hid, dtype=dtype))
        return (x,) + ws

    def stats_case(hid, dtype):
        labels = torch.randint(0, 300, (40,), generator=g).to(cuda)
        return (_randn(g, 40, hid, dtype=dtype),
                _randn(g, 300, hid, scale=0.05, dtype=dtype),
                _randn(g, 300, scale=0.1), labels)

    for hid, dtype, routes in ((128, torch.bfloat16, ("tc", "tc")),
                               (100, torch.bfloat16, ("split", "simt")),
                               (128, torch.float32, ("gemm", "tf32x3"))):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for name, fn, plain, case, route in (
                ("mlp", mlp.mlp_kernel, mlp.mlp_plain, mlp_case, routes[0]),
                ("xent_stats", xent.xent_stats_kernel,
                 xent.xent_stats_plain, stats_case, routes[1])):
            args = case(hid, dtype)
            before = dict(core.KERNELS[name].route_launches)
            got = fn(*args)
            after = core.KERNELS[name].route_launches
            assert {r: n - before[r] for r, n in after.items()} == {
                r: int(r == route) for r in after}, (name, hid, dtype)
            if name == "mlp":
                _held([got], [plain(*(t.float() for t in args))], tol)
            else:
                _held(got, plain(*args), F32_TOL)
    # an input that does not start on 16 bytes (TMA's alignment) is copied
    # by the wrapper and still takes the tc route
    for name, fn, plain, case in (
            ("mlp", mlp.mlp_kernel, mlp.mlp_plain, mlp_case),
            ("xent_stats", xent.xent_stats_kernel, xent.xent_stats_plain,
             stats_case)):
        args = list(case(128, torch.bfloat16))
        buf = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16,
                          device=cuda)
        args[0] = buf[1:].view_as(args[0]).copy_(args[0])
        assert args[0].data_ptr() % 16
        before = core.KERNELS[name].route_launches["tc"]
        got = fn(*args)
        assert core.KERNELS[name].route_launches["tc"] == before + 1
        if name == "mlp":
            _held([got], [plain(*(t.float() for t in args))], BF16_TOL)
        else:
            _held(got, plain(*args), F32_TOL)


def test_xent_bf16_backward_takes_the_tensor_core_route(cuda):
    """bf16 K6 launches its own kernels (the counts rise) and refuses what
    only the f32 route takes (H % 8 != 0) instead of running it."""
    from paddle_tpu_torch.ops.cuda import core, xent
    g = torch.Generator().manual_seed(6)

    def inputs(hid, dtype):
        h = _randn(g, 70, hid, dtype=dtype)
        w = _randn(g, 200, hid, scale=0.05, dtype=dtype)
        labels = torch.randint(0, 200, (70,), generator=g).to(cuda)
        stats = xent.xent_stats_plain(h, w, None, labels)
        return (h, w, None, labels, stats[0] + torch.log(stats[1]),
                _randn(g, 70, scale=0.01), 0.0, 1.0)

    args = inputs(128, torch.bfloat16)
    args[3][::5] = -100                       # rows no label reaches
    before = core.launch_counts()
    _held_xent_bwd(xent.xent_bwd_kernel(*args), xent.xent_bwd_plain(*args),
                   args[3], 200, torch.bfloat16)
    after = core.launch_counts()
    assert after["xent_bwd_dh"] == before["xent_bwd_dh"] + 1
    assert after["xent_bwd_dwb"] == before["xent_bwd_dwb"] + 1
    with pytest.raises(ValueError, match="multiple of 8"):
        xent.xent_bwd_dh_kernel(*inputs(100, torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 8"):
        xent.xent_bwd_dwb_kernel(*inputs(100, torch.bfloat16))
    assert core.launch_counts()["xent_bwd_dh"] == after["xent_bwd_dh"]
    args = inputs(100, torch.float32)
    _held(xent.xent_bwd_kernel(*args), xent.xent_bwd_plain(*args), F32_TOL)


def test_card_loss_backward_gives_the_cpu_gradients(cuda):
    """Every kernel of the card path is differentiable: GPT.loss's
    backward on the card gives every parameter the gradient the CPU plain
    path gives (f32, TF32 off; the embedding gradients sum with atomics
    in a varying order)."""
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.ops.cuda import core
    cfg = GPTConfig(vocab_size=300, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256, max_position=64,
                    dropout=0.0)
    card, cpu = GPT(cfg, device="cuda", seed=0), GPT(cfg, device="cpu",
                                                      seed=0)
    ids = torch.randint(0, 300, (2, 40),
                        generator=torch.Generator().manual_seed(6))
    core.reset_launches()
    lc = card.loss(ids.to(cuda))
    lc.backward()
    lp = cpu.loss(ids)
    lp.backward()
    assert abs(lc.item() - lp.item()) <= F32_TOL
    counts = core.launch_counts()
    assert all(counts[k] > 0 for k in TRAIN_KERNELS), counts
    grads = {n: p.grad for n, p in cpu.named_parameters()}
    scale = max(float(g.norm()) for g in grads.values())
    for name, p in card.named_parameters():
        assert p.grad is not None, name
        want = grads[name]
        err = float((p.grad.cpu() - want).norm())
        assert err <= 1e-3 * max(float(want.norm()), 1e-3 * scale), name


def test_bert_card_loss_backward_gives_the_cpu_gradients(cuda):
    """BertForPretraining.loss on the card (K1, K2/K3 with a padded
    kv_mask, K4, K5/K6 with the MLM bias, K8) gives the CPU plain path's
    loss and every parameter's gradient (f32, TF32 off)."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.ops.cuda import core
    cfg = BertConfig(vocab_size=300, hidden_size=128, num_layers=2,
                     num_heads=2, intermediate_size=256, max_position=64,
                     dropout=0.0)
    rs = np.random.RandomState(11)
    ids = torch.from_numpy(rs.randint(0, 300, (2, 40)))
    types = torch.zeros(2, 40, dtype=torch.long)
    types[:, 22:] = 1
    att = torch.ones(2, 40)
    att[0, 30:] = 0.0
    pos = torch.from_numpy(np.sort(np.stack([rs.choice(30, 6, replace=False)
                                             for _ in range(2)]), 1))
    args = (ids, torch.from_numpy(rs.randint(0, 300, (2, 6))),
            torch.from_numpy(rs.randint(0, 2, 2)), torch.ones(2, 6))
    out = {}
    for dev in ("cuda", "cpu"):
        model = BertForPretraining(cfg, device=dev, seed=0)
        core.reset_launches()
        loss = model.loss(*(a.to(dev) for a in args),
                          token_type_ids=types.to(dev),
                          attention_mask=att.to(dev),
                          mask_positions=pos.to(dev))
        loss.backward()
        out[dev] = (loss.item(), {k: p.grad.cpu()
                                  for k, p in model.named_parameters()},
                    core.launch_counts())
    (lc, gc, counts), (lp, gp, _) = out["cuda"], out["cpu"]
    assert abs(lc - lp) <= F32_TOL
    want = {"add_layer_norm": 4, "layer_norm": 2, "flash_attention": 2,
            "flash_attention_bwd_dq": 2, "flash_attention_bwd_dkv": 2,
            "mlp": 2, "xent_stats": 1, "xent_bwd_dh": 1, "xent_bwd_dwb": 1}
    assert {k: counts[k] for k in want} == want, counts
    scale = max(float(g.norm()) for g in gp.values())
    for name, g in gc.items():
        err = float((g - gp[name]).norm())
        assert err <= 1e-3 * max(float(gp[name].norm()), 1e-3 * scale), name


@pytest.mark.parametrize("dtype,pdtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_add_layer_norm_kernel_with_parameters_of_another_type(cuda, dtype,
                                                               pdtype):
    """K8 with the scale and bias in another type than the rows (the bf16
    policy's Transformer: f32 rows, bf16 parameters), widened exactly: on
    16-byte packs, element-wise rows and a ragged row count; a mix of x
    and h still raises."""
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    g = torch.Generator().manual_seed(8)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for rows, cols, offset in ((8192, 1024, 0), (8189, 1024, 0),
                               (13, 768, 0), (70, 100, 0), (11, 256, 1)):
        x = _randn(g, rows * cols + offset, scale=3.0,
                   dtype=dtype)[offset:].view(rows, cols)
        h = _randn(g, rows, cols, dtype=dtype)
        gam = _randn(g, cols, scale=0.1, dtype=pdtype) + 1.0
        bet = _randn(g, cols, scale=0.1, dtype=pdtype)
        got = ln.add_layer_norm_kernel(x, h, gam, bet, 1e-5)
        want = ln.add_layer_norm_plain(x, h, gam, bet, 1e-5)
        assert got[0].dtype == dtype
        _held(got, want, tol)
    with pytest.raises(TypeError):
        ln.add_layer_norm_kernel(x.to(torch.bfloat16), h.float(), gam, bet,
                                 1e-5)


def _transformer_batch(vocab, b=2, s=24, t=20, seed=12):
    rs = np.random.RandomState(seed)
    src = torch.from_numpy(rs.randint(1, vocab, (b, s)))
    src_mask = torch.ones(b, s)
    src_mask[1, 15:] = 0.0
    tgt_in = torch.from_numpy(rs.randint(1, vocab, (b, t)))
    tgt_out = torch.from_numpy(rs.randint(1, vocab, (b, t)))
    tgt_out[0, 17:] = 0
    return src, tgt_in, tgt_out, src_mask


def test_transformer_card_step_gives_the_cpu_gradients(cuda):
    """Transformer.loss at TransformerConfig.tiny()'s widths on the card
    (K8 on the post-norm residuals: 2 per encoder layer and 3 per decoder
    layer) gives the CPU plain path's loss and every gradient (f32, TF32
    off); under the bf16 policy (f32 rows, bf16 parameters) its loss is
    the CPU's within 1e-3 and K8 launches the same count."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Adam
    cfg = TransformerConfig.tiny()
    cfg.dropout = 0.0
    args = _transformer_batch(cfg.src_vocab)
    per_step = 2 * cfg.enc_layers + 3 * cfg.dec_layers
    out = {}
    for dev in ("cuda", "cpu"):
        model = Transformer(cfg, device=dev, seed=0)
        core.reset_launches()
        loss = model.loss(*(a.to(dev) for a in args))
        loss.backward()
        out[dev] = (loss.item(), {k: p.grad.cpu()
                                  for k, p in model.named_parameters()},
                    core.launch_counts())
    (lc, gc, counts), (lp, gp, _) = out["cuda"], out["cpu"]
    assert abs(lc - lp) <= F32_TOL
    assert counts["add_layer_norm"] == per_step
    assert sum(counts.values()) == per_step, counts
    scale = max(float(g.norm()) for g in gp.values())
    for name, g in gc.items():
        err = float((g - gp[name]).norm())
        assert err <= 1e-3 * max(float(gp[name].norm()), 1e-3 * scale), name
    losses = {}
    for dev in ("cuda", "cpu"):
        model = Transformer(cfg, device=dev, seed=0)
        opt = amp.decorate(Adam(model.parameters(), 1e-4), amp.bf16_policy())
        core.reset_launches()
        losses[dev] = float(opt.minimize(model, lambda m, *a: m.loss(*a),
                                         *(a.to(dev) for a in args)))
        if dev == "cuda":
            assert core.launch_counts()["add_layer_norm"] == per_step
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-3


def test_seq2seq_decodes_on_card_as_on_cpu(cuda):
    """AttentionSeq2Seq.tiny(): greedy and beam tokens on the card equal
    the CPU's, beam scores within 1e-4; the path runs no kernel of the
    port (the reference runs none)."""
    from paddle_tpu_torch.models.seq2seq import (AttentionSeq2Seq,
                                                 Seq2SeqConfig)
    from paddle_tpu_torch.ops.cuda import core
    rs = np.random.RandomState(3)
    src = torch.from_numpy(rs.randint(3, 64, (4, 9)))
    lengths = torch.tensor([9, 5, 1, 7])
    out = {}
    for dev in ("cuda", "cpu"):
        model = AttentionSeq2Seq(Seq2SeqConfig.tiny(), device=dev, seed=0)
        core.reset_launches()
        with torch.no_grad():
            g = model.greedy_decode(src.to(dev), lengths.to(dev), 1, 2, 10)
            s, sc = model.beam_decode(src.to(dev), lengths.to(dev), 1, 2, 4,
                                      10)
        out[dev] = (g.cpu(), s.cpu(), sc.cpu(), core.launch_counts())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert float((out["cuda"][2] - out["cpu"][2]).abs().max()) <= 1e-4
    assert sum(out["cuda"][3].values()) == 0


@pytest.mark.parametrize("dtype,loss_tol,grad_tol,stats_tol", [
    (torch.float32, 1e-4, 1e-2, 1e-5),
    (torch.float64, 1e-6, 1e-5, 1e-6)])
def test_resnet_card_step_gives_the_cpu_gradients_and_statistics(
        cuda, dtype, loss_tol, grad_tol, stats_tol):
    """One Momentum step of ResNet-18 (CIFAR stem, NHWC compute as
    channels_last, cuDNN convolutions) at 4 x 3 x 32 x 32 on the card and
    on the CPU from the same weights: the loss, every gradient (relative
    L2) and every updated running statistic (relative to its leaf's
    largest) within the bars; no kernel of the port launches (the
    reference's convolutions, pools and batch norms are XLA's). f64 holds
    the card's path to the CPU's at 1e-5; in f32 (TF32 off) cuDNN's
    convolution algorithms round otherwise than the CPU's, and the batch
    norms' bias gradients (sums over 4096 positions that cancel) carry
    it, so f32 is held at 1e-2."""
    from paddle_tpu_torch.models import resnet18
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy
    from paddle_tpu_torch.optimizer import Momentum
    rs = np.random.RandomState(5)
    images = torch.from_numpy(rs.rand(4, 3, 32, 32).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, 10, (4, 1)))
    out = {}
    for dev in ("cuda", "cpu"):
        model = resnet18(10, small_input=True, device=dev, seed=0).to(dtype)
        opt = Momentum(model.parameters(), 0.1, 0.9)
        core.reset_launches()
        loss = opt.minimize(model, lambda m, x, y: softmax_with_cross_entropy(
            m(x), y).mean(), images.to(dev, dtype), labels.to(dev))
        out[dev] = (float(loss), {k: p.grad.cpu() for k, p in
                                  model.named_parameters()},
                    {k: b.cpu() for k, b in model.named_buffers()},
                    core.launch_counts())
    (lc, gc, bc, counts), (lp, gp, bp, _) = out["cuda"], out["cpu"]
    assert abs(lc - lp) <= loss_tol
    assert sum(counts.values()) == 0, counts
    for name, g in gc.items():
        assert float((g - gp[name]).norm()) <= grad_tol * float(
            gp[name].norm()), name
    for name, b in bc.items():
        assert float((b - bp[name]).abs().max()) <= stats_tol * float(
            bp[name].abs().max()), name


def test_sparse_deepfm_step_on_card_gives_the_cpu_step(cuda):
    """Two sparse-row DeepFM steps (CTRConfig.tiny(), Adam on the head,
    Adagrad on both SparseTables, duplicate ids) on the card and on the
    CPU from the same weights and table draws: the losses, the head and
    both tables with their moments within 1e-5 (the backward of the
    gather sums duplicate rows atomically, in no fixed order); no kernel
    of the port launches (the reference's path is XLA gathers, scatters
    and GEMMs)."""
    from paddle_tpu_torch.models.ctr import (CTRConfig, DeepFM,
                                             make_sparse_deepfm_train_step)
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Adagrad, Adam
    from paddle_tpu_torch.parallel import SparseTable
    cfg = CTRConfig.tiny()
    rs = np.random.RandomState(0)
    dense = torch.from_numpy(rs.rand(32, 3).astype(np.float32))
    sparse = torch.from_numpy(rs.randint(0, 100, (32, 4)).astype(np.int32))
    sparse[:, 2] = 7
    labels = torch.from_numpy(rs.randint(0, 2, (32, 1)).astype(np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        model = DeepFM(cfg, sparse_tables=True, device=dev, seed=0)
        tbls = [SparseTable(cfg.total_vocab, d, lambda ps: Adagrad(ps, 0.05))
                for d in (cfg.embed_dim, 1)]
        states = [tb.init(seed=1 + i, device=dev) for i, tb in
                  enumerate(tbls)]
        step = make_sparse_deepfm_train_step(
            model, Adam(model.parameters(), 1e-2), *tbls, *states)
        core.reset_launches()
        losses = [float(step(dense.to(dev), sparse.to(dev), labels.to(dev)))
                  for _ in range(2)]
        out[dev] = (losses, {k: p.detach().cpu() for k, p in
                             model.named_parameters()},
                    [{"table": s["table"].cpu(), **{
                        k: v.cpu() for k, v in s["slots"].items()}}
                     for s in states], core.launch_counts())
    (lc, pc, tc, launches), (lp, pp, tp, _) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(lc, lp, rtol=1e-5)
    for k in pp:
        np.testing.assert_allclose(pc[k].numpy(), pp[k].numpy(), atol=1e-5,
                                   err_msg=k)
    for c, p in zip(tc, tp):
        for k in p:
            np.testing.assert_allclose(c[k].numpy(), p[k].numpy(),
                                       atol=1e-5, err_msg=k)
    assert sum(launches.values()) == 0


def test_host_table_pulls_through_pinned_memory_to_the_card(cuda):
    """HostTable.pull stages the gathered rows in pinned host memory and
    copies them without blocking: the rows on the card equal the host
    table's; a push of the card's row gradient updates the host rows;
    FeatureTable and ShardedHostTable pulls land on the card too."""
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel import (FeatureTable, HostTable,
                                           ShardedHostTable)
    tbl = HostTable(1000, 16, lambda ps: SGD(ps, 0.5), seed=2)
    ids = np.random.RandomState(1).randint(0, 1000, (64, 8))
    rows, uniq = tbl.pull(ids, device="cuda")
    assert rows.is_cuda
    torch.cuda.synchronize()
    np.testing.assert_array_equal(rows.cpu().numpy(), tbl.table[uniq])
    before = tbl.table[uniq].copy()
    tbl.push(uniq, torch.ones_like(rows))
    np.testing.assert_allclose(tbl.table[uniq], before - 0.5, atol=1e-6)
    prefetched = tbl.prefetch(ids, tag="t", device="cuda")
    prefetched.join()
    rows2, _ = tbl.take_prefetched("t")
    torch.cuda.synchronize()
    np.testing.assert_array_equal(rows2.cpu().numpy(), tbl.table[uniq])
    frows, fu, _ = FeatureTable(4, 32).pull(np.array([5, 9, 5]),
                                             device="cuda")
    assert frows.is_cuda and tuple(frows.shape) == (2, 4)
    buf = ShardedHostTable(4, 8, 0, 2).pull_local(np.array([2, 3, 4]),
                                                  device="cuda")
    torch.cuda.synchronize()
    assert buf.is_cuda and float(buf[1].abs().sum()) == 0.0


def test_decode_step_on_card_matches_cpu(cuda):
    """generate's prefill (K1, K2 on its SIMT route at f32, K4) and a
    decode step (K1, K4; the attention over the padded cache is plain
    torch) on the card give the CPU's logits and caches, f32 cache."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.ops.cuda import core
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    card = GPTDecoder(cfg, device="cuda", seed=0)
    cpu = GPTDecoder(cfg, device="cpu", seed=0)
    prompt = torch.randint(0, 512, (3, 12),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    core.reset_launches()
    for name, m in (("card", card), ("cpu", cpu)):
        with torch.no_grad():
            first, caches = m.prefill(prompt.to(m.device), 20)
            logits, caches = m.decode_step(prompt[:, :1].to(m.device),
                                           caches, 12)
        out[name] = (torch.cat([first, logits], 1).cpu(),
                     [c["k"].cpu() for c in caches])
    counts = core.launch_counts()
    assert all(counts[k] > 0 for k in ("layer_norm", "flash_attention",
                                       "mlp")), counts
    assert counts["decode_attention"] == 0
    assert float((out["card"][0] - out["cpu"][0]).abs().max()) <= F32_TOL
    for a, b in zip(out["card"][1], out["cpu"][1]):
        assert float((a - b).abs().max()) <= F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_linear_on_card(cuda, dtype):
    """A weight-only int8 Linear on the card (``Module.to`` casts the
    scale and bias, not the int8 values) equals its dequantized float
    product ``x @ (q * s) + b``, and in f32 the CPU's int8 Linear."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.quant import quantize_weights_int8
    g = torch.Generator().manual_seed(2)
    lin = quantize_weights_int8(pnn.Linear(768, 3072, gen=g))
    x = _randn(g, 16, 768, dev="cpu")
    want_cpu = lin(x).detach()
    lin = lin.to(cuda, dtype)
    assert lin.weight_q.dtype == torch.int8
    assert lin.weight_scale.dtype == dtype
    xc = x.to(cuda, dtype)
    got = lin(xc)
    ref = xc @ (lin.weight_q.to(dtype) * lin.weight_scale[None, :]) \
        + lin.bias
    assert got.dtype == dtype
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    scale = float(ref.float().abs().max())
    assert float((got.float() - ref.float()).abs().max()) <= tol * scale
    if dtype == torch.float32:
        assert float((got.cpu() - want_cpu).abs().max()) <= F32_TOL * scale


@pytest.mark.parametrize("remat", ["nothing", "dots_saveable", "full"])
def test_remat_step_relaunches_the_forward_kernels(cuda, remat):
    """A scan GPT's bf16 step under each remat policy launches K2 and K4
    once a layer in the forward, and again in the backward under the
    recomputing policies; K3 once a layer either way; the loss equals
    the unrolled model's."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Adam
    layers = 3
    kw = dict(vocab_size=512, hidden_size=128, num_layers=layers,
              num_heads=2, intermediate_size=512, max_position=128,
              dropout=0.0)
    ids = torch.randint(0, 512, (2, 128),
                        generator=torch.Generator().manual_seed(3)).to(cuda)
    losses = {}
    for scan in (False, True):
        model = GPT(GPTConfig(**kw, scan_layers=scan, remat=remat),
                    device="cuda", seed=0)
        opt = amp.decorate(Adam(model.parameters(), 1e-4), amp.bf16_policy())
        core.reset_launches()
        losses[scan] = float(opt.minimize(model, lambda m, x: m.loss(x),
                                          ids))
        counts = core.launch_counts()
    again = 1 if remat == "nothing" else 2
    assert counts["flash_attention"] == again * layers, counts
    assert counts["mlp"] == again * layers, counts
    assert counts["flash_attention_bwd_dq"] == layers, counts
    assert abs(losses[True] - losses[False]) <= 1e-6 * abs(losses[False])


def test_fleet_kill_on_card_gives_the_cpu_fleets_tokens(cuda):
    """Two replicas on the card (one module, the K7 ticket buffer of the
    device shared by both engines, stepped one after the other on one
    stream) with one killed mid-stream: every request is done with the
    tokens the same fleet gives on the CPU, and every serving kernel
    launched."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.serving import (FleetConfig, FleetRouter,
                                          ServeConfig)
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, cfg.vocab_size, n) for n in (5, 30, 12, 20,
                                                          9, 3)]
    outs = {}
    for dev in ("cpu", "cuda"):
        router = FleetRouter(
            GPTDecoder(cfg, device=dev, seed=6),
            FleetConfig(num_replicas=2, heartbeat_s=60.0),
            serve_config=ServeConfig(num_slots=2, page_size=8, max_len=48,
                                     prefill_len=16))
        core.reset_launches()
        fids = [router.submit(p, max_new=10) for p in prompts]
        for _ in range(3):
            router.step()
        router.kill_replica(max((0, 1),
                                key=lambda i: router._replicas[i].load()))
        router.drain()
        assert router.failovers == 1
        assert all(router.requests[f].status == "done" for f in fids)
        outs[dev] = [router.requests[f].tokens for f in fids]
        if dev == "cuda":
            counts = core.launch_counts()
            assert all(counts[k] > 0 for k in SERVE_KERNELS), counts
        router.close()
    assert outs["cuda"] == outs["cpu"]


def test_ernie_card_loss_backward_gives_the_cpu_gradients(cuda):
    """ErnieForPretraining.loss over ERNIE's 18000-token vocabulary on the
    card (K5/K6 meet its vocab tail) gives the CPU plain path's loss and
    every parameter's gradient (f32, TF32 off)."""
    from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.ops.cuda import core
    cfg = ErnieConfig(hidden_size=128, num_layers=2, num_heads=2,
                      intermediate_size=256, max_position=64, dropout=0.0)
    assert cfg.vocab_size == 18000
    rs = np.random.RandomState(12)
    ids = torch.from_numpy(rs.randint(0, 18000, (2, 40)))
    att = torch.ones(2, 40)
    att[1, 25:] = 0.0
    types = torch.zeros(2, 40, dtype=torch.long)
    types[:, 20:] = 1
    pos = torch.from_numpy(np.sort(np.stack([rs.choice(25, 6, replace=False)
                                             for _ in range(2)]), 1))
    args = (ids, torch.from_numpy(rs.randint(0, 18000, (2, 6))),
            torch.from_numpy(rs.randint(0, 2, 2)), torch.ones(2, 6))
    out = {}
    for dev in ("cuda", "cpu"):
        model = ErnieForPretraining(cfg, device=dev, seed=0)
        core.reset_launches()
        loss = model.loss(*(a.to(dev) for a in args),
                          token_type_ids=types.to(dev),
                          attention_mask=att.to(dev),
                          mask_positions=pos.to(dev))
        loss.backward()
        out[dev] = (loss.item(), {k: p.grad.cpu()
                                  for k, p in model.named_parameters()},
                    core.launch_counts())
    (lc, gc, counts), (lp, gp, _) = out["cuda"], out["cpu"]
    assert abs(lc - lp) <= F32_TOL
    for k in ("xent_stats", "xent_bwd_dh", "xent_bwd_dwb"):
        assert counts[k] == 1, counts
    scale = max(float(g.norm()) for g in gp.values())
    for name, g in gc.items():
        err = float((g - gp[name]).norm())
        assert err <= 1e-3 * max(float(gp[name].norm()), 1e-3 * scale), name


def test_cost_flops_on_card_is_the_cpu_count_and_launches_nothing(cuda):
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.observability.perf import cost_flops
    from paddle_tpu_torch.ops.cuda import core
    cfg = BertConfig(vocab_size=300, hidden_size=128, num_layers=2,
                     num_heads=2, intermediate_size=256, max_position=64,
                     dropout=0.0)
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 300, (2, 40)))

    def loss_fn(m, ids):
        mlm, nsp = m(ids)
        return mlm.float().square().mean() + nsp.float().sum()

    counts = []
    for dev in ("cuda", "cpu"):
        model = BertForPretraining(cfg, device=dev, seed=0)
        core.reset_launches()
        counts.append(cost_flops(loss_fn, model, ids.to(dev)))
        assert not any(core.launch_counts().values())
    assert counts[0] == counts[1] > 0


@pytest.mark.parametrize("room", [True, False])
def test_background_save_copies_before_the_next_update(cuda, monkeypatch,
                                                       room):
    """A save's copy (a device clone, or pinned host memory when the card
    has no room for one) is ordered before an in-place update queued
    right after ``save()`` returns: the checkpoint holds the pre-update
    bytes."""
    import tempfile
    from paddle_tpu_torch.io import CheckpointManager
    if not room:
        total = torch.cuda.mem_get_info()[1]
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda device=None: (0, total))
    state = {"w": torch.randn(4096, 1024, device="cuda"),
             "h": torch.randn(333, 7, device="cuda").bfloat16(),
             "step": torch.tensor(3, dtype=torch.int32, device="cuda"),
             "b": torch.randn(5, device="cuda")}
    want = {k: t.cpu() for k, t in state.items()}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        for step in (1, 2):             # the second reuses the staging
            mgr.save(step, state)
            for _ in range(20):         # the next steps, in place
                state["w"].mul_(1.5).add_(1.0)
                state["h"].add_(1.0)
                state["step"].add_(1)
            mgr.wait()
            got, _ = mgr.restore({k: torch.zeros_like(t) for k, t in
                                  want.items()}, step=step)
            for k, t in want.items():
                assert torch.equal(got[k], t), (step, k)
            want = {k: t.cpu() for k, t in state.items()}
        mgr.close()


def _stall(stream, ms=50):
    """Queue about ``ms`` of spinning on ``stream`` (at ~2 GHz), so work
    queued behind it on that stream lands late."""
    with torch.cuda.stream(stream):
        torch.cuda._sleep(int(ms * 2e6))


def test_staged_batch_is_ordered_before_its_first_use(cuda):
    """A batch placed from another thread while the loader's copy stream
    is stalled: the consumer's stream waits on the copy's event, so what
    it reads is the host batch, and the batch's tensors were allocated on
    the copy stream (the reason ``ready`` records their use on the
    consumer's)."""
    import threading
    from paddle_tpu_torch.data.loader import DataLoader, Staged
    loader = DataLoader(None)
    host = (np.arange(4096, dtype=np.int32).reshape(4, 1024),
            np.full((3, 5), 7.5, np.float32))
    _stall(loader._stager._copy_stream())
    box = {}
    t = threading.Thread(target=lambda: box.update(p=loader.place(host)))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    staged = box["p"]
    assert isinstance(staged, Staged)
    assert not loader._stager._copy_stream().query()     # the copies still queued
    assert all(t.device.type == "cuda" for t in staged.batch)
    ids, x = DataLoader.ready(staged)
    got_ids, got_x = ids.clone(), x * 1.0      # queued on this stream
    assert torch.equal(got_ids.cpu(), torch.from_numpy(host[0]))
    assert torch.equal(got_x.cpu(), torch.from_numpy(host[1]))


def test_submit_from_another_thread_stages_before_the_prefill(cuda):
    """``submit`` from a client thread while the stager's copy stream is
    stalled: the prefill on the stepping thread's stream waits for the
    staged chunk (its event), so the engine's tokens equal an engine's
    whose copies were not stalled, and every prefill read a staged
    chunk."""
    import threading
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    model = GPTDecoder(cfg, device="cuda", seed=7)
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, cfg.vocab_size, n) for n in (5, 30, 12, 20)]
    kw = dict(num_slots=2, page_size=8, max_len=48, prefill_len=16)
    calm = ServingEngine(model, ServeConfig(**kw))
    rids = [calm.submit(p, max_new=8) for p in prompts]
    calm.drain()
    want = [calm.requests[r].tokens for r in rids]

    eng = ServingEngine(model, ServeConfig(**kw))
    _stall(eng._stager._copy_stream(), ms=200)
    got = []
    t = threading.Thread(target=lambda: got.extend(
        eng.submit(p, max_new=8) for p in prompts))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(got) == len(prompts)
    assert not eng._stager._copy_stream().query()   # copies still queued
    eng.drain()
    assert [eng.requests[r].tokens for r in got] == want
    assert eng.staged_prefills == eng.prefill_calls == calm.prefill_calls


def test_opcheck_each_op_on_each_route(cuda):
    """torch.library.opcheck of the ten ops (schema, the fake
    implementation against the real outputs, autograd registration, AOT
    dispatch with dynamic shapes), each on every route it has
    (chip_smoke.py's cases)."""
    import chip_smoke
    from paddle_tpu_torch.ops.cuda import core
    checked = chip_smoke.opcheck_ops(cuda)
    assert sorted(checked) == sorted(core.KERNELS)
    for name, routes in checked.items():
        assert set(routes) == set(core.KERNELS[name].routes), name


def test_export_decode_on_card_is_token_exact(cuda, tmp_path):
    """export_decode of a live engine on the card, loaded back: 4 steps,
    each token fed back and the lengths advanced on the host, give the
    engine's next 4 greedy tokens in every running slot, and launch the
    decode kernels as many times a step as the engine's steps do."""
    import json
    import os

    from paddle_tpu_torch.io import load_program, read_params_bin
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    model = GPTDecoder(cfg, device="cuda", seed=0)
    eng = ServingEngine(model, ServeConfig(num_slots=2, page_size=16,
                                           max_len=64, prefill_len=16))
    rs = np.random.RandomState(0)
    for n in (5, 20):
        eng.submit(rs.randint(0, cfg.vocab_size, n).astype(np.int32),
                   max_new=10)
    while eng._queue:
        eng.step()
    eng.step()
    tok, table, lengths, active = (eng._last_tokens.copy(),
                                   eng._page_table.copy(),
                                   eng._lengths.copy(), eng._active.copy())
    path = eng.export_decode(str(tmp_path / "decode"))
    sig = json.load(open(os.path.join(path, "signature.json")))
    state = [torch.from_numpy(np.array(a)).to(cuda, getattr(torch, s["dtype"]))
             for a, s in zip(read_params_bin(os.path.join(path, "params.bin")),
                             sig["params"])]
    before = {s: len(r.tokens) for s, r in eng._running.items()}
    core.reset_launches()
    for _ in range(4):
        eng.step()
    per_step = {k: n / 4 for k, n in core.launch_counts().items()}
    prog = load_program(path, device="cuda")
    got = []
    tok_d = torch.from_numpy(tok).to(cuda)
    for _ in range(4):
        core.reset_launches()
        out = prog(*state, tok_d, torch.from_numpy(table).to(cuda),
                   torch.from_numpy(lengths).to(cuda),
                   torch.from_numpy(active).to(cuda))
        tok_d = out[0]
        got.append(tok_d.cpu().numpy())
        for o, i in sig["feedback"]:
            state[i] = out[o]
        lengths = lengths + active.astype(lengths.dtype)
        for k in ("layer_norm", "mlp", "decode_attention"):
            assert core.launch_counts()[k] == per_step[k] > 0, k
    got = np.stack(got)
    for slot, req in eng._running.items():
        assert got[:, slot].tolist() == \
            req.tokens[before[slot]:before[slot] + 4]


# ------------------------------------------------------------ detection

def _ssd_tools():
    import os
    import sys
    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import torch_ssd
    return torch_ssd


@pytest.mark.parametrize("matched", [False, True])
def test_ssd_step_on_card_matches_cpu(cuda, matched):
    """One f32 Momentum step of TinySSD (base 64, batch 2) on the card and
    on the CPU from the same weights, the CPU taking the card's ReLU
    branches and hard negatives: loss within 1e-4, every gradient within
    1e-3 relative L2; no kernel of the port launched."""
    import chip_smoke
    from paddle_tpu_torch.optimizer import Momentum
    ssd = _ssd_tools()
    loss_fn = ssd.matched_loss_fn if matched else ssd.ssd_loss_fn
    loss_card, loss_cpu, errs, _, launches = chip_smoke.train_crosscheck(
        lambda dev: ssd.TinySSD(64, device=dev, seed=0), loss_fn,
        ssd.ssd_batch(np.random.RandomState(0), 2, 64),
        chip_smoke.Replays(chip_smoke.ReluReplay(),
                           chip_smoke.MiningReplay()),
        lambda ps: Momentum(ps, 0.01, 0.9))
    assert abs(loss_card - loss_cpu) <= 1e-4
    assert max(errs.values()) <= 1e-3, errs
    assert not any(launches.values())


def _detections(args, dev, **kw):
    from paddle_tpu_torch.ops import detection as D
    boxes, scores = (a.to(dev) for a in args)
    out, idx, count = D.multiclass_nms2(boxes, scores, **kw)
    return out.cpu(), idx.cpu(), int(count)


@pytest.mark.parametrize("case", ["duplicates", "equal_scores", "random"])
def test_multiclass_nms_on_card_matches_cpu(cuda, case):
    """multiclass_nms2 on the card equals the CPU's: rows, source indices
    and counts, including duplicate boxes, tied scores within and across
    classes and more slots than survivors (-inf padding ties); 2,000 boxes
    with scores rounded to 2 decimals (many ties in the top-k sort)."""
    rng = np.random.RandomState(0)
    if case == "duplicates":
        boxes = np.tile(np.array([[0, 0, 10, 10], [20, 20, 30, 30]],
                                 np.float32), (6, 1))
        scores = np.full((3, 12), 0.6, np.float32)
        kw = dict(keep_top_k=30, nms_top_k=8)
    elif case == "equal_scores":
        xy = rng.uniform(0, 50, (300, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 20, (300, 2))],
                               1).astype(np.float32)
        scores = np.full((4, 300), 0.5, np.float32)
        kw = dict(keep_top_k=100, nms_top_k=120)
    else:
        xy = rng.uniform(0, 1, (2000, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.02, 0.3, (2000, 2))],
                               1).astype(np.float32)
        scores = np.round(rng.rand(5, 2000), 2).astype(np.float32)
        kw = dict(keep_top_k=200, nms_top_k=400, background_label=0)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores))
    kw.update(score_threshold=0.01, nms_threshold=0.45)
    card = _detections(args, cuda, **kw)
    cpu = _detections(args, "cpu", **kw)
    assert card[2] == cpu[2] > 0
    assert torch.equal(card[1], cpu[1])
    assert torch.equal(card[0], cpu[0])


def test_ssd_detection_output_on_card_matches_cpu(cuda):
    """detection_output of TinySSD's outputs (base 300, 28,276 priors,
    after 5 steps against the head's priors) on the card and the CPU
    from the same locs, scores and priors: chip_smoke.held_detections
    (count, labels and indices exact, values within 1e-5, a differing row
    only at a near tie of scores)."""
    import chip_smoke
    from paddle_tpu_torch.optimizer import Momentum
    ssd = _ssd_tools()
    model = ssd.TinySSD(300, device="cuda", seed=0)
    opt = Momentum(model.parameters(), 0.01, 0.9)
    data = [a.cuda() for a in ssd.ssd_batch(np.random.RandomState(0), 2,
                                            300)]
    for _ in range(5):
        opt.minimize(model, ssd.matched_loss_fn, *data)
    with torch.no_grad():
        locs, confs, boxes, vars_ = model(data[0])
        scores = torch.softmax(confs, -1)
    for i in range(2):
        args = (locs[i], scores[i], boxes, vars_)
        chip_smoke.held_detections(f"image {i}",
                                   chip_smoke.ssd_detections(args, "cuda"),
                                   chip_smoke.ssd_detections(args, "cpu"))


@pytest.mark.parametrize("model", ["tagger", "text_cnn", "stacked_lstm"])
def test_sequence_model_step_on_card_matches_cpu(cuda, model):
    """One f32 Adam step of the tagger (TaggerConfig()) or a sentiment
    net (SentimentConfig()) at full width, batch 4, on the card and on the
    CPU from the same weights: loss within 1e-4, every gradient within
    1e-3 relative L2; no kernel of the port launched."""
    import chip_smoke
    from paddle_tpu_torch.models.sentiment import (SentimentConfig,
                                                   StackedLSTMSentiment,
                                                   TextCNNSentiment)
    from paddle_tpu_torch.models.tagging import BiLstmCrfTagger, TaggerConfig
    rs = np.random.RandomState(0)
    if model == "tagger":
        cfg = TaggerConfig()
        make = lambda dev: BiLstmCrfTagger(cfg, device=dev, seed=0)
        loss_fn = chip_smoke.tagger_loss
        batch = chip_smoke.tagger_batch(rs, cfg, 4, (8, 64))
    else:
        cfg = SentimentConfig()
        cls = TextCNNSentiment if model == "text_cnn" else StackedLSTMSentiment
        make = lambda dev: cls(cfg, device=dev, seed=0)
        loss_fn = chip_smoke.sentiment_loss_of
        batch = chip_smoke.sentiment_batch(rs, cfg, 4, (32, 128))
    loss_card, loss_cpu, errs, _, launches = chip_smoke.train_crosscheck(
        make, loss_fn, batch)
    assert abs(loss_card - loss_cpu) <= 1e-4
    assert max(errs.values()) <= 1e-3, errs
    assert not any(launches.values())


def test_crf_decoding_on_card_matches_cpu(cuda):
    """crf_decoding and linear_chain_crf of random emissions at the
    tagger's 16 tags (64 rows of lengths 1-64) on the card and on the
    CPU: paths and label marks equal (or a near tie, chip_smoke's rule),
    each row's NLL within 1e-4 relative; integer-valued scores (ties
    everywhere) decode alike too."""
    import chip_smoke
    from paddle_tpu_torch.ops import crf as C
    rs = np.random.RandomState(1)
    lens = torch.from_numpy(rs.randint(1, 65, 64).astype(np.int32))
    tags = torch.from_numpy(rs.randint(0, 16, (64, 64)).astype(np.int32))
    for scale in (None, 1.0):
        if scale is None:
            em = torch.from_numpy(rs.randn(64, 64, 16).astype(np.float32))
            tr = torch.from_numpy(rs.randn(18, 16).astype(np.float32))
        else:
            em = torch.from_numpy(rs.randint(0, 2, (64, 64, 16)).astype(
                np.float32))
            tr = torch.from_numpy(rs.randint(0, 2, (18, 16)).astype(
                np.float32))
        card = C.crf_decoding(em.cuda(), tr.cuda(), lens.cuda()).cpu()
        cpu = C.crf_decoding(em, tr, lens)
        if scale is None:
            chip_smoke.held_paths("crf_decoding", card, cpu, em, tr, lens)
        else:
            assert torch.equal(card, cpu)
        if torch.equal(card, cpu):          # marks follow the paths
            assert torch.equal(C.crf_decoding(
                em.cuda(), tr.cuda(), lens.cuda(), tags.cuda()).cpu(),
                C.crf_decoding(em, tr, lens, tags))
        nll = C.linear_chain_crf(em.cuda(), tr.cuda(), tags.cuda(),
                                 lens.cuda()).cpu()
        want = C.linear_chain_crf(em, tr, tags, lens)
        assert float(((nll - want).abs()
                      / want.abs().clamp(min=1.0)).max()) <= 1e-4


def _tiny_desc(layers=2, heads=4, hidden=64, seq=64, batch=2):
    import chip_smoke
    shapes = chip_smoke.gpt_param_shapes(layers, hidden, 4 * hidden, 512,
                                         seq)
    desc = chip_smoke.gpt_loss_desc(layers, heads, seq, shapes)
    feeds = chip_smoke.gpt_desc_feeds(np.random.RandomState(5), shapes, 512,
                                      batch, seq)
    return desc, feeds


def test_program_desc_launches_the_kernels_through_the_registry(cuda):
    """GPT's loss as a ProgramDesc on the card: its forward launches K1
    (twice a layer and ln_f), K2 (once a layer) and K5 through the
    registered ops, its backward K3 (dq and dk/dv once a layer) and K6,
    and the loss and gradients are the CPU's."""
    import chip_smoke
    from paddle_tpu_torch.ops.cuda import core
    desc, feeds = _tiny_desc()
    core.reset_launches()
    card_loss, card_grads = chip_smoke.desc_loss_and_grads(desc, feeds,
                                                           "cuda")
    torch.cuda.synchronize()
    n = core.launch_counts()
    assert (n["layer_norm"], n["flash_attention"], n["xent_stats"]) == \
        (5, 2, 1)
    assert (n["flash_attention_bwd_dq"], n["flash_attention_bwd_dkv"],
            n["xent_bwd_dh"], n["xent_bwd_dwb"]) == (2, 2, 1, 1)
    cpu_loss, cpu_grads = chip_smoke.desc_loss_and_grads(desc, feeds, "cpu")
    assert abs(float(card_loss) - float(cpu_loss)) <= 1e-4 * abs(
        float(cpu_loss))
    floor = 1e-3 * max(float(g.norm()) for g in cpu_grads.values())
    for name, g in cpu_grads.items():
        err = float((card_grads[name].cpu() - g).norm())
        assert err <= 1e-3 * max(float(g.norm()), floor), name


def test_program_capture_names_the_kernel_ops(cuda):
    """``Program.capture`` of the parsed desc on the card names the
    kernels' torch.library ops, and ``Executor`` runs it on the card."""
    from paddle_tpu_torch.core.program import Program
    from paddle_tpu_torch.static import Executor, ProgramDesc
    desc, feeds = _tiny_desc()
    parsed = ProgramDesc.parse_from_string(desc.to_json())
    args = [torch.from_numpy(feeds[n]).cuda() for n in parsed.feeds]
    ops = Program.capture(parsed.build_fn(), *args).ops()
    for op in ("layer_norm", "flash_attention", "xent_stats"):
        assert f"paddle_tpu_torch::{op}" in ops, op
    (loss,) = Executor().run(parsed.to_static_program(), feed=feeds,
                             fetch_list=["loss"])
    assert loss.device.type == "cuda" and torch.isfinite(loss)


def test_fused_fc_elementwise_layernorm_launches_k8_once(cuda):
    """The op's add and layer norm are one K8 launch a call, the result
    within F32_TOL of the op on the CPU (its plain version) on the same
    inputs, in its values and gradients."""
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.ops.fused import fused_fc_elementwise_layernorm
    g = torch.Generator().manual_seed(0)
    args = [_randn(g, 37, 64, dev="cpu"), _randn(g, 64, 96, scale=0.1,
                                                 dev="cpu"),
            _randn(g, 37, 96, dev="cpu"), _randn(g, 96, dev="cpu"),
            _randn(g, 96, dev="cpu"), _randn(g, 96, dev="cpu")]
    outs = {}
    for dev in ("cuda", "cpu"):
        xs = [a.to(dev).requires_grad_() for a in args]
        core.reset_launches()
        out = fused_fc_elementwise_layernorm(*xs)
        launches = core.launch_counts()
        out.square().sum().backward()
        outs[dev] = [out.detach().cpu()] + [x.grad.cpu() for x in xs]
        if dev == "cuda":
            assert launches["add_layer_norm"] == 1
            assert sum(launches.values()) == 1
    _held(outs["cuda"], outs["cpu"], F32_TOL)


def test_layer_norm_without_scale_and_shift_launches_k1_and_k8(cuda):
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.ops.cuda import core
    g = torch.Generator().manual_seed(1)
    x, r = _randn(g, 5, 768, dev="cpu"), _randn(g, 5, 768, dev="cpu")
    for scale, shift in ((False, False), (True, False), (False, True)):
        ln = pnn.LayerNorm(768, scale=scale, shift=shift)
        with torch.no_grad():
            want = (ln(x), ln(x, r))
            ln.to("cuda")
            core.reset_launches()
            got = ln(x.cuda())
            assert core.launch_counts()["layer_norm"] == 1
            got_r = ln(x.cuda(), r.cuda())
        launches = core.launch_counts()
        assert launches["add_layer_norm"] == 1
        assert sum(launches.values()) == 2
        _held((got.cpu(), got_r.cpu()), want, F32_TOL)
