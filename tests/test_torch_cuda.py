"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
fixture, never at import). On the card, with no JAX installed there:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: 1e-4 abs in f32 (sums taken in another order than the plain
version's cuBLAS/torch reductions); bf16 outputs within 3e-2 (one bf16
rounding of values of order 1).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

F32_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0, dev="cuda", dtype=torch.float32):
    return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)


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


def test_flash_kernel_causal_offset_tails_and_mask(cuda):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    g = torch.Generator().manual_seed(1)
    for b, h, tq, tk, d, causal, masked in ((2, 3, 70, 70, 64, True, False),
                                           (1, 2, 30, 100, 32, True, False),
                                           (2, 2, 65, 65, 128, False, True)):
        q = _randn(g, b, h, tq, d)
        k = _randn(g, b, h, tk, d)
        v = _randn(g, b, h, tk, d)
        mask = None
        if masked:
            mask = torch.ones(b, tk, dtype=torch.bool, device=cuda)
            mask[1] = False
        out, lse = fa.flash_attention_kernel(q, k, v, d ** -0.5, causal,
                                             mask)
        ref, rlse = fa.chunked_attention(q, k, v, d ** -0.5, causal, mask,
                                         return_lse=True)
        assert float((out - ref).abs().max()) <= F32_TOL
        if masked:
            assert float(out[1].abs().max()) == 0.0
        else:
            assert float((lse - rlse).abs().max()) <= F32_TOL


def test_mlp_kernel_row_and_intermediate_tails(cuda):
    from paddle_tpu_torch.ops.cuda import mlp
    g = torch.Generator().manual_seed(2)
    for rows, hid, inter in ((1, 64, 40), (17, 96, 200), (33, 768, 3072)):
        x = _randn(g, rows, hid)
        w1, b1 = _randn(g, hid, inter, scale=0.1), _randn(g, inter)
        w2, b2 = _randn(g, inter, hid, scale=0.1), _randn(g, hid)
        got = mlp.mlp_kernel(x, w1, b1, w2, b2)
        want = mlp.mlp_plain(x, w1, b1, w2, b2)
        assert float((got - want).abs().max()) <= F32_TOL * max(
            1.0, float(want.abs().max()))


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
    assert all(c > 0 for c in core.launch_counts().values())
